"""The port's HTTP ``ServingServer`` on 127.0.0.1, port 0, over a tiny
model on the CPU: concurrent POSTs answered with the engine's tokens,
/health, and 400 / 404 on bad requests."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from pt2tpu import cli as jcli
from pt2tpu.models import registry as jreg
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch import cli as tcli
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.serve.generate import greedy_generate
from pt2tpu_torch.serve.server import ServingServer
from pt2tpu_torch.utils.randmodel import random_ternary_params


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Eager torch on tiny shapes runs on one intra-op thread: under
    pytest-xdist the workers share the cores, and idle OpenMP threads that
    spin for work slow every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def server(one_torch_thread):
    cfg = get_config("tiny-llama-gqa")
    params = random_ternary_params(cfg, seed=2, perm_mode="ssr", device="cpu")
    srv = ServingServer(cfg, params, host="127.0.0.1", port=0, max_batch=2, max_len=64,
                        kv_quant=True, decode_quantum=2).start()
    yield cfg, params, srv
    srv.stop()


def _post(port, body, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_concurrent_posts_get_the_engines_tokens(server):
    cfg, params, srv = server
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (4, 11, 7)]
    answers = [None] * 3

    def go(i):
        answers[i] = _post(srv.port, {"prompt_ids": prompts[i], "max_new": 6})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for p, (code, body) in zip(prompts, answers):
        assert code == 200
        want = greedy_generate(cfg, params, torch.tensor([p]), 6, max_len=64,
                               kv_quant=True)[0].tolist()
        assert body["ids"] == want
    assert sorted(a[1]["uid"] for a in answers) == sorted(set(a[1]["uid"] for a in answers))


def test_health(server):
    _, _, srv = server
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/health", timeout=30) as r:
        body = json.loads(r.read())
    assert r.status == 200 and body["status"] == "ok"
    assert {"admitted", "completed", "t_admit_s", "t_decode_s"} <= set(body["stats"])


@pytest.mark.parametrize("raw", [b"{not json", b'{"max_new": 3}', b'{"prompt_ids": null}',
                                 b'{"prompt_ids": []}', b'{"prompt_ids": [1, 2], "max_new": "x"}'])
def test_bad_body_is_a_400(server, raw):
    _, _, srv = server
    code, body = _post(srv.port, None, raw=raw)
    assert code == 400 and "bad request" in body["error"]


def test_unknown_path_is_a_404(server):
    _, _, srv = server
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nothing", timeout=30)
    assert e.value.code == 404


def test_cli_generate_kv_int8_prints_jax_ids(tmp_path, capsys):
    cfg = jreg.get_config("tiny-llama-gqa")
    params = jrand.random_ternary_params(cfg, jax.random.PRNGKey(8), perm_mode="down")
    jckpt.save_model(str(tmp_path), cfg, params)
    argv = ["generate", "--model", str(tmp_path), "--prompt-ids", "9,1,44,7,3", "--max-new", "7",
            "--kv-int8"]
    jcli.main(argv)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    tcli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and len(got.split(",")) == 7


@pytest.mark.parametrize("flag", [["--paged", "--page-size", "16", "--kv-pages", "6"],
                                  ["--draft", "DRAFT", "--spec-k", "3"], ["--tp", "2"]])
def test_cli_serve_unported_flags_raise(tmp_path, flag, monkeypatch):
    """``--tp`` is not ported and raises. ``--paged`` and ``--draft`` are:
    ``cli serve`` builds the paged or the speculative engine and hands it to
    the server, which answers POSTs on 127.0.0.1 with the tokens of JAX's
    paged engine / of JAX's greedy decoding on the same artifacts."""
    if flag[0] == "--tp":
        with pytest.raises(NotImplementedError, match="not ported"):
            tcli.main(["serve", "--model", str(tmp_path), "--device", "cpu"] + flag)
        return
    from pt2tpu.serve import greedy_generate as jgreedy
    from pt2tpu.serve.paged import PagedServeEngine as JPaged
    from pt2tpu_torch.serve import server as tserver

    cfg = jreg.get_config("tiny-llama-gqa")
    params = jrand.random_ternary_params(cfg, jax.random.PRNGKey(4), perm_mode="down")
    jckpt.save_model(str(tmp_path / "t"), cfg, params)
    dcfg = cfg.with_(n_layers=1)
    jckpt.save_model(str(tmp_path / "d"), dcfg,
                     jrand.random_ternary_params(dcfg, jax.random.PRNGKey(6), perm_mode="down"))
    flag = [str(tmp_path / "d") if f == "DRAFT" else f for f in flag]
    started = []
    start = tserver.ServingServer.start
    monkeypatch.setattr(tserver.ServingServer, "start",
                        lambda self: started.append(self) or start(self))
    exits = []

    def serve():
        try:
            tcli.main(["serve", "--model", str(tmp_path / "t"), "--device", "cpu", "--port", "0",
                       "--max-batch", "2", "--max-len", "64"] + flag)
        except SystemExit as e:  # how cli serve ends once its engine has stopped
            exits.append(str(e))

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    for _ in range(600):
        if started and started[0].port:
            break
        th.join(timeout=0.1)
    srv = started[0]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 12, 17)]
    try:
        got = [_post(srv.port, {"prompt_ids": p.tolist(), "max_new": 9}) for p in prompts]
    finally:
        srv.error = "stopped by the test"  # ends cli serve's wait loop, which stops the server
        th.join(timeout=60)
    assert not th.is_alive() and exits == ["the engine failed: stopped by the test"]
    if flag[0] == "--paged":
        assert type(srv.engine).__name__ == "PagedServeEngine" and srv.engine.ps == 16
        jeng = JPaged(cfg, params, max_batch=2, max_len=64, page_size=16, kv_pages=6)
        reqs = [jeng.submit(p, 9) for p in prompts]
        jeng.run()
        want = [r.out for r in reqs]
    else:
        assert srv.engine.draft is not None and srv.engine.spec_k == 3
        want = [np.asarray(jgreedy(cfg, params, jax.numpy.asarray(p[None]), max_new=9,
                                   max_len=64))[0].tolist() for p in prompts]
    assert [code for code, _ in got] == [200] * 3
    assert [body["ids"] for _, body in got] == want
