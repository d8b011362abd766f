"""The port's speculative continuous-batching engine (``ServeEngine(draft=
...)``) against the JAX package's (CPU, f32 dense weights carried across
from JAX).

  * greedy requests through two slots with an imperfect draft (one stops at
    an EOS mid-stream) and with a perfect one: JAX's speculative engine's
    tokens, finish order and acceptance counters, and the non-speculative
    engine's tokens;
  * sampled rows: deterministic for a fixed seed, valid ids; greedy rows in
    the same batch keep their tokens;
  * ``spec_accept_per_row`` emits tokens distributed as the target (a
    chi-square test over many rows), and accepts everything when the draft
    is the target;
  * JAX's refusals (a strategy override, a sliding-window config, another
    vocabulary); ``kv_heads`` and ``multihost`` wait for ``parallel/``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sstats

from pt2tpu.models import decoder as jdec
from pt2tpu.models import registry as jreg
from pt2tpu.serve.engine import ServeEngine as JEngine
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.serve.engine import ServeEngine
from pt2tpu_torch.serve.sampling import SamplingConfig, spec_accept_per_row, spec_draw
from pt2tpu_torch.utils.checkpoint import params_from_numpy

LENS = (3, 17, 9, 4, 12)
MAX_NEW = (9, 6, 11, 8, 7)
EOS_REQ = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(tree):
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    return params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")


def _run(engine, prompts, eos_ids, sampl=None):
    reqs = [engine.submit(p, m, eos_id=e, sampling=None if sampl is None else sampl[i])
            for i, (p, m, e) in enumerate(zip(prompts, MAX_NEW, eos_ids))]
    engine.run(max_steps=300)
    assert all(r.done for r in reqs)
    return [r.out for r in reqs], [r.uid for r in engine.finished]


@pytest.fixture(scope="module")
def setup():
    """tiny-llama-gqa, a 1-layer draft, five prompts (one EOS mid-stream),
    and JAX's speculative engine's runs at spec_k 3 (imperfect draft) and 4
    (the target as its own draft)."""
    jcfg = jreg.get_config("tiny-llama-gqa")
    params = jdec.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    jdcfg = jcfg.with_(n_layers=1)
    dparams = jdec.init_params(jdcfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32) for n in LENS]
    cfg, tparams = get_config("tiny-llama-gqa"), to_port(params)
    plain = ServeEngine(cfg, tparams, max_batch=2, max_len=64)
    ref = _run(plain, prompts, [None] * len(LENS))[0][EOS_REQ]
    stop = next(j for j in range(2, len(ref) - 1) if ref.index(ref[j]) == j)
    eos_ids = [ref[stop] if i == EOS_REQ else None for i in range(len(LENS))]
    want = {}
    for name, draft, k in (("imperfect", (jdcfg, dparams), 3), ("perfect", (jcfg, params), 4)):
        eng = JEngine(jcfg, params, max_batch=2, max_len=64, draft=draft, spec_k=k)
        want[name] = (*_run(eng, prompts, eos_ids), dict(eng.stats_spec))
    port = {"imperfect": ((cfg.with_(n_layers=1), to_port(dparams)), 3),
            "perfect": ((cfg, tparams), 4)}
    return cfg, tparams, prompts, eos_ids, stop + 1, want, port


@pytest.mark.parametrize("draft", ["imperfect", "perfect"])
def test_spec_engine_equals_jax_and_plain(setup, draft):
    cfg, tparams, prompts, eos_ids, stop_len, want, port = setup
    (d, k) = port[draft]
    eng = ServeEngine(cfg, tparams, max_batch=2, max_len=64, draft=d, spec_k=k)
    outs, order = _run(eng, prompts, eos_ids)
    w_outs, w_order, w_stats = want[draft]
    assert outs == w_outs and order == w_order
    assert eng.stats_spec == w_stats
    assert len(outs[EOS_REQ]) == stop_len < MAX_NEW[EOS_REQ]
    plain = ServeEngine(cfg, tparams, max_batch=2, max_len=64)
    assert _run(plain, prompts, eos_ids)[0] == outs
    assert eng.stats["steps"] <= plain.stats["steps"]
    if draft == "perfect":
        assert eng.stats_spec["accepted"] == eng.stats_spec["drafted"]
        assert eng.stats["steps"] < plain.stats["steps"]


def test_spec_engine_sampled_rows(setup):
    """Sampled rows (speculative sampling): the same seed gives the same
    tokens, every id in the vocabulary; greedy rows in the batch keep the
    plain engine's tokens."""
    cfg, tparams, prompts, eos_ids, _, _, port = setup
    sc = SamplingConfig(temperature=0.9, top_k=40, top_p=0.95)
    sampl = [sc if i % 2 else None for i in range(len(LENS))]
    d, k = port["imperfect"]

    def go(seed):
        eng = ServeEngine(cfg, tparams, max_batch=2, max_len=64, draft=d, spec_k=k, seed=seed)
        return _run(eng, prompts, [None] * len(LENS), sampl)[0]

    a, b = go(7), go(7)
    assert a == b
    assert all(0 <= t < cfg.vocab_size for o in a for t in o)
    assert [len(o) for o in a] == list(MAX_NEW)
    plain = _run(ServeEngine(cfg, tparams, max_batch=2, max_len=64), prompts,
                 [None] * len(LENS))[0]
    assert [a[i] for i in range(0, len(LENS), 2)] == [plain[i] for i in range(0, len(LENS), 2)]
    assert go(8) != a


def test_spec_accept_is_distributed_as_the_target():
    """k = 2 drafts from pd, accepted by the rejection rule: the first
    emitted token of each of 4000 rows (distinct uids) follows pt[0]; the
    second, where the first draft was accepted, follows pt[1] too."""
    V, B, k = 6, 4000, 2
    pd = torch.tensor([0.40, 0.25, 0.15, 0.10, 0.05, 0.05])
    pt0 = torch.tensor([0.10, 0.30, 0.05, 0.30, 0.05, 0.20])
    pt1 = torch.tensor([0.25, 0.05, 0.30, 0.10, 0.20, 0.10])
    uids, pos = list(range(B)), [11] * B
    pd_b = pd.expand(B, k, V).clone()
    pt_b = torch.stack([pt0, pt1, pt0]).expand(B, k + 1, V).clone()
    drafts = torch.stack([spec_draw(pd_b[:, i], 3, uids, [p + i for p in pos], 1)
                          for i in range(k)], dim=1)
    tokens, n_acc = spec_accept_per_row(3, uids, pos, drafts, pd_b, pt_b)
    def chi2_p(tok, p):
        seen = torch.bincount(tok, minlength=V).numpy()
        want = p.double().numpy()
        return sstats.chisquare(seen, want / want.sum() * seen.sum()).pvalue

    assert chi2_p(tokens[:, 0], pt0) > 1e-3
    acc = n_acc >= 1
    assert chi2_p(tokens[acc, 1], pt1) > 1e-3
    assert chi2_p(drafts[:, 0], pd) > 1e-3  # the drafts come from pd
    assert chi2_p(drafts[:, 0], pt0) < 1e-6  # and the test can tell pd from pt
    assert ((n_acc >= 0) & (n_acc <= k)).all()
    again = spec_accept_per_row(3, uids, pos, drafts, pd_b, pt_b)
    assert torch.equal(again[0], tokens) and torch.equal(again[1], n_acc)
    same = spec_accept_per_row(3, uids, pos, drafts, pd_b, pd.expand(B, k + 1, V).clone())[1]
    assert (same == k).all()  # a draft that is the target is always accepted


def test_spec_engine_refusals(setup):
    cfg, tparams, *_ = setup
    d = (cfg, tparams)
    with pytest.raises(ValueError, match="default engine programs"):
        ServeEngine(cfg, tparams, max_len=64, draft=d, decode_fn=lambda *a: None)
    gcfg = get_config("tiny-gemma3")
    with pytest.raises(ValueError, match="sliding-window"):
        ServeEngine(gcfg, {"embed": torch.zeros(1)}, max_len=64, draft=(gcfg, None))
    with pytest.raises(ValueError, match="share a vocabulary"):
        ServeEngine(cfg, tparams, max_len=64, draft=(cfg.with_(vocab_size=7), tparams))
    # kv_heads and multihost sit beside a draft as in JAX's engine: the
    # target pool takes kv_heads (the draft's keeps its own geometry), and
    # multihost is off in one process
    eng = ServeEngine(cfg, tparams, max_len=64, draft=d, kv_heads=1)
    assert eng.cache.k.shape[-2] == 1 and eng.d_cache.k.shape[-2] == cfg.kv_heads
    assert not ServeEngine(cfg, tparams, max_len=64, draft=d, multihost=True)._mh


def test_spec_engine_budget_leaves_room_for_the_window(setup):
    """A request whose prompt + max_new + spec_k + 1 passes max_len
    finishes at once with no tokens, as JAX's admission budget says."""
    cfg, tparams, *_ = setup
    eng = ServeEngine(cfg, tparams, max_batch=2, max_len=32, draft=(cfg, tparams), spec_k=4)
    r = eng.submit(np.arange(20, dtype=np.int32), 8)  # 20 + 8 + 5 > 32
    ok = eng.submit(np.arange(10, dtype=np.int32), 8)
    eng.run()
    assert r.done and r.out == [] and len(ok.out) == 8
