"""Manual tensor parallelism (``pt2tpu_torch.parallel``) against the JAX
package's ``pt2tpu.parallel.tp`` on the CPU: one port case for each case of
``tests/test_tp_manual.py``.

The port runs one process per rank: each world is a gloo group of 2 or 4
processes started by ``subprocess`` from ``tests/torch_tp_worker.py`` (no
JAX there), with ``OMP_NUM_THREADS=1``. One world runs many cases, so
start-ups stay few; each world has a 120 s timeout and its process group a
60 s one, so a hung collective fails these tests and not the suite's clock.

- ``tp_layer_forward`` against JAX's inside ``shard_map`` on the 8-device
  CPU mesh: the hidden within 1e-4 in f32;
- ``tp_row_apply``'s chunked all_reduce (chunks 1 and 2) against JAX's
  single-device apply, as JAX's test holds its own;
- ``tp_generate`` against JAX's ``tp_generate`` token for token at ways 2
  and 4: tiny-llama (identity, "ssr" and "down" layouts), the gated
  families (tiny-gemma, tiny-qwen3, tiny-gemma3), the ungated ones
  (tiny-opt, tiny-gpt2, tiny-bloom's ALiBi);
- the TP engine (``make_tp_engine_fns``, ``kv_heads``, ``multihost``)
  against JAX's TP engine: tiny-llama at ways 4 and 2, tiny-gemma3's
  sliding windows per row, tiny-bloom's ALiBi;
- ``prepare_tp_params``' lane orders equal JAX's arrays, and each rank's
  shard is JAX's ``tp_param_specs`` slice;
- a 2-rank ``multihost`` default engine with requests submitted on rank 0:
  both ranks give JAX's single-process engine's tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.models import decoder as jdec
from pt2tpu.models import get_config as jget_config
from pt2tpu.ops.ternary_matmul import ternary_linear_apply as jlinear_apply
from pt2tpu.parallel import tp as jtp
from pt2tpu.parallel.mesh import make_mesh as jmake_mesh
from pt2tpu.serve.engine import ServeEngine as JEngine
from pt2tpu.utils.randmodel import random_ternary_linear as jrand_linear
from pt2tpu.utils.randmodel import random_ternary_params as jrand_params
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.parallel import mesh as tmesh
from pt2tpu_torch.parallel import tp as ttp

from test_torch_packed_gather import to_port
from torch_tp_worker import run_world


_JPARAMS = {}


def jparams(name: str, seed: int, perm_mode: str):
    key = (name, seed, perm_mode)
    if key not in _JPARAMS:
        # f32, as the port's other tests against JAX: in bf16 XLA's fused
        # rounding and PyTorch's eager one part at exact ties of the logits
        _JPARAMS[key] = jrand_params(jget_config(name), jax.random.PRNGKey(seed),
                                     dtype=jnp.float32, perm_mode=perm_mode)
    return _JPARAMS[key]


def _prompt(cfg, seed: int):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)


def _requests(cfg, lens, max_new):
    return [(np.random.default_rng(s).integers(0, cfg.vocab_size, (n,)), max_new)
            for s, n in enumerate(lens)]


# every generate case: (name, perm_mode, ways); JAX's test_tp_manual cases
# and tiny-llama's three layouts at both widths
GENERATE = [("tiny-llama", pm, w) for w in (2, 4) for pm in ("identity", "ssr", "down")] + [
    (n, "ssr", 2) for n in ("tiny-gemma", "tiny-qwen3", "tiny-gemma3", "tiny-opt", "tiny-gpt2",
                            "tiny-bloom")]
# every engine case: (name, seed, perm_mode, ways, prompt lengths, max_new, max_batch, max_len)
ENGINE = [("tiny-llama", 9, "ssr", 4, (3, 9, 5, 17, 2), 5, 3, 64),
          ("tiny-llama", 9, "down", 2, (3, 9, 5, 17, 2), 5, 3, 64),
          ("tiny-gemma3", 9, "ssr", 2, (3, 9, 17), 5, 2, 64),
          ("tiny-bloom", 11, "ssr", 4, (3, 9, 5), 4, 2, 32)]
LAYER_X = np.random.default_rng(3).standard_normal(
    (2, 8, jget_config("tiny-llama").dim)).astype(np.float32) * 0.1
ROW_X = np.random.default_rng(4).standard_normal((3, 512)).astype(np.float32)


def _gen_name(name, pm, ways):
    return f"gen-{name}-{pm}-w{ways}"


def _engine_name(case):
    return f"engine-{case[0]}-{case[2]}-w{case[3]}"


def _cases(world: int):
    cases = []
    for name, pm, ways in GENERATE:
        if ways == world:
            cfg = get_config(name)
            cases.append(dict(name=_gen_name(name, pm, ways), kind="generate", cfg=cfg, ways=ways,
                              params=to_port(jparams(name, 5, pm)), prompt=_prompt(cfg, 1),
                              max_new=6, max_len=32))
    for case in ENGINE:
        name, seed, pm, ways, lens, max_new, mb, ml = case
        if ways == world:
            cfg = get_config(name)
            cases.append(dict(name=_engine_name(case), kind="engine", cfg=cfg, ways=ways,
                              params=to_port(jparams(name, seed, pm)), max_batch=mb, max_len=ml,
                              requests=_requests(cfg, lens, max_new)))
    if world == 4:
        cfg = get_config("tiny-llama")
        for pm in ("identity", "ssr"):
            layer = tdec.layer_slice(to_port(jparams("tiny-llama", 0, pm))["layers"], 0)
            cases.append(dict(name=f"layer-{pm}", kind="layer", cfg=cfg, ways=4, layer=layer,
                              x=torch.from_numpy(LAYER_X)))
        lin = jrand_linear(jax.random.PRNGKey(1), 256, 512, perm_mode="folded")
        cases.append(dict(name="row", kind="row", cfg=cfg, ways=4, chunks=(1, 2),
                          linear=to_port({"w": lin})["w"], x=torch.from_numpy(ROW_X)))
    if world == 2:
        cfg = get_config("tiny-llama")
        cases.append(dict(name="multihost", kind="multihost", cfg=cfg, max_batch=3, max_len=64,
                          params=to_port(jparams("tiny-llama", 9, "ssr")),
                          requests=_requests(cfg, (3, 9, 5, 17, 2), 5)))
    return cases


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(_cases(2), 2, str(tmp_path_factory.mktemp("tp2")), timeout_s=120)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(_cases(4), 4, str(tmp_path_factory.mktemp("tp4")), timeout_s=120)


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _ranks_equal(results, name):
    """The case's result, the same bits on every rank."""
    outs = [r[name] for r in results]
    assert all(_same(o, outs[0]) for o in outs[1:])
    return outs[0]


@pytest.mark.parametrize("name,pm,ways", GENERATE,
                         ids=[_gen_name(*c) for c in GENERATE])
def test_tp_generate_matches_jax(name, pm, ways, world2, world4):
    """Every rank's tokens are the same and equal JAX's ``tp_generate`` on
    the 8-device CPU mesh at the same ways."""
    got = _ranks_equal(world2 if ways == 2 else world4, _gen_name(name, pm, ways))
    cfg = jget_config(name)
    params = jparams(name, 5, pm)
    mesh = jmake_mesh({"data": 8 // ways, "model": ways})
    want = jtp.tp_generate(cfg, mesh, jtp.prepare_tp_params(cfg, params, ways=ways),
                           jnp.asarray(_prompt(cfg, 1)), max_new=6, max_len=32, impl="xla")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ENGINE, ids=[_engine_name(c) for c in ENGINE])
def test_tp_engine_matches_jax(case, world2, world4):
    """The TP engine (the rank's pool of its KV heads, rank 0 admitting for
    both) gives JAX's TP engine's tokens on every rank."""
    name, seed, pm, ways, lens, max_new, mb, ml = case
    got = _ranks_equal(world2 if ways == 2 else world4, _engine_name(case))
    cfg = jget_config(name)
    tp_params = jtp.prepare_tp_params(cfg, jparams(name, seed, pm), ways=ways)
    mesh = jmake_mesh({"data": 8 // ways, "model": ways})
    pf, df = jtp.make_tp_engine_fns(cfg, mesh, tp_params, impl="xla")
    eng = JEngine(cfg, tp_params, max_batch=mb, max_len=ml, impl="xla", prefill_fn=pf,
                  decode_fn=df)
    reqs = [eng.submit(p, max_new=n) for p, n in _requests(cfg, lens, max_new)]
    eng.run()
    assert got == [list(r.out) for r in reqs]


@pytest.mark.parametrize("pm", ["identity", "ssr"])
def test_tp_layer_matches_jax_shard_map(pm, world4):
    """``tp_layer_forward`` at ways 4 against JAX's inside ``shard_map``:
    the hidden within 1e-4 (f32), the same on every rank."""
    got = _ranks_equal(world4, f"layer-{pm}")
    cfg = jget_config("tiny-llama")
    lp = jdec.layer_slice(jparams("tiny-llama", 0, pm)["layers"], 0)
    mesh = jmake_mesh({"data": 2, "model": 4})
    lp_tp = jtp.prepare_tp_layer(cfg, lp, ways=4)
    fn = jtp.make_tp_layer_fn(cfg, mesh, lp_tp, LAYER_X.shape[1], chunks=2, impl="xla")
    want = np.asarray(fn(lp_tp, jnp.asarray(LAYER_X)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("chunks", [1, 2])
def test_tp_row_apply_chunked_reduce(chunks, world4):
    """The row-parallel apply sums the ranks' partials, per output chunk
    (each chunk's all_reduce issued before the next chunk's product), to
    JAX's single-device apply within JAX's test's 2e-5."""
    got = _ranks_equal(world4, "row")[[1, 2].index(chunks)]
    lin = jrand_linear(jax.random.PRNGKey(1), 256, 512, perm_mode="folded")
    want = np.asarray(jlinear_apply(lin, jnp.asarray(ROW_X), impl="xla"))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_multihost_engine_matches_jax_single_process(world2):
    """The default engine with ``multihost=True`` on 2 ranks, requests
    submitted on rank 0: both ranks emit JAX's single-process engine's
    tokens."""
    got = _ranks_equal(world2, "multihost")
    cfg = jget_config("tiny-llama")
    eng = JEngine(cfg, jparams("tiny-llama", 9, "ssr"), max_batch=3, max_len=64, impl="xla")
    reqs = [eng.submit(p, max_new=n) for p, n in _requests(cfg, (3, 9, 5, 17, 2), 5)]
    eng.run()
    assert got == [list(r.out) for r in reqs]


@pytest.mark.parametrize("name,pm,ways", [
    ("tiny-llama", "ssr", 2), ("tiny-llama", "ssr", 4), ("tiny-llama", "down", 2),
    ("tiny-llama", "down", 4), ("tiny-gemma", "ssr", 2), ("tiny-gemma", "ssr", 4),
    ("tiny-opt", "ssr", 2), ("tiny-opt", "ssr", 4)])
def test_prepare_and_shard_match_jax(name, pm, ways):
    """``prepare_tp_params``' lane orders are JAX's arrays, and each rank's
    shard is the slice JAX's ``tp_param_specs`` gives shard_map; where ways
    does not divide the heads (tiny-gemma's 2 KV heads at 4), both refuse."""
    cfg_j, cfg_t = jget_config(name), get_config(name)
    params = jparams(name, 5, pm)
    if cfg_t.kv_heads % ways:
        with pytest.raises(ValueError, match="must divide"):
            jtp.prepare_tp_params(cfg_j, params, ways=ways)
        with pytest.raises(ValueError, match="must divide"):
            ttp.prepare_tp_params(cfg_t, to_port(params), ways)
        return
    want = to_port(jtp.prepare_tp_params(cfg_j, params, ways=ways))
    got = ttp.prepare_tp_params(cfg_t, to_port(params), ways)
    for key in ("qkv", "gateup", "up", "o", "down"):
        a, b = want["layers"].get(key), got["layers"].get(key)
        assert (a is None) == (b is None)
        if a is None:
            continue
        for f in ("packed", "alpha", "mu", "perm", "bias"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None) and (x is None or torch.equal(x, y)), (key, f)
    axis_of = lambda r: tmesh.Axis("model", ways, r, tuple(range(ways)))  # noqa: E731
    shards = [ttp.shard_tp_params(got, axis_of(r)) for r in range(ways)]
    for key, dim in (("qkv", -1), ("o", -2), ("down", -2)):
        for f in ("packed", "alpha", "mu"):
            whole = getattr(got["layers"][key], f)
            parts = [getattr(s["layers"][key], f) for s in shards]
            assert torch.equal(torch.cat(parts, dim=dim), whole), (key, f)
    o = got["layers"]["o"]
    if o.gather is not None:  # the gather's output lanes follow the row shard
        parts = [s["layers"]["o"].gather.packed for s in shards]
        assert torch.equal(torch.cat(parts, dim=-1), o.gather.packed)


def test_mesh_in_one_process():
    """Without a process group the world is one rank: every axis has size 1
    and no group, a mesh that needs more ranks is refused, and
    ``initialize_distributed`` does nothing (JAX's single-process no-op)."""
    assert tmesh.initialize_distributed() is False
    m = tmesh.make_mesh({"data": 1, "model": 1})
    assert m["model"].size == 1 and m["model"].rank == 0 and m["model"].group is None
    assert tmesh.auto_mesh()["model"].size == 1
    with pytest.raises(ValueError, match="needs 2 processes"):
        tmesh.make_mesh({"data": 1, "model": 2})
