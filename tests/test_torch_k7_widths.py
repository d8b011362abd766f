"""K7 at the head widths above 256 that JAX's kernel takes (hd 384 and 512,
and the wide instance's 640 and 1024), against the JAX package on the CPU.

- The plain version against ``decode_attention_pallas`` in interpret mode,
  bf16 and int8, at JAX's own tolerance (2e-2: the two round the
  unnormalised probabilities to bf16 at different running maxima), as
  ``test_torch_attention.py`` holds hd 128.
- The tensor-core kernel's schedule (``decode_attention_split_plain`` on
  ``k7_plan``'s tile and splits) against the plain version at those widths:
  its tiles are 16 or 32 positions there.
- A 2-layer config with ``head_dim`` 384, built with ``ModelConfig.with_``:
  the port's engine gives JAX's engine's greedy tokens.
- Every multiple of 128 up to ``WIDE_MAX_HD`` passes ``_check`` (640 and
  1152 get the wide instance's plan: 16-position tiles, its own occupancy
  table); a width past it raises ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.models import registry as jreg
from pt2tpu.ops.kernels import pallas_attention as jpa
from pt2tpu.serve.engine import ServeEngine as JEngine
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.ops.kernels import attention as k7
from pt2tpu_torch.serve.engine import ServeEngine as TEngine

from test_torch_attention import _bf16, _mk
from test_torch_packed_gather import to_port

WIDE = (384, 512)
WIDE_RT = (640, 1024)  # the wide instance (the width at run time)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_inputs(q, k, v, valid, ks, vs, quant):
    tk = torch.from_numpy(k) if quant else _bf16(k)
    tv = torch.from_numpy(v) if quant else _bf16(v)
    return (_bf16(q), tk, tv, torch.from_numpy(valid),
            None if ks is None else torch.from_numpy(ks),
            None if vs is None else torch.from_numpy(vs))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hd", WIDE + WIDE_RT)
def test_plain_matches_tpu_kernel_interpret(hd, quant):
    B, M, H, Hkv = 2, 256, 4, 2
    q, k, v, valid, ks, vs = _mk(B, M, H, Hkv, hd, quant, seed=hd + quant)
    jk = jnp.asarray(k) if quant else jnp.asarray(k, jnp.bfloat16)
    jv = jnp.asarray(v) if quant else jnp.asarray(v, jnp.bfloat16)
    scale = hd ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = jpa.decode_attention_pallas(
            jnp.asarray(q, jnp.bfloat16), jk, jv, jnp.asarray(valid), scale,
            k_scale=None if ks is None else jnp.asarray(ks),
            v_scale=None if vs is None else jnp.asarray(vs))
    want = np.asarray(want, np.float32)
    t = _torch_inputs(q, k, v, valid, ks, vs, quant)
    got = k7.decode_attention_plain(t[0], t[1], t[2], t[3], scale, t[4], t[5])
    assert got.shape == (B, 1, H, hd) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)
    assert k7.supported(M, hd, quant)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("hd", WIDE)
def test_kernel_schedule_against_plain(hd, B, quant):
    M, H, Hkv = 512, 8, 2
    plan = k7.k7_plan(B, M, Hkv, H // Hkv, hd, quant)
    assert plan.tile == {(384, False): 16, (384, True): 32, (512, False): 16,
                         (512, True): 32}[(hd, quant)]
    assert plan.tile == k7.k7_tile(hd, quant) and plan.splits >= 1
    q, k, v, valid, ks, vs = _mk(B, M, H, Hkv, hd, quant, seed=B + hd)
    t = _torch_inputs(q, k, v, valid, ks, vs, quant)
    scale = hd ** -0.5
    want = k7.decode_attention_plain(t[0], t[1], t[2], t[3], scale, t[4], t[5]).float()
    got = k7.decode_attention_split_plain(t[0], t[1], t[2], t[3], scale, t[4], t[5],
                                          tile=plan.tile, splits=plan.splits).float()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-2


def test_tiles_and_chunks_of_the_narrow_widths_stay():
    """hd 128 and 256 keep the tiles and chunks they had."""
    assert [k7.k7_tile(hd, q) for hd in (128, 256) for q in (False, True)] == [64, 128, 32, 64]
    assert k7.HEAD_DIMS == (128, 256, 384, 512)
    assert k7.chunk_len(1, 1 << 18, 1, 1, 128) == 512 and k7.chunk_len(1, 1 << 18, 1, 1, 512) == 256


def test_unbuilt_width_raises():
    """JAX takes any multiple of 128: widths without a compile-time instance
    (640, 1152) pass ``_check`` and get the wide instance's plan; only a
    width past WIDE_MAX_HD (what one SM holds) raises."""
    B, M, H = 1, 128, 2
    valid = torch.ones((B, M), dtype=torch.bool)
    for hd in (640, 1152):
        q = torch.zeros((B, 1, H, hd), dtype=torch.bfloat16)
        kv = torch.zeros((B, M, H, hd), dtype=torch.bfloat16)
        assert k7.supported(M, hd, False) and hd not in k7.HEAD_DIMS
        k7._check(q, kv, kv, valid, None, None)
        assert k7.k7_plan(B, M, H, 1, hd, False).tile == 16
    hd = k7.WIDE_MAX_HD + 128
    q = torch.zeros((B, 1, H, hd), dtype=torch.bfloat16)
    kv = torch.zeros((B, M, H, hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"hd={hd}"):
        k7._check(q, kv, kv, valid, None, None)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hd", [640, 768, 1024, 1152, 2048])
def test_wide_instance_plan(hd, quant):
    """The wide instance's plan: 16-position tiles at every width and
    dtype, splits from its own occupancy table (one CTA an SM): the fewest
    that give every SM a CTA, within one wave of resident clusters."""
    t = k7.MAX_ACTIVE_CLUSTERS_WIDE
    for B, Hkv, rep, M in ((8, 2, 4, 2048), (1, 2, 4, 256), (1, 8, 1, 2048), (64, 8, 4, 2048)):
        plan = k7.k7_plan(B, M, Hkv, rep, hd, quant)
        assert plan.tile == k7.k7_tile(hd, quant) == 16
        pairs = B * Hkv
        assert 1 <= plan.splits <= min(k7.MAX_SPLITS, M // 16)
        assert plan.splits == 1 or pairs <= t[plan.splits]
        assert plan.splits == 1 or plan.splits <= -(-k7.SMS // pairs)
    assert k7.k7_plan(64, 2048, 8, 4, hd, quant).splits == 1  # 512 pairs: no split
    # the narrow widths keep their table
    assert k7.k7_plan(8, 2048, 8, 4, 128, quant) == k7.k7_plan(8, 2048, 8, 4, 128, quant)
    assert t[1] == k7.SMS


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("hd", WIDE_RT)
def test_wide_instance_schedule_against_plain(hd, B, quant):
    """The wide instance's schedule (16-position tiles, its plan's splits) in
    PyTorch against the plain version, on a windowed kv_valid too."""
    M, H, Hkv = 512, 8, 2
    plan = k7.k7_plan(B, M, Hkv, H // Hkv, hd, quant)
    q, k, v, valid, ks, vs = _mk(B, M, H, Hkv, hd, quant, seed=B + hd + 1)
    t = _torch_inputs(q, k, v, valid, ks, vs, quant)
    scale = hd ** -0.5
    pos = torch.arange(M)[None, :]
    for kv_valid in (t[3], (pos < 400) & (pos > 400 - 128)):
        kv_valid = kv_valid.expand(B, M).contiguous()
        want = k7.decode_attention_plain(t[0], t[1], t[2], kv_valid, scale, t[4], t[5]).float()
        got = k7.decode_attention_split_plain(t[0], t[1], t[2], kv_valid, scale, t[4], t[5],
                                              tile=plan.tile, splits=plan.splits).float()
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-2


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_hd384_model_engine_matches_jax(kv_quant):
    """A 2-layer tiny llama with head_dim 384 (ModelConfig.with_) through
    both packages' engines: the same greedy tokens."""
    kw = dict(n_layers=2, head_dim=384)
    cfg_j = jreg.get_config("tiny-llama").with_(**kw)
    cfg_t = get_config("tiny-llama").with_(**kw)
    assert cfg_t.hd == 384
    jparams = jrand.random_ternary_params(cfg_j, jax.random.PRNGKey(1), dtype=jnp.float32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg_j.vocab_size, size=L) for L in (5, 11, 3)]
    outs = []
    for Eng, cfg, params in ((JEngine, cfg_j, jparams), (TEngine, cfg_t, to_port(jparams))):
        eng = Eng(cfg, params, max_batch=2, max_len=64, kv_quant=kv_quant)
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        eng.run()
        outs.append([list(r.out) for r in reqs])
    assert outs[0] == outs[1]
