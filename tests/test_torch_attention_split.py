"""K7's tensor-core schedule on the CPU: ``decode_attention_split_plain``
and ``k7_plan`` (pt2tpu_torch/ops/kernels/attention.py).

- With ``splits=1`` and the TPU kernel's block as ``tile``, the split plain
  version follows the TPU kernel's own schedule (its running maximum per
  block, p rounded to bf16 against it), so it is held to
  ``decode_attention_pallas`` run in interpret mode (as
  tests/test_torch_attention.py runs it) at 1e-3 of max|ref|, not that
  file's 2e-2. The query is given in f32 holding bf16 values: both then
  return f32 (the TPU kernel computes in f32 and casts to q's dtype), so the
  comparison does not round the outputs to bf16, whose step alone is up to
  2^-7 of a value. What is left is f32 summation order, and the rare p that
  rounds to the neighbouring bf16 where the two exps differ in a last bit.
- With the kernel's own plan (several splits of each row's valid range),
  against ``decode_attention_plain`` at 1e-2 (K7's tolerance: the running
  maxima differ from the row's global one), on masks that are prefixes, have
  holes, keep only the last slot, or keep none (the row's output is 0).
- ``k7_plan`` against every registry config K7 serves, at B 1 / 4 / 8 and
  M 2048: at least 132 CTAs wherever there are tiles to split, no more
  than one wave of resident clusters, a cluster size the card takes,
  shapes only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.ops.kernels import pallas_attention as jpa
from pt2tpu_torch.models.registry import CONFIGS
from pt2tpu_torch.ops.kernels import attention as k7

TPU_SCHEDULE_TOL = 1e-3
ATTN_TOL = 1e-2


def _inputs(B, M, H, Hkv, hd, quant, mask="ragged", seed=0):
    """numpy inputs: q (bf16 values in f32), k, v, kv_valid and, for int8,
    the absmax-quantised cache with its (B, M, Hkv, 1) scales."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    q = torch.from_numpy(q).bfloat16().float().numpy()
    kf = rng.normal(size=(B, M, Hkv, hd)).astype(np.float32)
    vf = rng.normal(size=(B, M, Hkv, hd)).astype(np.float32)
    pos = np.arange(M)[None, :]
    if mask == "ragged":
        valid = pos < rng.integers(1, M + 1, size=(B, 1))
    elif mask == "prefix":
        valid = pos <= (M // 3 + 7 * np.arange(B))[:, None]
    elif mask == "holes":
        valid = (rng.random(size=(B, M)) < 0.4) & (pos < rng.integers(M // 2, M + 1, size=(B, 1)))
    elif mask == "last_only":
        valid = np.broadcast_to(pos == M - 1, (B, M)).copy()
    elif mask == "empty_row":
        valid = pos < rng.integers(1, M + 1, size=(B, 1))
        valid[0] = False
    else:
        raise ValueError(mask)
    if not quant:
        kf = torch.from_numpy(kf).bfloat16().float().numpy()
        vf = torch.from_numpy(vf).bfloat16().float().numpy()
        return q, kf, vf, valid, None, None
    ks = (np.abs(kf).max(axis=-1, keepdims=True) / 127).astype(np.float32)
    vs = (np.abs(vf).max(axis=-1, keepdims=True) / 127).astype(np.float32)
    k8 = np.clip(np.round(kf / ks), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(vf / vs), -127, 127).astype(np.int8)
    return q, k8, v8, valid, ks, vs


def _torch(a, quant):
    q, k, v, valid, ks, vs = a
    cache = (lambda x: torch.from_numpy(x)) if quant else (lambda x: torch.from_numpy(x).bfloat16())
    return (torch.from_numpy(q), cache(k), cache(v), torch.from_numpy(valid),
            None if ks is None else torch.from_numpy(ks), None if vs is None else torch.from_numpy(vs))


def _jax(a, quant, scale):
    q, k, v, valid, ks, vs = a
    cache = jnp.asarray if quant else (lambda x: jnp.asarray(x, jnp.bfloat16))
    with pltpu.force_tpu_interpret_mode():
        out = jpa.decode_attention_pallas(
            jnp.asarray(q), cache(k), cache(v), jnp.asarray(valid), scale,
            k_scale=None if ks is None else jnp.asarray(ks),
            v_scale=None if vs is None else jnp.asarray(vs))
    return np.asarray(out, np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# (hd, rep) with 2 kv heads: llama-2-7b's rep 1, llama-3-8b's rep 4,
# gemma-2b's rep 8 (there with one kv head, at hd 256)
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("rep", [1, 4, 8])
def test_one_split_follows_the_tpu_kernel(quant, hd, rep):
    Hkv, B = 2, 2
    M = 1024 if quant else 512  # two of the TPU kernel's blocks (512 / 256)
    scale = hd ** -0.5
    a = _inputs(B, M, rep * Hkv, Hkv, hd, quant, seed=rep + hd + quant)
    want = _jax(a, quant, scale)
    tile = k7._block_m(M, quant)
    got = k7.decode_attention_split_plain(*_torch(a, quant)[:4], scale, *_torch(a, quant)[4:],
                                          tile=tile, splits=1)
    assert got.dtype == torch.float32 and got.shape == (B, 1, rep * Hkv, hd)
    assert _rel(got.numpy(), want) <= TPU_SCHEDULE_TOL


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("mask", ["prefix", "holes", "last_only", "empty_row"])
def test_one_split_follows_the_tpu_kernel_on_masks(quant, mask):
    B, M, H, Hkv, hd = 3, 512, 8, 2, 128
    a = _inputs(B, M, H, Hkv, hd, quant, mask=mask, seed=5)
    want = _jax(a, quant, 0.1)
    t = _torch(a, quant)
    got = k7.decode_attention_split_plain(*t[:4], 0.1, *t[4:], tile=k7._block_m(M, quant),
                                          splits=1)
    assert _rel(got.numpy(), want) <= TPU_SCHEDULE_TOL
    if mask == "empty_row":
        assert np.all(want[0] == 0) and torch.all(got[0] == 0)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("mask", ["ragged", "prefix", "holes", "last_only", "empty_row"])
@pytest.mark.parametrize("B,M,H,Hkv,hd", [
    (2, 2048, 32, 8, 128),   # llama-3-8b's heads
    (2, 2048, 8, 1, 256),    # gemma-2b's
    (3, 384, 4, 4, 128),     # llama-2-7b's rep 1
    (2, 200, 16, 1, 128),    # M not a multiple of any tile, two head groups
])
def test_kernel_plan_against_plain(quant, mask, B, M, H, Hkv, hd):
    plan = k7.k7_plan(B, M, Hkv, H // Hkv, hd, quant)
    assert plan.splits > 1
    t = _torch(_inputs(B, M, H, Hkv, hd, quant, mask=mask, seed=B + M), quant)
    t = (t[0].bfloat16(),) + t[1:]  # the kernel's bf16 query
    want = k7.decode_attention_plain(*t[:4], 0.09, *t[4:]).float()
    got = k7.decode_attention_split_plain(*t[:4], 0.09, *t[4:], tile=plan.tile,
                                          splits=plan.splits)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert _rel(got.float().numpy(), want.numpy()) <= ATTN_TOL
    if mask == "empty_row":
        assert torch.all(got[0] == 0)


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 16])
def test_split_count_only_moves_the_rounding(splits):
    """More splits than a row has tiles leave CTAs without work: their
    (NEG, 0, 0) adds exactly nothing to the combine."""
    B, M, H, Hkv, hd = 3, 640, 8, 2, 128
    t = _torch(_inputs(B, M, H, Hkv, hd, False, seed=11), False)
    one = k7.decode_attention_split_plain(*t[:4], 0.09, tile=64, splits=1)
    got = k7.decode_attention_split_plain(*t[:4], 0.09, tile=64, splits=splits)
    assert _rel(got.numpy(), one.numpy()) <= TPU_SCHEDULE_TOL


def _k7_configs():
    return sorted(n for n, c in CONFIGS.items() if c.hd in k7.HEAD_DIMS)


def test_plan_covers_the_registry():
    assert _k7_configs() == ["gemma-2b", "gemma3-4b", "llama-2-13b", "llama-2-70b", "llama-2-7b",
                             "llama-3-8b", "mixtral-8x7b", "qwen2-7b", "qwen3-30b-a3b",
                             "qwen3-8b"]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("name", _k7_configs())
def test_plan_fills_one_wave(name, B, quant):
    cfg = CONFIGS[name]
    M = 2048
    Hkv, rep = cfg.kv_heads, cfg.n_heads // cfg.kv_heads
    plan = k7.k7_plan(B, M, Hkv, rep, cfg.hd, quant)
    assert plan.tile * cfg.hd * (1 if quant else 2) * 2 == 32768  # 32 KB of K and V per stage
    pairs = B * Hkv * -(-rep // 8)
    tiles = -(-M // plan.tile)
    S = plan.splits
    assert 1 <= S <= min(k7.MAX_SPLITS, tiles) and S in k7.MAX_ACTIVE_CLUSTERS
    if pairs <= k7.MAX_ACTIVE_CLUSTERS[1]:  # one wave of resident clusters
        assert pairs <= k7.MAX_ACTIVE_CLUSTERS[S]
    else:
        assert S == 1  # pairs that fill a wave alone are not split
    # at least 132 CTAs wherever there are positions to split, and no more
    # splits than that takes
    capped = S == min(k7.MAX_SPLITS, tiles) or pairs > k7.MAX_ACTIVE_CLUSTERS[S + 1]
    assert pairs * S >= k7.SMS or capped
    assert S == 1 or pairs * (S - 1) < k7.SMS
    if B == 8:  # the engine's point
        want = {"llama-2-7b": 1, "llama-2-13b": 1, "llama-3-8b": 3, "gemma-2b": 16,
                "llama-2-70b": 3, "qwen3-8b": 3, "qwen2-7b": 5, "gemma3-4b": 5,
                "mixtral-8x7b": 3, "qwen3-30b-a3b": 5}[name]
        assert S == want
    # shapes only: the same plan on every call
    assert k7.k7_plan(B, M, Hkv, rep, cfg.hd, quant) == plan
