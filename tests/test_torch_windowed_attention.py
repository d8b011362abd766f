"""K7's plain versions on windowed ``kv_valid``, the masks a sliding-window
layer (gemma2/3) hands the decode attention: slots (p - W, p] of each row,
so the valid slots no longer start at 0 and whole leading tiles (and whole
splits of the tensor-core kernel's schedule) hold none.

- ``decode_attention_plain`` against the TPU kernel
  ``decode_attention_pallas`` in interpret mode on the same windowed masks,
  at JAX's own tolerance for the two (atol = rtol = 2e-2: they round the
  unnormalised probabilities to bf16 at different running maxima); bf16 and
  int8 KV, hd 128 and 256, 1 / 2 / 4 / 8 queries per KV head.
- ``decode_attention_split_plain`` (the tensor-core kernel's schedule) on
  its plan against ``decode_attention_plain``: a tile or a split with no
  valid slot adds nothing, and the combine divides by the valid mass
  (within 1e-2 of max|out|, the bf16 rounding of the probabilities); the
  card's kernels are held to both in tests/test_torch_kernels_cuda.py.
- A sliding layer's window reaches K7 through ``models.common.attention``
  unchanged: the plain route with the window in ``kv_valid`` equals the
  route with the same window as an additive mask (1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.ops.kernels import pallas_attention as jpa
from pt2tpu_torch.models import common as tcommon
from pt2tpu_torch.ops.kernels import attention as k7

HEADS = [(4, 4, 128), (8, 4, 128), (16, 4, 128), (16, 2, 128), (4, 2, 256), (8, 1, 256)]
# (window W, last position p of each row): a window whose start is not on a
# tile; one near the end of the cache (leading tiles and splits empty); a
# window of one slot
WINDOWS = {"unaligned": (300, (310, 433, 511)), "late": (40, (511, 500, 470)),
           "one_slot": (1, (0, 200, 511))}


def _inputs(B, M, H, Hkv, hd, quant, window, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    kf = rng.normal(size=(B, M, Hkv, hd)).astype(np.float32)
    vf = rng.normal(size=(B, M, Hkv, hd)).astype(np.float32)
    W, last = WINDOWS[window]
    p = np.array(last[:B])[:, None]
    pos = np.arange(M)[None, :]
    valid = (pos <= p) & (pos > p - W)
    if not quant:
        return q, kf, vf, valid, None, None
    ks = np.abs(kf).max(axis=-1, keepdims=True) / 127
    vs = np.abs(vf).max(axis=-1, keepdims=True) / 127
    k8 = np.clip(np.round(kf / ks), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(vf / vs), -127, 127).astype(np.int8)
    return q, k8, v8, valid, ks.astype(np.float32), vs.astype(np.float32)


def _torch(q, k, v, valid, ks, vs, quant):
    bf = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    return (bf(q), torch.from_numpy(k) if quant else bf(k), torch.from_numpy(v) if quant else bf(v),
            torch.from_numpy(valid), None if ks is None else torch.from_numpy(ks),
            None if vs is None else torch.from_numpy(vs))


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("H,Hkv,hd", HEADS)
def test_plain_matches_tpu_kernel_on_windows(H, Hkv, hd, quant, window):
    B, M = 3, 512
    q, k, v, valid, ks, vs = _inputs(B, M, H, Hkv, hd, quant, window, seed=H + hd)
    scale = hd ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = jpa.decode_attention_pallas(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(k) if quant else jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v) if quant else jnp.asarray(v, jnp.bfloat16), jnp.asarray(valid), scale,
            k_scale=None if ks is None else jnp.asarray(ks),
            v_scale=None if vs is None else jnp.asarray(vs))
    want = np.asarray(want, np.float32)
    t = _torch(q, k, v, valid, ks, vs, quant)
    got = k7.decode_attention_plain(*t[:4], scale, *t[4:])
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(k7.decode_attention(*t[:4], scale, *t[4:]), got)


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("H,Hkv,hd", HEADS)
def test_split_schedule_on_windows(H, Hkv, hd, quant, window):
    """The tensor-core kernel's schedule at the engine's M (2048, windows
    shifted to its end) and B 8 on its own plan, and at 16 splits (the most
    the card takes): empty tiles and splits add nothing."""
    B, M = 8, 2048
    q, k, v, valid, ks, vs = _inputs(3, 512, H, Hkv, hd, quant, window, seed=H * hd)
    pad = lambda a: np.concatenate([np.zeros(a.shape[:1] + (M - 512,) + a.shape[2:], a.dtype), a],
                                   axis=1)  # noqa: E731
    rep = lambda a: np.concatenate([a] * 3, axis=0)[:B]  # noqa: E731
    q = rep(q)
    k, v, valid = rep(pad(k)), rep(pad(v)), rep(pad(valid))
    ks = None if ks is None else rep(pad(ks))
    vs = None if vs is None else rep(pad(vs))
    t = _torch(q, k, v, valid, ks, vs, quant)
    plain = k7.decode_attention_plain(*t[:4], 0.07, *t[4:]).float()
    plan = k7.k7_plan(B, M, Hkv, H // Hkv, hd, quant)
    for splits in sorted({plan.splits, 16}):
        split = k7.decode_attention_split_plain(*t[:4], 0.07, *t[4:], tile=plan.tile,
                                                splits=splits).float()
        assert ((split - plain).abs().max() / plain.abs().max()).item() <= 1e-2, splits


def test_window_in_kv_valid_equals_the_window_as_a_mask():
    rng = np.random.default_rng(9)
    B, M, H, Hkv, hd = 3, 64, 8, 2, 16
    q = torch.from_numpy(rng.normal(size=(B, 1, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, M, Hkv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, M, Hkv, hd)).astype(np.float32))
    p = torch.tensor([[20], [40], [63]])
    pos = torch.arange(M)[None, :]
    causal = pos <= p
    window = causal & (pos > p - 16)
    got = tcommon.attention(q, k, v, kv_valid=window)
    bias = torch.where(window, 0.0, float("-inf"))[:, None, None, :]  # (B, 1, 1, M)
    want = tcommon.attention(q, k, v, bias, kv_valid=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
