"""Decode attention of the port against the JAX package on the CPU.

- K7's plain version (``decode_attention_plain``) against the TPU kernel
  ``decode_attention_pallas`` run in interpret mode, as
  tests/test_attention_kernel.py runs it, at JAX's own tolerance
  (atol = rtol = 2e-2): the two round the unnormalised probabilities to
  bf16 at different running maxima.
- The port's ``attention`` with int8 scales (and with the integer-domain
  flag) against JAX's ``attention(attn_kernel=False)`` in f32 at 1e-5:
  the same math, summed in another order.
- ``supported`` has JAX's truth table, and the CPU never routes to K7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.models import common as jcommon
from pt2tpu.ops.kernels import pallas_attention as jpa
from pt2tpu_torch.models import common as tcommon
from pt2tpu_torch.ops.kernels import attention as k7


def _mk(B, M, H, Hkv, hd, quant, seed=0, q_dtype=np.float32):
    """numpy inputs: q, k, v, ragged kv_valid, and for int8 the absmax
    quantised cache with its (B, M, Hkv, 1) scales."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, hd)).astype(q_dtype)
    kf = rng.normal(size=(B, M, Hkv, hd)).astype(np.float32)
    vf = rng.normal(size=(B, M, Hkv, hd)).astype(np.float32)
    lens = rng.integers(1, M + 1, size=(B,))
    valid = np.arange(M)[None, :] < lens[:, None]
    if not quant:
        return q, kf, vf, valid, None, None
    ks = np.abs(kf).max(axis=-1, keepdims=True) / 127
    vs = np.abs(vf).max(axis=-1, keepdims=True) / 127
    k8 = np.clip(np.round(kf / ks), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(vf / vs), -127, 127).astype(np.int8)
    return q, k8, v8, valid, ks.astype(np.float32), vs.astype(np.float32)


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


@pytest.mark.parametrize("B,M,H,Hkv,quant", [
    (2, 512, 4, 4, False),  # MHA bf16: grid (2, 2)
    (2, 256, 8, 2, False),  # GQA bf16: grid (2, 1)
    (2, 512, 8, 2, True),   # GQA int8, rep 4: grid (2, 1)
], ids=["bf16-mha", "bf16-gqa", "int8-gqa-rep4"])
def test_plain_matches_tpu_kernel_interpret(B, M, H, Hkv, quant):
    q, k, v, valid, ks, vs = _mk(B, M, H, Hkv, 128, quant, seed=B + M + H)
    jq = jnp.asarray(q, jnp.bfloat16)
    jk = jnp.asarray(k) if quant else jnp.asarray(k, jnp.bfloat16)
    jv = jnp.asarray(v) if quant else jnp.asarray(v, jnp.bfloat16)
    jks = None if ks is None else jnp.asarray(ks)
    jvs = None if vs is None else jnp.asarray(vs)
    with pltpu.force_tpu_interpret_mode():
        want = jpa.decode_attention_pallas(jq, jk, jv, jnp.asarray(valid), 0.125,
                                           k_scale=jks, v_scale=jvs)
    want = np.asarray(want, np.float32)
    tk = torch.from_numpy(k) if quant else _bf16(k)
    tv = torch.from_numpy(v) if quant else _bf16(v)
    got = k7.decode_attention_plain(
        _bf16(q), tk, tv, torch.from_numpy(valid), 0.125,
        None if ks is None else torch.from_numpy(ks), None if vs is None else torch.from_numpy(vs))
    assert got.shape == (B, 1, H, 128) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)
    # the wrapper on CPU tensors is the plain version
    again = k7.decode_attention(
        _bf16(q), tk, tv, torch.from_numpy(valid), 0.125,
        None if ks is None else torch.from_numpy(ks), None if vs is None else torch.from_numpy(vs))
    assert torch.equal(again, got)


def test_plain_quantized_query_matches_jax_prep():
    """The int8 query prep (per (row, head) absmax, floor 1e-20, round half
    to even) gives JAX's bytes, including an all-zero head."""
    q = np.random.default_rng(3).normal(size=(2, 1, 4, 128)).astype(np.float32)
    q[1, 0, 2] = 0.0
    q[0, 0, 1, :3] = [127.0, 2.5, -3.5]  # scale 1: halves round to even
    qb = torch.from_numpy(q).bfloat16()
    q8, qs = k7.quantize_query(qb)
    qf = jnp.asarray(q, jnp.bfloat16)[:, 0].astype(jnp.float32)
    jqs = jnp.maximum(jnp.max(jnp.abs(qf), axis=-1, keepdims=True) / 127.0, 1e-20)
    jq8 = jnp.clip(jnp.round(qf / jqs), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(jqs)[..., 0])
    assert q8[0, 1, 1].item() == 2 and q8[0, 1, 2].item() == -4


@pytest.mark.parametrize("integer_domain", [False, True], ids=["convert", "integer"])
@pytest.mark.parametrize("Lq,masked", [(1, False), (5, True)], ids=["decode", "prefill"])
def test_attention_with_scales_matches_jax(monkeypatch, integer_domain, Lq, masked):
    B, M, H, Hkv, hd = 2, 24, 4, 2, 16
    rng = np.random.default_rng(Lq + 10 * integer_domain)
    q = rng.normal(size=(B, Lq, H, hd)).astype(np.float32)
    _, k8, v8, valid, ks, vs = _mk(B, M, H, Hkv, hd, True, seed=7)
    mask = None
    if masked:
        mask = np.where(np.arange(M)[None, :] <= 10 + np.arange(Lq)[:, None], 0.0,
                        -np.inf).astype(np.float32)
    monkeypatch.setattr(jcommon, "INT8_INTEGER_DOMAIN", integer_domain)
    monkeypatch.setattr(tcommon, "INT8_INTEGER_DOMAIN", integer_domain)
    want = jcommon.attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
        None if mask is None else jnp.asarray(mask), jnp.asarray(valid),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), attn_kernel=False)
    got = tcommon.attention(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
        None if mask is None else torch.from_numpy(mask), torch.from_numpy(valid),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bf16_attention_still_matches_jax():
    B, M, H, Hkv, hd = 2, 20, 4, 2, 16
    q, kf, vf, valid, _, _ = _mk(B, M, H, Hkv, hd, False, seed=9)
    kb = np.array(jnp.asarray(kf, jnp.bfloat16).astype(jnp.float32))
    vb = np.array(jnp.asarray(vf, jnp.bfloat16).astype(jnp.float32))
    want = jcommon.attention(jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb), None,
                             jnp.asarray(valid), attn_kernel=False)
    got = tcommon.attention(torch.from_numpy(q), torch.from_numpy(kb), torch.from_numpy(vb),
                            None, torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_supported_truth_table_matches_jax():
    for M in (1, 64, 128, 160, 256, 384, 512, 640, 1024, 1536, 2048, 2176):
        for hd in (16, 64, 96, 128, 192, 256, 384, 512):
            for quant in (False, True):
                assert k7.supported(M, hd, quant) == jpa.supported(M, hd, quant), (M, hd, quant)


def test_flags_default_on_and_cpu_never_routes(monkeypatch):
    """Both kernel flags are on in the port, yet CPU tensors of a shape K7
    takes stay on the plain route: the wrapper is never called."""
    assert tcommon.DECODE_ATTN_KERNEL and tcommon.INT8_DECODE_ATTN_KERNEL
    assert not tcommon.INT8_INTEGER_DOMAIN

    def refuse(*a, **kw):
        raise AssertionError("K7 reached from CPU tensors")

    monkeypatch.setattr(tcommon, "decode_attention", refuse)
    for quant in (False, True):
        q, k, v, valid, ks, vs = _mk(2, 256, 8, 2, 128, quant, seed=4)
        tk = torch.from_numpy(k) if quant else _bf16(k)
        tv = torch.from_numpy(v) if quant else _bf16(v)
        for attn_kernel in (None, True):
            out = tcommon.attention(
                _bf16(q), tk, tv, None, torch.from_numpy(valid), scale=0.125,
                k_scale=None if ks is None else torch.from_numpy(ks),
                v_scale=None if vs is None else torch.from_numpy(vs), attn_kernel=attn_kernel)
            assert out.shape == (2, 1, 8, 128)


def test_chunking_fills_the_card():
    # llama-3-8b heads at the engine point, llama-2-7b heads, a single row
    for B, M, Hkv, rep in ((8, 2048, 8, 4), (8, 2048, 32, 1), (1, 2048, 8, 4), (4, 256, 8, 4)):
        c = k7.chunk_len(B, M, Hkv, rep, 128)
        n = -(-M // c)
        assert c % 64 == 0 and 64 <= c <= 512
        assert B * Hkv * n >= 256 or c == 64
    assert k7.chunk_len(1, 16, 1, 16, 128) == 64  # rep > 8: two head groups per kv head
