"""The port's KV cache against ``pt2tpu.serve.kvcache``: int8 bytes and
scales equal to JAX's (round half to even in both), per-row and per-position
writes equal, reads equal (bf16 as values, int8 raw as stored), and greedy
decoding with an int8 cache giving JAX's tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.models import registry as jreg
from pt2tpu.serve import kvcache as jkv
from pt2tpu.serve.generate import generate as jgenerate
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.serve import kvcache as tkv
from pt2tpu_torch.serve.generate import greedy_generate
from pt2tpu_torch.utils.checkpoint import params_from_numpy
from pt2tpu_torch.utils.device import quotient_f32

from test_torch_kernels_cuda import reciprocal_witnesses


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Eager torch on tiny shapes runs on one intra-op thread: under
    pytest-xdist the workers share the cores, and idle OpenMP threads that
    spin for work slow every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(tree):
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    return params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def test_quantize_i8_bytes_equal_jax():
    x = np.random.default_rng(0).normal(size=(3, 7, 2, 16)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0  # an all-zero vector: scale floored at 1e-8, codes 0
    x[0, 1, 1, :4] = [127.0, 2.5, -3.5, 0.5]  # scale 1: halves round to even
    q, s = tkv.quantize_i8(torch.from_numpy(x))
    jq, js = jkv._quantize_i8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.shape == (3, 7, 2, 1)
    assert q[0, 1, 1, :4].tolist() == [127, 2, -4, 0]


def test_quantize_i8_bytes_equal_jax_where_the_reciprocal_is_an_ulp_off():
    """At absmax values where fl(a * fl(1 / 127)) != fl(a / 127) (found with
    numpy from a seed; each vector also holds an element at a half of the
    correct scale, whose code the other scale moves), the port's scales and
    codes are JAX's bytes on the CPU. On the card PyTorch's division by the
    scalar 127 takes the product there; ``quantize_i8`` divides through the
    exact quotient, ``utils.device.quotient_f32``, and gives these bytes on
    the card too (test_torch_kernels_cuda.py::
    test_quantize_i8_bytes_equal_jax_on_the_card)."""
    x = reciprocal_witnesses()
    a = np.abs(x).max(axis=-1, keepdims=True)
    rcp = a * (np.float32(1) / np.float32(127))
    assert (rcp != a / np.float32(127)).all()  # every vector is a witness
    codes_rcp = np.clip(np.round(x / rcp), -127, 127)
    q, s = tkv.quantize_i8(torch.from_numpy(x))
    jq, js = jkv._quantize_i8(jnp.asarray(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert (codes_rcp != q.numpy()).any(axis=-1).all()  # the other scale moves a code


def test_quotient_f32_is_the_correctly_rounded_quotient():
    """quotient_f32 (the int8 query prep's and the integer-domain attention's
    max|x| / 127) gives numpy's f32 quotient at the witnesses' absmax values,
    and JAX's kv scales there."""
    a = np.abs(reciprocal_witnesses()).max(axis=-1, keepdims=True)
    got = quotient_f32(torch.from_numpy(a), 127.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), a / np.float32(127))
    _, js = jkv._quantize_i8(jnp.asarray(reciprocal_witnesses()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(js))


def _pair(quant, B=3, M=12, Hkv=2, hd=16):
    """An empty one-layer cache in each package."""
    tc = tkv.KVCache(
        k=torch.zeros((1, B, M, Hkv, hd), dtype=torch.int8 if quant else torch.bfloat16),
        v=torch.zeros((1, B, M, Hkv, hd), dtype=torch.int8 if quant else torch.bfloat16),
        k_scale=torch.zeros((1, B, M, Hkv, 1)) if quant else None,
        v_scale=torch.zeros((1, B, M, Hkv, 1)) if quant else None,
    )
    dt = jnp.int8 if quant else jnp.bfloat16
    jc = jkv.KVLayerView(
        k=jnp.zeros((B, M, Hkv, hd), dt), v=jnp.zeros((B, M, Hkv, hd), dt),
        k_scale=jnp.zeros((B, M, Hkv, 1), jnp.float32) if quant else None,
        v_scale=jnp.zeros((B, M, Hkv, 1), jnp.float32) if quant else None,
    )
    return tc, jc


def _same(tc, jc):
    for t, j in ((tc.k[0], jc.k), (tc.v[0], jc.v)):
        np.testing.assert_array_equal(t.float().numpy(), _f32(j))
    if tc.quantized:
        np.testing.assert_array_equal(tc.k_scale[0].numpy(), np.asarray(jc.k_scale))
        np.testing.assert_array_equal(tc.v_scale[0].numpy(), np.asarray(jc.v_scale))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_write_rows_and_write_equal_jax(quant):
    rng = np.random.default_rng(1 + quant)
    tc, jc = _pair(quant)
    for positions in ([0, 5, 11], [3, 3, 0], [11, 1, 7]):
        kn = rng.normal(size=(3, 1, 2, 16)).astype(np.float32)
        vn = rng.normal(size=(3, 1, 2, 16)).astype(np.float32)
        tc.write_rows(0, torch.from_numpy(kn), torch.from_numpy(vn), torch.tensor(positions))
        jc = jc.write_rows(jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(positions))
        _same(tc, jc)
    kn = rng.normal(size=(3, 4, 2, 16)).astype(np.float32)
    vn = rng.normal(size=(3, 4, 2, 16)).astype(np.float32)
    tc.write(0, torch.from_numpy(kn), torch.from_numpy(vn), 6)
    jc = jc.write(jnp.asarray(kn), jnp.asarray(vn), 6)
    _same(tc, jc)
    raw = tc.read_raw(0)
    assert raw[0].data_ptr() == tc.k.data_ptr() and (raw[2] is None) == (not quant)
    if quant:  # int8 is read raw: the stored codes and scales, as JAX's read_raw
        jraw = jc.read_raw()
        for t, j in zip(raw, jraw):
            np.testing.assert_array_equal(t.float().numpy(), _f32(j))
        with pytest.raises(ValueError):
            tc.read(0, torch.float32)
    else:
        tk, tv = tc.read(0, torch.float32)
        jk, jv = jc.read(jnp.float32)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(ValueError):
        tc.write(0, torch.from_numpy(kn), torch.from_numpy(vn), 9)  # [9, 13) > 12


def test_rows_view_writes_into_the_pool():
    c = tkv.init_cache(get_config("tiny-llama-gqa"), 3, 8, quantized=True, device="cpu")
    row = c.rows(1, 2)
    row.write(0, torch.ones((1, 2, 2, 16)), torch.ones((1, 2, 2, 16)), 0)
    assert c.k[0, 1, :2].eq(127).all() and c.k[0, [0, 2]].eq(0).all()
    assert c.k_scale[0, 1, :2].eq(1 / 127).all()


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-llama-gqa"])
def test_greedy_int8_kv_tokens_equal_jax(name):
    jcfg = jreg.get_config(name)
    params = jrand.random_ternary_params(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32,
                                         perm_mode="down")
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(3, 9)).astype(np.int32)
    want = np.asarray(jgenerate(jcfg, params, jnp.asarray(prompt), 10, impl="xla",
                                kv_quant=True))
    got = greedy_generate(get_config(name), to_port(params), torch.from_numpy(prompt), 10,
                          kv_quant=True)
    np.testing.assert_array_equal(got.numpy(), want)
