"""K4's rows path (``csrc/onehot_gather_rows.cu``: x's rows staged in shared
memory by bulk copies, perm held in registers, 16-byte stores) on the CPU:
its plain version, ``onehot_gather_plain``, held against the JAX package's
``onehot_iota_pallas`` and ``_stacked`` in interpret mode on the same numpy
inputs, and its route, ``k4_path``.

Tolerance: none. The gather copies values: off the TPU JAX's one-hot
product runs in f32, where a product with a one-hot column is exact, so
both give x's values bit for bit. The one difference is the sign of zero:
JAX's sum adds -0.0 * 1 to +0.0 products and gives +0.0, where the port
copies -0.0's bits, as both of K4's kernels do. Those lanes are held equal
as values and checked to keep the port's sign.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.ops.kernels import pallas_gather as jpg
from pt2tpu_torch.ops.kernels import gather as tkg

from test_torch_gather import bf16_values, ssr_perm


def inputs(rng, rows, m, dtype):
    """x as numpy f32 (bf16-exact for bf16), with -0.0 in half of row 0;
    JAX's operand and the port's."""
    x = bf16_values(rng, (rows, m)) if dtype == "bf16" else rng.normal(size=(rows, m)).astype(
        np.float32)
    x[0, : m // 2] = -0.0
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return x, jx, tx


def held(got, want, x, perm):
    """got (the port, x's dtype) against JAX's f32 want: equal values, the
    same bits wherever the copied value is not -0.0, and -0.0 kept."""
    m = x.shape[1]
    g32 = got.float().numpy()
    np.testing.assert_array_equal(g32, want)
    src = np.pad(x, ((0, 0), (0, 1)))[:, np.minimum(perm, m)]  # the value each lane copies
    neg0 = (src == 0) & np.signbit(src)
    assert neg0.any()
    np.testing.assert_array_equal(g32.view(np.int32)[~neg0], want.view(np.int32)[~neg0])
    assert np.signbit(g32[neg0]).all()
    assert not np.signbit(g32[:, perm >= m]).any()  # pad lanes: +0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,K", [(200, 256), (300, 512)])
@pytest.mark.parametrize("rows", [65, 128, 300])
def test_gather_plain_bit_exact_vs_iota_interpret(rows, m, K, dtype):
    rng = np.random.default_rng(rows + m)
    perm = ssr_perm(rng, m, K, interleave=True)
    x, jx, tx = inputs(rng, rows, m, dtype)
    D = -(-m // 128) * 128
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpg.onehot_iota_pallas(jx, jnp.asarray(perm), D=D))
    got = tkg.onehot_gather_plain(tx, torch.from_numpy(perm))
    assert got.dtype == tx.dtype and got.shape == (rows, K)
    held(got, want, x, perm)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows", [65, 128])
def test_gather_plain_bit_exact_vs_iota_stacked_interpret(rows, dtype):
    rng = np.random.default_rng(rows + 18)
    m, K, L = 300, 512, 3
    perms = np.stack([ssr_perm(rng, m, K, interleave=True) for _ in range(L)])
    x, jx, tx = inputs(rng, rows, m, dtype)
    tperm = torch.from_numpy(perms)
    for li in (0, 2):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jpg.onehot_iota_pallas_stacked(jx, jnp.asarray(perms), li, D=384))
        got = tkg.onehot_gather(tx, tperm[li])  # a view, as the port stacks; the CPU's plain version
        held(got, want, x, perms[li])


@pytest.mark.parametrize("rows,m,K,elem,path", [
    (0, 4096, 4096, 2, "cuda_core"), (1, 4096, 4096, 2, "rows"), (15, 4096, 4096, 2, "rows"),
    (16, 4096, 4096, 2, "rows"), (64, 4096, 4096, 2, "rows"), (65, 4096, 4096, 2, "rows"),
    (512, 4096, 4096, 2, "rows"), (1000, 300, 512, 2, "rows"),
    (512, 32768, 32768, 2, "rows"), (512, 32769, 32776, 2, "cuda_core"),
    (512, 16384, 16384, 4, "rows"), (512, 16385, 16392, 4, "cuda_core"),
    (512, 4096, 4100, 2, "cuda_core"), (512, 4096, 4104, 2, "rows"),
    (512, 200, 260, 4, "cuda_core"), (16, 200, 264, 4, "rows"),
])
def test_k4_path_names_the_kernel(rows, m, K, elem, path):
    """Rows from K4_ROWS_MIN_ROWS, a row of x up to 64 KB (m x elem = 65536
    in, 65538 / 65540 out) and K a multiple of 8 take the rows path."""
    assert tkg.k4_path(rows, m, K, elem) == path


def test_k4_path_reads_its_threshold_at_each_call(monkeypatch):
    monkeypatch.setattr(tkg, "K4_ROWS_MIN_ROWS", 1 << 30)
    assert tkg.k4_path(512, 4096, 4096, 2) == "cuda_core"
    monkeypatch.setattr(tkg, "K4_ROWS_MIN_ROWS", 16)
    assert tkg.k4_path(15, 4096, 4096, 2) == "cuda_core"
    assert tkg.k4_path(16, 4096, 4096, 2) == "rows"


def test_cpu_wrapper_stays_the_plain_version():
    """On a CPU tensor K4's wrapper is its plain version at any row count and
    counts no launch on either path."""
    rng = np.random.default_rng(9)
    m, K = 200, 256
    perm = torch.from_numpy(ssr_perm(rng, m, K, interleave=True))
    before = (tkg.onehot_gather.launches, tkg.onehot_gather.launches_rows)
    for rows in (1, 16, 130):
        x = torch.from_numpy(rng.normal(size=(rows, m)).astype(np.float32))
        assert torch.equal(tkg.onehot_gather(x, perm), tkg.onehot_gather_plain(x, perm))
    assert (tkg.onehot_gather.launches, tkg.onehot_gather.launches_rows) == before
