"""K5's rows path (``csrc/onehot_matmul_rows.cu``: the packed planes decoded
once into a lane map, then x's rows staged in shared memory and gathered),
held on the CPU through its plain versions against the JAX package's
``onehot_matmul_pallas`` and ``_stacked`` in interpret mode, on the same
numpy inputs.

Tolerances: on one-hot planes every sum is one product of 1 and x, so the
rows path's plain version, JAX's kernel and the index form agree bit for bit
(bf16 x: JAX's f32 result is the bf16 value exactly). On planes that are not
one-hot (a field of 2, two ones in a column, lanes with more than E fields)
the two sum in different orders: 1e-6 of max|ref|, also against x @ G in
float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.core import packing as jpack
from pt2tpu.ops import gather as jgather
from pt2tpu.ops.kernels import pallas_gather as jpg
from pt2tpu_torch.ops.kernels import gather as tkg

from test_torch_gather import bf16_values, rel_err, ssr_perm


def planes(perm, m):
    """The JAX package's packed one-hot planes of ``perm`` over m features."""
    return np.array(jgather.make_packed_gather(jnp.asarray(perm), m).packed)


def inputs(rng, rows, m, dtype):
    """x as numpy f32 (bf16-exact for bf16), JAX's operand and the port's."""
    x = bf16_values(rng, (rows, m)) if dtype == "bf16" else rng.normal(size=(rows, m)).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return x, jx, tx


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,K", [(200, 256), (300, 512)])
@pytest.mark.parametrize("rows", [65, 128, 300])
def test_rows_plain_bit_exact_vs_pallas_interpret(rows, m, K, dtype):
    rng = np.random.default_rng(rows + m)
    perm = ssr_perm(rng, m, K, interleave=True)
    g = planes(perm, m)
    x, jx, tx = inputs(rng, rows, m, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpg.onehot_matmul_pallas(jx, jnp.asarray(g), tile_n=128,
                                                   blocks_per_step=1))
    got = tkg.onehot_matmul_rows_plain(tx, torch.from_numpy(g))
    assert got.dtype == tx.dtype and got.shape == (rows, K)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the index form and K5's first plain version give the same bits
    np.testing.assert_array_equal(got.float().numpy(), tkg.onehot_gather_plain(
        tx, torch.from_numpy(perm)).float().numpy())
    assert torch.equal(got, tkg.onehot_matmul_plain(tx, torch.from_numpy(g)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows", [65, 128])
def test_rows_plain_bit_exact_vs_pallas_stacked_interpret(rows, dtype):
    rng = np.random.default_rng(rows + 12)
    m, K, L = 300, 512, 3
    gs = np.stack([planes(ssr_perm(rng, m, K, True), m) for _ in range(L)])
    _, jx, tx = inputs(rng, rows, m, dtype)
    tg = torch.from_numpy(gs)
    for li in (0, 2):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jpg.onehot_matmul_pallas_stacked(jx, jnp.asarray(gs), li,
                                                               tile_n=128))
        got = tkg.onehot_matmul_rows_plain(tx, tg[li])  # a view, as the port stacks
        np.testing.assert_array_equal(got.float().numpy(), want)


def any_planes(rng, kind, m, D, K):
    """Codes (K, D) whose planes are not a permutation: "field-of-2" (a third
    of the lanes hold a 2), "two-ones" (half the lanes a second 1), "dense"
    (every lane 5-40 fields, all past the lane map's E)."""
    codes = np.full((K, D), -1, np.int8)  # field 0 everywhere
    perm = ssr_perm(rng, m, K, interleave=True)
    valid = perm < m
    codes[np.nonzero(valid)[0], perm[valid]] = 0  # the one-hot
    if kind == "field-of-2":
        codes[np.nonzero(valid)[0][::3], perm[valid][::3]] = 1
    elif kind == "two-ones":
        cols = np.nonzero(valid)[0][::2]
        codes[cols, rng.integers(0, m, size=cols.size)] = 0
    else:
        for k in range(K):
            codes[k, rng.choice(m, size=rng.integers(5, 41), replace=False)] = 0
        codes[::5, 7] = 1
    return codes


@pytest.mark.parametrize("kind", ["field-of-2", "two-ones", "dense"])
def test_rows_plain_is_x_at_g_for_any_planes(kind):
    rng = np.random.default_rng(3)
    m, D, K = 200, 256, 256
    codes = any_planes(rng, kind, m, D, K)
    g = np.array(jpack.pack_ternary(jnp.asarray(codes), block_size=128))
    assert (tkg.onehot_planes(torch.from_numpy(g)).numpy() == (codes.T + 1)).all()
    x = rng.normal(size=(70, m)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpg.onehot_matmul_pallas(jnp.asarray(x), jnp.asarray(g)))
    got = tkg.onehot_matmul_rows_plain(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    assert rel_err(got, want) <= 1e-6
    exact = np.pad(x, ((0, 0), (0, D - m))).astype(np.float64) @ (codes.T + 1).astype(np.float64)
    assert rel_err(got, exact) <= 1e-6
    # the lane map: counts of the fields below m; lanes past E keep no entry
    lmap = tkg.onehot_lane_map_plain(torch.from_numpy(g), m).numpy()
    u = (codes.T + 1)[:m]
    counts = (u != 0).sum(0)
    np.testing.assert_array_equal(lmap[:K], counts)
    ent = lmap[K:].reshape(tkg.K5_MAP_FIELDS, K)
    over = counts > tkg.K5_MAP_FIELDS
    assert (ent[:, over] == -1).all()
    if kind == "dense":
        assert over.all()


def test_rows_plain_sums_in_increasing_feature_order():
    """The rows path's order, per lane: the first product starts the sum, the
    fields follow in increasing feature, each product rounded before it is
    added, so -0.0 survives a single field of 1 and 1 + 2^-24 + 2^-24
    differs from 2^-24 + 2^-24 + 1."""
    m, D, K = 3, 128, 128
    codes = np.full((K, D), -1, np.int8)
    codes[0, 0] = 0  # lane 0: feature 0 alone
    codes[1, :3] = 0  # lane 1: features 0, 1, 2
    g = torch.from_numpy(np.array(jpack.pack_ternary(jnp.asarray(codes), block_size=128)))
    x = torch.tensor([[-0.0, 2.0 ** -24, 2.0 ** -24], [1.0, 2.0 ** -24, 2.0 ** -24]])
    got = tkg.onehot_matmul_rows_plain(x, g)
    assert torch.equal(got[0, 0], torch.tensor(-0.0)) and torch.signbit(got[0, 0])
    assert got[0, 1].item() == 2.0 ** -23
    assert got[1, 1].item() == 1.0  # (1 + 2^-24) + 2^-24: each step rounds to 1
    assert not torch.signbit(got[:, 2:]).any() and not got[:, 2:].any()  # no field: +0.0


@pytest.mark.parametrize("m,K", [(200, 256), (300, 512), (4096, 4096)])
def test_lane_map_plain_gives_each_lanes_perm(m, K):
    rng = np.random.default_rng(m + K)
    perm = ssr_perm(rng, m, K, interleave=m < K)
    lmap = tkg.onehot_lane_map_plain(torch.from_numpy(planes(perm, m)), m)
    E = tkg.K5_MAP_FIELDS
    assert lmap.dtype == torch.int32 and lmap.shape == ((1 + E) * K,)
    lmap = lmap.numpy()
    real = perm < m
    np.testing.assert_array_equal(lmap[:K], real.astype(np.int32))  # pad lanes: count 0
    ent = lmap[K:].reshape(E, K)
    np.testing.assert_array_equal(ent[0, real], (perm[real] << 2) | 1)  # u = 1
    assert (ent[0, ~real] == -1).all() and (ent[1:] == -1).all()


def test_lane_map_plain_sorts_and_drops_fields_past_m():
    m, D, K = 100, 128, 128
    codes = np.full((K, D), -1, np.int8)
    codes[5, [90, 3, 40]] = [1, 0, 0]  # lane 5: features 3 (u 1), 40 (u 1), 90 (u 2)
    codes[6, 120] = 0  # lane 6: a field past m only
    g = torch.from_numpy(np.array(jpack.pack_ternary(jnp.asarray(codes), block_size=128)))
    lmap = tkg.onehot_lane_map_plain(g, m).numpy()
    ent = lmap[K:].reshape(tkg.K5_MAP_FIELDS, K)
    assert lmap[5] == 3 and list(ent[:, 5]) == [3 << 2 | 1, 40 << 2 | 1, 90 << 2 | 2, -1]
    assert lmap[6] == 0 and (ent[:, 6] == -1).all()


@pytest.mark.parametrize("rows,m,elem,path", [
    (1, 4096, 2, "cuda_core"), (8, 4096, 2, "cuda_core"), (15, 4096, 2, "cuda_core"),
    (16, 4096, 2, "rows"), (64, 4096, 2, "rows"), (65, 4096, 2, "rows"),
    (128, 4096, 2, "rows"), (512, 4096, 2, "rows"),
    (1000, 300, 2, "rows"), (512, 8192, 4, "rows"), (512, 16384, 4, "rows"),
    (512, 16385, 4, "cuda_core"), (512, 28672, 2, "rows"), (512, 28672, 4, "cuda_core"),
])
def test_k5_path_names_the_kernel(rows, m, elem, path):
    assert tkg.k5_path(rows, m, elem) == path


def test_k5_path_reads_its_threshold_at_each_call(monkeypatch):
    monkeypatch.setattr(tkg, "K5_ROWS_MIN_ROWS", 1 << 30)
    assert tkg.k5_path(512, 4096, 2) == "cuda_core"
    monkeypatch.setattr(tkg, "K5_ROWS_MIN_ROWS", 1)
    assert tkg.k5_path(1, 4096, 2) == "rows"


def test_cpu_wrapper_stays_the_plain_version():
    """On a CPU tensor K5's wrapper is its plain version at any row count and
    counts no launch; the SSR gather on the CPU stays the index form."""
    from pt2tpu_torch.ops import gather as tgather

    rng = np.random.default_rng(9)
    m, K = 200, 256
    perm = ssr_perm(rng, m, K, interleave=True)
    g = torch.from_numpy(planes(perm, m))
    x = torch.from_numpy(rng.normal(size=(130, m)).astype(np.float32))
    before = (tkg.onehot_matmul.launches, tkg.onehot_matmul.launches_rows)
    assert torch.equal(tkg.onehot_matmul(x, g), tkg.onehot_matmul_rows_plain(x, g))
    assert (tkg.onehot_matmul.launches, tkg.onehot_matmul.launches_rows) == before
    pg = tgather.PackedGather(packed=g, perm=torch.from_numpy(perm), in_features=m)
    assert torch.equal(tgather.gather_apply(pg, x), tkg.onehot_gather_plain(x, pg.perm))
