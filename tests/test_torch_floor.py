"""The floor probe (``impl="floor8"``: W2A8 with the 2-bit unpack skipped,
the raw packed bytes dotted) held against the JAX package on the same numpy
inputs (CPU).

Each floor plain version is held against JAX's Pallas kernel with
``a8="floor"`` in interpret mode (``_accumulate_step``'s "floor" mode). The
integer dots are exact on both sides; what differs is the f32 epilogue
(the order of the alpha products and of the offset term), held at 1e-5 of
max|want|. The inputs are chosen so that the row normalisation is exact
(every row's absmax is 127 * 2^-k), since JAX normalises under jit, where
an f32 ulp can move a rounded row (``held_to_pallas`` in
``test_torch_gather.py``), and the scales so that mu - alpha is exact in
bf16 (the Pallas kernel rounds it there).

On the CPU ``impl="floor8"`` is the exact route, as JAX's is off the TPU;
on CUDA it routes as ``"a8"`` does, every flag set alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.models import registry as jreg
from pt2tpu.ops import ternary_matmul as jtm
from pt2tpu.ops.kernels import pallas_ternary as jpt
from pt2tpu.serve.generate import greedy_generate as jgreedy
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch.ops import ternary_matmul as ttm
from pt2tpu_torch.ops.kernels import ternary as tk
from pt2tpu_torch.serve.generate import greedy_generate as tgreedy

from test_torch_gather import _t, rand_layer, ssr_perm
from test_torch_packed_gather import FLAG_SETS, planes, set_flags, to_port

REL = 1e-5


def floor_rows(rng, B, m):
    """bf16 rows whose absmax is 127 * 2^-(b % 3): the normalisation x / sx
    is exact, jitted or not."""
    x = np.array(jnp.asarray(rng.normal(scale=20.0, size=(B, m)), jnp.bfloat16)
                 .astype(jnp.float32))
    x = np.clip(x, -126.0, 126.0)
    for b in range(B):
        x[b, rng.integers(m)] = 127.0 * (-1.0) ** b
        x[b] *= 2.0 ** -(b % 3)
    return x


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("B", [1, 8, 17, 70])
def test_floor_plain_matches_pallas_interpret(B):
    rng = np.random.default_rng(B)
    K, n = 384, 256
    packed, alpha, mu = rand_layer(rng, K, n)
    x = floor_rows(rng, B, K)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas(
            jnp.asarray(x), jnp.asarray(packed), alpha, mu, tile_n=128, a8="floor"))
    got = tk.ternary_matmul_floor_plain(_t(x), _t(packed), _t(alpha), _t(mu)).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) <= REL
    # the wrapper on a CPU tensor is its plain version
    wrapped = tk.ternary_matmul(_t(x), _t(packed), _t(alpha), _t(mu), a8="floor")
    np.testing.assert_array_equal(wrapped.numpy(), got)
    # and the floor is not the W2A8 product: the unpack really is skipped
    a8 = tk.ternary_matmul_plain_a8(_t(x), _t(packed), _t(alpha), _t(mu)).numpy()
    assert rel_err(got, a8) > 0.1


def test_floor_plain_matches_pallas_stacked_interpret():
    rng = np.random.default_rng(11)
    K, n, B = 256, 128, 4
    layers = [rand_layer(rng, K, n) for _ in range(2)]
    packed = np.stack([l[0] for l in layers])
    alpha = jnp.stack([l[1] for l in layers])
    mu = jnp.stack([l[2] for l in layers])
    x = floor_rows(rng, B, K)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_stacked(
            jnp.asarray(x), jnp.asarray(packed), alpha, mu, 1, tile_n=128, a8="floor"))
    tp, ta, tm_ = _t(packed), _t(alpha), _t(mu)
    got = tk.ternary_matmul_floor_plain(_t(x), tp[1], ta[1], tm_[1]).numpy()
    assert rel_err(got, want) <= REL
    # K1s on the CPU: the floor of the slot the index names
    sel = torch.tensor(1, dtype=torch.int32)
    np.testing.assert_array_equal(
        tk.ternary_matmul_idx(_t(x), tp, ta, tm_, sel, a8="floor").numpy(), got)


@pytest.mark.parametrize("B,m,K,n", [(1, 256, 256, 128), (5, 200, 384, 256),
                                     (33, 300, 512, 128)])
def test_igathered_floor_plain_matches_pallas_interpret(B, m, K, n):
    rng = np.random.default_rng(B + m)
    packed, alpha, mu = rand_layer(rng, K, n)
    perm = ssr_perm(rng, m, K, interleave=m == 300)
    x = floor_rows(rng, B, m)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_igathered(
            jnp.asarray(x), jnp.asarray(perm), jnp.asarray(packed), alpha, mu, tile_n=128,
            a8="floor"))
    args = (_t(x), _t(perm), _t(packed), _t(alpha), _t(mu))
    got = tk.ternary_matmul_igathered_floor_plain(*args).numpy()
    assert rel_err(got, want) <= REL
    np.testing.assert_array_equal(tk.ternary_matmul_igathered(*args, a8="floor").numpy(), got)
    np.testing.assert_array_equal(tk.ternary_matmul_igathered_plain(*args, a8="floor").numpy(),
                                  got)


def test_igathered_floor_plain_matches_pallas_stacked_interpret():
    rng = np.random.default_rng(12)
    B, m, K, n, L = 3, 200, 256, 256, 2
    layers = [rand_layer(rng, K, n) for _ in range(L)]
    packed = np.stack([l[0] for l in layers])
    alpha = jnp.stack([l[1] for l in layers])
    mu = jnp.stack([l[2] for l in layers])
    perms = np.stack([ssr_perm(rng, m, K, True) for _ in range(L)])
    x = floor_rows(rng, B, m)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_igathered_stacked(
            jnp.asarray(x), jnp.asarray(perms), jnp.asarray(packed), alpha, mu, 1,
            tile_n=128, a8="floor"))
    tp, ta, tm_, tpm = _t(packed), _t(alpha), _t(mu), _t(perms)
    got = tk.ternary_matmul_igathered_floor_plain(_t(x), tpm[1], tp[1], ta[1], tm_[1]).numpy()
    assert rel_err(got, want) <= REL
    sel = torch.tensor(0, dtype=torch.int32)
    np.testing.assert_array_equal(
        tk.ternary_matmul_igathered_idx(_t(x), tpm, tp, ta, tm_, sel, base=1,
                                        a8="floor").numpy(), got)


@pytest.mark.parametrize("B,m,K,n", [(1, 256, 256, 128), (4, 200, 384, 256),
                                     (16, 384, 512, 384)])
def test_gathered_floor_plain_matches_pallas_interpret(B, m, K, n):
    rng = np.random.default_rng(B + m + n)
    packed, alpha, mu = rand_layer(rng, K, n)
    g = planes(ssr_perm(rng, m, K, interleave=m == 200), m)
    x = floor_rows(rng, B, m)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_gathered(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(packed), alpha, mu,
            tile_n=128, blocks_per_step=1, a8="floor"))
    args = (_t(x), _t(g), _t(packed), _t(alpha), _t(mu))
    got = tk.ternary_matmul_gathered_floor_plain(*args).numpy()
    assert rel_err(got, want) <= REL
    np.testing.assert_array_equal(tk.ternary_matmul_gathered(*args, a8="floor").numpy(), got)


def test_gathered_floor_plain_matches_pallas_stacked_interpret():
    rng = np.random.default_rng(23)
    B, m, K, n, L = 3, 200, 256, 256, 2
    layers = [rand_layer(rng, K, n) for _ in range(L)]
    packed = np.stack([l[0] for l in layers])
    alpha = jnp.stack([l[1] for l in layers])
    mu = jnp.stack([l[2] for l in layers])
    gs = np.stack([planes(ssr_perm(rng, m, K, True), m) for _ in range(L)])
    x = floor_rows(rng, B, m)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_gathered_stacked(
            jnp.asarray(x), jnp.asarray(gs), jnp.asarray(packed), alpha, mu, 1,
            tile_n=128, a8="floor"))
    tp, ta, tm_, tg = _t(packed), _t(alpha), _t(mu), _t(gs)
    got = tk.ternary_matmul_gathered_floor_plain(_t(x), tg[1], tp[1], ta[1], tm_[1]).numpy()
    assert rel_err(got, want) <= REL
    sel = torch.tensor(1, dtype=torch.int32)
    np.testing.assert_array_equal(
        tk.ternary_matmul_gathered_idx(_t(x), tg, tp, ta, tm_, sel, a8="floor").numpy(), got)


def test_floor_mode_values():
    assert "floor8" in ttm.IMPLS and tk.FLOOR == "floor"
    assert jtm._a8_flag("floor8") == tk.FLOOR
    assert ttm._a8_flag("floor8", "cuda") == tk.FLOOR
    assert ttm._a8_flag("floor8", "cpu") is False  # the exact route, as JAX's off the TPU
    assert ttm._a8_flag("a8", "cpu") is True and ttm._a8_flag("auto", "cuda") is False
    with pytest.raises(ValueError, match="a8 is a bool"):
        tk.ternary_matmul(torch.zeros(1, 128), torch.zeros(32, 128, dtype=torch.int8),
                          torch.zeros(1, 128), torch.zeros(1, 128), a8="floor9")


@pytest.mark.parametrize("mode", ["ssr", "folded"])
@pytest.mark.parametrize("rows", [1, 9, 70])
def test_ternary_linear_apply_floor8_equals_jax_on_the_cpu(mode, rows):
    jl = jrand.random_ternary_linear(jax.random.PRNGKey(rows), 384, 256, perm_mode=mode)
    x = np.random.default_rng(rows).normal(size=(rows, jl.in_features)).astype(np.float32)
    want = np.asarray(jtm.ternary_linear_apply(jl, jnp.asarray(x), impl="floor8"))
    got = ttm.ternary_linear_apply(to_port(jl), torch.from_numpy(x), impl="floor8").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the exact route: the same answer as impl="auto"
    auto = ttm.ternary_linear_apply(to_port(jl), torch.from_numpy(x), impl="auto").numpy()
    np.testing.assert_array_equal(got, auto)


def test_stacked_apply_floor8_equals_jax_on_the_cpu():
    layers = [jrand.random_ternary_linear(jax.random.PRNGKey(s), 256, 256, perm_mode="ssr")
              for s in (1, 2)]
    jl = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *layers)
    x = np.random.default_rng(3).normal(size=(2, layers[0].in_features)).astype(np.float32)
    want = np.asarray(jtm.ternary_linear_apply_stacked(jl, jnp.asarray(x), jnp.int32(1),
                                                       impl="floor8"))
    tl = to_port(jl)
    for idx in (1, torch.tensor(1, dtype=torch.int32)):
        got = ttm.ternary_linear_apply_stacked(tl, torch.from_numpy(x), idx, impl="floor8")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows", [1, 8, 16, 64, 65])
@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_linear_route_floor8_is_the_a8_route(flags, rows, monkeypatch):
    set_flags(monkeypatch, FLAG_SETS[flags])
    jl = jrand.random_ternary_linear(jax.random.PRNGKey(rows), 384, 256, perm_mode="ssr")
    tl = to_port(jl)
    jd = to_port(jrand.random_ternary_linear(jax.random.PRNGKey(7), 256, 384, perm_mode="folded"))
    for p in (tl, jd):
        for dix in (False, True):
            assert ttm.linear_route(p, rows, "floor8", "cuda", dix) == \
                ttm.linear_route(p, rows, "a8", "cuda", dix)
        assert ttm.linear_route(p, rows, "floor8", "cpu") == ()
    # and every kernel's own path choice is the a8 one, K1_DEC_A8 on or off
    for dec_a8 in (False, True):
        monkeypatch.setattr(tk, "K1_DEC_A8", dec_a8)
        for n in (128, 416):
            for path in (tk.k1_path, tk.k3_path, tk.k6_path):
                assert path(rows, n, 128, tk.FLOOR) == path(rows, n, 128, True)


def test_greedy_generate_floor8_equals_jax_on_the_cpu():
    """A 2-layer tiny llama through both packages' greedy decode under
    impl="floor8": on the CPU both take the exact route."""
    cfg_j = jreg.get_config("tiny-llama").with_(n_layers=2)
    jparams = jrand.random_ternary_params(cfg_j, jax.random.PRNGKey(0), perm_mode="ssr",
                                          dtype=jnp.float32)
    from pt2tpu_torch.models.registry import get_config

    cfg_t = get_config("tiny-llama").with_(n_layers=2)
    prompt = np.random.default_rng(0).integers(0, cfg_j.vocab_size, size=(2, 7))
    want = np.asarray(jgreedy(cfg_j, jparams, jnp.asarray(prompt, jnp.int32), max_new=5,
                              impl="floor8"))
    got = tgreedy(cfg_t, to_port(jparams), torch.from_numpy(prompt), max_new=5, impl="floor8")
    np.testing.assert_array_equal(got.numpy(), want)
