"""The packed one-hot gather (K5), the gather fused into the matmul as its
prologue (K6) and the routing that reaches them, held against the JAX
package on the same numpy inputs (CPU).

Tolerances: K5's plain version is a real f32 product with G's raw 2-bit
fields, so on a one-hot G it is bit-exact against ``onehot_matmul_pallas``
in interpret mode (and against the index form); on planes that are not
one-hot (a field of 2, two ones in a column) the two sum in different
orders: 1e-6 of max|ref|. K6's plain version against
``ternary_matmul_pallas_gathered`` in interpret mode: 1e-5 of max|ref|, f32
summation order and the TPU kernel's telescoped unpack at decode row counts
(2.5e-6, ``pallas_ternary.py:164-179``); bf16 scales are drawn so that
mu - alpha is exact in bf16, as in ``test_torch_gather.py``. The whole slice
(a 2-layer model through both packages' routes under the P2 flags): the
same greedy tokens and logits within P2_TOL (relative L2), for the reasons
its test states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.core import packing as jpack
from pt2tpu.models import registry as jreg
from pt2tpu.ops import gather as jgather
from pt2tpu.ops import ternary_matmul as jtm
from pt2tpu.ops.kernels import pallas_gather as jpg
from pt2tpu.ops.kernels import pallas_ternary as jpt
from pt2tpu.serve.generate import forward_cached as jforward_cached
from pt2tpu.serve.kvcache import init_cache as jinit_cache
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch.ops import gather as tgather
from pt2tpu_torch.ops import ternary_matmul as ttm
from pt2tpu_torch.ops.kernels import gather as tkg
from pt2tpu_torch.ops.kernels import ternary as tk
from pt2tpu_torch.serve.generate import forward_cached as tforward_cached
from pt2tpu_torch.serve.kvcache import init_cache as tinit_cache
from pt2tpu_torch.utils.checkpoint import params_from_numpy

from test_torch_gather import _t, bf16_values, exact_scales, rand_layer, rel_err, ssr_perm

REL = 1e-5


def planes(perm, m):
    """The JAX package's packed one-hot planes of ``perm`` over m features."""
    return np.array(jgather.make_packed_gather(jnp.asarray(perm), m).packed)


@pytest.mark.parametrize("rows,m,K,interleave", [(1, 256, 256, False), (5, 200, 384, True),
                                                 (20, 300, 512, True)])
def test_onehot_matmul_plain_bit_exact_vs_pallas_interpret(rows, m, K, interleave):
    rng = np.random.default_rng(rows + m)
    perm = ssr_perm(rng, m, K, interleave)
    g = planes(perm, m)
    x = rng.normal(size=(rows, m)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpg.onehot_matmul_pallas(jnp.asarray(x), jnp.asarray(g), tile_n=128,
                                                   blocks_per_step=1))
    got = tkg.onehot_matmul_plain(torch.from_numpy(x), torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (rows, K)
    np.testing.assert_array_equal(got.numpy(), want)
    # the index form gives the same values; the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(tkg.onehot_gather_plain(torch.from_numpy(x),
                                                          torch.from_numpy(perm)).numpy(), want)
    np.testing.assert_array_equal(tkg.onehot_matmul(torch.from_numpy(x),
                                                    torch.from_numpy(g)).numpy(), want)


def test_onehot_matmul_plain_bit_exact_vs_pallas_stacked_interpret():
    rng = np.random.default_rng(12)
    m, K, L = 200, 384, 3
    gs = np.stack([planes(ssr_perm(rng, m, K, True), m) for _ in range(L)])
    x = rng.normal(size=(4, m)).astype(np.float32)
    tg = torch.from_numpy(gs)
    for li in (0, 2):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jpg.onehot_matmul_pallas_stacked(jnp.asarray(x), jnp.asarray(gs), li,
                                                               tile_n=128))
        got = tkg.onehot_matmul_plain(torch.from_numpy(x), tg[li])  # a view, as the port stacks
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["field-of-2", "two-ones"])
def test_onehot_matmul_plain_is_x_at_g_for_any_planes(kind):
    """Planes that are not one-hot: both compute x @ u with u the raw field."""
    rng = np.random.default_rng(3)
    m, D, K = 200, 256, 256
    codes = np.full((K, D), -1, np.int8)  # field 0 everywhere
    perm = ssr_perm(rng, m, K, interleave=True)
    valid = perm < m
    codes[np.nonzero(valid)[0], perm[valid]] = 0  # the one-hot
    if kind == "field-of-2":
        codes[np.nonzero(valid)[0][::3], perm[valid][::3]] = 1
    else:
        cols = np.nonzero(valid)[0][::2]
        codes[cols, rng.integers(0, m, size=cols.size)] = 0
    g = np.array(jpack.pack_ternary(jnp.asarray(codes), block_size=128))
    assert (tkg.onehot_planes(torch.from_numpy(g)).numpy() == (codes.T + 1)).all()
    x = rng.normal(size=(6, m)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpg.onehot_matmul_pallas(jnp.asarray(x), jnp.asarray(g)))
    got = tkg.onehot_matmul_plain(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    assert rel_err(got, want) <= 1e-6
    exact = np.pad(x, ((0, 0), (0, D - m))).astype(np.float64) @ (codes.T + 1).astype(np.float64)
    assert rel_err(got, exact) <= 1e-6


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("B,m,K,n", [(1, 256, 256, 128), (4, 200, 384, 256),
                                     (16, 384, 512, 384)])
def test_gathered_plain_matches_pallas_interpret(B, m, K, n, a8):
    rng = np.random.default_rng(B + m + n)
    packed, alpha, mu = rand_layer(rng, K, n)
    g = planes(ssr_perm(rng, m, K, interleave=m == 200), m)
    x = bf16_values(rng, (B, m))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_gathered(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(packed), alpha, mu,
            tile_n=128, blocks_per_step=1, a8=a8,
        ))
    got = tk.ternary_matmul_gathered_plain(_t(x), _t(g), _t(packed), _t(alpha), _t(mu),
                                           a8=a8).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) <= REL
    wrapped = tk.ternary_matmul_gathered(_t(x), _t(g), _t(packed), _t(alpha), _t(mu), a8=a8)
    np.testing.assert_array_equal(wrapped.numpy(), got)


@pytest.mark.parametrize("a8", [False, True])
def test_gathered_plain_matches_pallas_stacked_interpret(a8):
    rng = np.random.default_rng(22)
    B, m, K, n, L = 3, 200, 256, 256, 2
    layers = [rand_layer(rng, K, n) for _ in range(L)]
    packed = np.stack([l[0] for l in layers])
    alpha = jnp.stack([l[1] for l in layers])
    mu = jnp.stack([l[2] for l in layers])
    gs = np.stack([planes(ssr_perm(rng, m, K, True), m) for _ in range(L)])
    x = bf16_values(rng, (B, m))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpt.ternary_matmul_pallas_gathered_stacked(
            jnp.asarray(x), jnp.asarray(gs), jnp.asarray(packed), alpha, mu, 1,
            tile_n=128, a8=a8,
        ))
    tp, ta, tm_, tg = _t(packed), _t(alpha), _t(mu), _t(gs)
    got = tk.ternary_matmul_gathered_plain(_t(x), tg[1], tp[1], ta[1], tm_[1], a8=a8).numpy()
    assert rel_err(got, want) <= REL


# ---- routing: the kernel the JAX package picks on the TPU, by the port's names
JAX_TO_PORT = {
    "ternary_matmul_pallas": "ternary_matmul",
    "ternary_matmul_pallas_igathered": "ternary_matmul_igathered",
    "ternary_matmul_pallas_gathered": "ternary_matmul_gathered",
    "onehot_iota_pallas": "onehot_gather",
    "onehot_matmul_pallas": "onehot_matmul",
}
# (GATHER_KERNEL, IGATHER_FUSED, FUSED_GATHER)
FLAG_SETS = {"defaults": ("iota", True, False), "P1": ("packed", True, False),
             "P2": ("packed", False, True), "unfused": ("packed", False, False)}


def to_port(tree):
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    return params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")


def set_flags(monkeypatch, flags):
    gk, igf, fg = flags
    for mod_j, mod_t, name, value in ((jgather, tgather, "GATHER_KERNEL", gk),
                                      (jtm, ttm, "IGATHER_FUSED", igf),
                                      (jtm, ttm, "FUSED_GATHER", fg)):
        monkeypatch.setattr(mod_j, name, value)
        monkeypatch.setattr(mod_t, name, value)


def jax_pick(monkeypatch, p, rows, impl):
    """The Pallas kernels ``pt2tpu.ops.ternary_matmul.ternary_linear_apply``
    calls on the TPU, in order: every kernel is replaced by a recorder that
    returns zeros of its output shape."""
    calls = []

    def recorder(name, width):
        def fn(x, *args, **kw):
            calls.append(JAX_TO_PORT[name])
            return jnp.zeros((x.shape[0], width(args, kw)), jnp.float32)
        return fn

    lanes = lambda args, kw: args[0].shape[-1]  # noqa: E731  perm (K,) or planes (D/4, K)
    with monkeypatch.context() as mp:
        mp.setattr(jtm.jax, "default_backend", lambda: "tpu")
        for mod, name in ((jpt, "ternary_matmul_pallas"), (jpt, "ternary_matmul_pallas_igathered"),
                          (jpt, "ternary_matmul_pallas_gathered")):
            mp.setattr(mod, name, recorder(name, lambda args, kw: p.packed.shape[-1]))
        for name in ("onehot_iota_pallas", "onehot_matmul_pallas"):
            mp.setattr(jpg, name, recorder(name, lanes))
        jtm.ternary_linear_apply(p, jnp.zeros((rows, p.in_features), jnp.float32), impl=impl)
    return tuple(calls)


@pytest.mark.parametrize("impl", ["auto", "a8"])
@pytest.mark.parametrize("rows", [1, 64, 65])
@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_linear_route_names_the_kernel_jax_picks_on_the_tpu(flags, rows, impl, monkeypatch):
    set_flags(monkeypatch, FLAG_SETS[flags])
    jl = jrand.random_ternary_linear(jax.random.PRNGKey(rows), 384, 256, perm_mode="ssr")
    tl = to_port(jl)
    assert tl.gather is not None
    want = jax_pick(monkeypatch, jl, rows, impl)
    assert len(want) in (1, 2)
    assert ttm.linear_route(tl, rows, impl, "cuda") == want
    # the CPU and the plain route launch nothing, whatever the flags
    assert ttm.linear_route(tl, rows, impl, "cpu") == ()
    assert ttm.linear_route(tl, rows, "plain", "cuda") == ()
    # a layer without a gather (down, folded) runs K1 alone, as in JAX
    jd = jrand.random_ternary_linear(jax.random.PRNGKey(7), 256, 384, perm_mode="folded")
    assert ttm.linear_route(to_port(jd), rows, impl, "cuda") == jax_pick(monkeypatch, jd, rows, impl) \
        == ("ternary_matmul",)


def test_gather_kernel_flag():
    assert tgather.GATHER_KERNEL == "iota"  # the JAX default
    assert (ttm.IGATHER_FUSED, ttm.FUSED_GATHER, ttm.FUSED_MLP) == (True, False, True)
    for value, name in (("iota", "onehot_gather"), ("packed", "onehot_matmul")):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tgather, "GATHER_KERNEL", value)
            assert tgather.gather_kernel() == name
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgather, "GATHER_KERNEL", "onehot")
        with pytest.raises(ValueError, match="GATHER_KERNEL"):
            tgather.gather_kernel()


# ---- the slice as a whole
P2_TOL = 5e-3


def ssr_model(seed):
    """A 2-layer, 256-wide full-SSR llama in f32 (JAX's params, the port's
    copy). Scales are drawn so that mu - alpha is exact in bf16, as the TPU
    kernels take it."""
    cfg = jreg.get_config("tiny-llama").with_(n_layers=2, dim=256, intermediate=512)
    jparams = jrand.random_ternary_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32,
                                          perm_mode="ssr")
    layers = jparams["layers"]
    rng = np.random.default_rng(seed)
    for name in ("qkv", "o", "gateup", "down"):
        lin = layers[name]
        L, nb, n = lin.alpha.shape
        alpha, mu = exact_scales(rng, L * nb, n)
        layers[name] = dataclasses.replace(lin, alpha=alpha.reshape(L, nb, n),
                                           mu=mu.reshape(L, nb, n))
    return cfg, jparams, to_port(jparams)


def prefill_and_decode(cfg, jparams, tparams, B, Lp, monkeypatch):
    """One prefill of B x Lp ids and two greedy decode steps on both sides,
    each fed its own picks: JAX through its Pallas kernels in interpret mode,
    the port on the CPU. Returns [(jax logits, port logits)] per step and
    the JAX kernels traced, by the port's names."""
    traced = []
    for mod, name in ((jpt, "ternary_matmul_pallas_stacked"),
                      (jpt, "ternary_matmul_pallas_gathered_stacked"),
                      (jpg, "onehot_matmul_pallas_stacked"), (jpg, "onehot_iota_pallas_stacked")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _name=name, **kw:
                            traced.append(JAX_TO_PORT[_name[:-len("_stacked")]]) or _fn(*a, **kw))
    prompt = np.random.default_rng(Lp).integers(0, cfg.vocab_size, size=(B, Lp)).astype(np.int32)
    jcache = jinit_cache(cfg, B, Lp + 8)
    tcache = tinit_cache(cfg, B, Lp + 8, device="cpu")
    jtok, ttok = jnp.asarray(prompt), torch.from_numpy(prompt).long()
    out = []
    with torch.inference_mode():
        for step in range(3):
            pos = 0 if step == 0 else Lp + step - 1
            with pltpu.force_tpu_interpret_mode():
                jl, jcache = jforward_cached(cfg, jparams, jtok, jcache, pos, "pallas")
            tl, _ = tforward_cached(cfg, tparams, ttok, tcache, pos, "auto")
            out.append((np.asarray(jl), tl.float().numpy()))
            jtok, ttok = jnp.argmax(jl, -1)[:, None], tl.argmax(-1)[:, None]
    return out, traced


def test_ssr_model_under_p2_flags_matches_jax_pallas_interpret(monkeypatch):
    """The "ssr" layout (down folded) under the P2 flags: the 80-row prefill
    gathers with K5 and multiplies with K1, decode runs qkv / o / gateup
    through K6 and down through K1. The port runs the route the card takes
    (``linear_route`` asked for CUDA), each wrapper its plain version on the
    CPU, and casts K1's operand to bf16 as its wrapper does on the card (the
    TPU kernel casts it on every backend; K6 keeps f32 in interpret mode, as
    the port's plain version does). Logits are held to P2_TOL, with the same
    greedy tokens, because the two sides differ by more than f32 summation
    order: a bf16 cast turns differences of 1e-7 into whole bf16 steps of a
    few operands, and the 8 casts of the prefill compound them; and the TPU
    kernels' telescoped unpack at <= 64 rows is exact only to 1e-5 - 4e-5 on
    f32 operands that bf16 does not represent (measured per K6 call at
    these shapes). Measured here: 2.2e-3, 0.9e-3 and 1.6e-3 (relative L2)
    at the prefill and the two steps; JAX's own XLA route sits 8.7e-3 from
    its Pallas route at the prefill."""
    set_flags(monkeypatch, FLAG_SETS["P2"])
    cfg, jparams, tparams = ssr_model(5)
    route, k1, k6 = ttm.linear_route, ttm.ternary_matmul, ttm.ternary_matmul_gathered
    launched = []
    monkeypatch.setattr(ttm, "linear_route",
                        lambda p, rows, impl="auto", device="cuda": route(p, rows, impl, "cuda"))
    monkeypatch.setattr(ttm, "ternary_matmul",
                        lambda x, *a, **kw: launched.append("K1") or k1(x.bfloat16(), *a, **kw))
    monkeypatch.setattr(ttm, "ternary_matmul_gathered",
                        lambda *a, **kw: launched.append("K6") or k6(*a, **kw))
    steps, traced = prefill_and_decode(cfg, jparams, tparams, 2, 40, monkeypatch)
    # JAX traces the scan body once per call: K5 + K1 for qkv, o, gateup and
    # K1 for down, then K6 x3 + K1 per decode step
    assert traced == (["onehot_matmul", "ternary_matmul"] * 3 + ["ternary_matmul"]
                      + (["ternary_matmul_gathered"] * 3 + ["ternary_matmul"]) * 2)
    L = cfg.n_layers
    assert launched == ["K1"] * 4 * L + (["K6"] * 3 + ["K1"]) * L * 2
    for want, got in steps:
        assert np.linalg.norm(got - want) <= P2_TOL * np.linalg.norm(want)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
