"""K2's ungated mode (gateup is up alone: mid = act(up)) of the port against
the JAX package (CPU).

The TPU kernel computes the ungated MLP in the same kernel as the gated one
(``pallas_ternary._mlp_common``: gated = False, half = the up width). The
port's three plain versions, ``ternary_mlp_plain`` (the contract),
``ternary_mlp_dec_plain`` (the decode path's algorithm) and
``ternary_mlp_tc_plain`` (the tensor-core path's), are held here at D = 512,
I = 1408 (11 blocks inside down's 16), n = 512, with the scale draws of
``tests/test_torch_fused_mlp.py``:

  * against ``ternary_mlp_pallas`` and ``_stacked`` in interpret mode, with
    and without the gather prologue, silu, gelu and relu, on f32 x, at that
    file's tolerance: within 1e-5 of max|ref| of the float64 evaluation,
    and within the Pallas kernel's own distance from it plus 1e-5;
  * with up widened by zero-scaled pad columns (what ``pad_gateup_blocks``
    leaves), which both packages sweep exactly;
  * the ungated reading is JAX's: a gateup exactly I wide is ungated, one
    2 x I wide gated, and the widths that neither takes raise in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.quant import fold as jfold
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch.ops.kernels import ternary as tk
from test_torch_fused_mlp import D, I, N, act_f64, assert_close_to_jax, dense_f64, jpt, \
    rel_err, to_port, with_exact_scales

ACTS = ["silu", "gelu", "relu"]
ROWS = 12  # the JAX outputs' rows; each row of the MLP is independent of the others
DEC_WAVE = 528  # the H100 SXM's dec_wave
TC_WAVE = 264  # its igtc_wave


class _Ungated:
    gated_mlp = False


def jax_ungated_layer(seed, gather, pad_blocks=0):
    """(up, down) of one ungated layer as the fold leaves them: full SSR (a
    gather on up, down folded into up's output lanes) or the "down" layout
    (no gather); up widened by ``pad_blocks`` zero-scaled blocks of columns."""
    rng = np.random.default_rng(seed)
    k0, k1 = jax.random.split(jax.random.PRNGKey(seed))
    up = jrand.random_ternary_linear(k0, I + 128 * pad_blocks, D,
                                     perm_mode="ssr" if gather else "identity")
    dn = jrand.random_ternary_linear(k1, N, I, perm_mode="ssr" if gather else "folded")
    up = with_exact_scales(up, rng, D // 128)
    dn = with_exact_scales(dn, rng, I // 128)
    if pad_blocks:
        keep = (np.arange(up.alpha.shape[1]) < I)[None, :]
        up = dataclasses.replace(up, alpha=up.alpha * keep, mu=up.mu * keep)
    if gather:
        lp = jfold.fold_layer_perms(_Ungated(), {"up": up, "down": dn})
        up, dn = lp["up"], lp["down"]
    return up, dn


def mlp_f64(x, up, dn, gather, act):
    """The ungated MLP in float64: gather (or pad), up, act, down over its
    first width // 128 blocks."""
    Wu = dense_f64(up)
    x64 = x.astype(np.float64)
    if gather:
        xg = np.pad(x64, ((0, 0), (0, 1)))[:, np.minimum(np.asarray(up.perm), x.shape[1])]
    else:
        xg = np.pad(x64, ((0, 0), (0, Wu.shape[0] - x.shape[1])))
    mid = act_f64(act, xg @ Wu)
    return mid @ dense_f64(dn)[: mid.shape[1]]


CASES = [(True, 0), (False, 0), (False, 1)]  # (gather, pad blocks)
CASE_IDS = ["ssr", "down", "down-padded"]


@pytest.fixture(scope="module")
def jax_outputs():
    """Per (case, act): the port's layers, JAX's outputs and their float64
    evaluations, single (layer seed 1) and stacked (layer 1 of seeds 10, 11)."""
    x = np.random.default_rng(2).normal(size=(ROWS, D)).astype(np.float32)
    out = {}
    for gather, pad in CASES:
        up, dn = jax_ungated_layer(1, gather, pad)
        layers = [jax_ungated_layer(10 + li, gather, pad) for li in range(2)]
        stack = lambda f: jnp.stack([f(u, d) for u, d in layers])  # noqa: E731
        assert dn.input_folded and (up.gather is not None) == gather
        for act in ACTS:
            with pltpu.force_tpu_interpret_mode():
                single = np.asarray(jpt.ternary_mlp_pallas(
                    jnp.asarray(x), up.perm if gather else None, up.packed, up.alpha, up.mu,
                    dn.packed, dn.alpha, dn.mu, act=act, intermediate=I))
                stacked = np.asarray(jpt.ternary_mlp_pallas_stacked(
                    jnp.asarray(x), stack(lambda u, d: u.perm) if gather else None,
                    stack(lambda u, d: u.packed), stack(lambda u, d: u.alpha),
                    stack(lambda u, d: u.mu), stack(lambda u, d: d.packed),
                    stack(lambda u, d: d.alpha), stack(lambda u, d: d.mu), 1, act=act,
                    intermediate=I))
            out[gather, pad, act] = [
                (to_port({"gu": up, "dn": dn}), single, mlp_f64(x, up, dn, gather, act)),
                (to_port({"gu": layers[1][0], "dn": layers[1][1]}), stacked,
                 mlp_f64(x, *layers[1], gather, act)),
            ]
    return x, out


def _args(p, gather):
    gu, dn = p["gu"], p["dn"]
    return (gu.perm if gather else None, gu.packed, gu.alpha, gu.mu, dn.packed, dn.alpha, dn.mu)


PLAINS = {
    "contract": lambda x, args, act: tk.ternary_mlp_plain(x, *args, intermediate=I, act=act),
    "dec": lambda x, args, act: tk.ternary_mlp_dec_plain(x, *args, intermediate=I, act=act,
                                                         wave=DEC_WAVE),
    "tc": lambda x, args, act: tk.ternary_mlp_tc_plain(x, *args, intermediate=I, act=act,
                                                       wave=TC_WAVE),
}


@pytest.mark.parametrize("plain", sorted(PLAINS))
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_ungated_plain_matches_pallas_interpret(jax_outputs, case, act, plain):
    """Each plain version at 1 to 8 rows (decode rows) and 12 (the
    tensor-core path's), single and stacked."""
    gather, pad = CASES[case]
    x, out = jax_outputs
    rows = ROWS if plain == "tc" else 8
    xt = torch.from_numpy(x[:rows])
    for p, want, exact in out[gather, pad, act]:  # ternary_mlp_pallas, then _stacked's layer 1
        got = PLAINS[plain](xt, _args(p, gather), act).numpy()
        assert got.shape == (rows, N)
        assert_close_to_jax(got, want[:rows], exact[:rows])


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_ungated_paths_in_bf16_match_the_contract(jax_outputs, case):
    """On bf16 x, as the kernels run: the decode and tensor-core algorithms
    within K2's card tolerance (1e-3) of the contract at several waves, and
    the wrapper on a CPU tensor is the contract."""
    gather, pad = CASES[case]
    x, out = jax_outputs
    p = out[gather, pad, "gelu"][0][0]
    xb = torch.from_numpy(x).bfloat16()
    want = tk.ternary_mlp_plain(xb, *_args(p, gather), intermediate=I, act="gelu")
    for wave in (1, 22, DEC_WAVE, 10**6):
        for name in ("dec", "tc"):
            xs = xb[:8] if name == "dec" else xb
            got = getattr(tk, f"ternary_mlp_{name}_plain")(
                xs, *_args(p, gather), intermediate=I, act="gelu", wave=wave)
            assert rel_err(got.numpy(), want[: xs.shape[0]].numpy()) <= 1e-3
    np.testing.assert_array_equal(
        tk.ternary_mlp(xb, *_args(p, gather), intermediate=I, act="gelu").numpy(), want.numpy())


@pytest.mark.parametrize("gu_n,gated", [(2 * I, True), (I, False), (I + 128, False),
                                        (2 * I + 256, True), (I - 128, None), (I + 64, None)])
def test_gated_or_ungated_as_jax_reads_the_width(gu_n, gated):
    """_mlp_shapes classifies a gateup width as _mlp_common does, and both
    refuse the widths that neither reading takes."""
    Kg = 512
    gp = np.zeros((Kg // 4, gu_n), np.int8)
    ga = np.zeros((Kg // 128, gu_n), np.float32)
    dp = np.zeros((2048 // 4, N), np.int8)
    da = np.zeros((16, N), np.float32)
    x = jnp.zeros((1, Kg))
    if gated is None:
        with pytest.raises(ValueError):
            jpt._mlp_common(x, jnp.asarray(gp), jnp.asarray(ga), jnp.asarray(dp),
                            jnp.asarray(da), 128, I)
        with pytest.raises(ValueError):
            tk._mlp_shapes(torch.from_numpy(gp), torch.from_numpy(ga), torch.from_numpy(dp),
                           torch.from_numpy(da), I, 128)
        return
    j = jpt._mlp_common(x, jnp.asarray(gp), jnp.asarray(ga), jnp.asarray(dp), jnp.asarray(da),
                        128, I)
    t = tk._mlp_shapes(torch.from_numpy(gp), torch.from_numpy(ga), torch.from_numpy(dp),
                       torch.from_numpy(da), I, 128)
    assert j[0] == t[4] == gated
    assert (j[1], j[4], j[5]) == t[:3]  # Kg, half, nv


def test_superblock_bound_as_jax():
    """Down must hold the superblock of 8 scale rows that the last visited
    block starts: 11 blocks of up ask for 16 rows of down, 12 are too few,
    in both packages."""
    gp = np.zeros((128, I), np.int8)
    ga = np.zeros((4, I), np.float32)
    for nbd, ok in ((16, True), (12, False)):
        dp = np.zeros((nbd * 32, N), np.int8)
        da = np.zeros((nbd, N), np.float32)
        args_t = (torch.from_numpy(gp), torch.from_numpy(ga), torch.from_numpy(dp),
                  torch.from_numpy(da), I, 128)
        args_j = (jnp.zeros((1, 512)), jnp.asarray(gp), jnp.asarray(ga), jnp.asarray(dp),
                  jnp.asarray(da), 128, I)
        if ok:
            assert tk._mlp_shapes(*args_t)[2] == jpt._mlp_common(*args_j)[5] == 11
        else:
            with pytest.raises(ValueError, match="superblock"):
                tk._mlp_shapes(*args_t)
            with pytest.raises(ValueError, match="superblock"):
                jpt._mlp_common(*args_j)
