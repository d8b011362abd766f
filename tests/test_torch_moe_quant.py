"""The port's mixture-of-experts quantizer against ``pt2tpu.quant.pipeline``
on tiny-moe (dim 64, 2 layers, 4 experts, 2 per token): the same dense
weights (JAX's ``init_params``, carried across) and the same synthetic
calibration windows, f32 on the CPU, full SSR (the default scope at dim 64).

- The routed per-expert Hessians: ``quantize_linear`` is called in JAX's
  order (each expert's gateup, then its down, then qkv and o), on the same
  weights exactly, with Hessians within HESS_TOL of JAX's relative to their
  largest entry in layer 0 (f32 summation order: rows w_te * x_t for
  gate/up, expert e's f32 mid times w_te for down) and LATER_HESS_TOL in
  layer 1, whose inputs come from layer 0's quantized weights (a bf16 scale
  one step off at a rounding edge moves them, as in
  tests/test_torch_families_quant.py).
- The artifact: per expert and projection the flags and perms equal JAX's;
  the codes equal JAX's except in rows whose first differing block holds a
  rounding decision within 1e-5 of its threshold (``torch_quant_audit``, on
  the port's own W, H and H_inv); the bf16 scales of the other rows within
  one bf16 step. The report's ``[xE]`` means (rel_out_err within 1e-3
  relative, nsamples equal). Each package loads the other's artifact, and
  the logits agree within 1e-4 of max|logit| on the rows the routing
  near-tie rule keeps (tests/test_torch_moe.py).
- ``fold_moe_expert_perms``: both outcomes, against JAX's on the same packed
  experts, byte for byte: every expert's down folds (gateup's output lanes
  permuted, a gather on gateup), and one expert's down with pad lanes among
  its valid ones, so no expert folds and every unfolded projection takes a
  packed one-hot gather."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.data import calibration as jcal
from pt2tpu.models import decoder as jdec
from pt2tpu.models import registry as jreg
from pt2tpu.ops import ternary_matmul as jtm
from pt2tpu.quant import fold as jfold
from pt2tpu.quant import pipeline as jpipe
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu_torch.core.packing import unpack_ternary
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.ops import ternary_matmul as ttm
from pt2tpu_torch.quant import fold as tfold
from pt2tpu_torch.quant import hessian as thess
from pt2tpu_torch.quant import pipeline as tpipe
from pt2tpu_torch.quant.fold import foldable_prefix_perm
from pt2tpu_torch.utils import checkpoint as tckpt
from torch_quant_audit import NEAR_TIE, audit, row_margins

NAME = "tiny-moe"
HESS_TOL = 1e-5
LATER_HESS_TOL = 1e-3
LOGIT_TOL = 1e-4
ROUTE_TIE = 1e-5  # routing margin of tests/test_torch_moe.py's near-tie rule


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(tree):
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    return tckpt.params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")


def _spy(module, store):
    orig = module.quantize_linear

    def spy(lin, H_acc, qcfg, use_ssr=None, **kw):
        W = lin.w
        store.append((np.array(W, np.float32) if not torch.is_tensor(W)
                      else W.float().numpy().copy(),
                      np.array(H_acc.normalized(), np.float32),
                      qcfg.use_ssr if use_ssr is None else use_ssr))
        return orig(lin, H_acc, qcfg, use_ssr=use_ssr, **kw)

    return spy


@pytest.fixture(scope="module")
def run():
    """One quantize of tiny-moe in each package (the one JAX quantize of this
    file)."""
    jcfg, tcfg = jreg.get_config(NAME), get_config(NAME)
    jp = jdec.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    calib, _ = jcal.get_calibration_data("synthetic", jcfg.vocab_size, num_samples=8,
                                         seq_len=32, seed=0)
    jcalls, tcalls = [], []
    jorig, torig = jpipe.quantize_linear, tpipe.quantize_linear
    jpipe.quantize_linear, tpipe.quantize_linear = _spy(jpipe, jcalls), _spy(tpipe, tcalls)
    try:
        jq, jr = jpipe.quantize_model(jcfg, jp, jnp.asarray(calib), jpipe.QuantConfig())
        tq, tr = tpipe.quantize_model(tcfg, to_port(jp), calib, tpipe.QuantConfig())
    finally:
        jpipe.quantize_linear, tpipe.quantize_linear = jorig, torig
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, calib=calib, jq=jq, jr=jr, tq=tq, tr=tr,
                jcalls=jcalls, tcalls=tcalls)


def _projections(r):
    """(layer, expert or None, group) in quantize_linear's call order."""
    out = []
    for li in range(r["tcfg"].n_layers):
        for e in range(r["tcfg"].n_experts):
            out += [(li, e, "gateup"), (li, e, "down")]
        out += [(li, None, "qkv"), (li, None, "o")]
    return out


def _slot(p, li, e):
    """Layer li (and expert e) of a stacked packed linear, as numpy."""
    def take(a):
        a = np.asarray(a) if not torch.is_tensor(a) else (
            a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy())
        a = a[li]
        return a if e is None else a[e]
    return take


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not torch.is_tensor(a) \
        else a.float().numpy()


def test_routed_hessians_equal_jax(run):
    r = run
    assert len(r["tcalls"]) == len(r["jcalls"]) == len(_projections(r))
    for (li, e, g), (W, H, ssr), (jW, jH, jssr) in zip(_projections(r), r["tcalls"],
                                                        r["jcalls"]):
        assert ssr == jssr
        if li == 0:
            np.testing.assert_array_equal(W, jW)  # the dense weights carried across
        tol = HESS_TOL if li == 0 else LATER_HESS_TOL
        assert np.abs(H - jH).max() <= tol * np.abs(jH).max(), (li, e, g)
    # the routing weights reach the Hessians: an expert's gate/up Hessian is
    # not the shared mlp_in one
    assert not np.allclose(r["tcalls"][0][1], r["tcalls"][2][1])


def test_quantize_model_gives_jax_artifact(run, tmp_path):
    r = run
    tl, jl = r["tq"]["layers"], r["jq"]["layers"]
    assert sorted(tl) == sorted(jl) and "gate" not in tl and "up" not in tl
    for name in ("gateup", "down"):
        assert tl[name].packed.shape == np.shape(jl[name].packed)
        for attr in ("identity_perm", "input_folded", "out_folded", "in_features"):
            assert getattr(tl[name], attr) == getattr(jl[name], attr), (name, attr)
        assert (tl[name].gather is None) == (jl[name].gather is None)
    Ie = r["tcfg"].expert_inter
    for (li, e, g), (W, H, use_ssr) in zip(_projections(r), r["tcalls"]):
        tp_, jp_ = tl[g], jl[g]
        tk, jk = _slot(tp_, li, e), _slot(jp_, li, e)
        np.testing.assert_array_equal(tk(tp_.perm), jk(jp_.perm))
        n = tp_.out_features
        rq = np.arange(n)
        if g == "gateup":  # rows relabelled by the expert's folded down perm
            down = tl["down"].layer(li).layer(e)
            order = np.argsort(foldable_prefix_perm(down).numpy())
            rq = np.concatenate([order, Ie + order])
        bs = tk(tp_.packed).shape[0] * 4 // tk(tp_.alpha).shape[0]
        nb = -(-W.shape[1] // bs)
        Tt = unpack_ternary(torch.from_numpy(tk(tp_.packed)), bs).numpy().T[rq, : nb * bs]
        Tj = unpack_ternary(torch.from_numpy(jk(jp_.packed).copy()), bs).numpy().T[rq, : nb * bs]
        bad = []
        if (Tt != Tj).any():
            Ht = torch.from_numpy(H)
            _, Hi = thess.damped_inverse(Ht, 0.01)
            margins = row_margins(torch.from_numpy(W), Ht, Hi, block_size=bs,
                                  use_ssr=use_ssr).numpy()
            bad = audit(Tt, Tj, margins, bs)
            assert all(mg < NEAR_TIE for _, _, mg in bad), (li, e, g, bad)
        keep = np.setdiff1d(np.arange(len(rq)), [row for row, _, _ in bad])
        for a, b in ((tp_.alpha, jp_.alpha), (tp_.mu, jp_.mu)):
            a, b = _slot(None, li, e)(_f32(a)), _slot(None, li, e)(_f32(b))
            a, b = a[:, rq[keep]], b[:, rq[keep]]
            assert (np.abs(a - b) <= 2.0**-7 * np.abs(b)).all(), (li, e, g)
    # the report's [xE] means
    for lt, lj in zip(r["tr"]["layers"], r["jr"]["layers"]):
        assert list(lt) == list(lj) == ["gateup", "down", "qkv", "o"]
        for g in lt:
            assert lt[g]["nsamples"] == lj[g]["nsamples"]
            assert abs(lt[g]["rel_out_err"] - lj[g]["rel_out_err"]) <= 1e-3 * lj[g]["rel_out_err"]
    # each package reads the other's artifact; logits by the routing near-tie rule
    tckpt.save_model(str(tmp_path / "port"), r["tcfg"], r["tq"])
    jckpt.save_model(str(tmp_path / "jax"), r["jcfg"], r["jq"])
    _, jq_from_port = jckpt.load_model(str(tmp_path / "port"))
    _, tq_from_jax = tckpt.load_model(str(tmp_path / "jax"), device="cpu")
    toks = np.asarray(r["calib"][:3, :24])
    kept = 0
    for tparams, jparams in ((r["tq"], jq_from_port), (tq_from_jax, r["jq"])):
        lt = tdec.forward(r["tcfg"], tparams, torch.from_numpy(toks).long(), "plain").numpy()
        lj = np.asarray(jdec.forward(r["jcfg"], jparams, jnp.asarray(toks), impl="xla"))
        margins = _route_margins(r["tcfg"], tparams, torch.from_numpy(toks).long())
        for b in range(toks.shape[0]):
            near = np.flatnonzero(margins[b] < ROUTE_TIE)
            end = near[0] if near.size else toks.shape[1]
            kept += end
            assert np.abs(lt[b, :end] - lj[b, :end]).max() <= LOGIT_TOL * np.abs(lj[b, :end]).max()
    assert kept >= 2 * toks.size - 8, kept


def _route_margins(cfg, params, toks):
    B, L = toks.shape
    h = tdec.embed_tokens(cfg, params, toks)
    mask = tdec.build_mask(cfg, L, L)
    cos, sin, _, _ = tdec.pos_tables(cfg, L)
    out = torch.full((B, L), float("inf"))
    k = cfg.experts_per_token
    for li in range(cfg.n_layers):
        lp = tdec.layer_view(params["layers"], li)
        h, io = tdec.layer_forward(cfg, lp, h, cos, sin, mask, impl="plain", layer_idx=li,
                                   return_taps=True)
        probs = torch.softmax(io.taps["mlp_in"].float() @ lp["router"].w.t().float(), -1)
        top = probs.sort(-1, descending=True).values
        out = torch.minimum(out, top[..., k - 1] - top[..., k])
    return out.numpy()


def _expert_pair(rng, e, ragged):
    """One expert's packed gateup (2 x 100 <- 64) and down (64 <- 128 lanes
    of 100 features) with SSR perms, as numpy; ``ragged`` puts down's pad
    lanes among its valid ones, so its perm does not fold."""
    out = {}
    for name, (n, m, K) in (("gateup", (200, 64, 64)), ("down", (64, 100, 128))):
        codes = rng.integers(-1, 2, size=(n, K)).astype(np.int8)
        nb = K // min(128, K)
        alpha = (0.5 + rng.random((nb, n))).astype(np.float32)
        mu = (0.01 * rng.normal(size=(nb, n))).astype(np.float32)
        perm = np.concatenate([rng.permutation(m), np.full(K - m, m)]).astype(np.int32)
        if name == "down" and ragged:
            perm = rng.permutation(perm).astype(np.int32)
        codes[:, perm >= m] = 0
        out[name] = (codes, alpha, mu, perm, m, min(128, K))
    return out


def _lps(pairs, make):
    return [{name: make(*args) for name, args in pair.items()} for pair in pairs]


def _tmake(codes, alpha, mu, perm, m, bs):
    return ttm.make_packed_linear(torch.from_numpy(codes), torch.from_numpy(alpha),
                                  torch.from_numpy(mu), torch.from_numpy(perm), None, m, bs)


def _jmake(codes, alpha, mu, perm, m, bs):
    return jtm.make_packed_linear(jnp.asarray(codes), jnp.asarray(alpha), jnp.asarray(mu),
                                  jnp.asarray(perm), None, m, bs)


@pytest.mark.parametrize("ragged", [False, True], ids=["folded", "gathers"])
def test_fold_moe_expert_perms_both_outcomes(ragged):
    rng = np.random.default_rng(5 + ragged)
    pairs = [_expert_pair(rng, e, ragged and e == 2) for e in range(4)]
    cfg = get_config(NAME)
    got = tfold.fold_moe_expert_perms(cfg, _lps(pairs, _tmake))
    want = jfold.fold_moe_expert_perms(jreg.get_config(NAME), _lps(pairs, _jmake))
    for t, j in zip(got, want):
        for name in ("gateup", "down"):
            a, b = t[name], j[name]
            for attr in ("identity_perm", "input_folded", "out_folded", "in_features"):
                assert getattr(a, attr) == getattr(b, attr), (name, attr)
            for f in ("packed", "perm"):
                np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))
            for f in ("alpha", "mu"):
                np.testing.assert_array_equal(_f32(getattr(a, f)), _f32(getattr(b, f)))
            assert (a.gather is None) == (b.gather is None)
            if a.gather is not None:
                np.testing.assert_array_equal(a.gather.packed.numpy(), np.asarray(b.gather.packed))
    if ragged:  # no expert folds: every down and gateup gathers
        assert all(lp["down"].gather is not None and not lp["down"].input_folded for lp in got)
        assert all(lp["gateup"].gather is not None and not lp["gateup"].out_folded for lp in got)
    else:
        assert all(lp["down"].input_folded and lp["gateup"].out_folded for lp in got)
        assert all(lp["gateup"].gather is not None for lp in got)
    # the experts stack into one (E, ...) leaf set
    stacked = tdec._map(lambda *xs: torch.stack(xs), *[lp["down"] for lp in got])
    assert stacked.packed.shape[0] == 4 and dataclasses.is_dataclass(stacked)
