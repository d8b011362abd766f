"""The port's model quantizer (``pt2tpu_torch.quant.pipeline.quantize_model``)
against ``pt2tpu.quant.pipeline`` on the same dense weights (JAX's
``init_params``, carried across) and the same synthetic calibration windows,
f32 on the CPU.

tiny-llama (ssr_scope "all", and "down" with the lm_head quantized) and
tiny-gemma: the artifacts' codes equal JAX's, except in rows whose first
differing block holds a rounding decision within 1e-5 of its threshold
(``torch_quant_audit``, on the port's own inputs); perms, layouts and the
bf16 scales of the other rows within one bf16 step (the f32 scales agree
within 1e-5 relative, and one may round to the neighbouring bf16); each
package's ``load_model`` reads the other's artifact; logits and perplexity
agree within 1e-4 (of max|logit|, relative).

dim 640 (one layer, so "auto" means "down"): the layouts agree exactly.
The two pipelines' Hessians agree to f32 summation order (1e-5 relative),
but the damped inverse of this calibration's ill-conditioned Hessians
amplifies that to ~1e-4 relative, so a few codes of the dense-order groups
move (0.02-0.03 % at this size, measured). So the artifact is held in two
parts: its codes are JAX's ``ternary_gptq`` on the port's own W, H and
H_inv (near-tie rule), its Hessians are JAX's to 1e-5, at least 99.9 % of
its codes are JAX's artifact's; the port's forward and perplexity over
JAX's artifact give JAX's logits within 1e-4 of max|logit| and its
perplexity within 1e-4 relative, and the two artifacts' perplexities agree
within 1e-2 relative (1.2e-3 measured: the moved codes).

Resume: a journal written by either package resumes in the other."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.data import calibration as jcal
from pt2tpu.data import evaluate as jev
from pt2tpu.models import decoder as jdec
from pt2tpu.models import registry as jreg
from pt2tpu.quant import gptq as jgptq
from pt2tpu.quant import pipeline as jpipe
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu_torch.core.packing import unpack_ternary
from pt2tpu_torch.data import evaluate as tev
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.quant import hessian as thess
from pt2tpu_torch.quant.fold import foldable_prefix_perm
from pt2tpu_torch.quant import pipeline as tpipe
from pt2tpu_torch.utils import checkpoint as tckpt
from torch_quant_audit import NEAR_TIE, audit, row_margins

WIDE = dict(dim=640, n_heads=5, n_kv_heads=1, intermediate=256, n_layers=1)
CASES = {  # name: (registry name, config changes, QuantConfig changes, key)
    "tiny-llama-all": ("tiny-llama", {}, {"ssr_scope": "all"}, 0),
    "tiny-llama-down-head": ("tiny-llama", {}, {"ssr_scope": "down", "quantize_lm_head": True}, 1),
    "tiny-gemma": ("tiny-gemma", {}, {}, 2),
    "dim-640": ("tiny-llama", WIDE, {}, 3),
}


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
    """Record each quantize_linear call's (W, normalized H, use_ssr)."""
    orig = module.quantize_linear

    def spy(lin, H_acc, qcfg, use_ssr=None, **kw):
        W = lin.w
        store.append((np.array(W, np.float32) if not torch.is_tensor(W) else W.float().numpy().copy(),
                      np.array(H_acc.normalized(), np.float32),
                      qcfg.use_ssr if use_ssr is None else use_ssr))
        return orig(lin, H_acc, qcfg, use_ssr=use_ssr, **kw)

    return spy


@pytest.fixture(scope="module")
def runs():
    return {}


def run(runs, name):
    if name in runs:
        return runs[name]
    reg, ckw, qkw, key = CASES[name]
    jcfg = jreg.get_config(reg).with_(**ckw)
    tcfg = get_config(reg).with_(**ckw)
    jp = jdec.init_params(jcfg, jax.random.PRNGKey(key), dtype=jnp.float32)
    calib, _ = jcal.get_calibration_data("synthetic", jcfg.vocab_size, num_samples=8,
                                         seq_len=64, seed=key)
    jcalls, tcalls = [], []
    jorig, torig = jpipe.quantize_linear, tpipe.quantize_linear
    jpipe.quantize_linear, tpipe.quantize_linear = _spy(jpipe, jcalls), _spy(tpipe, tcalls)
    try:
        jq, jr = jpipe.quantize_model(jcfg, jp, jnp.asarray(calib), jpipe.QuantConfig(**qkw))
        tq, tr = tpipe.quantize_model(tcfg, to_port(jp), calib, tpipe.QuantConfig(**qkw))
    finally:
        jpipe.quantize_linear, tpipe.quantize_linear = jorig, torig
    runs[name] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, calib=calib, jq=jq, jr=jr, tq=tq, tr=tr,
                      jcalls=jcalls, tcalls=tcalls, qkw=qkw)
    return runs[name]


def _codes(p, li=None):
    """(n, K) visit-order codes of a packed linear (layer ``li`` if stacked)."""
    packed = np.array(p.packed) if not torch.is_tensor(p.packed) else p.packed.numpy()
    if li is not None:
        packed = packed[li]
    bs = packed.shape[-2] * 4 // p.alpha.shape[-2]
    return unpack_ternary(torch.from_numpy(packed), bs).numpy().T


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not torch.is_tensor(a) else a.float().numpy()


def _projections(r):
    """(layer, group, JAX packed, port packed) of every quantized linear, in
    quantize_linear's call order."""
    out = []
    groups = [g for g, _, _ in tpipe._groups(r["tcfg"], tpipe.QuantConfig(**r["qkw"]))]
    for li in range(r["tcfg"].n_layers):
        for g in groups:
            out.append((li, g, r["jq"]["layers"][g], r["tq"]["layers"][g]))
    if r["qkw"].get("quantize_lm_head"):
        out.append((None, "lm_head", r["jq"]["lm_head"], r["tq"]["lm_head"]))
    return out


def _rows_q(r, params, li, g, n):
    """Packed row of each quantizer row: gateup's halves may be padded
    (pad_gateup_blocks) and its lanes relabelled by the folded down perm."""
    if g != "gateup":
        return np.arange(n)
    I = r["tcfg"].intermediate
    half = n // 2
    down = params["layers"]["down"]
    order = np.arange(I)
    if down.input_folded:
        order = np.argsort(foldable_prefix_perm(down.layer(li)).numpy())
    return np.concatenate([order, half + order])


def _check_codes(r, calls):
    """Codes and scales against JAX's per the near-tie rule; ``calls`` are the
    (W, H, use_ssr) each of the port's projections was quantized from."""
    assert len(calls) == len(_projections(r))
    for (li, g, jp_, tp_), (W, H, use_ssr) in zip(_projections(r), calls):
        for attr in ("identity_perm", "input_folded", "out_folded", "in_features"):
            assert getattr(tp_, attr) == getattr(jp_, attr), (li, g, attr)
        assert (tp_.gather is None) == (jp_.gather is None), (li, g)
        perm_t, perm_j = tp_.perm.numpy(), np.asarray(jp_.perm)
        if li is not None:
            perm_t, perm_j = perm_t[li], perm_j[li]
        np.testing.assert_array_equal(perm_t, perm_j)
        rq = _rows_q(r, r["tq"], li, g, tp_.out_features)
        np.testing.assert_array_equal(rq, _rows_q(r, to_port(r["jq"]), li, g, tp_.out_features))
        nb = -(-W.shape[1] // 128)
        Tt, Tj = _codes(tp_, li)[rq, : nb * 128], _codes(jp_, li)[rq, : nb * 128]
        bad = []
        if (Tt != Tj).any():
            Ht = torch.from_numpy(H)
            _, Hi = thess.damped_inverse(Ht, 0.01)
            margins = row_margins(torch.from_numpy(W), Ht, Hi, use_ssr=use_ssr).numpy()
            bad = audit(Tt, Tj, margins, 128)
            assert all(mg < NEAR_TIE for _, _, mg in bad), (li, g, bad)
        keep = np.setdiff1d(np.arange(len(rq)), [row for row, _, _ in bad])
        for a, b in ((tp_.alpha, jp_.alpha), (tp_.mu, jp_.mu)):
            a, b = _f32(a), _f32(b)
            if li is not None:
                a, b = a[li], b[li]
            # f32 scales within 1e-5 relative, stored bf16: at most one bf16 step
            a, b = a[:, rq[keep]], b[:, rq[keep]]
            assert (np.abs(a - b) <= 2.0**-7 * np.abs(b)).all(), (li, g)


def _logits(r, tparams, jparams, toks):
    lt = tdec.forward(r["tcfg"], tparams, torch.from_numpy(toks).long(), impl="plain").float().numpy()
    lj = np.asarray(jdec.forward(r["jcfg"], jparams, jnp.asarray(toks), impl="xla")).astype(np.float32)
    return lt, lj


@pytest.mark.parametrize("name", ["tiny-llama-all", "tiny-llama-down-head", "tiny-gemma"])
def test_quantize_model_gives_jax_artifact(runs, name, tmp_path):
    r = run(runs, name)
    _check_codes(r, r["tcalls"])
    assert r["tr"]["bits_per_weight"] == r["jr"]["bits_per_weight"]
    for lt, lj in zip(r["tr"]["layers"], r["jr"]["layers"]):
        assert lt.keys() == lj.keys()
        for g in lt:
            assert lt[g]["nsamples"] == lj[g]["nsamples"] and lt[g]["w_kurt"] == lj[g]["w_kurt"]
            assert abs(lt[g]["rel_out_err"] - lj[g]["rel_out_err"]) <= 1e-4 * lj[g]["rel_out_err"]
    assert sorted(r["tq"]["layers"]) == sorted(r["jq"]["layers"])
    # each package reads the other's artifact
    tckpt.save_model(str(tmp_path / "port"), r["tcfg"], r["tq"], tpipe.QuantConfig(**r["qkw"]),
                     r["tr"])
    jckpt.save_model(str(tmp_path / "jax"), r["jcfg"], r["jq"], jpipe.QuantConfig(**r["qkw"]),
                     r["jr"])
    jcfg2, jq_from_port = jckpt.load_model(str(tmp_path / "port"))
    tcfg2, tq_from_jax = tckpt.load_model(str(tmp_path / "jax"), device="cpu")
    assert tcfg2 == r["tcfg"] and jcfg2 == r["jcfg"]
    toks = r["calib"][:4]
    for tparams, jparams in ((r["tq"], jq_from_port), (tq_from_jax, r["jq"])):
        lt, lj = _logits(r, tparams, jparams, toks)
        assert np.isfinite(lt).all()
        assert np.abs(lt - lj).max() <= 1e-4 * np.abs(lj).max()
    stream = jcal._synthetic_stream(r["jcfg"].vocab_size, 600, 9)
    pt = tev.evaluate_perplexity(r["tcfg"], tq_from_jax, stream, seq_len=64, max_windows=8)
    pj = jev.evaluate_perplexity(r["jcfg"], jq_from_port, stream, seq_len=64, max_windows=8)
    assert abs(pt["ppl"] - pj["ppl"]) <= 1e-4 * pj["ppl"]


def test_dim_640_auto_means_down(runs):
    r = run(runs, "dim-640")
    assert tpipe.resolve_ssr_skip(tpipe.QuantConfig(), 640) == ("gate", "gateup", "k", "o", "q",
                                                               "qkv", "up", "v")
    tl, jl = r["tq"]["layers"], r["jq"]["layers"]
    for g in ("qkv", "o", "gateup"):
        assert tl[g].identity_perm and jl[g].identity_perm and tl[g].gather is None
    assert tl["down"].input_folded and jl["down"].input_folded and not tl["down"].identity_perm
    for (li, g, jp_, tp_), (W, H, use_ssr), (jW, jH, _) in zip(_projections(r), r["tcalls"],
                                                                r["jcalls"]):
        np.testing.assert_array_equal(W, jW)  # the dense weights carried across
        assert np.abs(H - jH).max() <= 1e-5 * np.abs(jH).max(), g  # f32 order
        np.testing.assert_array_equal(tp_.perm.numpy()[li], np.asarray(jp_.perm)[li])
        # the port's codes: JAX's GPTQ on the port's own inputs
        Ht = torch.from_numpy(H)
        _, Hi = thess.damped_inverse(Ht, 0.01)
        jq = jgptq.ternary_gptq(jnp.asarray(W), jnp.asarray(H), jnp.asarray(Hi.numpy()),
                                use_ssr=use_ssr)
        margins = row_margins(torch.from_numpy(W), Ht, Hi, use_ssr=use_ssr).numpy()
        rq = _rows_q(r, r["tq"], li, g, tp_.out_features)
        Tt = _codes(tp_, li)[rq, : margins.shape[1] * 128]
        bad = audit(Tt, np.asarray(jq.T), margins, 128)
        assert all(mg < NEAR_TIE for _, _, mg in bad), (g, bad)
    shares = [(Tt == Tj).mean() for Tt, Tj in (
        (_codes(tp_, li), _codes(jp_, li)) for li, _, jp_, tp_ in _projections(r))]
    assert min(shares) >= 0.999, shares  # the artifacts' codes
    stream = jcal._synthetic_stream(r["jcfg"].vocab_size, 1000, 9)
    pj = jev.evaluate_perplexity(r["jcfg"], r["jq"], stream, seq_len=64, max_windows=8)
    tq_from_jax = to_port(r["jq"])
    pt = tev.evaluate_perplexity(r["tcfg"], tq_from_jax, stream, seq_len=64, max_windows=8)
    assert abs(pt["ppl"] - pj["ppl"]) <= 1e-4 * pj["ppl"]
    pt = tev.evaluate_perplexity(r["tcfg"], r["tq"], stream, seq_len=64, max_windows=8)
    assert abs(pt["ppl"] - pj["ppl"]) <= 1e-2 * pj["ppl"]
    lt, lj = _logits(r, tq_from_jax, r["jq"], r["calib"][:2])
    assert np.abs(lt - lj).max() <= 1e-4 * np.abs(lj).max()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_resumes_across_packages(runs, writer, tmp_path):
    """One package quantizes tiny-llama with a journal; its layer 1 is
    removed (a preempted run); the other package resumes from layer 0's
    journal and gives the artifact of an uninterrupted run."""
    r = run(runs, "tiny-llama-all")
    qkw = r["qkw"]
    d = str(tmp_path / "journal")
    if writer == "port":
        tpipe.quantize_model(r["tcfg"], to_port(r["jp"]), r["calib"], tpipe.QuantConfig(**qkw),
                             journal_dir=d)
    else:
        jpipe.quantize_model(r["jcfg"], r["jp"], jnp.asarray(r["calib"]),
                             jpipe.QuantConfig(**qkw), journal_dir=d)
    for ext in ("npz", "json"):
        os.remove(os.path.join(d, "layers", f"0001.{ext}"))
    if writer == "port":
        out, _ = jpipe.quantize_model(r["jcfg"], r["jp"], jnp.asarray(r["calib"]),
                                      jpipe.QuantConfig(**qkw), journal_dir=d)
        want = r["jq"]
    else:
        out, _ = tpipe.quantize_model(r["tcfg"], to_port(r["jp"]), r["calib"],
                                      tpipe.QuantConfig(**qkw), journal_dir=d)
        want = r["tq"]
    for g in ("qkv", "o", "gateup", "down"):
        a, b = out["layers"][g], want["layers"][g]
        np.testing.assert_array_equal(np.asarray(a.packed), np.asarray(b.packed))
        np.testing.assert_array_equal(_f32(a.alpha), _f32(b.alpha))
    assert os.path.exists(os.path.join(d, "layers", "0001.npz"))  # journaled again
    shutil.rmtree(d)


def test_config_and_refusals():
    """QuantConfig's fields and defaults are JAX's (scale_dtype: each
    package's bf16); resolve_ssr_skip agrees on every scope; a mesh raises,
    naming what is not ported; a mixture-of-experts model, ported now,
    quantizes into (n_layers, E, ...) expert stacks."""
    jf = {f.name: f.default for f in dataclasses.fields(jpipe.QuantConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tpipe.QuantConfig)}
    assert jf.keys() == tf.keys()
    assert {k: v for k, v in jf.items() if k != "scale_dtype"} == {
        k: v for k, v in tf.items() if k != "scale_dtype"}
    for scope in ("all", "down", "auto"):
        for dim in (64, 639, 640, 4096):
            for skip in ((), ("o",), ("down",)):
                kw = dict(ssr_scope=scope, ssr_skip=skip)
                assert (tpipe.resolve_ssr_skip(tpipe.QuantConfig(**kw), dim)
                        == jpipe.resolve_ssr_skip(jpipe.QuantConfig(**kw), dim))
    with pytest.raises(ValueError, match="ssr_scope"):
        tpipe.resolve_ssr_skip(tpipe.QuantConfig(ssr_scope="most"), 64)
    cfg = get_config("tiny-llama")
    params = tdec.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calib = np.zeros((2, 8), np.int32)
    moe = get_config("tiny-moe")
    q, rep = tpipe.quantize_model(
        moe, tdec.init_params(moe, torch.Generator().manual_seed(0), device="cpu"),
        np.random.default_rng(0).integers(0, moe.vocab_size, (4, 16)))
    assert q["layers"]["gateup"].packed.shape[:2] == (2, 4) and "gate" not in q["layers"]
    assert sorted(rep["layers"][0]) == ["down", "gateup", "o", "qkv"]
    with pytest.raises(NotImplementedError, match="mesh"):
        tpipe.quantize_model(cfg, params, calib, mesh=object())


def test_dense_tree_taps_and_layer_helpers():
    """init_params gives JAX's tree (the same structure and shapes, other
    numbers); on JAX's weights carried across, layer_forward's taps equal
    JAX's within 1e-5 of their scale (f32); stack_layers / layer_slice /
    set_layer round-trip; the linear tables are JAX's."""
    assert tdec.LINEAR_NAMES == jdec.LINEAR_NAMES and tdec.TAP_OF_LINEAR == jdec.TAP_OF_LINEAR
    for name in ("tiny-llama", "tiny-gemma"):
        jcfg, tcfg = jreg.get_config(name), get_config(name)
        assert tdec.num_layer_linears(tcfg) == jdec.num_layer_linears(jcfg) == 7
        jp = jdec.init_params(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
        tp = tdec.init_params(tcfg, torch.Generator().manual_seed(5), device="cpu")
        fj, sj, ft, st = {}, {}, {}, {}
        jckpt._flatten("", jp, fj, sj)
        tckpt._flatten("", tp, ft, st)
        assert sj == st and {k: tuple(v.shape) for k, v in fj.items()} == {
            k: tuple(v.shape) for k, v in ft.items()}
        assert all(ft[k].dtype == torch.float32 for k in ft)
        carried = to_port(jp)
        L, D = 16, jcfg.dim
        x = np.random.default_rng(6).normal(size=(2, L, D)).astype(np.float32)
        jcos, jsin, _, _ = jdec.pos_tables(jcfg, L)
        _, jio = jdec.layer_forward(jcfg, jdec.layer_slice(jp["layers"], 1), jnp.asarray(x), jcos,
                                    jsin, jdec.build_mask(jcfg, L, L), return_taps=True,
                                    impl="xla", layer_idx=1)
        cos, sin, _, _ = tdec.pos_tables(tcfg, L)
        from pt2tpu_torch.models.common import causal_mask

        out, io = tdec.layer_forward(tcfg, tdec.layer_slice(carried["layers"], 1),
                                     torch.from_numpy(x), cos, sin, causal_mask(L, L),
                                     impl="plain", layer_idx=1, return_taps=True)
        assert io.kv is None and sorted(io.taps) == sorted(jio.taps)
        for k, v in io.taps.items():
            want = np.asarray(jio.taps[k])
            assert np.abs(v.numpy() - want).max() <= 1e-5 * np.abs(want).max(), (name, k)
        plain = tdec.layer_forward(tcfg, tdec.layer_slice(carried["layers"], 1),
                                   torch.from_numpy(x), cos, sin, causal_mask(L, L), impl="plain",
                                   layer_idx=1)
        assert torch.equal(out, plain)
    layers = [tdec.layer_slice(tp["layers"], i) for i in range(2)]
    again = tdec.stack_layers(layers)
    assert torch.equal(again["q"].w, tp["layers"]["q"].w) and again["router"] is None
    swapped = tdec.set_layer(tp["layers"], 0, layers[1])
    assert torch.equal(swapped["o"].w[0], tp["layers"]["o"].w[1])
    assert torch.equal(swapped["o"].w[1], tp["layers"]["o"].w[1])
    assert not torch.equal(tp["layers"]["o"].w[0], tp["layers"]["o"].w[1])  # a copy


def test_metrics_match_jax():
    """model_bits_per_weight / model_size_gb on one packed model (JAX's,
    carried across), compression_ratio, set_seed, the JSONL logger."""
    from pt2tpu.utils import metrics as jm
    from pt2tpu.utils import randmodel as jrand
    from pt2tpu_torch.utils import metrics as tm

    cfg = jreg.get_config("tiny-llama")
    jp = jrand.random_ternary_params(cfg, jax.random.PRNGKey(1), perm_mode="ssr")
    tp = to_port(jp)
    assert tm.model_bits_per_weight(tp) == jm.model_bits_per_weight(jp)
    assert tm.model_bits_per_weight({"x": torch.zeros(3)}) == 16.0
    assert abs(tm.model_size_gb(tp) - jm.model_size_gb(jp)) <= 1e-12
    assert tm.compression_ratio(2.0, 0.5) == jm.compression_ratio(2.0, 0.5) == 4.0
    g = tm.set_seed(3)
    assert np.random.randint(1 << 30) == (np.random.seed(3) or np.random.randint(1 << 30))
    assert torch.equal(torch.rand(2, generator=g), torch.rand(2, generator=torch.Generator().manual_seed(3)))


def test_metrics_logger(tmp_path, capsys):
    from pt2tpu_torch.utils.metrics import MetricsLogger

    log = MetricsLogger(str(tmp_path / "m" / "log.jsonl"))
    rec = log.emit("layer_quantized", layer=0, proj="o", rel_out_err=0.1)
    log.close()
    assert rec["event"] == "layer_quantized" and "layer_quantized: layer=0" in capsys.readouterr().err
    with open(tmp_path / "m" / "log.jsonl") as f:
        line = f.read()
    assert '"proj": "o"' in line and line.endswith("\n")
