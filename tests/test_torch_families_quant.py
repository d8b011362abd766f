"""The port's quantizer on every dense family case of
tests/test_torch_families.py against ``pt2tpu.quant.pipeline`` on the same
dense weights (JAX's ``init_params`` with random norms and biases, carried
across) and the same synthetic calibration, f32 on the CPU, the default
QuantConfig (full SSR at these widths, perms folded).

Each projection the port quantizes is held to JAX's ``quantize_linear`` on
the port's own inputs (W with its bias, the normalised Hessian): the codes
equal, except in rows whose first differing block holds a rounding decision
within 1e-5 of its threshold (``torch_quant_audit``); perms and biases
equal; the bf16 scales of the other rows within one bf16 step (the f32
scales agree within 1e-5 relative, and one may round to the neighbouring
bf16). The inputs themselves: layer 0's Hessians equal JAX's within 1e-5
relative (f32 summation order). A later layer's inputs come through the
layers before it, whose bf16 scales may sit one step apart at a rounding
edge; a step moves the next layer's Hessian by about 3e-5 relative (tiny-opt:
one mu of layer 0's up), which the small per-block means mu amplify, so
there the Hessians are held within 1e-3 and the projection by the rule
above on the port's own inputs. The folded artifact's layout (groups, flags,
perms) equals JAX's, at least 99.9 % of its codes are JAX's artifact's, the
ungated MLP quantizes ``up`` with down's perm folded into its output lanes,
and q/k/v biases ride on the fused qkv. Each package reads the other's
artifact, and the logits over it agree within 1e-4 of max|logit|."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.data import calibration as jcal
from pt2tpu.models import decoder as jdec
from pt2tpu.models.common import DenseLinear as JDense
from pt2tpu.quant import pipeline as jpipe
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu_torch.core.packing import unpack_ternary
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.quant import hessian as thess
from pt2tpu_torch.quant import pipeline as tpipe
from pt2tpu_torch.utils import checkpoint as tckpt
from test_torch_families import FAMILIES, configs, jax_params, to_port
from torch_quant_audit import NEAR_TIE, audit, row_margins

BF16_STEP = 2.0**-7  # relative: one step of bf16's 8-bit significand, at its coarsest


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FixedH:
    """A Hessian accumulator that hands out a given normalised Hessian."""

    nsamples = 0

    def __init__(self, H):
        self.H = H

    def normalized(self):
        return self.H


def _record(module, store):
    """Wrap ``module.quantize_linear``: record each call's (W, bias,
    normalised H, use_ssr, packed result)."""
    orig = module.quantize_linear

    def spy(lin, H_acc, qcfg, use_ssr=None, **kw):
        packed, stats = orig(lin, H_acc, qcfg, use_ssr=use_ssr, **kw)
        H = H_acc.normalized()
        store.append((np.array(lin.w, np.float32) if not torch.is_tensor(lin.w)
                      else lin.w.float().numpy().copy(),
                      None if lin.b is None else (np.array(lin.b, np.float32)
                                                  if not torch.is_tensor(lin.b)
                                                  else lin.b.float().numpy().copy()),
                      np.array(H, np.float32) if not torch.is_tensor(H) else H.numpy().copy(),
                      qcfg.use_ssr if use_ssr is None else use_ssr, packed))
        return packed, stats

    return orig, spy


def _np(a):
    return a.float().numpy() if torch.is_tensor(a) else np.asarray(jnp.asarray(a, jnp.float32))


def _codes(p, li=None):
    """(n, K) visit-order codes of a packed linear (layer ``li`` if stacked)."""
    packed = p.packed if torch.is_tensor(p.packed) else torch.from_numpy(np.array(p.packed))
    if li is not None:
        packed = packed[li]
    return unpack_ternary(packed, packed.shape[-2] * 4 // p.alpha.shape[-2]).numpy().T


def _hold_projection(W, b, H, use_ssr, tp):
    """The port's packed projection against JAX's quantize_linear on the
    same W, bias and H."""
    jp, _ = jpipe.quantize_linear(
        JDense(w=jnp.asarray(W), b=None if b is None else jnp.asarray(b)),
        _FixedH(jnp.asarray(H)), jpipe.QuantConfig(), use_ssr=use_ssr)
    np.testing.assert_array_equal(tp.perm.numpy(), np.asarray(jp.perm))
    if b is not None:
        np.testing.assert_array_equal(tp.bias.numpy(), np.asarray(jp.bias))
    Tt, Tj = _codes(tp), _codes(jp)
    bad = []
    if (Tt != Tj).any():
        Ht = torch.from_numpy(H)
        _, Hi = thess.damped_inverse(Ht, 0.01)
        margins = row_margins(torch.from_numpy(W), Ht, Hi, use_ssr=use_ssr).numpy()
        bad = audit(Tt[:, : margins.shape[1] * 128], Tj[:, : margins.shape[1] * 128], margins,
                    128)
        assert all(mg < NEAR_TIE for _, _, mg in bad), bad
    keep = np.setdiff1d(np.arange(Tt.shape[0]), [row for row, _, _ in bad])
    for a, c in ((tp.alpha, jp.alpha), (tp.mu, jp.mu)):
        a, c = _np(a)[:, keep], _np(c)[:, keep]
        assert (np.abs(a - c) <= BF16_STEP * np.abs(c)).all()


@pytest.mark.parametrize("name", FAMILIES)
def test_quantize_model_gives_jax_artifact(name, tmp_path):
    jcfg, tcfg = configs(name)
    jp = jax_params(name, "dense", seed=21)
    calib, _ = jcal.get_calibration_data("synthetic", jcfg.vocab_size, num_samples=8,
                                         seq_len=48, seed=4)
    tcalls, jcalls = [], []
    torig, tspy = _record(tpipe, tcalls)
    jorig, jspy = _record(jpipe, jcalls)
    tpipe.quantize_linear, jpipe.quantize_linear = tspy, jspy
    try:
        jq, jr = jpipe.quantize_model(jcfg, jp, jnp.asarray(calib), jpipe.QuantConfig())
        tq, tr = tpipe.quantize_model(tcfg, to_port(jp), calib, tpipe.QuantConfig())
    finally:
        tpipe.quantize_linear, jpipe.quantize_linear = torig, jorig

    groups = [g for g, _, _ in tpipe._groups(tcfg, tpipe.QuantConfig())]
    assert len(tcalls) == len(jcalls) == len(groups) * tcfg.n_layers
    for i, ((W, b, H, use_ssr, tp), (jW, jb, jH, _, _)) in enumerate(zip(tcalls, jcalls)):
        np.testing.assert_array_equal(W, jW)  # the dense weights carried across
        if b is not None:
            np.testing.assert_array_equal(b, jb)
        tol = 1e-5 if i < len(groups) else 1e-3  # layer 0, then the layers after it
        assert np.abs(H - jH).max() <= tol * np.abs(jH).max(), (i, groups[i % len(groups)])
        _hold_projection(W, b, H, use_ssr, tp)

    assert sorted(tq["layers"]) == sorted(jq["layers"])
    assert ("up" in tq["layers"]) != jcfg.gated_mlp
    assert ("gateup" in tq["layers"]) == jcfg.gated_mlp
    if jcfg.linear_bias or jcfg.qkv_bias:
        assert tq["layers"]["qkv"].bias is not None
    for g in groups:
        t, j = tq["layers"][g], jq["layers"][g]
        for attr in ("identity_perm", "input_folded", "out_folded", "in_features"):
            assert getattr(t, attr) == getattr(j, attr), (g, attr)
        assert (t.gather is None) == (j.gather is None), g
        # layer 0 from the same inputs: JAX's perms and codes (a later
        # layer's SSR order follows its inputs, held above)
        np.testing.assert_array_equal(t.perm.numpy()[0], np.asarray(j.perm)[0])
        assert (_codes(t, 0) == _codes(j, 0)).mean() >= 0.999, g
    assert tq["layers"]["down"].input_folded
    assert tr["bits_per_weight"] == jr["bits_per_weight"]

    tckpt.save_model(str(tmp_path / "port"), tcfg, tq, tpipe.QuantConfig(), tr)
    jckpt.save_model(str(tmp_path / "jax"), jcfg, jq, jpipe.QuantConfig(), jr)
    jcfg2, jq_from_port = jckpt.load_model(str(tmp_path / "port"))
    tcfg2, tq_from_jax = tckpt.load_model(str(tmp_path / "jax"), device="cpu")
    assert tcfg2 == tcfg
    # JAX's load_model keeps layer_globals as the manifest's list
    assert dataclasses.asdict(jcfg2) == {k: list(v) if isinstance(v, tuple) else v
                                         for k, v in dataclasses.asdict(jcfg).items()}
    toks = np.asarray(calib[:2])
    for tparams, jparams in ((tq, jq_from_port), (tq_from_jax, jq)):
        lt = tdec.forward(tcfg, tparams, torch.from_numpy(toks).long(), impl="plain").numpy()
        lj = np.asarray(jdec.forward(jcfg, jparams, jnp.asarray(toks), impl="xla"))
        assert np.isfinite(lt).all()
        assert np.abs(lt - lj).max() <= 1e-4 * np.abs(lj).max()


def test_streamed_quantization_equals_resident():
    """``quantize_model(..., device=...)`` on parameters that lie elsewhere
    streams them one layer at a time (JAX's host-resident path) and gives
    the artifact of the resident run, byte for byte (here both sides are
    the CPU; on the card, chip_smoke.py phase 21 streams a host checkpoint)."""
    jcfg, tcfg = configs("tiny-qwen2")
    params = to_port(jax_params("tiny-qwen2", "dense", seed=3))
    calib, _ = jcal.get_calibration_data("synthetic", jcfg.vocab_size, num_samples=4,
                                         seq_len=32, seed=2)
    resident, _ = tpipe.quantize_model(tcfg, params, calib, tpipe.QuantConfig())
    streamed, _ = tpipe.quantize_model(tcfg, params, calib, tpipe.QuantConfig(),
                                       device=torch.device("cpu", 0))
    fr, sr, fs, ss = {}, {}, {}, {}
    tckpt._flatten("", resident, fr, sr)
    tckpt._flatten("", streamed, fs, ss)
    assert sr == ss and fr.keys() == fs.keys()
    assert all(torch.equal(fr[k], fs[k]) for k in fr)
