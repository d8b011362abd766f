"""The port's Hessian accumulation, damped inverse and ternary GPTQ
(``pt2tpu_torch.quant.hessian`` / ``.gptq``) against the JAX package's on the
same numpy inputs, f32 on the CPU.

GPTQ gets the same W, H and H_inv in both packages: codes and perm equal
except in rows whose first differing block holds a rounding decision within
1e-5 of its threshold (``torch_quant_audit``, measured on the port's replay
of its own loop); scales of the other rows within 1e-5 relative. Hessians
and inverses agree to f32 summation order (1e-5 relative on a
well-conditioned H)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.ops import ternary_matmul as jtm
from pt2tpu.quant import gptq as jg
from pt2tpu.quant import hessian as jh
from pt2tpu_torch.ops import ternary_matmul as ttm
from pt2tpu_torch.quant import gptq as tg
from pt2tpu_torch.quant import hessian as th
from torch_quant_audit import NEAR_TIE, audit, row_margins


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, n=40, m=300, N=1024):
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(n, m)) / np.sqrt(m)).astype(np.float32)
    X = rng.normal(size=(N, m)).astype(np.float32)
    X[:, 1::3] += 0.8 * X[:, ::3][:, : X[:, 1::3].shape[1]]
    H = (X.T @ X / N).astype(np.float32)
    _, H_inv = jh.damped_inverse(jnp.asarray(H))
    return W, X, H, np.asarray(H_inv)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_accumulate_hessian_and_normalized():
    _, X, _, _ = _problem(0)
    acc = th.HessianAccumulator(300, device="cpu")
    jacc = jh.HessianAccumulator(300)
    for chunk in (X[:300].reshape(3, 100, 300), X[300:]):
        acc.update(torch.from_numpy(chunk))
        jacc.update(jnp.asarray(chunk))
    assert acc.nsamples == jacc.nsamples == 1024
    _close(acc.H.numpy(), jacc.H)
    # the same H: the normalized bits are the correctly rounded quotient, JAX's
    Hn = acc.normalized().numpy()
    np.testing.assert_array_equal(Hn, acc.H.numpy() / np.float32(1024))
    np.testing.assert_array_equal(Hn, np.asarray(jnp.asarray(acc.H.numpy()) / 1024))
    H, n = th.accumulate_hessian(torch.zeros(300, 300), torch.from_numpy(X[:7]))
    assert n == 7


def test_damped_inverse_well_conditioned():
    _, _, H, H_inv = _problem(1)
    Hd, Hi = th.damped_inverse(torch.from_numpy(H))
    jHd, jHi = jh.damped_inverse(jnp.asarray(H))
    np.testing.assert_array_equal(Hd.numpy(), np.asarray(jHd))
    _close(Hi.numpy(), jHi, rel=1e-4)
    eye = Hd.double() @ Hi.double()
    assert torch.allclose(eye, torch.eye(300, dtype=torch.float64), atol=1e-4)


def test_damped_inverse_escalates_like_jax():
    """An indefinite H (eigenvalues 4 and -2): damping 0.01, 0.1 and 1.0
    fail, 10 succeeds, in both packages."""
    H = np.array([[1.0, 3.0], [3.0, 1.0]], np.float32)
    Hd, Hi = th.damped_inverse(torch.from_numpy(H))
    jHd, jHi = jh.damped_inverse(jnp.asarray(H))
    np.testing.assert_allclose(Hd.numpy(), H + 10.0 * np.eye(2, dtype=np.float32), rtol=1e-6)
    np.testing.assert_array_equal(Hd.numpy(), np.asarray(jHd))
    _close(Hi.numpy(), jHi)


def test_damped_inverse_falls_back_to_pinv_like_jax():
    """A negative mean diagonal makes every damping step worse: after four
    attempts both packages return the pseudo-inverse, and the port logs it."""
    H = np.diag([1.0, -3.0, 0.5]).astype(np.float32)

    class Log:
        events = []

        def emit(self, event, **kw):
            self.events.append(event)

    log = Log()
    Hd, Hi = th.damped_inverse(torch.from_numpy(H), log=log)
    jHd, jHi = jh.damped_inverse(jnp.asarray(H))
    np.testing.assert_allclose(Hd.numpy(), np.asarray(jHd), rtol=1e-6)
    _close(Hi.numpy(), jHi)
    assert log.events == ["damped_inverse_pinv"]


CASES = [  # (use_ssr, use_aga, aga_mode, m): m = 300 leaves a partial last block
    (True, True, "exact", 300),
    (False, True, "exact", 300),
    (True, False, "exact", 256),
    (False, False, "exact", 256),
    (True, True, "reference", 300),
]


@pytest.mark.parametrize("use_ssr,use_aga,mode,m", CASES)
def test_ternary_gptq_gives_jax_codes(use_ssr, use_aga, mode, m):
    W, _, H, H_inv = _problem(2 + m, m=m)
    H_inv = np.array(H_inv)
    q = tg.ternary_gptq(torch.from_numpy(W), torch.from_numpy(H), torch.from_numpy(H_inv),
                        use_ssr=use_ssr, use_aga=use_aga, aga_mode=mode)
    jq = jg.ternary_gptq(jnp.asarray(W), jnp.asarray(H), jnp.asarray(H_inv),
                         use_ssr=use_ssr, use_aga=use_aga, aga_mode=mode)
    np.testing.assert_array_equal(q.perm.numpy(), np.asarray(jq.perm))
    np.testing.assert_array_equal(q.lane_valid.numpy(), np.asarray(jq.lane_valid))
    assert q.T.dtype == torch.int8 and q.T.shape == jq.T.shape
    margins = row_margins(torch.from_numpy(W), torch.from_numpy(H), torch.from_numpy(H_inv),
                          use_ssr=use_ssr, use_aga=use_aga, aga_mode=mode).numpy()
    bad = audit(q.T.numpy(), np.asarray(jq.T), margins, 128)
    assert all(mg < NEAR_TIE for _, _, mg in bad), bad
    keep = np.setdiff1d(np.arange(W.shape[0]), [r for r, _, _ in bad])
    _close(q.alpha.numpy()[keep], np.asarray(jq.alpha)[keep])
    _close(q.mu.numpy()[keep], np.asarray(jq.mu)[keep])
    assert (q.T.numpy()[:, ~q.lane_valid.numpy()] == 0).all()
    Wd = tg.dequantize_layer(q, m).numpy()
    _close(Wd[keep], np.asarray(jg.dequantize_layer(jq, m))[keep])


def test_pack_layer_bytes_equal_jax():
    """One quantizer result (JAX's, carried across) packs to JAX's bytes."""
    W, _, H, H_inv = _problem(3)
    jq = jg.ternary_gptq(jnp.asarray(W), jnp.asarray(H), jnp.asarray(H_inv))
    q = tg.TernaryLayerQuant(*[torch.from_numpy(np.array(a)) for a in jq])
    bias = np.random.default_rng(4).normal(size=(40,)).astype(np.float32)
    p = ttm.pack_layer(q, in_features=300, bias=torch.from_numpy(bias))
    jp = jtm.pack_layer(jq, in_features=300, bias=jnp.asarray(bias))
    np.testing.assert_array_equal(p.packed.numpy(), np.asarray(jp.packed))
    np.testing.assert_array_equal(p.perm.numpy(), np.asarray(jp.perm))
    for a, b in ((p.alpha, jp.alpha), (p.mu, jp.mu)):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b.astype(jnp.float32)))
    assert p.identity_perm == bool(jp.identity_perm) and p.in_features == jp.in_features


def test_quantize_layer_weights_and_refusal():
    W, X, _, _ = _problem(5, m=128)
    Hraw = (X[:, :128].T @ X[:, :128]).astype(np.float32)
    q = tg.quantize_layer_weights(torch.from_numpy(W), torch.from_numpy(Hraw), 1024)
    jq = jg.quantize_layer_weights(jnp.asarray(W), jnp.asarray(Hraw), 1024)
    assert (q.T.numpy() == np.asarray(jq.T)).mean() > 0.999
    np.testing.assert_array_equal(q.perm.numpy(), np.asarray(jq.perm))
    with pytest.raises(ValueError, match="H/H_inv"):
        tg.ternary_gptq(torch.from_numpy(W), torch.eye(5), torch.eye(5))
