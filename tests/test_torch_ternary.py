"""The port's ATQ (``pt2tpu_torch.core.ternary``) against ``pt2tpu.core.ternary``
on the same numpy inputs, f32 on the CPU.

Both packages compute the same f32 formulas with reductions in different
orders, so scales agree within 1e-5 relative and codes agree exactly, except
where a rounding decision of the row sits within 1e-5 of its threshold
(``torch_quant_audit.block_margins`` measures it on the port's side; every
differing row must be such a near-tie)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.core import ternary as jt
from pt2tpu_torch.core import ternary as tt
from torch_quant_audit import NEAR_TIE, block_margins

REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, n=64, m=128, masked=False):
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(n, m)) * 0.05 + rng.normal(size=(n, 1)) * 0.01).astype(np.float32)
    X = rng.normal(size=(4 * m, m)).astype(np.float32)
    X[:, 1::2] += 0.7 * X[:, ::2]  # correlated columns: an off-diagonal S
    S = (X.T @ X / len(X)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((m,), bool)
        mask[m - 37:] = False
        mask[5] = False
    return W, S, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def assert_close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, np.abs(got - want).max() / scale


def assert_codes(T_port, T_jax, W, mask, rows_ok=None):
    """Equal codes, or every differing row a measured near-tie; returns the
    rows that differ (their scales are then not compared)."""
    T_port, T_jax = np.asarray(T_port), np.asarray(T_jax)
    rows = np.nonzero((T_port != T_jax).any(axis=1))[0]
    if len(rows):
        margins = block_margins(_t(W), _t(mask)).numpy()
        assert (margins[rows] < NEAR_TIE).all(), (rows, margins[rows])
    return rows


@pytest.mark.parametrize("masked", [False, True])
def test_ternary_init(masked):
    W, _, mask = _inputs(0, masked=masked)
    a, u, T = tt.ternary_init(_t(W), _t(mask))
    ja, ju, jT = jt.ternary_init(_j(W), _j(mask))
    rows = assert_codes(T.numpy(), jT, W, mask)
    keep = np.setdiff1d(np.arange(W.shape[0]), rows)
    assert_close(a.numpy()[keep], np.asarray(ja)[keep])
    assert_close(u.numpy(), np.asarray(ju))
    if mask is not None:
        assert (T.numpy()[:, ~mask] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_optimal_grid_and_flexible_round(masked):
    W, _, mask = _inputs(1, masked=masked)
    T = np.random.default_rng(2).integers(-1, 2, W.shape).astype(np.float32)
    a, u = tt.optimal_grid(_t(W), _t(T), _t(mask))
    ja, ju = jt.optimal_grid(_j(W), _j(T), _j(mask))
    assert_close(a.numpy(), ja)
    assert_close(u.numpy(), ju)
    R = tt.flexible_round(_t(W), a, u, _t(mask)).numpy()
    jR = np.asarray(jt.flexible_round(_j(W), ja, ju, _j(mask)))
    diff = R != jR
    if diff.any():  # Z within 1e-5 of +-0.5 at every differing code
        Z = (W - np.asarray(ju)) / np.maximum(np.asarray(ja), 1e-8)
        assert (np.minimum(abs(Z - 0.5), abs(Z + 0.5))[diff] < NEAR_TIE).all()


@pytest.mark.parametrize("masked", [False, True])
def test_itf(masked):
    W, _, mask = _inputs(3, masked=masked)
    a0, u0, T0 = tt.ternary_init(_t(W), _t(mask))
    a, u, T = tt.itf(_t(W), a0, u0, T0, _t(mask))
    ja0, ju0, jT0 = jt.ternary_init(_j(W), _j(mask))
    ja, ju, jT = jt.itf(_j(W), ja0, ju0, jT0, _j(mask))
    rows = assert_codes(T.numpy(), jT, W, mask)
    keep = np.setdiff1d(np.arange(W.shape[0]), rows)
    assert_close(a.numpy()[keep], np.asarray(ja)[keep])
    assert_close(u.numpy()[keep], np.asarray(ju)[keep])


@pytest.mark.parametrize("max_iter", [1, 2, 5])
def test_itf_stops_at_max_iter(max_iter):
    """A fixed number of iterations gives JAX's grid and codes."""
    W, _, mask = _inputs(4, masked=True)
    args = tt.ternary_init(_t(W), _t(mask))
    a, u, T = tt.itf(_t(W), *args, _t(mask), max_iter=max_iter)
    ja, ju, jT = jt.itf(_j(W), *[jnp.asarray(x.numpy()) for x in args], _j(mask),
                        max_iter=max_iter)
    rows = assert_codes(T.numpy(), jT, W, mask)
    keep = np.setdiff1d(np.arange(W.shape[0]), rows)
    assert_close(a.numpy()[keep], np.asarray(ja)[keep])
    assert_close(u.numpy()[keep], np.asarray(ju)[keep])


def test_itf_all_zero_start_returns_untouched():
    W, _, _ = _inputs(5)
    a, u, T = torch.full((64, 1), 0.3), torch.full((64, 1), -0.1), torch.zeros((64, 128))
    got = tt.itf(_t(W), a, u, T)
    assert all(torch.equal(g, w) for g, w in zip(got, (a, u, T)))
    jgot = jt.itf(_j(W), jnp.asarray(a.numpy()), jnp.asarray(u.numpy()), jnp.zeros((64, 128)))
    assert all(np.array_equal(np.asarray(j), g.numpy()) for j, g in zip(jgot, got))


@pytest.mark.parametrize("fn", ["aga", "aga_exact"])
@pytest.mark.parametrize("masked", [False, True])
def test_aga(fn, masked):
    W, S, mask = _inputs(6, masked=masked)
    a0, u0, T = tt.ternary_init(_t(W), _t(mask))
    fb = (a0, u0)
    a, u = getattr(tt, fn)(_t(W), T, _t(S), _t(mask), fallback=fb)
    ja, ju = getattr(jt, fn)(_j(W), jnp.asarray(T.numpy()), _j(S), _j(mask),
                             fallback=(jnp.asarray(a0.numpy()), jnp.asarray(u0.numpy())))
    assert_close(a.numpy(), ja)
    assert_close(u.numpy(), ju)


@pytest.mark.parametrize("fn", ["aga", "aga_exact"])
def test_aga_degenerate_rows_keep_the_itf_grid(fn):
    """A row whose codes are all +1 (or all -1) makes its 2x2 system
    singular under either form (alpha and mu both scale the ones vector):
    both packages keep the fallback grid on those rows and solve the rest."""
    W, S, _ = _inputs(7)
    a0, u0, T = tt.ternary_init(_t(W))
    T[:16] = 1.0
    T[16:24] = -1.0
    a, u = getattr(tt, fn)(_t(W), T, _t(S), fallback=(a0, u0))
    ja, ju = getattr(jt, fn)(_j(W), jnp.asarray(T.numpy()), _j(S),
                             fallback=(jnp.asarray(a0.numpy()), jnp.asarray(u0.numpy())))
    assert torch.equal(a[:24], a0[:24]) and torch.equal(u[:24], u0[:24])
    assert not torch.equal(a[24:], a0[24:])
    np.testing.assert_array_equal(np.asarray(ja)[:24], a0.numpy()[:24])
    np.testing.assert_array_equal(np.asarray(ju)[:24], u0.numpy()[:24])
    assert_close(a.numpy(), ja)
    assert_close(u.numpy(), ju)


@pytest.mark.parametrize("mode", ["exact", "reference", "reference_quirk"])
@pytest.mark.parametrize("masked", [False, True])
def test_atq_quantize(mode, masked):
    W, S, mask = _inputs(9, masked=masked)
    r = tt.atq_quantize(_t(W), _t(S), _t(mask), aga_mode=mode)
    jr = jt.atq_quantize(_j(W), _j(S), _j(mask), aga_mode=mode)
    rows = assert_codes(r.T.numpy(), jr.T, W, mask)
    keep = np.setdiff1d(np.arange(W.shape[0]), rows)
    assert_close(r.alpha.numpy()[keep], np.asarray(jr.alpha)[keep])
    assert_close(r.mu.numpy()[keep], np.asarray(jr.mu)[keep])
    if mask is not None:
        assert (r.T.numpy()[:, ~mask] == 0).all()


def test_atq_without_aga_and_error_metrics():
    W, S, _ = _inputs(10)
    r = tt.atq_quantize(_t(W), _t(S), use_aga=False)
    jr = jt.atq_quantize(_j(W), _j(S), use_aga=False)
    assert_codes(r.T.numpy(), jr.T, W, None)
    Wc = tt.dequantize(r.alpha, r.mu, r.T)
    jWc = jt.dequantize(jr.alpha, jr.mu, jr.T)
    assert_close(Wc.numpy(), jWc)
    X = np.random.default_rng(11).normal(size=(3, 5, 128)).astype(np.float32)
    assert_close(tt.quantization_error(_t(W), Wc).numpy(), jt.quantization_error(_j(W), jWc))
    assert_close(tt.output_error(_t(W), Wc, _t(X)).numpy(), jt.output_error(_j(W), jWc, _j(X)))


def test_atq_refuses_an_unknown_mode():
    W, S, _ = _inputs(12)
    with pytest.raises(ValueError, match="aga_mode"):
        tt.atq_quantize(_t(W), _t(S), aga_mode="nope")
