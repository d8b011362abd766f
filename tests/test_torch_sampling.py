"""Per-row sampling of the port against ``pt2tpu.serve.sampling``.

``filtered_logits`` is the same function in both packages: the same -inf
pattern and the same finite values. The draws differ (a torch.Generator
seeded from (seed, uid, position) where JAX folds a threefry key), so what
is held is determinism per (seed, uid, position), independence from the
batch, the admission order and the quantum, exact argmax on greedy rows, and
the distribution: a chi-square test at V = 16 against softmax(filtered)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.serve import sampling as jsamp
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.serve import sampling as tsamp
from pt2tpu_torch.serve.engine import ServeEngine
from pt2tpu_torch.utils.randmodel import random_ternary_params

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Eager torch on tiny shapes runs on one intra-op thread: under
    pytest-xdist the workers share the cores, and idle OpenMP threads that
    spin for work slow every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = [  # (temps, top_ks, top_ps) per row
    ([1.0, 0.7, 1.3, 0.5, 2.0, 1.0], [0, 5, 1, 50, 3, 64], [1.0, 0.9, 0.5, 0.95, 1.0, 0.3]),
    ([0.0, 1e-7, 1.0, 0.9, 1.0, 1.1], [0, 0, 0, 10, 64, 2], [1.0, 1.0, 0.999, 0.6, 0.1, 1.0]),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_filtered_logits_equal_jax(case):
    temps, top_ks, top_ps = CASES[case]
    logits = np.random.default_rng(case).normal(size=(6, 64)).astype(np.float32) * 3.0
    logits[1, :4] = logits[1, 4]  # ties at the cut
    want = np.asarray(jsamp.filtered_logits(
        jnp.asarray(logits), jnp.asarray(temps, jnp.float32), jnp.asarray(top_ks, jnp.int32),
        jnp.asarray(top_ps, jnp.float32)))
    got = tsamp.filtered_logits(
        torch.from_numpy(logits), torch.tensor(temps), torch.tensor(top_ks),
        torch.tensor(top_ps)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[fin], want[fin])


def _draw(logits, uids, positions, temps, top_ks=None, top_ps=None, seed=7):
    B = logits.shape[0]
    return tsamp.sample_per_row(logits, seed, uids, positions, temps,
                                top_ks or [0] * B, top_ps or [1.0] * B)


def test_greedy_rows_take_the_exact_argmax():
    logits = torch.from_numpy(np.random.default_rng(1).normal(size=(5, 40)).astype(np.float32))
    logits[2, 7] = logits[2, 30] = logits[2].max() + 1  # a tie: the first index wins
    temps = [0.0, 1.0, 0.0, 0.5, -1.0]
    got = _draw(logits, list(range(5)), [3] * 5, temps)
    want = logits.argmax(dim=-1)
    for b in (0, 2, 4):
        assert got[b].item() == want[b].item()
    assert got[2].item() == 7
    assert torch.equal(_draw(logits, list(range(5)), [3] * 5, [0.0] * 5), want)


def test_determinism_and_independence_from_the_batch():
    rng = np.random.default_rng(2)
    row = torch.from_numpy(rng.normal(size=(1, 50)).astype(np.float32))
    alone = [_draw(row, [42], [p], [1.0]).item() for p in range(20)]
    assert alone == [_draw(row, [42], [p], [1.0]).item() for p in range(20)]
    assert len(set(alone)) > 3  # positions key different draws
    others = torch.from_numpy(rng.normal(size=(3, 50)).astype(np.float32))
    for p in range(20):
        batch = torch.cat([others[:2], row, others[2:]])
        got = _draw(batch, [5, 9, 42, 1], [p + 3, 0, p, p], [0.9, 1.0, 1.0, 0.0])
        assert got[2].item() == alone[p]
    assert _draw(row, [42], [0], [1.0], seed=8).item() != alone[0] or \
        _draw(row, [42], [1], [1.0], seed=8).item() != alone[1]


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (6, 1.0), (0, 0.8)])
def test_chi_square_against_softmax_of_filtered(top_k, top_p):
    V, N = 16, 4000
    logits = torch.from_numpy(np.random.default_rng(3).normal(size=(1, V)).astype(np.float32))
    flt = tsamp.filtered_logits(logits, torch.tensor([0.9]), torch.tensor([top_k]),
                                torch.tensor([top_p]))
    probs = torch.softmax(flt, dim=-1)[0].double().numpy()
    batch = logits.expand(N, V)
    draws = tsamp.sample_per_row(batch, 123, list(range(N)), [17] * N, [0.9] * N,
                                 [top_k] * N, [top_p] * N).numpy()
    counts = np.bincount(draws, minlength=V)
    assert counts[probs == 0].sum() == 0  # nothing outside the kept set
    keep = probs > 0
    expected = N * probs[keep]
    chi2 = float(((counts[keep] - expected) ** 2 / expected).sum())
    # 99.9th percentile of chi-square with (kept - 1) <= 15 degrees of freedom
    assert chi2 < 37.7, (chi2, counts, expected)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tiny-llama-gqa")
    return cfg, random_ternary_params(cfg, seed=9, perm_mode="ssr", device="cpu")


def test_sampled_engine_independent_of_quantum_and_admission(tiny):
    """The same sampled requests (same uids) through engines that batch them
    differently and step them by 1 or 4 give the same tokens."""
    cfg, params = tiny
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 12, 3, 8)]
    scs = [tsamp.SamplingConfig(1.0, 0, 1.0), tsamp.SamplingConfig(0.7, 20, 0.9), None,
           tsamp.SamplingConfig(1.3, 0, 0.8)]
    outs = []
    for max_batch, quantum in ((1, 1), (4, 1), (2, 4), (3, 8)):
        eng = ServeEngine(cfg, params, max_batch=max_batch, max_len=64, seed=3,
                          decode_quantum=quantum)
        reqs = [eng.submit(p, 9, sampling=s) for p, s in zip(prompts, scs)]
        eng.run()
        outs.append([r.out for r in reqs])
    assert all(o == outs[0] for o in outs[1:])
    eng = ServeEngine(cfg, params, max_batch=2, max_len=64, seed=4)
    reqs = [eng.submit(p, 9, sampling=s) for p, s in zip(prompts, scs)]
    eng.run()
    assert [r.out for r in reqs][2] == outs[0][2]  # the greedy request ignores the seed
    assert [r.out for r in reqs] != outs[0]


def test_row_seed_keys_each_triple():
    seen = {tsamp.row_seed(s, u, p) for s in range(3) for u in range(5) for p in range(50)}
    assert len(seen) == 3 * 5 * 50
    assert all(0 <= x < 2**63 for x in seen)


def test_jax_sample_per_row_greedy_rows_agree():
    """Both packages give the exact argmax on greedy rows of the same logits."""
    logits = np.random.default_rng(5).normal(size=(4, 30)).astype(np.float32)
    temps = np.array([0.0, 0.0, 0.0, 0.0], np.float32)
    want = np.asarray(jsamp.sample_per_row(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.arange(4), jnp.zeros(4, jnp.int32),
        jnp.asarray(temps), jnp.zeros(4, jnp.int32), jnp.ones(4, jnp.float32)))
    got = _draw(torch.from_numpy(logits), [0, 1, 2, 3], [0] * 4, temps.tolist()).numpy()
    np.testing.assert_array_equal(got, want)

