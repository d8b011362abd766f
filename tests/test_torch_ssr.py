"""The port's SSR (``pt2tpu_torch.core.ssr``) against ``pt2tpu.core.ssr`` on
the same numpy inputs, f32 on the CPU: similarity scores within 1e-6 of
their scale, and the same block picks, ties and a last partial block
included (``jax.lax.top_k`` puts the lower index first on equal scores; the
port's stable descending sort does the same)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.core import ssr as js
from pt2tpu_torch.core import ssr as ts


def _W(seed, n=32, m=200):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, m)) + rng.normal(size=(n, 1))).astype(np.float32)


def test_similarity_to_mean():
    W = _W(0)
    avail = np.random.default_rng(1).random(200) < 0.6
    got = ts.similarity_to_mean(torch.from_numpy(W), torch.from_numpy(avail)).numpy()
    want = np.asarray(js.similarity_to_mean(jnp.asarray(W), jnp.asarray(avail)))
    assert np.array_equal(np.isinf(got), ~avail) and np.array_equal(np.isinf(want), ~avail)
    np.testing.assert_allclose(got[avail], want[avail], atol=1e-6)
    full = ts.similarity_to_mean(torch.from_numpy(W)).numpy()
    np.testing.assert_allclose(full, np.asarray(js.similarity_to_mean(jnp.asarray(W))), atol=1e-6)


def _walk(select, W, bs, to):
    """Every block of a whole SSR pass: (indices, lane_valid) per step."""
    m = W.shape[1]
    avail = to(np.ones(m, bool))
    out = []
    for _ in range(-(-m // bs)):
        idx, valid, avail = select(to(W), avail, bs)
        out.append((np.asarray(idx).astype(np.int64), np.asarray(valid)))
    return out


@pytest.mark.parametrize("bs", [64, 128])
def test_select_block_walks_like_jax(bs):
    """A whole pass over m = 200 columns: the same indices per block, the
    last block partial (its extra lanes invalid, on the same columns)."""
    W = _W(2)
    got = _walk(ts.select_block, W, bs, torch.from_numpy)
    want = _walk(js.select_block, W, bs, jnp.asarray)
    for (gi, gv), (wi, wv) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)
    assert not got[-1][1].all() and got[-1][1].sum() == 200 - (len(got) - 1) * bs
    cover = np.concatenate([i[v] for i, v in got])
    assert sorted(cover.tolist()) == list(range(200))


def test_select_block_ties_take_the_lower_index():
    """Duplicated columns score the same: the lower index comes first."""
    W = _W(3, m=64)
    W[:, 40] = W[:, 7]
    W[:, 50] = W[:, 7]
    W[:, 9] = W[:, 30]
    sims = ts.similarity_to_mean(torch.from_numpy(W)).numpy()
    assert sims[7] == sims[40] == sims[50] and sims[9] == sims[30]
    for bs in (5, 20, 64):
        idx, valid, _ = ts.select_block(torch.from_numpy(W), torch.ones(64, dtype=torch.bool), bs)
        jidx, jvalid, _ = js.select_block(jnp.asarray(W), jnp.ones(64, bool), bs)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        order = list(idx.numpy())
        for a, b in ((7, 40), (40, 50), (9, 30)):
            if a in order and b in order:
                assert order.index(a) < order.index(b)


def test_static_reorder_indices_and_permutations():
    W = _W(4, n=16, m=48)
    got = ts.static_reorder_indices(torch.from_numpy(W)).numpy()
    np.testing.assert_array_equal(got, np.asarray(js.static_reorder_indices(jnp.asarray(W))))
    perm = torch.from_numpy(got)
    np.testing.assert_array_equal(ts.apply_permutation(torch.from_numpy(W), perm).numpy(),
                                  np.asarray(js.apply_permutation(jnp.asarray(W), jnp.asarray(got))))
    X = np.random.default_rng(5).normal(size=(2, 3, 48)).astype(np.float32)
    np.testing.assert_array_equal(
        ts.apply_permutation_to_input(torch.from_numpy(X), perm).numpy(),
        np.asarray(js.apply_permutation_to_input(jnp.asarray(X), jnp.asarray(got))))
    np.testing.assert_allclose(ts.cosine_similarity_matrix(torch.from_numpy(W)).numpy(),
                               np.asarray(js.cosine_similarity_matrix(jnp.asarray(W))), atol=1e-6)


@pytest.mark.parametrize("bs", [16, 48, 50])
def test_block_variance(bs):
    W = _W(6, n=8, m=100)
    np.testing.assert_allclose(ts.block_variance(torch.from_numpy(W), bs).numpy(),
                               np.asarray(js.block_variance(jnp.asarray(W), bs)), rtol=1e-5)
