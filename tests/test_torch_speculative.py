"""The port's speculative decoding (``serve/speculative.py``) and the engine's
windowed per-row forward against the JAX package (CPU, f32 dense weights
carried across from JAX).

  * ``speculative_generate`` at k 1 / 3 / 4 gives JAX's tokens, which are
    ``greedy_generate``'s, and JAX's acceptance counters; with an int8
    target cache too; a perfect draft accepts every drafted token; a
    sliding-window family (gemma3) through the verify; JAX's refusals.
  * ``engine._rows_forward`` over windows of k + 1 tokens at per-row
    positions (the speculative verify: one additive (B, 1, Lw, M) mask) gives
    JAX's f32 logits and cache, ALiBi's bias included.
  * ``cli generate --draft`` prints JAX's ids and ``speculative:
    SpecStats(...)`` on stderr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu import cli as jcli
from pt2tpu.models import decoder as jdec
from pt2tpu.models import registry as jreg
from pt2tpu.serve import engine as jeng
from pt2tpu.serve import greedy_generate as jgreedy
from pt2tpu.serve.kvcache import init_cache as jinit_cache
from pt2tpu.serve.speculative import speculative_generate as jspec
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu_torch import cli as tcli
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.serve import engine as teng
from pt2tpu_torch.serve.generate import greedy_generate
from pt2tpu_torch.serve.kvcache import init_cache
from pt2tpu_torch.serve.speculative import SpecStats, speculative_generate
from pt2tpu_torch.utils.checkpoint import params_from_numpy

LOGIT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(tree):
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    return params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")


@pytest.fixture(scope="module")
def models():
    """tiny-llama (JAX's PRNGKey(0)) and a 1-layer draft (PRNGKey(7)), as
    JAX's test draws them, in both packages."""
    cfg_t = jreg.get_config("tiny-llama")
    params_t = jdec.init_params(cfg_t, jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg_d = cfg_t.with_(n_layers=1)
    params_d = jdec.init_params(cfg_d, jax.random.PRNGKey(7), dtype=jnp.float32)
    port = (get_config("tiny-llama"), to_port(params_t),
            get_config("tiny-llama").with_(n_layers=1), to_port(params_d))
    return (cfg_t, params_t, cfg_d, params_d), port


def prompt_of(vocab, n, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(np.int32)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_speculative_equals_jax_and_greedy(models, k, kv_quant):
    (jt, jpt, jd, jpd), (tt, tpt, td, tpd) = models
    prompt = prompt_of(jt.vocab_size, 5)
    want, jstats = jspec(jt, jpt, jd, jpd, jnp.asarray(prompt), max_new=12, k=k, max_len=64,
                         kv_quant=kv_quant)
    want = np.asarray(want)
    greedy = np.asarray(jgreedy(jt, jpt, jnp.asarray(prompt), max_new=12, max_len=64,
                                kv_quant=kv_quant))
    np.testing.assert_array_equal(want, greedy)
    got, stats = speculative_generate(tt, tpt, td, tpd, torch.from_numpy(prompt), max_new=12,
                                      k=k, max_len=64, kv_quant=kv_quant)
    assert got.dtype == torch.int32 and got.shape == (1, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (stats.rounds, stats.drafted, stats.accepted) == (
        jstats.rounds, jstats.drafted, jstats.accepted)
    assert stats.drafted == stats.rounds * k


def test_speculative_perfect_draft_accepts_every_draft(models):
    _, (tt, tpt, _, _) = models
    prompt = torch.from_numpy(prompt_of(tt.vocab_size, 4, seed=1))
    want = greedy_generate(tt, tpt, prompt, 9, max_len=64)
    got, stats = speculative_generate(tt, tpt, tt, tpt, prompt, max_new=9, k=4, max_len=64)
    assert torch.equal(got, want)
    assert stats.accepted == stats.drafted and stats.acceptance_rate == 1.0
    assert stats.rounds == 2  # 1 + 5 + 5 tokens >= 9: two rounds, not 8 steps


def test_speculative_sliding_family_equals_jax():
    jt = jreg.get_config("tiny-gemma3")
    jpt = jdec.init_params(jt, jax.random.PRNGKey(2), dtype=jnp.float32)
    jd = jt.with_(n_layers=2)
    jpd = jdec.init_params(jd, jax.random.PRNGKey(3), dtype=jnp.float32)
    prompt = prompt_of(jt.vocab_size, 6, seed=2)
    want = np.asarray(jgreedy(jt, jpt, jnp.asarray(prompt), max_new=8, max_len=64))
    cfg = get_config("tiny-gemma3")
    got, _ = speculative_generate(cfg, to_port(jpt), cfg.with_(n_layers=2), to_port(jpd),
                                  torch.from_numpy(prompt), max_new=8, k=3, max_len=64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_speculative_refusals_are_jax(models):
    (jt, jpt, jd, jpd), (tt, tpt, td, tpd) = models
    cases = [
        (dict(prompt=np.zeros((2, 4), np.int32), max_new=4), "single-sequence"),
        (dict(prompt=np.zeros((1, 4), np.int32), max_new=60, max_len=64), "exceeds max_len"),
    ]
    for kw, msg in cases:
        p = kw.pop("prompt")
        with pytest.raises(ValueError, match=msg):
            jspec(jt, jpt, jd, jpd, jnp.asarray(p), **kw)
        with pytest.raises(ValueError, match=msg):
            speculative_generate(tt, tpt, td, tpd, torch.from_numpy(p), **kw)
    other = td.with_(vocab_size=td.vocab_size + 1)
    with pytest.raises(ValueError, match="share a vocabulary"):
        speculative_generate(tt, tpt, other, tpd, torch.zeros((1, 4), dtype=torch.long), 4)
    assert repr(SpecStats(3, 12, 6)) == repr(jax_stats(3, 12, 6))


def jax_stats(*a):
    from pt2tpu.serve.speculative import SpecStats as J

    return J(*a)


# (family, k): windows of k + 1 tokens; tiny-bloom puts ALiBi's bias on the mask
WINDOWS = [("tiny-llama", 3), ("tiny-llama-gqa", 4), ("tiny-bloom", 2)]


@pytest.mark.parametrize("name,k", WINDOWS)
def test_rows_forward_windows_equal_jax(name, k):
    """Two windowed forwards in a row over a 2-slot pool: rows at positions
    (0, 0) then (k + 1, 3): f32 logits within 1e-4 of JAX's, the cache the
    same."""
    jcfg = jreg.get_config(name)
    params = jdec.init_params(jcfg, jax.random.PRNGKey(4), dtype=jnp.float32)
    tparams = to_port(params)
    cfg = get_config(name)
    rng = np.random.default_rng(5)
    jc = jinit_cache(jcfg, 2, 32)
    tc = init_cache(cfg, 2, 32, device="cpu")
    for pos in ((0, 0), (k + 1, 3)):
        toks = rng.integers(0, jcfg.vocab_size, (2, k + 1)).astype(np.int32)
        want, jc = jeng._rows_forward(jcfg, params, jnp.asarray(toks), jc,
                                      jnp.asarray(pos, jnp.int32))
        got = teng._rows_forward(cfg, tparams, torch.from_numpy(toks).long(), tc,
                                 torch.tensor(pos))
        assert got.shape == (2, k + 1, jcfg.vocab_size)
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= LOGIT_TOL * np.abs(want).max()
    np.testing.assert_allclose(tc.k.float().numpy(), np.asarray(jc.k, np.float32), atol=1e-2)


def test_cli_generate_draft_prints_jax_ids(tmp_path, capsys):
    cfg = jreg.get_config("tiny-llama")
    params = jdec.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    draft = jdec.init_params(cfg.with_(n_layers=1), jax.random.PRNGKey(7), dtype=jnp.float32)
    jckpt.save_model(str(tmp_path / "t"), cfg, params)
    jckpt.save_model(str(tmp_path / "d"), cfg.with_(n_layers=1), draft)
    argv = ["generate", "--model", str(tmp_path / "t"), "--prompt-ids", "9,1,44,7,3",
            "--max-new", "10", "--draft", str(tmp_path / "d"), "--spec-k", "3"]
    jcli.main(argv)
    jout = capsys.readouterr()
    tcli.main(argv + ["--device", "cpu"])
    tout = capsys.readouterr()
    assert tout.out.strip().splitlines()[-1] == jout.out.strip().splitlines()[-1]
    assert "speculative: SpecStats(" in tout.err
    assert tout.err.strip().splitlines()[-1] == jout.err.strip().splitlines()[-1]
    with pytest.raises(SystemExit, match="greedy-only"):
        tcli.main(argv + ["--device", "cpu", "--temperature", "0.7"])
