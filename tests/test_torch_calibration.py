"""The port's token streams and perplexity protocol
(``pt2tpu_torch.data``) against ``pt2tpu.data``: the synthetic stream, the
calibration windows and a file stream give JAX's tokens exactly; the
provenance strings are JAX's; window_nll / evaluate_perplexity on the same
dense tiny-llama weights agree within 1e-5 relative (f32 forward)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.data import calibration as jcal
from pt2tpu.data import evaluate as jev
from pt2tpu.models import decoder as jdec
from pt2tpu.models import registry as jreg
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu_torch.data import calibration as tcal
from pt2tpu_torch.data import evaluate as tev
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.utils.checkpoint import params_from_numpy


@pytest.mark.parametrize("vocab,length,seed", [(256, 4096, 0), (32000, 1 << 14, 42), (7, 600, 3)])
def test_synthetic_stream_is_jax_tokens(vocab, length, seed):
    got = tcal._synthetic_stream(vocab, length, seed)
    want = jcal._synthetic_stream(vocab, length, seed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("source", ["synthetic", "random-name"])
def test_token_stream_and_provenance(source, split):
    """The synthetic stream, test split seeded one further; named sets
    (wikitext, c4, ptb) need a local HuggingFace cache and stay untested
    here, as in the JAX package's tests."""
    got, prov = tcal.get_token_stream(source, 256, split=split, min_length=4096, seed=7)
    want, jprov = jcal.get_token_stream(source, 256, split=split, min_length=4096, seed=7)
    np.testing.assert_array_equal(got, want)
    assert prov == jprov and prov.startswith("synthetic[")


def test_file_streams(tmp_path):
    toks = np.random.default_rng(1).integers(0, 100, 3000)
    np.save(tmp_path / "t.npy", toks)
    got, prov = tcal.get_token_stream(str(tmp_path / "t.npy"), 100)
    assert prov == f"file:{tmp_path / 't.npy'}"
    np.testing.assert_array_equal(got, jcal.get_token_stream(str(tmp_path / "t.npy"), 100)[0])
    (tmp_path / "c.txt").write_text("a b c")

    def tok(text):
        return {"input_ids": [len(w) for w in text.split()]}

    got, prov = tcal.get_token_stream(str(tmp_path / "c.txt"), 100, tokenizer=tok)
    assert got.tolist() == [1, 1, 1] and prov.startswith("file:")
    with pytest.raises(ValueError, match="tokenizer"):
        tcal.get_token_stream(str(tmp_path / "c.txt"), 100)


@pytest.mark.parametrize("n,L,seed", [(8, 64, 0), (3, 500, 9), (4, 40, 1)])
def test_calibration_windows_are_jax_windows(n, L, seed):
    short = np.arange(30, dtype=np.int32)  # tiled first when shorter than a window
    for toks in (tcal._synthetic_stream(256, 5000, seed), short):
        np.testing.assert_array_equal(tcal.sample_calibration_windows(toks, n, L, seed),
                                      jcal.sample_calibration_windows(toks, n, L, seed))
    got, prov = tcal.get_calibration_data("synthetic", 256, num_samples=n, seq_len=L, seed=seed)
    want, jprov = jcal.get_calibration_data("synthetic", 256, num_samples=n, seq_len=L, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert prov == jprov


def test_perplexity_matches_jax():
    jcfg = jreg.get_config("tiny-llama")
    jp = jdec.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    flat, structure = {}, {}
    jckpt._flatten("", jp, flat, structure)
    tp = params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")
    stream = tcal._synthetic_stream(256, 700, 5)
    got = tev.evaluate_perplexity(get_config("tiny-llama"), tp, stream, seq_len=64, batch_size=4,
                                  max_windows=9)
    want = jev.evaluate_perplexity(jcfg, jp, stream, seq_len=64, batch_size=4, max_windows=9)
    assert got["tokens"] == want["tokens"] == 9 * 63
    assert abs(got["nll_per_token"] - want["nll_per_token"]) <= 1e-5 * want["nll_per_token"]
    assert abs(got["ppl"] - want["ppl"]) <= 1e-5 * want["ppl"]
    nll, cnt = tev.window_nll(get_config("tiny-llama"), tp, torch.from_numpy(stream[:128].reshape(2, 64)))
    jnll, jcnt = jev.window_nll(jcfg, jp, jnp.asarray(stream[:128].reshape(2, 64)))
    assert cnt == jcnt == 126 and abs(float(nll) - float(jnll)) <= 1e-5 * float(jnll)
    with pytest.raises(ValueError, match="seq_len"):
        tev.evaluate_perplexity(get_config("tiny-llama"), tp, stream[:10], seq_len=64, max_windows=0)
