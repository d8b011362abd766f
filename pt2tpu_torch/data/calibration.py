"""Calibration / evaluation token streams: counterpart of
``pt2tpu.data.calibration`` (numpy only, the same tokens for the same seed).

A corpus is tokenized once and ``num_samples`` seeded windows of ``seq_len``
tokens are drawn from it. Sources, tried in order:

  1. a local pre-tokenized ``.npy`` file, or a ``.txt`` file with a
     tokenizer;
  2. a named set ('wikitext' | 'c4' | 'ptb') through HuggingFace
     ``datasets``, if it is in the local cache;
  3. the deterministic synthetic Zipf stream, labelled as such in the
     provenance string.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

__all__ = ["get_token_stream", "sample_calibration_windows", "get_calibration_data"]


def _synthetic_stream(vocab_size: int, length: int, seed: int) -> np.ndarray:
    """Deterministic Zipf-distributed token stream with repeated phrases, so
    that Hessians are non-trivially correlated."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    toks = rng.choice(vocab_size, size=length, p=probs)
    n_phrases = max(1, length // 512)
    phrase = rng.choice(vocab_size, size=32, p=probs)
    for _ in range(n_phrases):
        pos = rng.integers(0, max(1, length - 32))
        toks[pos : pos + 32] = phrase
    return toks.astype(np.int32)


def get_token_stream(
    source: str,
    vocab_size: int,
    split: str = "train",
    min_length: int = 1 << 18,
    seed: int = 42,
    tokenizer=None,
) -> Tuple[np.ndarray, str]:
    """Resolve a token stream: ``source`` is a path (.npy / .txt), a
    dataset name ('wikitext' | 'c4' | 'ptb') or 'synthetic'. Returns
    (int32 tokens, provenance)."""
    if source.endswith(".npy") and os.path.exists(source):
        toks = np.load(source).astype(np.int32).reshape(-1)
        return toks, f"file:{source}"
    if source.endswith(".txt") and os.path.exists(source):
        if tokenizer is None:
            raise ValueError("text file source requires a tokenizer")
        with open(source, encoding="utf-8") as f:
            text = f.read()
        toks = np.asarray(tokenizer(text)["input_ids"], np.int32).reshape(-1)
        return toks, f"file:{source}"
    if source in ("wikitext", "c4", "ptb"):
        try:
            toks = _load_hf_dataset(source, split, tokenizer)
            return toks, f"hf:{source}/{split}"
        except Exception as e:  # not in the local cache: the synthetic stream, labelled
            sstate = f"hf-unavailable({type(e).__name__})"
    else:
        sstate = "requested"
    toks = _synthetic_stream(vocab_size, min_length, seed + (0 if split == "train" else 1))
    return toks, f"synthetic[{sstate}]"


def _load_hf_dataset(name: str, split: str, tokenizer) -> np.ndarray:
    """The reference's dataset recipe, from the local HuggingFace cache only."""
    from datasets import load_dataset  # type: ignore

    os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
    if name == "wikitext":
        ds = load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
        text = "\n\n".join(ds["text"])
    elif name == "c4":
        hf_split = "train" if split == "train" else "validation"
        ds = load_dataset("allenai/c4", "en", split=hf_split, streaming=True)
        ds = ds.take(1280 if split == "train" else 1000)
        text = "\n\n".join(item["text"] for item in ds)
    elif name == "ptb":
        ds = load_dataset("ptb_text_only", "penn_treebank", split=split)
        text = "\n\n".join(ds["sentence"])
    else:
        raise ValueError(name)
    if tokenizer is None:
        raise ValueError("HF dataset source requires a tokenizer")
    return np.asarray(tokenizer(text)["input_ids"], np.int32).reshape(-1)


def sample_calibration_windows(
    tokens: np.ndarray, num_samples: int, seq_len: int, seed: int = 42
) -> np.ndarray:
    """(num_samples, seq_len) windows at seeded uniform starts over
    [0, len - seq_len - 1] (a short stream is tiled first)."""
    rng = np.random.default_rng(seed)
    hi = len(tokens) - seq_len - 1
    if hi <= 0:
        reps = -(-(seq_len + 2) // len(tokens))
        tokens = np.tile(tokens, reps)
        hi = len(tokens) - seq_len - 1
    starts = rng.integers(0, hi, size=num_samples)
    return np.stack([tokens[s : s + seq_len] for s in starts]).astype(np.int32)


def get_calibration_data(
    source: str,
    vocab_size: int,
    num_samples: int = 128,
    seq_len: int = 2048,
    seed: int = 42,
    tokenizer=None,
) -> Tuple[np.ndarray, str]:
    """Stream, then seeded windows (defaults: 128 x 2048, seed 42)."""
    toks, prov = get_token_stream(source, vocab_size, split="train", seed=seed, tokenizer=tokenizer)
    return sample_calibration_windows(toks, num_samples, seq_len, seed), prov
