"""Architecture configs of the families the port serves: the llama and gemma
(v1) entries of ``pt2tpu.models.registry``."""

from __future__ import annotations

from typing import Dict

from .decoder import ModelConfig

__all__ = ["get_config", "CONFIGS"]


def _llama(name, dim, n_layers, n_heads, inter, n_kv=None, vocab=32000, **kw):
    return ModelConfig(
        family=name,
        vocab_size=vocab,
        dim=dim,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        intermediate=inter,
        norm="rmsnorm",
        pos="rope",
        act="silu",
        gated_mlp=True,
        **kw,
    )


def _gemma(dim, n_layers, n_heads, inter, head_dim, vocab=256000, **kw):
    return ModelConfig(
        family="gemma",
        vocab_size=vocab,
        dim=dim,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=kw.pop("n_kv", n_heads),
        head_dim=head_dim,
        intermediate=inter,
        norm="rmsnorm",
        norm_plus_one=True,  # gemma's rmsnorm scales by (1 + w)
        pos="rope",
        act="gelu",  # GeGLU, gelu in its tanh form
        gated_mlp=True,
        embed_scale=float(dim) ** 0.5,
        tie_embeddings=True,
        **kw,
    )


CONFIGS: Dict[str, ModelConfig] = {
    "llama-2-7b": _llama("llama2", 4096, 32, 32, 11008),
    "llama-2-13b": _llama("llama2", 5120, 40, 40, 13824),
    "llama-3-8b": _llama(
        "llama3", 4096, 32, 32, 14336, n_kv=8, vocab=128256, rope_theta=500000.0
    ),
    "gemma-2b": _gemma(2048, 18, 8, 16384, head_dim=256, n_kv=1),
    "tiny-llama": _llama("llama2", 64, 2, 4, 128, vocab=256, max_seq_len=128),
    "tiny-gemma": _gemma(64, 2, 4, 128, head_dim=32, vocab=256, max_seq_len=128, n_kv=2),
    "tiny-llama-gqa": _llama(
        "llama2", 64, 2, 4, 128, n_kv=2, vocab=256, max_seq_len=128
    ),
}


def get_config(name: str) -> ModelConfig:
    if name in CONFIGS:
        return CONFIGS[name]
    raise KeyError(f"unknown model config '{name}'; known: {sorted(CONFIGS)}")
