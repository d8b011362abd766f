"""Model registry: family inference from a name and the architecture configs
of every family the port computes, the entries of ``pt2tpu.models.registry``
field for field (llama, qwen2, qwen3, gemma v1, gemma3, opt, gpt2, bloom, and
the mixture-of-experts mixtral and qwen3-moe)."""

from __future__ import annotations

from typing import Dict

from .decoder import ModelConfig

__all__ = ["get_model_type", "get_config", "CONFIGS"]


def get_model_type(model_name: str) -> str:
    """The model family a checkpoint's name implies (the JAX package's rule)."""
    s = model_name.lower()
    if "gemma-3" in s or "gemma3" in s:
        return "gemma3"
    # "gemma-2-9b" / "gemma-2-2b" are v2; "gemma-2b" / "gemma-7b" are v1
    if "gemma-2-" in s or s.endswith("gemma-2") or "gemma2" in s:
        return "gemma2"
    if "gemma" in s:
        return "gemma"
    if "mixtral" in s:
        return "mixtral"
    if "llama-3" in s or "llama3" in s:
        return "llama3"
    if "llama-2" in s or "llama2" in s:
        return "llama2"
    if "llama" in s:
        return "llama"
    if "qwen3" in s:
        return "qwen3"
    if "qwen" in s:
        return "qwen"
    if "opt" in s:
        return "opt"
    if "bloom" in s:
        return "bloom"
    if "gpt2" in s or "gpt-2" in s:
        return "gpt2"
    return "llama"


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


def _opt(dim, n_layers, n_heads, inter, vocab=50272, **kw):
    return ModelConfig(
        family="opt",
        vocab_size=vocab,
        dim=dim,
        n_layers=n_layers,
        n_heads=n_heads,
        intermediate=inter,
        norm="layernorm",
        pos="learned",
        pos_offset=2,
        act="relu",
        gated_mlp=False,
        linear_bias=True,
        tie_embeddings=True,  # OPT ties lm_head to embed_tokens
        **kw,
    )


def _gpt2(dim, n_layers, n_heads, vocab=50257, **kw):
    kw.setdefault("max_seq_len", 1024)
    return ModelConfig(
        family="gpt2",
        vocab_size=vocab,
        dim=dim,
        n_layers=n_layers,
        n_heads=n_heads,
        intermediate=4 * dim,
        norm="layernorm",
        pos="learned",
        act="gelu",
        gated_mlp=False,
        linear_bias=True,
        tie_embeddings=True,
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


def _qwen3(dim, n_layers, n_heads, inter, n_kv, head_dim, vocab=151936, **kw):
    kw.setdefault("rope_theta", 1000000.0)
    return ModelConfig(
        family="qwen3",
        vocab_size=vocab,
        dim=dim,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        intermediate=inter,
        norm="rmsnorm",
        norm_eps=1e-6,
        pos="rope",
        act="silu",
        gated_mlp=True,
        qk_norm=True,
        **kw,
    )


def _gemma3(dim, n_layers, n_heads, inter, head_dim, n_kv, vocab=262144,
            sliding_window=1024, pattern=6, **kw):
    kw.setdefault("rope_theta", 1000000.0)
    return ModelConfig(
        family="gemma3",
        vocab_size=vocab,
        dim=dim,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        intermediate=inter,
        norm="rmsnorm",
        norm_eps=1e-6,
        norm_plus_one=True,
        pos="rope",
        act="gelu",
        gated_mlp=True,
        embed_scale=float(dim) ** 0.5,
        tie_embeddings=True,
        qk_norm=True,
        sandwich_norm=True,
        sliding_window=sliding_window,
        layer_globals=tuple((i + 1) % pattern == 0 for i in range(n_layers)),
        rope_local_theta=10000.0,
        attn_scale=float(head_dim) ** -0.5,
        **kw,
    )


def _bloom(dim, n_layers, n_heads, vocab=250880, **kw):
    return ModelConfig(
        family="bloom",
        vocab_size=vocab,
        dim=dim,
        n_layers=n_layers,
        n_heads=n_heads,
        intermediate=4 * dim,
        norm="layernorm",
        pos="alibi",
        act="gelu",
        gated_mlp=False,
        linear_bias=True,
        embed_norm=True,  # bloom layernorms the embedding output
        tie_embeddings=True,
        **kw,
    )


CONFIGS: Dict[str, ModelConfig] = {
    "opt-125m": _opt(768, 12, 12, 3072),
    "opt-1.3b": _opt(2048, 24, 32, 8192),
    "gpt2-xl": _gpt2(1600, 48, 25),
    "llama-2-7b": _llama("llama2", 4096, 32, 32, 11008),
    "llama-2-13b": _llama("llama2", 5120, 40, 40, 13824),
    "llama-2-70b": _llama("llama2", 8192, 80, 64, 28672, n_kv=8),
    "llama-3-8b": _llama(
        "llama3", 4096, 32, 32, 14336, n_kv=8, vocab=128256, rope_theta=500000.0
    ),
    "qwen2-7b": _llama(
        "qwen", 3584, 28, 28, 18944, n_kv=4, vocab=152064, qkv_bias=True,
        rope_theta=1000000.0,
    ),
    "gemma-2b": _gemma(2048, 18, 8, 16384, head_dim=256, n_kv=1),
    "qwen3-8b": _qwen3(4096, 36, 32, 12288, n_kv=8, head_dim=128),
    "gemma3-4b": _gemma3(2560, 34, 8, 10240, head_dim=256, n_kv=4, rope_scale=8.0),
    "bloom-560m": _bloom(1024, 24, 16),
    "mixtral-8x7b": _llama(
        "mixtral", 4096, 32, 32, 14336, n_kv=8, vocab=32000,
        rope_theta=1000000.0, n_experts=8, experts_per_token=2,
        max_seq_len=4096,
    ),
    "qwen3-30b-a3b": _qwen3(
        2048, 48, 32, 6144, n_kv=4, head_dim=128, n_experts=128,
        experts_per_token=8, moe_inter=768,
    ),
    "tiny-llama": _llama("llama2", 64, 2, 4, 128, vocab=256, max_seq_len=128),
    "tiny-gemma": _gemma(64, 2, 4, 128, head_dim=32, vocab=256, max_seq_len=128, n_kv=2),
    "tiny-bloom": _bloom(64, 2, 4, vocab=256, max_seq_len=128),
    "tiny-llama-gqa": _llama(
        "llama2", 64, 2, 4, 128, n_kv=2, vocab=256, max_seq_len=128
    ),
    "tiny-opt": _opt(64, 2, 4, 128, vocab=256, max_seq_len=128),
    "tiny-gpt2": _gpt2(64, 2, 4, vocab=256, max_seq_len=128),
    "tiny-qwen3": _qwen3(64, 2, 4, 128, n_kv=2, head_dim=16, vocab=256, max_seq_len=128),
    "tiny-gemma3": _gemma3(
        64, 4, 4, 128, head_dim=16, n_kv=2, vocab=256, max_seq_len=128,
        sliding_window=16, pattern=2,
    ),
    "tiny-moe": _llama(
        "mixtral", 64, 2, 4, 128, vocab=256, max_seq_len=128,
        n_experts=4, experts_per_token=2,
    ),
}


def get_config(name: str) -> ModelConfig:
    if name in CONFIGS:
        return CONFIGS[name]
    raise KeyError(f"unknown model config '{name}'; known: {sorted(CONFIGS)}")
