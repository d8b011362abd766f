"""Random ternary-quantized model params, made directly on the device.

Counterpart of ``pt2tpu.utils.randmodel``: the same layout, shapes and
scale statistics, drawn from a ``torch.Generator`` (so not the JAX
package's numbers). No 7B artifact ships with the repo; benchmarks and the
chip smoke build their model this way.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..models.common import DenseLinear
from ..models.decoder import ModelConfig, check_supported, stack_layers
from ..ops.gather import make_packed_gather
from ..ops.ternary_matmul import PackedTernaryLinear, make_packed_linear
from ..quant.fold import pad_gateup_blocks
from .device import resolve_device

__all__ = ["random_ternary_linear", "random_ternary_params", "default_perm_mode"]


def random_ternary_linear(
    gen: torch.Generator,
    out_features: int,
    in_features: int,
    bias: bool = False,
    perm_mode: str = "identity",  # "identity" | "ssr" | "folded"
    device=None,
) -> PackedTernaryLinear:
    """One packed layer with random codes and plausible scales. ``gen`` must
    live on ``device``. "ssr" draws a random permutation and attaches its
    packed gather (what the fold emits for qkv/o/gateup); "folded" marks the
    layer input_folded (what the fold emits for down)."""
    if perm_mode not in ("identity", "ssr", "folded"):
        raise ValueError(f"unknown perm_mode {perm_mode!r}")
    dev = resolve_device(device)
    bs = min(128, in_features)
    while in_features % bs != 0 and bs > 4:
        bs //= 2
    nb = in_features // bs
    K = nb * bs
    codes = torch.randint(-1, 2, (out_features, K), generator=gen, device=dev, dtype=torch.int8)
    scale = 1.0 / math.sqrt(in_features)
    alpha = scale * (0.8 + 0.4 * torch.rand((nb, out_features), generator=gen, device=dev))
    mu = 0.02 * scale * torch.randn((nb, out_features), generator=gen, device=dev)
    if perm_mode == "ssr":
        perm = torch.randperm(in_features, generator=gen, device=dev).to(torch.int32)
        perm = F.pad(perm, (0, K - in_features), value=in_features)
    else:
        perm = torch.arange(K, dtype=torch.int32, device=dev)
    p = make_packed_linear(
        codes=codes,
        alpha=alpha,
        mu=mu,
        perm=perm,
        bias=torch.zeros((out_features,), dtype=torch.float32, device=dev) if bias else None,
        in_features=in_features,
        block_size=bs,
    )
    if perm_mode == "ssr":
        p = dataclasses.replace(
            p, gather=make_packed_gather(p.perm, in_features), identity_perm=False
        )
    elif perm_mode == "folded":
        p.input_folded = True
    return p


def default_perm_mode(cfg: ModelConfig) -> str:
    """The layout the quantizer's default ssr_scope="auto" emits for this
    width: SSR on down only from dim 640 up, full SSR below."""
    return "down" if cfg.dim >= 640 else "ssr"


def random_ternary_params(
    cfg: ModelConfig,
    seed: int = 0,
    perm_mode: str = "identity",  # "identity" | "ssr" | "down"
    device=None,
):
    """Full decoder params with every projection pre-ternarized, in the fused
    production layout (qkv / o / gateup / down), bf16 dense parts, bf16
    scales, 128-lane scale blocks.

    ``perm_mode="ssr"`` is the post-fold layout of a full-SSR model (what the
    quantizer emits below dim 640, or at any width with ssr_scope="all"):
    qkv/o/gateup carry packed gathers, down is input_folded.
    ``perm_mode="down"`` is what it emits at dim >= 640: identity perms on
    qkv/o/gateup, down input_folded. Gateup is padded by
    :func:`pad_gateup_blocks`; an ungated MLP (opt, gpt2, bloom) has ``up``
    in its place. Embedding, learned positions and lm_head are dense; with
    tied embeddings lm_head is None. Norm weights are ones, LayerNorm biases
    and linear biases zeros (gemma's norm adds its 1 + at the norm, as the
    JAX package does); the layout of each family is the JAX package's:
    qk-norm weights, sandwich norms, the embedding norm.
    """
    check_supported(cfg)
    if perm_mode not in ("identity", "ssr", "down"):
        raise ValueError(f"unknown perm_mode {perm_mode!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = torch.bfloat16
    H, Hkv, hd, D, I = cfg.n_heads, cfg.kv_heads, cfg.hd, cfg.dim, cfg.intermediate
    qbias = cfg.linear_bias or cfg.qkv_bias
    ones = lambda n=D: torch.ones((n,), dtype=dtype, device=dev)  # noqa: E731
    zeros = lambda: torch.zeros((D,), dtype=dtype, device=dev)  # noqa: E731
    layernorm = cfg.norm == "layernorm"
    params = {
        "embed": (torch.randn((cfg.vocab_size, D), generator=gen, device=dev) * 0.02).to(dtype),
        "emb_ln_w": ones() if cfg.embed_norm else None,
        "emb_ln_b": zeros() if (cfg.embed_norm and layernorm) else None,
        "pos_embed": None,
        "lnf_w": ones(),
        "lnf_b": zeros() if layernorm else None,
        "lm_head": None if cfg.tie_embeddings else DenseLinear(
            w=(torch.randn((cfg.vocab_size, D), generator=gen, device=dev) / D**0.5).to(dtype),
        ),
    }
    if cfg.pos == "learned":  # drawn after the head: other families keep their numbers
        params["pos_embed"] = (torch.randn((cfg.max_seq_len + cfg.pos_offset, D), generator=gen,
                                           device=dev) * 0.02).to(dtype)
    shapes = {
        "qkv": ((H + 2 * Hkv) * hd, D, qbias),
        "o": (D, H * hd, cfg.linear_bias),
        "down": (D, I, cfg.linear_bias),
    }
    if cfg.gated_mlp:
        shapes["gateup"] = (2 * I, D, cfg.linear_bias)
    else:
        shapes["up"] = (I, D, cfg.linear_bias)
    layers = []
    for _ in range(cfg.n_layers):
        lp = {
            "ln1_w": ones(),
            "ln1_b": zeros() if layernorm else None,
            "ln2_w": ones(),
            "ln2_b": zeros() if layernorm else None,
            "q_norm_w": ones(hd) if cfg.qk_norm else None,
            "k_norm_w": ones(hd) if cfg.qk_norm else None,
            "post_attn_w": ones() if cfg.sandwich_norm else None,
            "post_mlp_w": ones() if cfg.sandwich_norm else None,
        }
        for name, (o, i, has_bias) in sorted(shapes.items()):
            pm = "identity"
            if perm_mode in ("ssr", "down"):
                pm = "folded" if name == "down" else ("ssr" if perm_mode == "ssr" else "identity")
            lp[name] = random_ternary_linear(gen, o, i, has_bias, perm_mode=pm, device=dev)
        layers.append(pad_gateup_blocks(lp))
    params["layers"] = stack_layers(layers)
    return params
