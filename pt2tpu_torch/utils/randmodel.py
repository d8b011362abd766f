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
from ..ops.gather import PackedGather, make_packed_gather
from ..ops.ternary_matmul import PackedTernaryLinear, make_packed_linear
from ..quant.fold import pad_gateup_blocks
from .device import resolve_device

__all__ = ["random_ternary_linear", "random_expert_stack", "random_ternary_params",
           "default_perm_mode"]


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
    bs = _block_size(in_features)
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


def _block_size(in_features: int) -> int:
    bs = min(128, in_features)
    while in_features % bs != 0 and bs > 4:
        bs //= 2
    return bs


# every byte of four codes u = T + 1 in {0, 1, 2} (core/packing.py's planes)
_PLANE_BYTES = [sum(((i // 3**p) % 3) << (2 * p) for p in range(4)) for i in range(81)]


def random_expert_stack(
    gen: torch.Generator,
    n_layers: int,
    n_experts: int,
    out_features: int,
    in_features: int,
    perm_mode: str = "identity",  # "identity" | "ssr" | "folded"
    out_folded: bool = False,
    device=None,
) -> PackedTernaryLinear:
    """One projection of every expert of every layer, as the quantizer
    stacks them: (n_layers, E, K/4, n) packed planes, (n_layers, E, nb, n)
    bf16 scales (the scale blocks padded to a multiple of 16 with zero
    scales, as :func:`make_packed_linear` pads), (n_layers, E, K) perms, no
    bias. The planes are drawn byte by byte (four uniform codes a byte), so
    a full-size model is made without its (n, K) code matrices. "ssr" draws a
    permutation per expert and attaches its packed gather (an expert's
    gate/up under full SSR); "folded" draws one and marks the layer
    input_folded (down, whose perm the fold moved into gate/up's output
    lanes, which are then ``out_folded``)."""
    if perm_mode not in ("identity", "ssr", "folded"):
        raise ValueError(f"unknown perm_mode {perm_mode!r}")
    dev = resolve_device(device)
    L, E, n, m = n_layers, n_experts, out_features, in_features
    bs = _block_size(m)
    nb = m // bs
    nbp = -(-nb // 16) * 16
    K = nbp * bs
    lut = torch.tensor(_PLANE_BYTES, dtype=torch.uint8, device=dev)
    packed = torch.full((L, E, K // 4, n), 0b01010101, dtype=torch.uint8, device=dev)  # T = 0
    alpha = torch.zeros((L, E, nbp, n), dtype=torch.bfloat16, device=dev)
    mu = torch.zeros((L, E, nbp, n), dtype=torch.bfloat16, device=dev)
    perm = torch.full((L, E, K), m, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(m)
    gathers = []
    for li in range(L):
        for e in range(E):
            idx = torch.randint(0, 81, (nb * bs // 4, n), generator=gen, device=dev)
            packed[li, e, : nb * bs // 4] = lut[idx]
            del idx
            alpha[li, e, :nb] = scale * (0.8 + 0.4 * torch.rand((nb, n), generator=gen, device=dev))
            mu[li, e, :nb] = 0.02 * scale * torch.randn((nb, n), generator=gen, device=dev)
            if perm_mode == "identity":
                perm[li, e, :m] = torch.arange(m, dtype=torch.int32, device=dev)
            else:
                perm[li, e, :m] = torch.randperm(m, generator=gen, device=dev).to(torch.int32)
            if perm_mode == "ssr":
                gathers.append(make_packed_gather(perm[li, e], m))
    gather = None
    if gathers:
        gather = PackedGather(
            packed=torch.stack([g.packed for g in gathers]).view(L, E, *gathers[0].packed.shape),
            perm=perm.clone(), in_features=m)
    return PackedTernaryLinear(
        packed=packed.view(torch.int8), alpha=alpha, mu=mu, perm=perm, bias=None,
        in_features=m, identity_perm=perm_mode == "identity", gather=gather,
        input_folded=perm_mode == "folded", out_folded=out_folded)


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

    A mixture-of-experts config gets, in place of the MLP, a bf16 router and
    the experts' gateup and down as (n_layers, E, ...) stacks
    (:func:`random_expert_stack`) in the layout that the quantizer and
    ``fold_moe_expert_perms`` emit: "ssr", gateup with a gather (K3 at decode
    rows) and its output lanes folded, down input_folded; "down", gateup
    with identity perms and its output lanes folded, down input_folded (K1
    only); "identity", neither. Experts are not padded (the MoE MLP splits
    gate/up at ``expert_inter``).
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
    }
    if not cfg.is_moe:
        shapes["down"] = (D, I, cfg.linear_bias)
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
    if cfg.is_moe:
        L, E, Ie = cfg.n_layers, cfg.n_experts, cfg.expert_inter
        fold = perm_mode != "identity"
        params["layers"]["router"] = DenseLinear(
            w=(torch.randn((L, E, D), generator=gen, device=dev) / D**0.5).to(dtype))
        params["layers"]["gateup"] = random_expert_stack(
            gen, L, E, 2 * Ie, D, "ssr" if perm_mode == "ssr" else "identity", out_folded=fold,
            device=dev)
        params["layers"]["down"] = random_expert_stack(
            gen, L, E, D, Ie, "folded" if fold else "identity", device=dev)
    return params
