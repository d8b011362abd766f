"""Model-level ternarization: sequential calibration + GPTQ. Counterpart of
``pt2tpu.quant.pipeline``.

  1. embed every calibration batch once;
  2. per decoder layer: run the dense layer with its activation taps, stream
     the taps into per-group Hessian accumulators (quant/hessian.py),
     quantize each group (quant/gptq.py), pack it
     (ops/ternary_matmul.pack_layer), fold the SSR perms (quant/fold.py),
     then rerun the layer with its quantized weights to give the next
     layer's inputs.

Each finished layer can be journaled (``journal_dir``) in the JAX package's
format, and a run resumes at the first layer not journaled, in either
package. Everything runs on the device the dense parameters lie on, with the
plain route (``impl="plain"``) as the JAX package's ``impl="xla"``, unless
``device`` names another: then the parameters stay where they are (a
host-resident checkpoint, ``hf_loader.load_hf_model(device="cpu")``) and go
to ``device`` one layer at a time, the non-layer leaves after the loop.
Mixture-of-experts layers quantize each expert from its routed Hessians
(the JAX package's rule): gate/up from rows w_te * x_t, down from expert e's
own f32 mid-activations times w_te, then fold expert by expert and stack
the experts into (E, ...) leaves.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models import decoder as dec
from ..models.common import DenseLinear, layer_norm, rms_norm
from ..ops.ternary_matmul import pack_layer
from ..utils.metrics import MetricsLogger, model_bits_per_weight
from .fold import fold_head_perm, fold_layer_perms, fold_moe_expert_perms, pad_gateup_blocks
from .gptq import dequantize_layer, ternary_gptq
from .hessian import HessianAccumulator, damped_inverse, full_f32

__all__ = ["QuantConfig", "quantize_model", "quantize_linear", "resolve_ssr_skip", "rel_out_err"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization hyperparameters, the JAX package's fields and defaults.

    ``ssr_scope``: "all" (SSR on every group, the reference's recipe),
    "down" (SSR only on the down projection, whose perm folds into gate/up's
    output lanes: no run-time gather), "auto" ("all" below dim 640, "down"
    from 640); ``ssr_skip`` names groups quantized without SSR in any scope.
    ``scale_dtype``: the packed scales' type (bf16, the only one the port's
    kernels take)."""

    block_size: int = 128
    percdamp: float = 0.01
    use_ssr: bool = True
    ssr_skip: Tuple[str, ...] = ()
    ssr_scope: str = "auto"
    use_aga: bool = True
    aga_mode: str = "exact"
    max_iter: int = 100
    scale_dtype: Any = torch.bfloat16
    batch_size: int = 8
    skip: Tuple[str, ...] = ()
    fuse_projections: bool = True
    fold_perms: bool = True
    quantize_lm_head: bool = False


# every group name except "down" (fused and unfused spellings)
_NON_DOWN_GROUPS = ("q", "k", "v", "qkv", "o", "gate", "up", "gateup")


def resolve_ssr_skip(qcfg: QuantConfig, dim: int) -> Tuple[str, ...]:
    """The effective ssr_skip for a model of width ``dim``."""
    scope = qcfg.ssr_scope
    if scope == "auto":
        scope = "all" if dim < 640 else "down"
    if scope == "all":
        return qcfg.ssr_skip
    if scope == "down":
        return tuple(sorted(set(qcfg.ssr_skip) | set(_NON_DOWN_GROUPS)))
    raise ValueError(f"ssr_scope must be all|down|auto, got {scope!r}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rel_out_err(W: torch.Tensor, W_hat: torch.Tensor, H: torch.Tensor) -> float:
    """Hessian-weighted relative output error tr(dW H dW^T) / tr(W H W^T),
    dW = W - W_hat, in f32."""
    dW = W - W_hat
    with full_f32():
        num = ((dW @ H) * dW).sum()
        den = torch.clamp_min(((W @ H) * W).sum(), 1e-12)
    return float(num / den)


def quantize_linear(
    lin: DenseLinear,
    H_acc: HessianAccumulator,
    qcfg: QuantConfig,
    use_ssr: Optional[bool] = None,
    log: Optional[MetricsLogger] = None,
    timing: Optional[Dict[str, float]] = None,
):
    """Quantize one projection from its accumulated Hessian (``use_ssr``
    overrides ``qcfg.use_ssr``). Returns (PackedTernaryLinear, stats):
    rel_out_err = tr(dW H dW^T) / tr(W H W^T), rel_w_err, w_kurt (the whole
    matrix's plain kurtosis, ~3 for Gaussian weights), nsamples. ``timing``,
    if given, receives the seconds of the damped inverse and of GPTQ."""
    if qcfg.scale_dtype not in (torch.bfloat16, "bfloat16"):
        raise NotImplementedError(f"scale_dtype {qcfg.scale_dtype}: the port packs bf16 scales")
    W = lin.w.float()
    dev = W.device
    H = H_acc.normalized().to(dev)
    t0 = time.perf_counter()
    _, H_inv = damped_inverse(H, qcfg.percdamp, log=log)
    _sync(dev)
    t1 = time.perf_counter()
    q = ternary_gptq(
        W, H, H_inv,
        block_size=qcfg.block_size,
        use_ssr=qcfg.use_ssr if use_ssr is None else use_ssr,
        use_aga=qcfg.use_aga,
        max_iter=qcfg.max_iter,
        aga_mode=qcfg.aga_mode,
    )
    _sync(dev)
    if timing is not None:
        timing["inverse_s"] = t1 - t0
        timing["gptq_s"] = time.perf_counter() - t1
    packed = pack_layer(q, in_features=W.shape[1], bias=lin.b)
    W_hat = dequantize_layer(q, W.shape[1])
    dW = W - W_hat
    rms = torch.sqrt(torch.clamp_min((W**2).mean(), 1e-24))
    kurt = float(((W / rms) ** 4).mean())
    stats = {
        "rel_out_err": rel_out_err(W, W_hat, H),
        "rel_w_err": float(torch.linalg.vector_norm(dW)
                           / torch.clamp_min(torch.linalg.vector_norm(W), 1e-12)),
        "w_kurt": round(kurt, 2),
        "nsamples": H_acc.nsamples,
    }
    if kurt > 5.0:
        print(
            f"warning: heavy-tailed weights (kurtosis {kurt:.1f} > 5; gaussian ~3): the "
            "ternary grid fits such rows poorly and per-layer rel_out_err will NOT show it; "
            "expect end-to-end quality loss (consider leaving this projection dense via "
            "QuantConfig.skip)",
            file=sys.stderr,
        )
    return packed, stats


def _tap_dims(cfg: dec.ModelConfig) -> Dict[str, int]:
    return {
        "attn_in": cfg.dim,
        "o_in": cfg.n_heads * cfg.hd,
        "mlp_in": cfg.dim,
        "down_in": cfg.intermediate,
    }


def _groups(cfg: dec.ModelConfig, qcfg: QuantConfig):
    """(group name, member projections, tap) in quantization order."""
    names = [n for n in dec.LINEAR_NAMES
             if (cfg.gated_mlp or n != "gate") and n not in qcfg.skip]
    fuse = qcfg.fuse_projections
    groups = []
    if fuse and all(n in names for n in ("q", "k", "v")):
        groups.append(("qkv", ("q", "k", "v"), "attn_in"))
    else:
        groups += [(n, (n,), dec.TAP_OF_LINEAR[n]) for n in ("q", "k", "v") if n in names]
    if "o" in names:
        groups.append(("o", ("o",), "o_in"))
    if fuse and cfg.gated_mlp and "gate" in names and "up" in names:
        groups.append(("gateup", ("gate", "up"), "mlp_in"))
    else:
        groups += [(n, (n,), dec.TAP_OF_LINEAR[n]) for n in ("gate", "up") if n in names]
    if "down" in names:
        groups.append(("down", ("down",), "down_in"))
    if cfg.is_moe:  # the experts take the routed per-expert path
        groups = [g for g in groups if g[0] in ("qkv", "q", "k", "v", "o")]
    return groups


def _expert_mid(cfg: dec.ModelConfig, gate_w: torch.Tensor, up_w: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Expert e's f32 mid-activations act(x @ gate^T) * (x @ up^T), the
    input of its down projection (recomputed per expert: taps of every
    expert's mid would multiply calibration memory by E)."""
    with full_f32():
        g = x.float() @ gate_w.t().float()
        u = x.float() @ up_w.t().float()
    return dec._act(cfg, g) * u


def _quantize_experts(cfg, lp, accs_gu, accs_dn, qcfg, ssr_skip, log, t_inv, t_gptq):
    """Each expert's concatenated gate/up and its down from their routed
    Hessians, folded expert by expert (``fold_moe_expert_perms``), then
    stacked: {"gateup" / "down": ((E, ...) packed leaves, the experts' mean
    stats)}. ``t_inv`` / ``t_gptq`` receive each call's seconds."""
    expert_lps, stats = [], {"gateup": [], "down": []}
    for e in range(cfg.n_experts):
        lin_gu = DenseLinear(w=torch.cat([lp["gate"].w[e], lp["up"].w[e]], dim=0))
        elp = {}
        for gname, lin, acc in (("gateup", lin_gu, accs_gu[e]),
                                ("down", DenseLinear(w=lp["down"].w[e]), accs_dn[e])):
            timing: Dict[str, float] = {}
            elp[gname], st = quantize_linear(lin, acc, qcfg,
                                             use_ssr=qcfg.use_ssr and gname not in ssr_skip,
                                             log=log, timing=timing)
            stats[gname].append(st)
            t_inv[f"{gname}[{e}]"], t_gptq[f"{gname}[{e}]"] = timing["inverse_s"], timing["gptq_s"]
        expert_lps.append(elp)
    if qcfg.fold_perms:
        expert_lps = fold_moe_expert_perms(cfg, expert_lps)
    return {
        gname: (dec._map(lambda *xs: torch.stack(xs), *[elp[gname] for elp in expert_lps]),
                {k: float(sum(st[k] for st in stats[gname]) / cfg.n_experts)
                 for k in stats[gname][0]})
        for gname in ("gateup", "down")
    }


def _group_linear(lp: Dict[str, Any], members) -> DenseLinear:
    if len(members) == 1:
        return lp[members[0]]
    ws = [lp[m].w for m in members]
    bs = [lp[m].b for m in members]
    bias = None
    if any(b is not None for b in bs):
        bias = torch.cat([b if b is not None else torch.zeros(w.shape[0], dtype=w.dtype,
                                                              device=w.device)
                          for b, w in zip(bs, ws)])
    return DenseLinear(w=torch.cat(ws, dim=0), b=bias)


@torch.no_grad()
def quantize_model(
    cfg: dec.ModelConfig,
    params: Dict[str, Any],
    calib_tokens,  # (N, L) int token ids: numpy or a tensor
    qcfg: QuantConfig = QuantConfig(),
    log: Optional[MetricsLogger] = None,
    start_layer: int = 0,
    prequantized_layers: Optional[List[Any]] = None,
    journal_dir: Optional[str] = None,
    mesh=None,
    device=None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Ternarize every decoder-layer projection; embeddings, the final norm
    and the lm_head stay dense (the head too is quantized with
    ``qcfg.quantize_lm_head``, SSR per ``qcfg.use_ssr`` in any scope).

    ``device``: where the work runs; None is where the dense parameters
    lie. A ``device`` other than theirs streams: each dense layer goes there
    alone, and the embedding, final norm and lm_head follow after the loop
    (the JAX package's host-resident path).

    ``journal_dir``: each finished layer is written there, and a journaled
    prefix is loaded on entry (a preempted run resumes at the first layer
    not journaled). ``start_layer`` / ``prequantized_layers`` resume from
    layers in hand. Returns (quantized params, report); the report carries
    each group's stats by layer, ``bits_per_weight`` and ``timing`` (seconds
    per layer: each tap's Hessian, each group's damped inverse and GPTQ, the
    whole layer, on the device's clock)."""
    if mesh is not None:
        raise NotImplementedError("a device mesh needs parallel/sharding: not ported")
    dec.check_supported(cfg)
    log = log or MetricsLogger(verbose=False)
    host = params["embed"].device
    dev = host if device is None else torch.device(device)
    stream = dev.type != host.type or (dev.index is not None and dev.index != host.index)
    if stream:
        log.emit("streaming_quantization", device=str(dev))
    if journal_dir and prequantized_layers is None and start_layer == 0:
        from ..utils.checkpoint import load_layers

        prequantized_layers = load_layers(journal_dir, device=dev)
        start_layer = len(prequantized_layers)
        if start_layer:
            log.emit("resume_from_journal", layers=start_layer)

    calib = torch.as_tensor(calib_tokens).to(device=dev, dtype=torch.long)
    N, L = calib.shape
    bs = min(qcfg.batch_size, N)
    emb_params = {k: params.get(k) for k in ("embed", "pos_embed", "emb_ln_w", "emb_ln_b")}
    if stream:
        emb_params = {k: None if v is None else v.to(dev) for k, v in emb_params.items()}
    hidden = [dec.embed_tokens(cfg, emb_params, calib[i : i + bs]) for i in range(0, N, bs)]
    del emb_params  # streaming: free the device copy before the layer loop
    cos, sin, cos_l, sin_l = dec.pos_tables(cfg, L, device=dev)
    mask = dec.build_mask(cfg, L, L, device=dev)

    def run_layer(lp, x, li, taps: bool):
        out = dec.layer_forward(cfg, lp, x, cos, sin, mask, impl="plain", layer_idx=li,
                                return_taps=taps, cos_loc=cos_l, sin_loc=sin_l)
        return out if taps else (out, None)

    groups = _groups(cfg, qcfg)
    ssr_skip = resolve_ssr_skip(qcfg, cfg.dim)
    tap_dims = _tap_dims(cfg)

    new_layers: List[Any] = list(prequantized_layers or [])
    if start_layer != len(new_layers):
        raise ValueError(
            f"resume mismatch: start_layer={start_layer} but "
            f"{len(new_layers)} prequantized layers supplied"
        )
    for pre_li, pre_lp in enumerate(new_layers):
        hidden = [run_layer(pre_lp, h, pre_li, False)[0] for h in hidden]

    report: Dict[str, Any] = {"layers": [], "timing": []}
    E = cfg.n_experts
    for li in range(start_layer, cfg.n_layers):
        _sync(dev)
        t_layer = time.perf_counter()
        lp = dec.layer_slice(params["layers"], li)
        if stream:  # one dense layer on the device at a time
            lp = dec._map(lambda t: t.to(dev), lp)
        needed = {tap for _, _, tap in groups}
        accs = {t: HessianAccumulator(tap_dims[t], device=dev) for t in needed}
        t_hess = dict.fromkeys(sorted(needed), 0.0)
        if cfg.is_moe:
            # routed per-expert Hessians H_e = sum_t w_te^2 x_t x_t^T, as rows
            # w_te * x_t (unrouted tokens have w = 0); down sees expert e's
            # own mid-activations
            accs_gu = [HessianAccumulator(cfg.dim, device=dev) for _ in range(E)]
            accs_dn = [HessianAccumulator(cfg.expert_inter, device=dev) for _ in range(E)]
            t_hess["experts"] = 0.0
        for h in hidden:
            _, io = run_layer(lp, h, li, True)
            for t in sorted(needed):
                _sync(dev)
                t0 = time.perf_counter()
                accs[t].update(io.taps[t])
                _sync(dev)
                t_hess[t] += time.perf_counter() - t0
            if cfg.is_moe:
                _sync(dev)
                t0 = time.perf_counter()
                x, w = io.taps["mlp_in"], io.taps["moe_w"]
                for e in range(E):
                    accs_gu[e].update(x.float() * w[..., e : e + 1])
                    mid = _expert_mid(cfg, lp["gate"].w[e], lp["up"].w[e], x)
                    accs_dn[e].update(mid * w[..., e : e + 1])
                _sync(dev)
                t_hess["experts"] += time.perf_counter() - t0
            del io

        new_lp = dict(lp)
        layer_report, t_inv, t_gptq = {}, {}, {}
        if cfg.is_moe:
            experts = _quantize_experts(cfg, lp, accs_gu, accs_dn, qcfg, ssr_skip, log, t_inv,
                                        t_gptq)
            del accs_gu, accs_dn
            for gname, (stacked, means) in experts.items():
                new_lp[gname], layer_report[gname] = stacked, means
                log.emit("layer_quantized", layer=li, proj=f"{gname}[x{E}]", **means)
            new_lp.pop("gate", None)
            new_lp.pop("up", None)
        for gname, members, tap in groups:
            timing: Dict[str, float] = {}
            packed, stats = quantize_linear(
                _group_linear(lp, members), accs[tap], qcfg,
                use_ssr=qcfg.use_ssr and gname not in ssr_skip, log=log, timing=timing,
            )
            t_inv[gname], t_gptq[gname] = timing["inverse_s"], timing["gptq_s"]
            new_lp[gname] = packed
            for m in members:
                if m != gname:
                    new_lp.pop(m, None)
            layer_report[gname] = stats
            log.emit("layer_quantized", layer=li, proj=gname, **stats)
        del accs
        if qcfg.fold_perms:
            new_lp = fold_layer_perms(cfg, new_lp)
        report["layers"].append(layer_report)

        hidden = [run_layer(new_lp, h, li, False)[0] for h in hidden]
        new_layers.append(new_lp)
        if journal_dir:
            from ..utils.checkpoint import save_layer

            save_layer(journal_dir, li, new_lp)
        _sync(dev)
        report["timing"].append({"layer": li, "hessian_s": t_hess, "inverse_s": t_inv,
                                 "gptq_s": t_gptq, "layer_s": time.perf_counter() - t_layer})

    out_params = dict(params)
    if stream:
        # the embedding, final norm and lm_head move now, with the dense
        # layers gone
        for k, v in out_params.items():
            if k != "layers" and v is not None:
                out_params[k] = dec._map(lambda t: t.to(dev), v)
    out_params["layers"] = dec.stack_layers([pad_gateup_blocks(lp) for lp in new_layers])

    if qcfg.quantize_lm_head and out_params.get("lm_head") is not None:
        # what feeds the head: the final norm's output (gemma's 1 + w left
        # out, as in the JAX package)
        acc = HessianAccumulator(cfg.dim, device=dev)
        for h in hidden:
            if cfg.norm == "layernorm":
                acc.update(layer_norm(h, out_params["lnf_w"], out_params["lnf_b"], cfg.norm_eps))
            else:
                acc.update(rms_norm(h, out_params["lnf_w"], cfg.norm_eps))
        packed, stats = quantize_linear(out_params["lm_head"], acc, qcfg, log=log)
        if qcfg.fold_perms:
            packed = fold_head_perm(packed)
        out_params["lm_head"] = packed
        report["lm_head"] = stats
        log.emit("lm_head_quantized", **stats)

    report["bits_per_weight"] = model_bits_per_weight(out_params)
    log.emit("model_quantized", bits_per_weight=report["bits_per_weight"])
    return out_params, report
