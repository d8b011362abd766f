"""Load local HuggingFace checkpoints into the port's parameter tree
(counterpart of ``pt2tpu.models.hf_loader``).

A checkpoint directory holds ``config.json`` and the weights as safetensors
shards (read by this module's own reader: an 8-byte little-endian header
length, a JSON header naming each tensor's dtype, shape and byte range, then
the raw little-endian bytes) or as ``pytorch_model*.bin`` files (read by
``torch.load(weights_only=True)``). Nothing is fetched from a network.

Families: the llama layout (llama / llama2 / llama3 / mistral / qwen2 with
its q/k/v bias / qwen3 with qk-norm), gemma v1, gemma2 and gemma3 (sandwich
norms; gemma3's multimodal checkpoints through the nested
``language_model.model`` prefix, text only), opt, gpt2 (its Conv1D weights
stored (in, out), transposed here) and bloom (its fused query_key_value
stored head by head as [q_h | k_h | v_h], de-interleaved here), and the
mixture-of-experts layouts of mixtral (``block_sparse_moe``) and qwen3-moe
(``mlp.experts``), read into a router and (E, out, in) expert stacks. The
parameter trees have the JAX loader's keys, so a quantized artifact has the
JAX package's structure.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .common import DenseLinear
from .decoder import ModelConfig, check_supported, stack_layers
from .registry import get_model_type

__all__ = ["load_hf_model", "read_hf_tensors", "read_safetensors", "write_safetensors",
           "config_from_hf"]

# safetensors dtype names -> (numpy dtype of the stored bytes, torch dtype)
_ST_DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),  # bit patterns, viewed as bf16
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors in their stored
    dtype (bf16 stays bf16)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which the "
                             f"reader does not take ({sorted(_ST_DTYPES)})")
        np_dt, t_dt = _ST_DTYPES[info["dtype"]]
        lo, hi = info["data_offsets"]
        a = np.frombuffer(data[lo:hi], dtype=np.dtype(np_dt).newbyteorder("<"))
        a = a.astype(np_dt).reshape(info["shape"])  # native order, owning its bytes
        t = torch.from_numpy(a)
        out[name] = t.view(torch.bfloat16) if t_dt == torch.bfloat16 else t
    del data
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write ``tensors`` as one safetensors file (the format
    :func:`read_safetensors` reads): each tensor's bytes in name order, little
    endian, the header padded with spaces to a multiple of 8 bytes."""
    names = sorted(tensors)
    to_name = {dt: name for name, (_, dt) in _ST_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name in names:
        t = tensors[name].detach().contiguous().cpu()
        if t.dtype not in to_name:
            raise ValueError(f"tensor {name}: dtype {t.dtype} has no safetensors name here")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        data = raw.astype(raw.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": to_name[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for data in blobs:
            f.write(data)


def read_hf_tensors(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a checkpoint directory: its safetensors shards if it
    has any, else its ``pytorch_model*.bin`` files (as f32, as the JAX
    loader reads them)."""
    files = sorted(os.listdir(model_dir))
    st = [f for f in files if f.endswith(".safetensors")]
    tensors: Dict[str, torch.Tensor] = {}
    if st:
        for f in st:
            tensors.update(read_safetensors(os.path.join(model_dir, f)))
        return tensors
    bins = [f for f in files if f.endswith(".bin") and "pytorch_model" in f]
    if bins:
        for f in bins:
            sd = torch.load(os.path.join(model_dir, f), map_location="cpu", weights_only=True)
            tensors.update({k: v.to(torch.float32) for k, v in sd.items()})
        return tensors
    raise FileNotFoundError(f"no safetensors/bin checkpoints in {model_dir}")


def _layer_globals_from_hf(hc, n_layers, mt):
    """Per-layer is-global flags: the explicit ``layer_types`` list, else the
    family's pattern (gemma3: every ``sliding_window_pattern``-th layer;
    gemma2: the odd layers)."""
    lt = hc.get("layer_types")
    if lt:
        return tuple(t != "sliding_attention" for t in lt)
    if mt.startswith("gemma3"):
        p = hc.get("sliding_window_pattern", 6)
        return tuple((i + 1) % p == 0 for i in range(n_layers))
    return tuple(bool(i % 2) for i in range(n_layers))


def config_from_hf(model_dir: str) -> ModelConfig:
    """A ModelConfig from a local ``config.json``, field for field the JAX
    loader's."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hc = json.load(f)
    arch = (hc.get("architectures") or [""])[0].lower()
    mt = hc.get("model_type", get_model_type(model_dir))
    if mt == "gemma3" and "text_config" in hc:
        # the multimodal wrapper: its text LM only
        hc = {**hc["text_config"], "architectures": hc.get("architectures")}
        mt = "gemma3_text"
    if "llama" in arch or mt in ("llama", "mistral", "qwen2", "qwen3", "mixtral", "qwen3_moe"):
        rs = hc.get("rope_scaling") or {}
        rtype = rs.get("rope_type") or rs.get("type")
        rope_scale, rope_llama3 = 1.0, None
        if rtype == "linear":
            rope_scale = float(rs.get("factor", 1.0))
        elif rtype == "llama3":
            rope_llama3 = (
                float(rs.get("factor", 8.0)),
                float(rs.get("low_freq_factor", 1.0)),
                float(rs.get("high_freq_factor", 4.0)),
                int(rs.get("original_max_position_embeddings", 8192)),
            )
        elif rtype not in (None, "default"):
            raise ValueError(f"unsupported rope_scaling type '{rtype}'")
        return ModelConfig(
            family=mt,
            rope_scale=rope_scale,
            rope_llama3=rope_llama3,
            vocab_size=hc["vocab_size"],
            dim=hc["hidden_size"],
            n_layers=hc["num_hidden_layers"],
            n_heads=hc["num_attention_heads"],
            n_kv_heads=hc.get("num_key_value_heads"),
            intermediate=hc["intermediate_size"],
            head_dim=hc.get("head_dim"),
            max_seq_len=hc.get("max_position_embeddings", 2048),
            norm="rmsnorm",
            norm_eps=hc.get("rms_norm_eps", 1e-5),
            pos="rope",
            rope_theta=hc.get("rope_theta", 10000.0),
            act="silu",
            gated_mlp=True,
            qkv_bias=bool(hc.get("attention_bias", False) or mt == "qwen2"),
            qk_norm=(mt in ("qwen3", "qwen3_moe")),
            tie_embeddings=bool(hc.get("tie_word_embeddings", False)),
            n_experts=int(hc.get("num_local_experts") or hc.get("num_experts") or 0),
            experts_per_token=int(hc.get("num_experts_per_tok", 2)),
            moe_inter=hc.get("moe_intermediate_size"),
            norm_topk=bool(hc.get("norm_topk_prob", True)),
        )
    if "opt" in arch or mt == "opt":
        return ModelConfig(
            family="opt",
            vocab_size=hc["vocab_size"],
            dim=hc["hidden_size"],
            n_layers=hc["num_hidden_layers"],
            n_heads=hc["num_attention_heads"],
            intermediate=hc["ffn_dim"],
            max_seq_len=hc.get("max_position_embeddings", 2048),
            norm="layernorm",
            pos="learned",
            pos_offset=2,
            act="relu",
            gated_mlp=False,
            linear_bias=True,
            tie_embeddings=bool(hc.get("tie_word_embeddings", True)),
        )
    if "gemma" in arch or mt in ("gemma", "gemma2", "gemma3_text", "gemma3"):
        n_layers = hc["num_hidden_layers"]
        common = dict(
            vocab_size=hc["vocab_size"],
            dim=hc["hidden_size"],
            n_layers=n_layers,
            n_heads=hc["num_attention_heads"],
            n_kv_heads=hc.get("num_key_value_heads"),
            intermediate=hc["intermediate_size"],
            head_dim=hc.get("head_dim", 256),
            max_seq_len=hc.get("max_position_embeddings", 8192),
            norm="rmsnorm",
            norm_eps=hc.get("rms_norm_eps", 1e-6),
            pos="rope",
            rope_theta=hc.get("rope_theta", 10000.0),
            act="gelu",
            gated_mlp=True,
            tie_embeddings=True,
            embed_scale=float(hc["hidden_size"]) ** 0.5,
            norm_plus_one=True,
        )
        qpas = hc.get("query_pre_attn_scalar")
        if mt == "gemma2" or "gemma2" in arch:
            return ModelConfig(
                family="gemma2",
                sandwich_norm=True,
                sliding_window=hc.get("sliding_window", 4096),
                layer_globals=_layer_globals_from_hf(hc, n_layers, "gemma2"),
                attn_scale=None if qpas is None else qpas**-0.5,
                attn_softcap=hc.get("attn_logit_softcapping") or 0.0,
                final_softcap=hc.get("final_logit_softcapping") or 0.0,
                **common,
            )
        if mt in ("gemma3_text", "gemma3") or "gemma3" in arch:
            rs = hc.get("rope_scaling") or {}
            rtype = rs.get("rope_type") or rs.get("type")
            if rtype not in (None, "default", "linear"):
                raise ValueError(f"unsupported gemma3 rope_scaling type '{rtype}'")
            return ModelConfig(
                family="gemma3",
                qk_norm=True,
                sandwich_norm=True,
                sliding_window=hc.get("sliding_window", 1024),
                layer_globals=_layer_globals_from_hf(hc, n_layers, "gemma3"),
                rope_local_theta=hc.get("rope_local_base_freq", 10000.0),
                rope_scale=float(rs.get("factor", 1.0)),
                attn_scale=None if qpas is None else qpas**-0.5,
                **common,
            )
        return ModelConfig(family="gemma", **common)
    if "bloom" in arch or mt == "bloom":
        D = hc["hidden_size"]
        return ModelConfig(
            family="bloom",
            vocab_size=hc["vocab_size"],
            dim=D,
            n_layers=hc.get("num_hidden_layers", hc.get("n_layer")),
            n_heads=hc.get("num_attention_heads", hc.get("n_head")),
            intermediate=4 * D,
            max_seq_len=hc.get("seq_length", 2048),
            norm="layernorm",
            norm_eps=hc.get("layer_norm_epsilon", 1e-5),
            pos="alibi",
            act="gelu",
            gated_mlp=False,
            linear_bias=True,
            tie_embeddings=True,
            embed_norm=True,
        )
    if "gpt2" in arch or mt == "gpt2":
        return ModelConfig(
            family="gpt2",
            vocab_size=hc["vocab_size"],
            dim=hc["n_embd"],
            n_layers=hc["n_layer"],
            n_heads=hc["n_head"],
            intermediate=hc.get("n_inner") or 4 * hc["n_embd"],
            max_seq_len=hc.get("n_positions", 1024),
            norm="layernorm",
            norm_eps=hc.get("layer_norm_epsilon", 1e-5),
            pos="learned",
            act="gelu",
            gated_mlp=False,
            linear_bias=True,
            tie_embeddings=True,
        )
    raise ValueError(f"unsupported architecture {arch or mt} in {model_dir}")


class _Maker:
    """Turns checkpoint tensors into the tree's leaves: f32 first (the JAX
    loader's numpy step), then ``dtype`` on ``device``."""

    def __init__(self, t: Dict[str, torch.Tensor], dtype, device):
        self.t, self.dtype, self.device = t, dtype, device

    def __call__(self, x) -> torch.Tensor:
        if isinstance(x, str):
            x = self.t[x]
        return x.float().to(self.dtype).contiguous().to(self.device)

    def lin(self, wkey: str, bkey: str = None, transpose: bool = False) -> DenseLinear:
        w = self.t[wkey].float()
        if transpose:  # GPT-2's Conv1D stores (in, out)
            w = w.t()
        b = self(bkey) if bkey and bkey in self.t else None
        return DenseLinear(w=self(w), b=b)


def _llama_layers(cfg: ModelConfig, mk: _Maker, prefix: str = "model.") -> List[Dict[str, Any]]:
    t = mk.t
    layers = []
    for i in range(cfg.n_layers):
        p = f"{prefix}layers.{i}."
        lay = {"ln1_w": mk(p + "input_layernorm.weight"), "ln1_b": None, "ln2_b": None}
        if cfg.sandwich_norm:
            # gemma2/3: post_attention_layernorm normalises the attention
            # output; the MLP's pre-norm is its own tensor
            lay["ln2_w"] = mk(p + "pre_feedforward_layernorm.weight")
            lay["post_attn_w"] = mk(p + "post_attention_layernorm.weight")
            lay["post_mlp_w"] = mk(p + "post_feedforward_layernorm.weight")
        else:
            lay["ln2_w"] = mk(p + "post_attention_layernorm.weight")
        if cfg.qk_norm:
            lay["q_norm_w"] = mk(p + "self_attn.q_norm.weight")
            lay["k_norm_w"] = mk(p + "self_attn.k_norm.weight")
        projections = (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                       ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"))
        if not cfg.is_moe:
            projections += (("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
                            ("down", "mlp.down_proj"))
        for ours, theirs in projections:
            if p + theirs + ".weight" not in t:
                raise KeyError(f"checkpoint lacks {p + theirs}.weight")
            lay[ours] = mk.lin(p + theirs + ".weight", p + theirs + ".bias")
        if cfg.is_moe:
            lay.update(_moe_leaves(cfg, mk, p))
        layers.append(lay)
    return layers


def _moe_leaves(cfg: ModelConfig, mk: _Maker, p: str) -> Dict[str, Any]:
    """A layer's router and (E, out, in) expert stacks: mixtral's
    ``block_sparse_moe.gate`` + ``experts.N.{w1,w3,w2}``, or qwen3-moe's
    ``mlp.gate`` + ``mlp.experts.N.{gate,up,down}_proj``."""
    t = mk.t
    if p + "block_sparse_moe.gate.weight" in t:
        rkey = p + "block_sparse_moe.gate.weight"
        names = [tuple(f"{p}block_sparse_moe.experts.{e}.{w}.weight" for w in ("w1", "w3", "w2"))
                 for e in range(cfg.n_experts)]
    else:
        rkey = p + "mlp.gate.weight"
        names = [tuple(f"{p}mlp.experts.{e}.{w}_proj.weight" for w in ("gate", "up", "down"))
                 for e in range(cfg.n_experts)]
    for key in (rkey,) + tuple(k for ks in names for k in ks):
        if key not in t:
            raise KeyError(f"checkpoint lacks {key}")
    leaves = {"router": DenseLinear(w=mk(rkey))}
    for name, j in (("gate", 0), ("up", 1), ("down", 2)):
        leaves[name] = DenseLinear(w=mk(torch.stack([t[ks[j]].float() for ks in names])))
    return leaves


def _opt_layers(cfg: ModelConfig, mk: _Maker) -> List[Dict[str, Any]]:
    layers = []
    for i in range(cfg.n_layers):
        p = f"model.decoder.layers.{i}."
        lay = {
            "ln1_w": mk(p + "self_attn_layer_norm.weight"),
            "ln1_b": mk(p + "self_attn_layer_norm.bias"),
            "ln2_w": mk(p + "final_layer_norm.weight"),
            "ln2_b": mk(p + "final_layer_norm.bias"),
            "gate": None,
        }
        for ours, theirs in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                             ("v", "self_attn.v_proj"), ("o", "self_attn.out_proj"),
                             ("up", "fc1"), ("down", "fc2")):
            lay[ours] = mk.lin(p + theirs + ".weight", p + theirs + ".bias")
        layers.append(lay)
    return layers


def _gpt2_layers(cfg: ModelConfig, mk: _Maker) -> List[Dict[str, Any]]:
    D = cfg.dim
    layers = []
    for i in range(cfg.n_layers):
        p = f"h.{i}." if f"h.{i}.ln_1.weight" in mk.t else f"transformer.h.{i}."
        qkv = mk.t[p + "attn.c_attn.weight"].float().t()  # (3D, D)
        qkv_b = mk.t[p + "attn.c_attn.bias"].float()
        lay = {
            "ln1_w": mk(p + "ln_1.weight"),
            "ln1_b": mk(p + "ln_1.bias"),
            "ln2_w": mk(p + "ln_2.weight"),
            "ln2_b": mk(p + "ln_2.bias"),
            "gate": None,
            "q": DenseLinear(mk(qkv[:D]), mk(qkv_b[:D])),
            "k": DenseLinear(mk(qkv[D : 2 * D]), mk(qkv_b[D : 2 * D])),
            "v": DenseLinear(mk(qkv[2 * D :]), mk(qkv_b[2 * D :])),
            "o": mk.lin(p + "attn.c_proj.weight", p + "attn.c_proj.bias", transpose=True),
            "up": mk.lin(p + "mlp.c_fc.weight", p + "mlp.c_fc.bias", transpose=True),
            "down": mk.lin(p + "mlp.c_proj.weight", p + "mlp.c_proj.bias", transpose=True),
        }
        layers.append(lay)
    return layers


def _bloom_layers(cfg: ModelConfig, mk: _Maker) -> List[Dict[str, Any]]:
    """Bloom's fused query_key_value holds, head by head, [q_h | k_h | v_h]:
    de-interleaved into q, k and v."""
    H, hd, D = cfg.n_heads, cfg.hd, cfg.dim
    pre = "transformer." if "transformer.h.0.input_layernorm.weight" in mk.t else ""
    layers = []
    for i in range(cfg.n_layers):
        p = f"{pre}h.{i}."
        w3 = mk.t[p + "self_attention.query_key_value.weight"].float().reshape(H, 3, hd, D)
        b3 = mk.t[p + "self_attention.query_key_value.bias"].float().reshape(H, 3, hd)
        lay = {
            "ln1_w": mk(p + "input_layernorm.weight"),
            "ln1_b": mk(p + "input_layernorm.bias"),
            "ln2_w": mk(p + "post_attention_layernorm.weight"),
            "ln2_b": mk(p + "post_attention_layernorm.bias"),
            "gate": None,
        }
        for j, name in enumerate(("q", "k", "v")):
            lay[name] = DenseLinear(mk(w3[:, j].reshape(H * hd, D)), mk(b3[:, j].reshape(H * hd)))
        lay["o"] = mk.lin(p + "self_attention.dense.weight", p + "self_attention.dense.bias")
        lay["up"] = mk.lin(p + "mlp.dense_h_to_4h.weight", p + "mlp.dense_h_to_4h.bias")
        lay["down"] = mk.lin(p + "mlp.dense_4h_to_h.weight", p + "mlp.dense_4h_to_h.bias")
        layers.append(lay)
    return layers


def load_hf_model(model_dir: str, dtype=torch.bfloat16,
                  device=None) -> Tuple[ModelConfig, Dict[str, Any]]:
    """(ModelConfig, params) from a local HF checkpoint directory, every
    leaf in ``dtype`` on ``device`` (default: the card). ``device="cpu"``
    keeps the model host-resident, the JAX loader's ``host=True``: the
    quantizer then streams one layer at a time to the card
    (``quantize_model(..., device=...)``)."""
    dev = resolve_device(device)
    cfg = config_from_hf(model_dir)
    check_supported(cfg)
    t = read_hf_tensors(model_dir)
    mk = _Maker(t, dtype, dev)
    fam = cfg.family
    emb_ln = None
    if fam == "opt":
        layers = _opt_layers(cfg, mk)
        embed = t["model.decoder.embed_tokens.weight"]
        pos = t["model.decoder.embed_positions.weight"]
        lnf_w = t.get("model.decoder.final_layer_norm.weight")
        lnf_b = t.get("model.decoder.final_layer_norm.bias")
        head = None if cfg.tie_embeddings else t.get("lm_head.weight")
    elif fam == "gpt2":
        layers = _gpt2_layers(cfg, mk)
        pre = "" if "wte.weight" in t else "transformer."
        embed, pos = t[pre + "wte.weight"], t[pre + "wpe.weight"]
        lnf_w, lnf_b, head = t[pre + "ln_f.weight"], t[pre + "ln_f.bias"], None
    elif fam == "bloom":
        layers = _bloom_layers(cfg, mk)
        pre = "transformer." if "transformer.word_embeddings.weight" in t else ""
        embed, pos = t[pre + "word_embeddings.weight"], None
        lnf_w, lnf_b, head = t[pre + "ln_f.weight"], t[pre + "ln_f.bias"], None
        emb_ln = (t[pre + "word_embeddings_layernorm.weight"],
                  t[pre + "word_embeddings_layernorm.bias"])
    else:  # llama / gemma families (gemma3's multimodal checkpoints nest the LM)
        prefix = ("language_model.model." if "language_model.model.embed_tokens.weight" in t
                  else "model.")
        layers = _llama_layers(cfg, mk, prefix)
        embed, pos = t[prefix + "embed_tokens.weight"], None
        lnf_w, lnf_b = t[prefix + "norm.weight"], None
        head = None if cfg.tie_embeddings else t.get("lm_head.weight")
    params = {
        "embed": mk(embed),
        "pos_embed": None if pos is None else mk(pos),
        "layers": stack_layers(layers),
        "lnf_w": mk(lnf_w),
        "lnf_b": None if lnf_b is None else mk(lnf_b),
        "lm_head": None if head is None else DenseLinear(mk(head), None),
    }
    if emb_ln is not None:
        params["emb_ln_w"], params["emb_ln_b"] = mk(emb_ln[0]), mk(emb_ln[1])
    return cfg, params
