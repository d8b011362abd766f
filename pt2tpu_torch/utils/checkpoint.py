"""Model artifacts in the JAX package's format (``pt2tpu.utils.checkpoint``).

  artifact_dir/
    manifest.json — model config, quant provenance, and ``structure``: one
                    entry per dotted prefix with kind ternary / dense / dict /
                    array / none
    arrays.npz    — every tensor under its dotted key; bf16 stored as its
                    uint16 bit pattern, those keys listed in the object array
                    ``__bf16_keys__``

Artifacts written by either package load in the other. So do the
quantizer's per-layer journal files (``save_layer`` / ``load_layers``:
``layers/NNNN.npz`` + ``layers/NNNN.json``, the layer's structure), which
let a preempted quantization resume in either package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..models.common import DenseLinear
from ..models.decoder import ModelConfig
from ..ops.gather import PackedGather
from ..ops.ternary_matmul import PackedTernaryLinear
from ..quant.fold import pad_gateup_blocks
from .device import resolve_device

__all__ = ["save_model", "load_model", "save_layer", "load_layers", "params_from_numpy"]

_FORMAT_VERSION = 1


def _to_tensor(a: np.ndarray, device, bf16_bits: bool = False) -> torch.Tensor:
    """numpy -> tensor on ``device``. bf16 arrives either as its uint16 bit
    pattern (``bf16_bits``) or as an ml_dtypes bfloat16 array; torch takes
    neither directly, so both go through an int16 view."""
    a = np.asarray(a)
    if not a.flags.writeable:  # e.g. a view of a JAX array
        a = a.copy()
    if bf16_bits or a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def params_from_numpy(
    structure: Dict[str, Any],
    arrays: Dict[str, np.ndarray],
    device=None,
    bf16_keys: Iterable[str] = (),
) -> Dict[str, Any]:
    """Rebuild a parameter tree from its flat form: the ``structure`` and
    flat numpy ``arrays`` that ``pt2tpu.utils.checkpoint._flatten`` (or an
    artifact) gives. ``bf16_keys`` names arrays that hold bf16 bit patterns
    as uint16."""
    dev = resolve_device(device)
    bf16 = set(bf16_keys)

    def arr(key):
        return _to_tensor(arrays[key], dev, key in bf16)

    def opt(key):
        return arr(key) if key in arrays else None

    def build(prefix: str):
        info = structure[prefix]
        kind = info["kind"]
        if kind == "none":
            return None
        if kind == "ternary":
            gather = None
            if info.get("gather_in_features") is not None:
                gather = PackedGather(
                    packed=arr(f"{prefix}.gather.packed"),
                    perm=arr(f"{prefix}.gather.perm"),
                    in_features=info["gather_in_features"],
                )
            return PackedTernaryLinear(
                packed=arr(f"{prefix}.packed"),
                alpha=arr(f"{prefix}.alpha"),
                mu=arr(f"{prefix}.mu"),
                perm=arr(f"{prefix}.perm"),
                bias=opt(f"{prefix}.bias"),
                gather=gather,
                in_features=info["in_features"],
                identity_perm=bool(info.get("identity_perm", False)),
                input_folded=bool(info.get("input_folded", False)),
                out_folded=bool(info.get("out_folded", False)),
            )
        if kind == "dense":
            return DenseLinear(w=arr(f"{prefix}.w"), b=opt(f"{prefix}.b"))
        if kind == "dict":
            return {k: build(f"{prefix}.{k}" if prefix else k) for k in info["keys"]}
        return arr(prefix)

    params = build("")
    if isinstance(params, dict) and isinstance(params.get("layers"), dict):
        params["layers"] = pad_gateup_blocks(params["layers"])
    return params


def _flatten(prefix: str, tree, out: Dict[str, torch.Tensor], structure: Dict[str, Any]):
    if tree is None:
        structure[prefix] = {"kind": "none"}
    elif isinstance(tree, PackedTernaryLinear):
        structure[prefix] = {
            "kind": "ternary",
            "in_features": tree.in_features,
            "identity_perm": bool(tree.identity_perm),
            "has_bias": tree.bias is not None,
            "input_folded": bool(tree.input_folded),
            "out_folded": bool(tree.out_folded),
            "gather_in_features": None if tree.gather is None else tree.gather.in_features,
        }
        out[f"{prefix}.packed"] = tree.packed
        out[f"{prefix}.alpha"] = tree.alpha
        out[f"{prefix}.mu"] = tree.mu
        out[f"{prefix}.perm"] = tree.perm
        if tree.bias is not None:
            out[f"{prefix}.bias"] = tree.bias
        if tree.gather is not None:
            out[f"{prefix}.gather.packed"] = tree.gather.packed
            out[f"{prefix}.gather.perm"] = tree.gather.perm
    elif isinstance(tree, DenseLinear):
        structure[prefix] = {"kind": "dense", "has_bias": tree.b is not None}
        out[f"{prefix}.w"] = tree.w
        if tree.b is not None:
            out[f"{prefix}.b"] = tree.b
    elif isinstance(tree, dict):
        structure[prefix] = {"kind": "dict", "keys": sorted(tree.keys())}
        for k in sorted(tree.keys()):
            _flatten(f"{prefix}.{k}" if prefix else k, tree[k], out, structure)
    else:
        structure[prefix] = {"kind": "array"}
        out[prefix] = tree


def _write_npz(path: str, flat: Dict[str, torch.Tensor]) -> None:
    store, bf16_keys = {}, []
    for k, t in flat.items():
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            store[k] = t.view(torch.int16).numpy().view(np.uint16)
            bf16_keys.append(k)
        else:
            store[k] = t.numpy()
    np.savez(path, __bf16_keys__=np.asarray(bf16_keys, dtype=object), **store)


def _read_npz(path: str) -> Tuple[Dict[str, np.ndarray], List[str]]:
    with np.load(path, allow_pickle=True) as z:
        bf16 = z["__bf16_keys__"].tolist()
        arrays = {k: z[k] for k in z.files if k != "__bf16_keys__"}
    return arrays, bf16


def _jsonable(x):
    """A manifest entry: dataclasses as dicts, dtypes and types as strings."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {k: _jsonable(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return repr(x)
    if isinstance(x, (type, torch.dtype)):
        return str(x)
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


def save_model(
    path: str,
    cfg: ModelConfig,
    params: Dict[str, Any],
    quant_config: Optional[Any] = None,
    report: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a model artifact directory (packed or dense params), with the
    quantizer's config and report in the manifest when given."""
    os.makedirs(path, exist_ok=True)
    flat: Dict[str, torch.Tensor] = {}
    structure: Dict[str, Any] = {}
    _flatten("", params, flat, structure)
    _write_npz(os.path.join(path, "arrays.npz"), flat)
    manifest = {
        "format_version": _FORMAT_VERSION,
        "model_config": dataclasses.asdict(cfg),
        "quant_config": _jsonable(quant_config) if quant_config else None,
        "report": _jsonable(report) if report else None,
        "structure": structure,
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_model(path: str, device=None) -> Tuple[ModelConfig, Dict[str, Any]]:
    """Load an artifact directory -> (ModelConfig, params) on ``device``
    (default: the card)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["format_version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported artifact version {manifest['format_version']}")
    cfg = ModelConfig.from_dict(manifest["model_config"])
    arrays, bf16 = _read_npz(os.path.join(path, "arrays.npz"))
    params = params_from_numpy(manifest["structure"], arrays, device, bf16_keys=bf16)
    return cfg, params


# ------------------------------------------------- incremental layers ----
def save_layer(path: str, layer_idx: int, layer_params: Dict[str, Any]) -> None:
    """Journal one quantized decoder layer (resume support)."""
    os.makedirs(os.path.join(path, "layers"), exist_ok=True)
    flat: Dict[str, torch.Tensor] = {}
    structure: Dict[str, Any] = {}
    _flatten("", layer_params, flat, structure)
    _write_npz(os.path.join(path, "layers", f"{layer_idx:04d}.npz"), flat)
    with open(os.path.join(path, "layers", f"{layer_idx:04d}.json"), "w") as f:
        json.dump(structure, f)


def load_layers(path: str, device=None) -> List[Dict[str, Any]]:
    """The contiguous prefix of journaled layers 0..k, on ``device``
    (default: the card)."""
    ldir = os.path.join(path, "layers")
    out: List[Dict[str, Any]] = []
    i = 0
    while os.path.exists(os.path.join(ldir, f"{i:04d}.npz")):
        with open(os.path.join(ldir, f"{i:04d}.json")) as f:
            structure = json.load(f)
        arrays, bf16 = _read_npz(os.path.join(ldir, f"{i:04d}.npz"))
        out.append(params_from_numpy(structure, arrays, device, bf16_keys=bf16))
        i += 1
    return out
