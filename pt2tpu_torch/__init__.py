"""pt2tpu_torch — the PyTorch/CUDA port of pt2tpu: packed-ternary serving of
the registry's models (dense families and mixtures of experts) on an NVIDIA
H100.

A package of its own beside the JAX package ``pt2tpu``, which stays the
reference; nothing here imports JAX or ``pt2tpu``. Every entry point runs on
the card unless the caller passes ``device="cpu"``. CUDA kernels are built
from ``csrc/`` at first use, never at import.
"""

from .core.packing import pack_ternary, unpack_ternary
from .models.decoder import ModelConfig, forward
from .models.registry import get_config
from .ops.ternary_matmul import (
    PackedTernaryLinear,
    make_packed_linear,
    ternary_linear_apply,
    ternary_linear_apply_stacked,
)
from .serve.generate import greedy_generate
from .serve.kvcache import KVCache, init_cache
from .utils.checkpoint import load_model, params_from_numpy, save_model
from .utils.randmodel import random_ternary_params

__version__ = "0.1.0"

__all__ = [
    "pack_ternary",
    "unpack_ternary",
    "ModelConfig",
    "forward",
    "get_config",
    "PackedTernaryLinear",
    "make_packed_linear",
    "ternary_linear_apply",
    "ternary_linear_apply_stacked",
    "greedy_generate",
    "KVCache",
    "init_cache",
    "load_model",
    "save_model",
    "params_from_numpy",
    "random_ternary_params",
]
