"""Parallel execution on ``torch.distributed`` (counterpart of
``pt2tpu.parallel``): named process-group axes (``mesh``) and manual tensor
parallelism (``tp``), one process per rank."""

from .mesh import Axis, auto_mesh, initialize_distributed, make_mesh
from .tp import (make_tp_engine_fns, prepare_tp_layer, prepare_tp_params, shard_major_gateup,
                 shard_major_qkv, shard_tp_layer, shard_tp_params, tp_generate,
                 tp_layer_forward, tp_row_apply)

__all__ = ["Axis", "auto_mesh", "initialize_distributed", "make_mesh", "make_tp_engine_fns",
           "prepare_tp_layer", "prepare_tp_params", "shard_major_gateup", "shard_major_qkv",
           "shard_tp_layer", "shard_tp_params", "tp_generate", "tp_layer_forward", "tp_row_apply"]
