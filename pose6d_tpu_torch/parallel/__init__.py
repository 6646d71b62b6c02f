"""Data and head parallelism over torch.distributed (counterpart of
pose6d_tpu/parallel): the mesh and its sharding rules (mesh.py), the
collectives with their gradients (collectives.py) and the split heads
(heads.py)."""

from .collectives import Group
from .heads import shard_posenet
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    gather_params,
    gather_state,
    make_mesh,
    param_spec,
    shard_batch,
    shard_params,
    shard_state,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Group",
    "Mesh",
    "gather_params",
    "gather_state",
    "make_mesh",
    "param_spec",
    "shard_batch",
    "shard_params",
    "shard_posenet",
    "shard_state",
]
