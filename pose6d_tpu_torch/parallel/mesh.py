"""The (data, model) mesh over torch.distributed ranks and the sharding
rules (counterpart of pose6d_tpu/parallel/mesh.py).

One process per rank, as torchrun launches them; the caller initializes the
default process group (init_process_group with its backend, address, world
size and rank: nothing on a machine names a cluster). `make_mesh` lays the
ranks out as JAX lays out devices, np.arange(world).reshape(dp, tp): rank r
sits at data coordinate r // tp and model coordinate r % tp. Its data group
is the ranks of its model coordinate (they hold the same parameters and
different rows), its model group the ranks of its data coordinate (the same
rows and different head columns).

  - data axis: each rank takes its rows of the global batch (shard_batch);
    the gradient is all-reduced as a mean over the data group and BatchNorm
    reduces its statistics over it, so a step under the mesh is the
    one-process step on the global batch, as GSPMD partitions one program.
  - model axis: the head MLPs Megatron-style (parallel/heads.py):
    `(rot|trans|fusion|z)_dense0` column-parallel, `..._dense1`
    row-parallel; the towers and everything else replicated.

JAX's arrays are global, so it needs no inverse of its shard functions;
here each rank holds its slices, and gather_params / gather_state give back
the one-process layout (checkpoints are written in it).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .collectives import Group, all_gather_rows

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """shape {"data": dp, "model": tp} (as jax.sharding.Mesh.shape); this
    rank's coordinates, its two groups and the whole world."""

    shape: Dict[str, int]
    rank: int
    data_index: int
    model_index: int
    data_group: Group
    model_group: Group
    world: Group

    @property
    def dp(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def tp(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def rows(self) -> Tuple[int, int]:
        """(this rank's block of rows, the number of blocks)."""
        return self.data_index, self.dp

    @property
    def is_primary(self) -> bool:
        """Rank 0: the one that prints and writes files."""
        return self.rank == 0


def make_mesh(shape: Optional[Sequence[int]] = None) -> Mesh:
    """A (data, model) mesh over the initialized default process group;
    by default every rank on the data axis. Every rank calls it, with the
    same shape (it creates the process groups of every row and column)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized; call "
                           "init_process_group first (torchrun sets its environment)")
    world, rank = dist.get_world_size(), dist.get_rank()
    dp, tp = (world, 1) if shape is None else (int(shape[0]), int(shape[1]))
    if dp * tp != world:
        raise ValueError(f"mesh shape {(dp, tp)} != {world} devices")
    grid = np.arange(world).reshape(dp, tp)
    groups = {}
    # every rank creates every group, in one order
    for axis, lines in ((DATA_AXIS, grid.T), (MODEL_AXIS, grid)):
        for line in lines:
            ranks = tuple(int(r) for r in line)
            pg = dist.new_group(list(ranks))
            if rank in ranks:
                groups[axis] = Group(pg, ranks, ranks.index(rank))
    return Mesh({DATA_AXIS: dp, MODEL_AXIS: tp}, rank, rank // tp, rank % tp,
                groups[DATA_AXIS], groups[MODEL_AXIS], Group(None, tuple(range(world)), rank))


def local_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of n."""
    if n % mesh.dp:
        raise ValueError(f"batch {n} not divisible by the data axis {mesh.dp}")
    b = n // mesh.dp
    return slice(mesh.data_index * b, (mesh.data_index + 1) * b)


def shard_batch(batch: Any, mesh: Mesh, dim: int = 0) -> Any:
    """This rank's rows (along `dim`) of every array or tensor of a batch
    (a dict, nested dicts, or one array)."""
    if isinstance(batch, Mapping):
        return {k: shard_batch(v, mesh, dim) for k, v in batch.items()}
    index = [slice(None)] * dim + [local_rows(batch.shape[dim], mesh)]
    return batch[tuple(index)]


# Megatron-style TP for the head MLPs: column-parallel on the first dense
# layer, row-parallel on the second (JAX's rules, its regexes)
_TP_COL = re.compile(r"(rot|trans|fusion|z)_dense0$")
_TP_ROW = re.compile(r"(rot|trans|fusion|z)_dense1$")


def param_spec(name: str, value: torch.Tensor, tp) -> Optional[int]:
    """The dim of a PoseNet parameter or buffer (its state_dict key) split
    over the model axis, None when replicated: JAX's rules in torch's
    layout (value is taken, as JAX's param_spec takes it, and not read).
    A Linear weight is [out, in], so column-parallel splits dim 0 (flax
    kernel P(None, 'model')) and row-parallel dim 1 (P('model', None)); a
    column-parallel bias splits (P('model')), a row-parallel one does not."""
    if not tp:
        return None
    module, _, leaf = name.rpartition(".")
    scope = module.rpartition(".")[2]
    if _TP_COL.search(scope) and leaf in ("weight", "bias"):
        return 0
    if _TP_ROW.search(scope) and leaf == "weight":
        return 1
    return None


def full_shape(name: str, value: torch.Tensor, mesh: Mesh) -> torch.Size:
    """The one-process shape of this rank's slice `value`."""
    d = param_spec(name, value, mesh.tp > 1)
    if d is None:
        return value.shape
    shape = list(value.shape)
    shape[d] *= mesh.tp
    return torch.Size(shape)


def shard_params(params: Mapping[str, torch.Tensor], mesh: Mesh) -> dict:
    """This rank's slices of a one-process state_dict: split tensors cut to
    their model-axis block, the rest as they are."""
    n = mesh.tp
    out = {}
    for name, v in params.items():
        d = param_spec(name, v, n > 1)
        if d is None:
            out[name] = v
            continue
        if v.shape[d] % n:
            raise ValueError(f"{name}: dim {d} of {tuple(v.shape)} not divisible by the "
                             f"model axis {n}")
        w = v.shape[d] // n
        out[name] = v.narrow(d, mesh.model_index * w, w).clone()
    return out


def gather_params(params: Mapping[str, torch.Tensor], mesh: Mesh) -> dict:
    """The inverse of shard_params: split tensors all-gathered over the
    model group. Every rank of the group calls it and gets the whole."""
    out = {}
    for name, v in params.items():
        d = param_spec(name, v, mesh.tp > 1)
        if d is None:
            out[name] = v
            continue
        full = all_gather_rows(v.movedim(d, 0), mesh.model_group)
        out[name] = full.movedim(0, d).contiguous()
    return out


def _map_moments(opt_state: dict, names: Sequence[str], fn) -> dict:
    """AdamW's state_dict with fn(param name, moment) applied to each
    parameter's exp_avg / exp_avg_sq (its state is keyed by the index of
    the parameter in `names`' order)."""
    state = {}
    for i, s in opt_state["state"].items():
        state[i] = {k: fn(names[int(i)], v) if k in ("exp_avg", "exp_avg_sq") else v
                    for k, v in s.items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}


def shard_optimizer_state(opt_state: dict, names: Sequence[str], mesh: Mesh) -> dict:
    """A one-process AdamW state_dict cut by shard_params' rule."""
    return _map_moments(opt_state, names,
                        lambda name, v: shard_params({name: v}, mesh)[name])


def gather_optimizer_state(opt_state: dict, names: Sequence[str], mesh: Mesh) -> dict:
    return _map_moments(opt_state, names,
                        lambda name, v: gather_params({name: v}, mesh)[name])


def shard_state(state, mesh: Mesh):
    """A one-process train.loop.TrainState onto the mesh: the heads
    swapped for their column- and row-parallel halves holding this rank's
    slices, every BatchNorm and Dropout told its groups
    (parallel/heads.shard_posenet), and a fresh PoseOptimizer over the
    sharded parameters with AdamW's moments cut by the same rule."""
    from ..train.loop import PoseOptimizer, TrainState
    from .heads import shard_posenet

    names = [n for n, _ in state.model.named_parameters()]
    opt_state = state.tx.state_dict()
    model = shard_posenet(state.model, mesh)
    tx = PoseOptimizer(model.parameters(), state.tx.cfg, mesh=mesh,
                       sharded=[param_spec(n, p, mesh.tp > 1) is not None
                                for n, p in model.named_parameters()])
    tx.load_state_dict(shard_optimizer_state(opt_state, names, mesh))
    return TrainState(model=model, tx=tx, step=state.step)


def gather_state(state) -> dict:
    """The inverse of shard_state, as state_dicts in the one-process
    layout: {"model", "optimizer", "step"}. Every rank calls it."""
    mesh = state.model.mesh
    names = [n for n, _ in state.model.named_parameters()]
    return {"model": gather_params(state.model.state_dict(), mesh),
            "optimizer": gather_optimizer_state(state.tx.state_dict(), names, mesh),
            "step": int(state.step)}


def load_gathered(state, payload: dict) -> None:
    """Load one-process state_dicts ({"model", "optimizer"}, e.g. a
    checkpoint) into a sharded TrainState, each rank taking its slices."""
    mesh = state.model.mesh
    names = [n for n, _ in state.model.named_parameters()]
    state.model.load_state_dict(shard_params(payload["model"], mesh), strict=True)
    state.tx.load_state_dict(shard_optimizer_state(payload["optimizer"], names, mesh))
