"""PoseNet's heads split over the model axis, Megatron-style, and the
model's BatchNorms and Dropouts told their groups (shard_posenet).

For each head prefix (rot_, trans_, fusion_, z_):

  {prefix}dense0  ColumnParallelLinear: this rank's rows of the weight
                  [out/tp, in] and of the bias; its input goes through
                  copy_to_group, its output is this rank's features.
  {prefix}norm0   the norm that follows sees only those features: a
                  BatchNorm (per feature) becomes ShardedBatchNorm, which
                  takes its slice of weight, bias and running statistics; a
                  LayerNorm becomes ShardedLayerNorm, its mean and variance
                  reduced over the model group. Both keep their parameters
                  whole and replicated, as JAX's param_spec keeps them, and
                  slice them in the forward (their gradient is the
                  all-reduce of every rank's slice).
  {prefix}drop0   draws the mask of the global shape and keeps this rank's
                  rows and columns.
  {prefix}dense1  RowParallelLinear: this rank's columns of the weight
                  [out, in/tp]; the partial products are all-reduced
                  (reduce_from_group) and the bias, replicated, is added
                  once, after the reduction.

Every Dropout keeps this rank's rows of its global mask, and with more than
one data rank every BatchNorm becomes a ShardedBatchNorm that reduces its
batch statistics over the data group. The state_dict keys stay the
one-process keys (parallel/mesh.param_spec says which are split).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..models.resnet import BatchNorm
from .collectives import (Group, all_gather_rows, copy_to_group, reduce_from_group,
                          reduce_sum)

PREFIXES = ("rot_", "trans_", "fusion_", "z_")


class ColumnParallelLinear(nn.Module):
    def __init__(self, linear: nn.Linear, group: Group):
        super().__init__()
        out = linear.out_features
        if out % group.size:
            raise ValueError(f"a column-parallel layer of {out} features does not split over "
                             f"a model axis of {group.size}")
        n = out // group.size
        self.group = group
        self.in_features, self.out_features = linear.in_features, n
        self.weight = nn.Parameter(linear.weight.detach().narrow(0, group.index * n, n).clone())
        self.bias = nn.Parameter(linear.bias.detach().narrow(0, group.index * n, n).clone())

    def forward(self, x):
        return F.linear(copy_to_group(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    def __init__(self, linear: nn.Linear, group: Group):
        super().__init__()
        k = linear.in_features
        if k % group.size:
            raise ValueError(f"a row-parallel layer of {k} inputs does not split over a "
                             f"model axis of {group.size}")
        n = k // group.size
        self.group = group
        self.in_features, self.out_features = n, linear.out_features
        self.weight = nn.Parameter(linear.weight.detach().narrow(1, group.index * n, n).clone())
        self.bias = nn.Parameter(linear.bias.detach().clone())

    def forward(self, x):
        return reduce_from_group(F.linear(x, self.weight), self.group) + self.bias


def feature_slice(t: torch.Tensor, shard) -> torch.Tensor:
    """This rank's features of a whole, replicated per-feature tensor
    (shard = (model group, first feature, count)); the gradient of the
    whole is the all-reduce of every rank's slice."""
    group, lo, n = shard
    return copy_to_group(t, group).narrow(0, lo, n)


class ShardedLayerNorm(nn.LayerNorm):
    """A LayerNorm over features split across the model group: this rank's
    [B, n] of the whole [B, n * tp]; the mean and the variance (two-pass)
    are the model group's sums over the whole width."""

    def __init__(self, norm: nn.LayerNorm, group: Group, n: int):
        super().__init__(norm.normalized_shape, eps=norm.eps)
        self.weight, self.bias = norm.weight, norm.bias
        self.shard = (group, group.index * n, n)

    def forward(self, x):
        group, _, n = self.shard
        width = n * group.size
        mean = reduce_sum(x.sum(-1, keepdim=True), group) / width
        d = x - mean
        var = reduce_sum((d * d).sum(-1, keepdim=True), group) / width
        return (d * torch.rsqrt(var + self.eps) * feature_slice(self.weight, self.shard)
                + feature_slice(self.bias, self.shard))


class ShardedBatchNorm(BatchNorm):
    """models/resnet.BatchNorm under a mesh, sharing the parameters and
    running statistics of the norm it replaces (same state_dict keys).
    data_group: the train-mode statistics are those of the global batch,
    the data group's sums (reduce_sum, which carries the gradient) of this
    rank's rows, mean first and then the centred squares. shard (model
    group, first feature, count): the input holds this rank's features of
    a column-parallel layer's output; the weight, bias and running
    statistics stay whole, the forward takes their slice, and the running
    update all-gathers every rank's statistics."""

    def __init__(self, norm: BatchNorm, data_group=None, shard=None):
        super().__init__(norm.num_features, norm.flax_momentum, norm.eps)
        self.weight, self.bias = norm.weight, norm.bias
        for name in ("running_mean", "running_var", "num_batches_tracked"):
            setattr(self, name, getattr(norm, name))
        self.train(norm.training)
        self.data_group, self.shard = data_group, shard

    def forward(self, x):
        self._check_input_dim(x)
        w, b, rm, rv = self.weight, self.bias, self.running_mean, self.running_var
        if self.shard is not None:
            w, b = feature_slice(w, self.shard), feature_slice(b, self.shard)
            _, lo, n = self.shard
            rm, rv = rm.narrow(0, lo, n), rv.narrow(0, lo, n)
        if not self.training:
            return F.batch_norm(x, rm, rv, w, b, False, 0.0, self.eps)
        dims = (0,) if x.dim() == 2 else (0, 2, 3)
        view = (1, -1) + (1,) * (x.dim() - 2)
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.data_group is None:
            y = F.batch_norm(x, None, None, w, b, True, 0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(xs, dim=dims, correction=0)
        else:
            count = xs.numel() // xs.shape[1] * self.data_group.size
            mean = reduce_sum(xs.sum(dims), self.data_group) / count
            d = xs - mean.view(view)
            var = reduce_sum((d * d).sum(dims), self.data_group) / count
            y = (d * torch.rsqrt(var + self.eps).view(view) * w.view(view)
                 + b.view(view)).to(x.dtype)
        with torch.no_grad():
            stats = torch.stack([mean.detach(), var.detach()])
            if self.shard is not None:
                stats = all_gather_rows(stats.T.contiguous(), self.shard[0]).T
            m = self.flax_momentum
            self.running_mean.mul_(m).add_(stats[0], alpha=1.0 - m)
            self.running_var.mul_(m).add_(stats[1], alpha=1.0 - m)
        return y


def shard_posenet(model: nn.Module, mesh) -> nn.Module:
    """Put a one-process PoseNet onto the mesh, in place: the head splits
    above when the model axis is wider than 1 (every split width must
    divide it), each Dropout's rows (and, after a column-parallel layer,
    columns), and a ShardedBatchNorm for every BatchNorm when the data axis
    is wider than 1. Sets model.mesh; returns the model."""
    from ..models.posenet import Dropout

    if getattr(model, "mesh", None) is not None:
        raise ValueError("the model is already sharded")
    group = mesh.model_group
    # the split halves first: a width that does not split raises here,
    # with the model unchanged
    splits = [(prefix, ColumnParallelLinear(getattr(model, f"{prefix}dense0"), group),
               RowParallelLinear(getattr(model, f"{prefix}dense1"), group))
              for prefix in PREFIXES
              if mesh.tp > 1 and getattr(model, f"{prefix}dense0", None) is not None]
    shards = {}  # the BatchNorms after a column-parallel layer
    for prefix, col, row in splits:
        setattr(model, f"{prefix}dense0", col)
        setattr(model, f"{prefix}dense1", row)
        n = col.out_features
        norm = getattr(model, f"{prefix}norm0", None)
        if isinstance(norm, BatchNorm):
            shards[f"{prefix}norm0"] = (group, group.index * n, n)
        elif isinstance(norm, nn.LayerNorm):
            setattr(model, f"{prefix}norm0", ShardedLayerNorm(norm, group, n))
        drop = getattr(model, f"{prefix}drop0", None)
        if drop is not None:
            drop.cols = (group.index, group.size)
    data_group = mesh.data_group if mesh.dp > 1 else None
    for name, m in list(model.named_modules()):
        if isinstance(m, Dropout):
            m.rows = mesh.rows
        elif isinstance(m, BatchNorm) and (data_group is not None or name in shards):
            parent, _, child = name.rpartition(".")
            setattr(model.get_submodule(parent), child,
                    ShardedBatchNorm(m, data_group, shards.get(name)))
    model.mesh = mesh
    return model
