"""ADD-S nearest-point distance (counterpart of
pose6d_tpu/ops/pallas_addmin.py pairwise_min_dist_pallas).

`pairwise_min_dist_kernel` launches the CUDA kernel (csrc/addmin.cu) for a
CUDA tensor and runs the plain version `_pairwise_min_dist` for a CPU
tensor; any other device raises. Inputs are expected centred per sample
(losses/add.py does it).

The kernel's grid is a plan, `addmin_plan(B, P)`: a block takes (sample,
tile of predicted points), its threads are `splits` GT splits x tile / R
threads, each thread R predicted points. Split s scans the GT points
j = s (mod splits) in increasing order and the splits merge by (d^2,
index), so the argmin, and with it the output, is the same bits under
every plan.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import _build

SMS = 132           # the H100's SMs: the plan fills them at the serving batch
MAX_THREADS = 1024  # a block's threads, splits * tile / R (csrc/addmin.cu)
R_VALUES = (1, 2, 4)  # predicted points per thread the kernel is built for


@dataclasses.dataclass(frozen=True)
class AddminPlan:
    """tile predicted points per block, r of them per thread, splits of
    the GT axis per block."""

    tile: int
    r: int
    splits: int

    def __post_init__(self):
        if (self.r not in R_VALUES or self.tile < self.r or self.tile % self.r
                or self.splits < 1 or self.threads > MAX_THREADS):
            raise ValueError(f"invalid addmin plan {self}")

    @property
    def threads(self) -> int:
        return self.splits * (self.tile // self.r)

    def blocks(self, B: int, P: int) -> int:
        return B * math.ceil(P / self.tile)


def addmin_plan(B: int, P: int) -> AddminPlan:
    """The plan for [B, P, 3] inputs: the widest tile of 128, 64, 32, 16 or
    8 predicted points whose grid still gives every SM a block; at 64 or
    128, R = 4 points a thread and 16 GT splits, at 32 or less R = 2 and 32
    splits (a block keeps 4-16 warps); never more splits than GT points.
    python -m pose6d_tpu_torch.ops.addmin_sweep times the others: at B 8
    and 32, P 500 and 2048 this rule is within 5 % of the fastest plan."""
    tile = 128
    while tile > 8 and B * math.ceil(P / tile) < SMS:
        tile //= 2
    r, splits = (4, 16) if tile >= 64 else (2, 32)
    return AddminPlan(tile, r, min(splits, P))


def _pairwise_min_dist(pred_pts: torch.Tensor, gt_pts: torch.Tensor) -> torch.Tensor:
    """Plain version, the JAX package's expansion (losses/add.py
    _pairwise_min_dist): sqrt(min_q max(|a|^2 + |b|^2 - 2 a.b, 0)) over the
    [B, P, P] matrix from one batched matmul. [B,P,3] x [B,P,3] -> [B,P]."""
    pred2 = (pred_pts * pred_pts).sum(-1)
    gt2 = (gt_pts * gt_pts).sum(-1)
    cross = torch.einsum("bpi,bqi->bpq", pred_pts, gt_pts)
    d2 = torch.clamp_min(pred2[:, :, None] + gt2[:, None, :] - 2.0 * cross, 0.0)
    return torch.sqrt(d2.min(dim=2).values)


def expansion_d2_atol(pred_pts: torch.Tensor, gt_pts: torch.Tensor) -> float:
    """The plain version's envelope in d^2: |a|^2, |b|^2 and 2 a.b each
    round to a few f32 ulps of their size, so its squared distances lie
    within 8 eps (max |a|^2 + max |b|^2) of exact. It is accurate in d^2,
    not in d: where a point's nearest is close, its sqrt strays by up to
    the square root of that (under 3e-4 m on a 5 cm cloud), where the
    kernel's difference form is within 1e-7 m."""
    eps = torch.finfo(torch.float32).eps
    return 8 * eps * float(pred_pts.square().sum(-1).max() + gt_pts.square().sum(-1).max())


def _launch_addmin(pred, gt, out, plan: AddminPlan, stream: int) -> None:
    B, P, _ = pred.shape
    code = _build.lib().pose6d_addmin_forward(
        pred.data_ptr(), gt.data_ptr(), out.data_ptr(), B, P, plan.tile, plan.r, plan.splits,
        stream)
    _build.check(code, "pairwise_min_dist_kernel")


def pairwise_min_dist_kernel(pred_pts: torch.Tensor, gt_pts: torch.Tensor,
                             plan: AddminPlan | None = None) -> torch.Tensor:
    """For each predicted point, the distance to the nearest GT point:
    [B,P,3] x [B,P,3] f32 -> [B,P] f32. `plan` (default addmin_plan(B, P))
    changes the kernel's grid, never its output."""
    if pred_pts.ndim != 3 or pred_pts.shape[-1] != 3 or pred_pts.shape[1] == 0:
        raise ValueError(f"pred_pts must be [B,P,3] with P > 0, got {tuple(pred_pts.shape)}")
    for name, t in (("pred_pts", pred_pts), ("gt_pts", gt_pts)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
        if tuple(t.shape) != tuple(pred_pts.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(pred_pts.shape)}")
    if pred_pts.device.type == "cpu":
        return _pairwise_min_dist(pred_pts, gt_pts)
    _build.check_on_card(pred_pts, (gt_pts,))
    if plan is None:
        plan = addmin_plan(*pred_pts.shape[:2])
    out = torch.empty(pred_pts.shape[:2], dtype=torch.float32, device=pred_pts.device)
    with _build.on_device(pred_pts.device) as stream:
        _launch_addmin(pred_pts, gt_pts, out, plan, stream)
    _build.launch_counts["pairwise_min_dist"] += 1
    return out
