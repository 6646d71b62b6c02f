"""Training loss: geodesic quaternion distance + L1 translation
(counterpart of pose6d_tpu/losses/pose_loss.py; reference
models/pose_loss.py):
  loss = rot_weight * geodesic(q_pred, q_gt) + trans_weight * L1(t_pred, t_gt)
with the stable atan2 form of the geodesic and the double-cover sign flip.
Reductions are batch means.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.quat import quat_normalize


@dataclasses.dataclass(frozen=True)
class PoseLossConfig:
    """The reference trainers all use (1.0, 10.0, 'geodesic')
    (scripts/training/train_rgb.py:73)."""

    rot_weight: float = 1.0
    trans_weight: float = 10.0
    rotation_loss: str = "geodesic"  # 'geodesic' | 'l1'


def geodesic_distance(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Mean geodesic angle between quaternion batches [B, 4] (xyzw):
    2 atan2(|q1 - q2|, |q1 + q2|), with q2 flipped where q1 . q2 < 0."""
    q1 = quat_normalize(q1)
    q2 = quat_normalize(q2)
    dot = (q1 * q2).sum(-1, keepdim=True)
    q2 = torch.where(dot < 0, -q2, q2)
    diff_norm = torch.linalg.norm(q1 - q2, dim=-1)
    sum_norm = torch.linalg.norm(q1 + q2, dim=-1)
    return (2.0 * torch.atan2(diff_norm, sum_norm)).mean()


def quaternion_l1(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Double-cover-aware L1 distance between quaternion batches [B, 4]."""
    q1 = quat_normalize(q1)
    q2 = quat_normalize(q2)
    dist_pos = (q1 - q2).abs().sum(-1)
    dist_neg = (q1 + q2).abs().sum(-1)
    return torch.minimum(dist_pos, dist_neg).mean()


def pose_loss(pred_rot: torch.Tensor, pred_trans: torch.Tensor, gt_rot: torch.Tensor,
              gt_trans: torch.Tensor, config: PoseLossConfig = PoseLossConfig()) -> torch.Tensor:
    """Combined rotation + translation loss (a scalar tensor)."""
    if config.rotation_loss == "geodesic":
        rot_loss = geodesic_distance(pred_rot, gt_rot)
    elif config.rotation_loss == "l1":
        rot_loss = quaternion_l1(pred_rot, gt_rot)
    else:
        raise ValueError(f"unknown rotation_loss {config.rotation_loss!r}")
    trans_loss = (pred_trans - gt_trans).abs().mean()
    return config.rot_weight * rot_loss + config.trans_weight * trans_loss
