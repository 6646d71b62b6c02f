"""Batched ADD / ADD-S / ADD-0.1d evaluation (counterpart of
pose6d_tpu/losses/add.py).

The object point clouds are stacked into one [n_obj, P, 3] tensor; a batch
gathers its objects by id. ADD-S's nearest-point search runs through the
CUDA kernel of ops/addmin.py on the card (its plain version on the CPU),
after per-sample centring. Symmetric objects use ADD-S for the 0.1d
decision; means cover each object's real (non-padded) points only.
PLY loading is a later slice: ObjectModels is built from arrays.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.addmin import pairwise_min_dist_kernel

# LineMOD symmetric objects, 0-indexed (eggbox=9, glue=10)
SYMMETRIC_OBJECT_IDS = (9, 10)


@dataclasses.dataclass(frozen=True)
class ObjectModels:
    """points [n_obj, P, 3] f32 metres; diameters [n_obj] metres;
    symmetric, present [n_obj] bool; num_valid [n_obj] int real points."""

    points: torch.Tensor
    diameters: torch.Tensor
    symmetric: torch.Tensor
    present: torch.Tensor
    num_valid: torch.Tensor

    def to(self, device) -> "ObjectModels":
        return ObjectModels(*(getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)))


def _transform_points(points, rot_mat, trans):
    """Per-sample rigid transform: [B, P, 3] x [B, 3, 3] + [B, 3]."""
    return torch.einsum("bpj,bij->bpi", points, rot_mat) + trans[:, None, :]


def pairwise_min_dist(pred_pts: torch.Tensor, gt_pts: torch.Tensor) -> torch.Tensor:
    """Nearest-GT distance per predicted point [B, P], with per-sample
    centring (translation-invariant; keeps f32 away from cancellation at
    metre offsets)."""
    center = gt_pts.mean(dim=1, keepdim=True)
    return pairwise_min_dist_kernel((pred_pts - center).contiguous(),
                                    (gt_pts - center).contiguous())


def _point_mean(per_point, safe_ids, num_valid):
    """Mean of [B, P] values over each sample's real points only."""
    if num_valid is None:
        return per_point.mean(dim=-1)
    nv = num_valid[safe_ids].float()
    pmask = torch.arange(per_point.shape[-1], device=per_point.device)[None, :] < nv[:, None]
    return torch.where(pmask, per_point, torch.zeros_like(per_point)).sum(-1) / nv.clamp_min(1.0)


def add_per_sample(model_points, diameters, symmetric, present, pred_rot_mat,
                   pred_trans, gt_rot_mat, gt_trans, obj_ids, num_valid=None) -> dict:
    """Per-sample ADD / ADD-S (metres), the 0.1d indicator and validity."""
    obj_ids = obj_ids.long()
    n_obj = model_points.shape[0]
    safe_ids = obj_ids.clamp(0, n_obj - 1)
    valid = (obj_ids >= 0) & (obj_ids < n_obj) & present[safe_ids]
    pts = model_points[safe_ids]
    gt_pts = _transform_points(pts, gt_rot_mat, gt_trans)
    pred_pts = _transform_points(pts, pred_rot_mat, pred_trans)
    add = _point_mean(torch.linalg.norm(pred_pts - gt_pts, dim=-1), safe_ids, num_valid)
    # padded GT points repeat real ones, so the min over GT is unaffected
    add_s = _point_mean(pairwise_min_dist(pred_pts, gt_pts), safe_ids, num_valid)
    effective = torch.where(symmetric[safe_ids], add_s, add)
    correct = (effective < 0.1 * diameters[safe_ids]).float()
    return {"add": add, "add_s": add_s, "effective": effective, "correct": correct,
            "valid": valid}


def add_metrics(model_points, diameters, symmetric, present, pred_rot_mat,
                pred_trans, gt_rot_mat, gt_trans, obj_ids, num_valid=None) -> dict:
    """Batch means over valid samples: 'add_mean' and 'add_s_mean' in mm,
    'add_01d_acc' in %, and 'count' (reference models/add_loss.py:156-201)."""
    per = add_per_sample(model_points, diameters, symmetric, present, pred_rot_mat,
                         pred_trans, gt_rot_mat, gt_trans, obj_ids, num_valid)
    valid = per["valid"]
    count = valid.sum()
    denom = count.clamp_min(1)
    vmask = valid.float()
    return {
        "add_mean": (per["add"] * vmask).sum() / denom * 1000.0,
        "add_s_mean": (per["add_s"] * vmask).sum() / denom * 1000.0,
        "add_01d_acc": (per["correct"] * vmask).sum() / denom * 100.0,
        "count": count,
    }
