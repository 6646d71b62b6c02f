"""Batched ADD / ADD-S / ADD-0.1d evaluation (counterpart of
pose6d_tpu/losses/add.py).

The object point clouds are stacked into one [n_obj, P, 3] tensor; a batch
gathers its objects by id. ADD-S's nearest-point search runs through the
CUDA kernel of ops/addmin.py on the card (its plain version on the CPU),
after per-sample centring. Symmetric objects use ADD-S for the 0.1d
decision; means cover each object's real (non-padded) points only.

The object models load from a LineMOD models directory (ASCII PLY meshes,
mm -> m, the ||p|| < 0.5 m outlier filter, models_info.yml diameters,
500 points drawn as the JAX package draws them: `load_object_models`), or
are built from arrays (`ObjectModels`). `ADDEvaluator` holds them on a
device. `add_loss` is the differentiable ADD(-S): its ADD-S backward is
(p - g[argmin]) / d through the argmin the kernel returns (`NearestDistance`).
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..geometry.quat import quat_to_mat
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


def _parse_ascii_ply(path: str) -> np.ndarray:
    """The x, y, z columns of an ASCII PLY file's rows after end_header
    (every row of three or more numbers: vertices, as the JAX reader
    takes them) [N, 3] float64."""
    verts = []
    header_end = False
    with open(path, "r") as f:
        for line in f:
            if not header_end:
                header_end = "end_header" in line
                continue
            vals = line.strip().split()
            if len(vals) >= 3:
                verts.append([float(vals[0]), float(vals[1]), float(vals[2])])
    return np.asarray(verts, dtype=np.float64)


_INFO_LINE = re.compile(r"^(-?\d+)\s*:\s*\{(.*)\}$")


def parse_models_info(path: str) -> dict:
    """models_info.yml's `N: {diameter: x, min_x: y, ...}` lines -> {N:
    {field: float}}, as yaml.safe_load reads them. Blank and comment lines
    are skipped; any other line raises ValueError naming the file."""
    info: dict = {}
    with open(path, "r") as f:
        for n, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            m = _INFO_LINE.match(line)
            if m is None:
                raise ValueError(f"{path}:{n}: not an `N: {{field: value, ...}}` line")
            fields = (item.split(":", 1) for item in m.group(2).split(",") if ":" in item)
            info[int(m.group(1))] = {k.strip(): float(v) for k, v in fields}
    return info


def load_object_models(model_dir: str, n_obj: int = 15, num_points: int = 500, seed: int = 0,
                       symmetric_ids: tuple = SYMMETRIC_OBJECT_IDS) -> "ObjectModels":
    """obj_XX.ply meshes and models_info.yml diameters of `model_dir` as
    stacked CPU tensors; the same points as the JAX package's
    load_object_models bit for bit (its rng.choice draws, in its order).
    A mesh over num_points points is downsampled; one under is padded by
    repeats (num_valid keeps the real count); an object without a mesh is
    zero and not present; without an official diameter one comes from the
    largest distance among <= 100 sampled points (0.1 m by default)."""
    rng = np.random.default_rng(seed)
    official = {}
    info_path = os.path.join(model_dir, "models_info.yml")
    if os.path.exists(info_path):
        for key, data in parse_models_info(info_path).items():
            if "diameter" in data:
                official[key - 1] = data["diameter"] / 1000.0

    points = np.zeros((n_obj, num_points, 3), dtype=np.float32)
    diameters = np.full((n_obj,), 0.1, dtype=np.float32)
    present = np.zeros((n_obj,), dtype=bool)
    num_valid = np.full((n_obj,), num_points, dtype=np.int32)
    if os.path.isdir(model_dir):
        for ply_file in sorted(f for f in os.listdir(model_dir) if f.endswith(".ply")):
            try:
                obj_id = int(ply_file.split("_")[1].split(".")[0]) - 1
            except (IndexError, ValueError):
                continue
            if not 0 <= obj_id < n_obj:
                continue
            pts = _parse_ascii_ply(os.path.join(model_dir, ply_file)) / 1000.0
            if pts.size == 0:
                continue
            pts = pts[np.linalg.norm(pts, axis=1) < 0.5]
            if pts.shape[0] == 0:
                continue
            if obj_id in official:
                diameters[obj_id] = official[obj_id]
            elif pts.shape[0] > 10:
                sample = pts[rng.choice(pts.shape[0], min(100, pts.shape[0]), replace=False)]
                diameters[obj_id] = float(np.max(
                    np.linalg.norm(sample[:, None] - sample[None, :], axis=2)))
            if pts.shape[0] > num_points:
                pts = pts[rng.choice(pts.shape[0], num_points, replace=False)]
            elif pts.shape[0] < num_points:
                num_valid[obj_id] = pts.shape[0]
                idx = rng.choice(pts.shape[0], num_points - pts.shape[0], replace=True)
                pts = np.concatenate([pts, pts[idx]], axis=0)
            points[obj_id] = pts.astype(np.float32)
            present[obj_id] = True
    symmetric = np.zeros((n_obj,), dtype=bool)
    for sid in symmetric_ids:
        if 0 <= sid < n_obj:
            symmetric[sid] = True
    return ObjectModels(*(torch.from_numpy(a) for a in (points, diameters, symmetric, present,
                                                         num_valid)))


def _transform_points(points, rot_mat, trans):
    """Per-sample rigid transform: [B, P, 3] x [B, 3, 3] + [B, 3]."""
    return torch.einsum("bpj,bij->bpi", points, rot_mat) + trans[:, None, :]


def pairwise_min_dist(pred_pts: torch.Tensor, gt_pts: torch.Tensor) -> torch.Tensor:
    """Nearest-GT distance per predicted point [B, P], with per-sample
    centring (translation-invariant; keeps f32 away from cancellation at
    metre offsets). The search is the f32 kernel's; float64 clouds (a
    float64 module's evaluation) are searched in f32 and the distances
    given back in float64."""
    center = gt_pts.mean(dim=1, keepdim=True)
    return pairwise_min_dist_kernel((pred_pts - center).float().contiguous(),
                                    (gt_pts - center).float().contiguous()).to(pred_pts.dtype)


class NearestDistance(torch.autograd.Function):
    """pairwise_min_dist on centred clouds with a backward: the forward is
    the kernel (its plain version on the CPU) with its argmin output; the
    backward gives each predicted point grad * (p - g[argmin]) / d and
    scatters its negative onto that GT point, in elementwise torch ops
    (the argmin is never recomputed). On exact ties it all goes to the
    lowest index, where JAX's min splits the GT side's share; a point at
    distance 0 gets 0, where JAX's sqrt gives NaN."""

    @staticmethod
    def forward(ctx, pred, gt):
        dist, idx = pairwise_min_dist_kernel(pred, gt, return_index=True)
        ctx.save_for_backward(pred, gt, dist, idx)
        return dist

    @staticmethod
    def backward(ctx, grad):
        pred, gt, dist, idx = ctx.saved_tensors
        idx3 = idx[..., None].expand(-1, -1, 3)
        scale = torch.where(dist > 0, grad / torch.where(dist > 0, dist, 1.0), 0.0)
        g_pred = (pred - torch.gather(gt, 1, idx3)) * scale[..., None]
        g_gt = torch.zeros_like(gt).scatter_add_(1, idx3, -g_pred)
        return g_pred, g_gt


def _nearest_distance(pred_pts: torch.Tensor, gt_pts: torch.Tensor) -> torch.Tensor:
    """pairwise_min_dist, differentiable (NearestDistance)."""
    center = gt_pts.mean(dim=1, keepdim=True)
    return NearestDistance.apply((pred_pts - center).contiguous(),
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
                pred_trans, gt_rot_mat, gt_trans, obj_ids, num_valid=None, group=None) -> dict:
    """Batch means over valid samples: 'add_mean' and 'add_s_mean' in mm,
    'add_01d_acc' in %, and 'count' (reference models/add_loss.py:156-201).
    group (a data group, parallel/collectives.Group): each rank holds its
    rows, and the sums and the count are all-reduced before the division,
    so every rank gets the means of the global batch."""
    per = add_per_sample(model_points, diameters, symmetric, present, pred_rot_mat,
                         pred_trans, gt_rot_mat, gt_trans, obj_ids, num_valid)
    valid = per["valid"]
    vmask = valid.float()
    sums = [(per[k] * vmask).sum() for k in ("add", "add_s", "correct")]
    count = valid.sum()
    if group is not None:
        from ..parallel.collectives import all_reduce_

        total = all_reduce_(torch.stack(sums + [count.to(vmask.dtype)]), group)
        sums, count = list(total[:3]), total[3].round().long()
    denom = count.clamp_min(1)
    return {
        "add_mean": sums[0] / denom * 1000.0,
        "add_s_mean": sums[1] / denom * 1000.0,
        "add_01d_acc": sums[2] / denom * 100.0,
        "count": count,
    }


def add_loss(model_points, symmetric, present, pred_rot_mat, pred_trans, gt_rot_mat, gt_trans,
             obj_ids, num_valid=None) -> torch.Tensor:
    """Differentiable ADD(-S) loss (reference models/add_loss.py:101-150):
    per valid sample ADD-S for symmetric objects and ADD otherwise (metres,
    over the real points), averaged over the valid samples."""
    obj_ids = obj_ids.long()
    n_obj = model_points.shape[0]
    safe_ids = obj_ids.clamp(0, n_obj - 1)
    valid = (obj_ids >= 0) & (obj_ids < n_obj) & present[safe_ids]
    pts = model_points[safe_ids]
    gt_pts = _transform_points(pts, gt_rot_mat, gt_trans)
    pred_pts = _transform_points(pts, pred_rot_mat, pred_trans)
    add = _point_mean(torch.linalg.norm(pred_pts - gt_pts, dim=-1), safe_ids, num_valid)
    add_s = _point_mean(_nearest_distance(pred_pts, gt_pts), safe_ids, num_valid)
    per_sample = torch.where(symmetric[safe_ids], add_s, add)
    vmask = valid.float()
    return (per_sample * vmask).sum() / vmask.sum().clamp_min(1.0)


class ADDEvaluator:
    """The object models of `model_dir` (load_object_models) on `device`,
    with the batched metric calls; its tensors are what make_eval_step
    reads (points, diameters, symmetric, present, num_valid)."""

    def __init__(self, model_dir: str, n_obj: int = 15, num_points: int = 500, seed: int = 0,
                 device=DEFAULT_DEVICE):
        self.host_models = load_object_models(model_dir, n_obj=n_obj, num_points=num_points,
                                              seed=seed)
        models = self.host_models.to(device)
        self.points, self.diameters = models.points, models.diameters
        self.symmetric, self.present = models.symmetric, models.present
        self.num_valid = models.num_valid

    @torch.no_grad()
    def eval_metrics_from_quat(self, pred_q, pred_t, gt_q, gt_t, obj_ids) -> dict:
        """add_metrics of xyzw quaternion poses; tensors on the device."""
        dev = self.points.device
        put = lambda t: torch.as_tensor(t).to(dev)  # noqa: E731
        return add_metrics(self.points, self.diameters, self.symmetric, self.present,
                           quat_to_mat(put(pred_q).float()), put(pred_t).float(),
                           quat_to_mat(put(gt_q).float()), put(gt_t).float(), put(obj_ids),
                           num_valid=self.num_valid)

    def eval_metrics(self, pred_q, pred_t, gt_q, gt_t, obj_ids) -> dict:
        """eval_metrics_from_quat as Python floats."""
        out = self.eval_metrics_from_quat(pred_q, pred_t, gt_q, gt_t, obj_ids)
        return {k: float(v) for k, v in out.items()}
