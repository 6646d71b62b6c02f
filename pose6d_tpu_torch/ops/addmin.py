"""ADD-S nearest-point distance (counterpart of
pose6d_tpu/ops/pallas_addmin.py pairwise_min_dist_pallas).

`pairwise_min_dist_kernel` launches the CUDA kernel (csrc/addmin.cu) for a
CUDA tensor and runs the plain version `_pairwise_min_dist` for a CPU
tensor; any other device raises. Inputs are expected centred per sample
(losses/add.py does it).
"""

from __future__ import annotations

import torch

from .. import _build


def _pairwise_min_dist(pred_pts: torch.Tensor, gt_pts: torch.Tensor) -> torch.Tensor:
    """Plain version, the JAX package's expansion (losses/add.py
    _pairwise_min_dist): sqrt(min_q max(|a|^2 + |b|^2 - 2 a.b, 0)) over the
    [B, P, P] matrix from one batched matmul. [B,P,3] x [B,P,3] -> [B,P]."""
    pred2 = (pred_pts * pred_pts).sum(-1)
    gt2 = (gt_pts * gt_pts).sum(-1)
    cross = torch.einsum("bpi,bqi->bpq", pred_pts, gt_pts)
    d2 = torch.clamp_min(pred2[:, :, None] + gt2[:, None, :] - 2.0 * cross, 0.0)
    return torch.sqrt(d2.min(dim=2).values)


def _launch_addmin(pred, gt, out, stream: int) -> None:
    B, P, _ = pred.shape
    code = _build.lib().pose6d_addmin_forward(
        pred.data_ptr(), gt.data_ptr(), out.data_ptr(), B, P, stream)
    _build.check(code, "pairwise_min_dist_kernel")


def pairwise_min_dist_kernel(pred_pts: torch.Tensor, gt_pts: torch.Tensor) -> torch.Tensor:
    """For each predicted point, the distance to the nearest GT point:
    [B,P,3] x [B,P,3] f32 -> [B,P] f32."""
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
    out = torch.empty(pred_pts.shape[:2], dtype=torch.float32, device=pred_pts.device)
    with _build.on_device(pred_pts.device) as stream:
        _launch_addmin(pred_pts, gt_pts, out, stream)
    _build.launch_counts["pairwise_min_dist"] += 1
    return out
