"""Pinhole-camera bookkeeping (counterpart of
pose6d_tpu/geometry/pinhole.py): X = (u - cx) Z / fx, Y = (v - cy) Z / fy."""

from __future__ import annotations

import torch


def pinhole_xy_from_z(z: torch.Tensor, bbox_center: torch.Tensor,
                      camera_matrix: torch.Tensor) -> torch.Tensor:
    """Back-project pixel (u, v) at depth z: z [B] or [B, 1], bbox_center
    [B, 2], camera_matrix [B, 3, 3] or [3, 3] -> translation [B, 3]."""
    z = z.reshape(z.shape[0], -1)[:, :1]
    if camera_matrix.ndim == 2:
        camera_matrix = camera_matrix.expand(z.shape[0], 3, 3)
    fx = camera_matrix[:, 0, 0:1]
    fy = camera_matrix[:, 1, 1:2]
    cx = camera_matrix[:, 0, 2:3]
    cy = camera_matrix[:, 1, 2:3]
    x = (bbox_center[:, 0:1] - cx) * z / fx
    y = (bbox_center[:, 1:2] - cy) * z / fy
    return torch.cat([x, y, z], dim=-1)


def adjust_intrinsics_for_crop(camera_matrix, x1, y1, pad_l, pad_t, scale):
    """Intrinsics of a square crop + resize: cx' = (cx + pad_l - x1) * s,
    fx' = fx * s (reference data/dataset_rgbd.py:158-169)."""
    fx = camera_matrix[..., 0, 0]
    fy = camera_matrix[..., 1, 1]
    cx = camera_matrix[..., 0, 2]
    cy = camera_matrix[..., 1, 2]
    cx_crop = (cx + pad_l - x1) * scale
    cy_crop = (cy + pad_t - y1) * scale
    fx_crop = fx * scale
    fy_crop = fy * scale
    zeros = torch.zeros_like(fx_crop)
    ones = torch.ones_like(fx_crop)
    row0 = torch.stack([fx_crop, zeros, cx_crop], -1)
    row1 = torch.stack([zeros, fy_crop, cy_crop], -1)
    row2 = torch.stack([zeros, zeros, ones], -1)
    return torch.stack([row0, row1, row2], dim=-2)
