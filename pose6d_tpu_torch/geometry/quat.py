"""Quaternions in the scipy [x, y, z, w] convention, batched over leading
axes (counterpart of pose6d_tpu/geometry/quat.py)."""

from __future__ import annotations

import torch

_EPS = 1e-8


def quat_normalize(q: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """L2-normalize quaternions along the last axis (safe at zero)."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """xyzw quaternions [..., 4] -> rotation matrices [..., 3, 3] (assumes
    approximately unit quaternions, as the reference's ADD loss does)."""
    x, y, z, w = q.unbind(-1)
    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * y2 - 2 * z2, 2 * xy - 2 * wz, 2 * xz + 2 * wy], -1)
    row1 = torch.stack([2 * xy + 2 * wz, 1 - 2 * x2 - 2 * z2, 2 * yz - 2 * wx], -1)
    row2 = torch.stack([2 * xz - 2 * wy, 2 * yz + 2 * wx, 1 - 2 * x2 - 2 * y2], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> xyzw quaternions [..., 4].

    Branch-free Shepperd's method: all four pivot candidates are computed
    and the one with the largest pivot is selected."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def pivot(v):
        h = torch.sqrt(torch.clamp_min(v, _EPS)) * 0.5
        return h, 0.25 / torch.clamp_min(h, _EPS)

    qw, s = pivot(1.0 + tr)
    cand_w = torch.stack([(m21 - m12) * s, (m02 - m20) * s, (m10 - m01) * s, qw], -1)
    qx, s = pivot(1.0 + m00 - m11 - m22)
    cand_x = torch.stack([qx, (m01 + m10) * s, (m02 + m20) * s, (m21 - m12) * s], -1)
    qy, s = pivot(1.0 - m00 + m11 - m22)
    cand_y = torch.stack([(m01 + m10) * s, qy, (m12 + m21) * s, (m02 - m20) * s], -1)
    qz, s = pivot(1.0 - m00 - m11 + m22)
    cand_z = torch.stack([(m02 + m20) * s, (m12 + m21) * s, qz, (m10 - m01) * s], -1)

    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], -1)
    choice = torch.argmax(pivots, dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # [..., 4, 4]
    idx = choice[..., None, None].expand(*choice.shape, 1, 4)
    return quat_normalize(torch.gather(cands, -2, idx).squeeze(-2))
