"""3D box corners from PLY models (counterpart of pose6d_tpu/utils/mesh.py,
the reference's utils/mesh_utils.py:7-53): ASCII PLY, mm -> m, points
beyond 0.3 m dropped, the box of the 1st / 99th percentiles."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..losses.add import _parse_ascii_ply

__all__ = ["load_mesh_corners"]


def load_mesh_corners(mesh_dir: str, obj_id_str: str) -> Optional[np.ndarray]:
    """[8, 3] box corners in metres, or None if the mesh is absent or empty."""
    ply_path = os.path.join(mesh_dir, f"obj_{obj_id_str}.ply")
    if not os.path.exists(ply_path):
        return None
    verts = _parse_ascii_ply(ply_path) / 1000.0
    if verts.size == 0:
        return None
    verts = verts[np.linalg.norm(verts, axis=1) < 0.3]
    if len(verts) == 0:
        return None
    lo = np.percentile(verts, 1, axis=0)
    hi = np.percentile(verts, 99, axis=0)
    return np.asarray([
        [lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]], [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]], [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]],
    ])
