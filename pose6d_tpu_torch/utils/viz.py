"""Host-side overlays: project 3D boxes and axes and draw them onto frames
(counterpart of pose6d_tpu/utils/viz.py, the reference's
utils/visualization.py:8-70). Projection is geometry.pinhole on CPU
tensors; drawing is data/raster.py, cv2's line algorithm in numpy. Colours
are channel values in the image's own order: the defaults are the JAX
package's, which draws on BGR frames (draw_axes' X is (0, 0, 255))."""

from __future__ import annotations

import numpy as np
import torch

from ..data import raster
from ..geometry.pinhole import project_points as _project

__all__ = ["project_points", "draw_3d_box", "draw_axes", "draw_rectangle"]

EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7)]
AXIS_COLORS = ((0, 0, 255), (0, 255, 0), (255, 0, 0))  # X, Y, Z on a BGR frame


def project_points(points_3d, rotation, translation, K) -> np.ndarray:
    """[N, 3] points + pose (xyzw quaternion or 3x3 matrix) + K -> integer
    pixel coordinates [N, 2] (float32 projection, truncated)."""
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    pts = _project(f32(points_3d), f32(rotation), f32(translation), f32(K))
    return pts.numpy().astype(int)


def draw_3d_box(img, pts_2d, color=(0, 255, 0), thickness=2) -> None:
    """The 12 wireframe edges of [8, 2] projected corners, in place."""
    for s, e in EDGES:
        raster.line(img, (int(pts_2d[s][0]), int(pts_2d[s][1])),
                    (int(pts_2d[e][0]), int(pts_2d[e][1])), color, thickness)


def draw_axes(img, rotation, translation, K, scale=0.1) -> None:
    """The object's X, Y, Z axes (`scale` metres) from its origin, in place."""
    pts = project_points(np.asarray([[0, 0, 0], [scale, 0, 0], [0, scale, 0], [0, 0, scale]],
                                    np.float32), rotation, translation, K)
    for axis in range(3):
        raster.line(img, tuple(pts[0]), tuple(pts[axis + 1]), AXIS_COLORS[axis], 3)


def draw_rectangle(img, pt1, pt2, color, thickness=2) -> None:
    """An axis-aligned box outline with corners pt1, pt2, in place."""
    raster.rectangle(img, pt1, pt2, color, thickness)
