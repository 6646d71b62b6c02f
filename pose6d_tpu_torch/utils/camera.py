"""Camera and ground-truth lookup for single frames (counterpart of
pose6d_tpu/utils/camera.py), with the reference's return tuple and
fallbacks (utils/camera.py:15-56). gt.yml and info.yml are parsed by the
port's C++ parser (data/_native.py); there is no PyYAML fallback."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..data import _native
from ..geometry.pinhole import DEFAULT_K

__all__ = ["DEFAULT_K", "load_frame_intrinsics", "load_frame_pose", "get_gt_and_K"]


def load_frame_intrinsics(data_dir: str, obj_folder: str, frame_id: int) -> np.ndarray:
    """One frame's camera matrix from info.yml: the frame's entry, else the
    file's first entry, else DEFAULT_K."""
    info_path = os.path.join(data_dir, obj_folder, "info.yml")
    if os.path.exists(info_path):
        infos = _native.parse_info(info_path)
        entry = infos.get(frame_id) if infos else None
        if entry is None and infos:
            entry = infos[min(infos)]
        if entry is not None:
            return np.asarray(entry["cam_K"], dtype=np.float64).reshape(3, 3)
    return DEFAULT_K.copy()


def load_frame_pose(data_dir: str, obj_folder: str,
                    frame_id: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(rotation matrix, translation in metres) of the folder's own object
    in one frame, or None when it is not annotated there."""
    gt_path = os.path.join(data_dir, obj_folder, "gt.yml")
    if not os.path.exists(gt_path):
        return None
    annotations = _native.parse_gt(gt_path).get(frame_id, [])
    match = next((a for a in annotations if f"{int(a['obj_id']):02d}" == obj_folder), None)
    if match is None:
        return None
    rot = np.asarray(match["cam_R_m2c"], dtype=np.float64).reshape(3, 3)
    return rot, np.asarray(match["cam_t_m2c"], dtype=np.float64) / 1000.0


def get_gt_and_K(data_dir: str, obj_id_str: str, frame_id: int):
    """(rot_mat, trans_m, K): the pose entries are None for a frame that is
    not annotated; K always resolves."""
    pose = load_frame_pose(data_dir, obj_id_str, frame_id)
    K = load_frame_intrinsics(data_dir, obj_id_str, frame_id)
    if pose is None:
        return None, None, K
    return pose[0], pose[1], K
