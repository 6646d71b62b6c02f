"""LineMOD dataset index (counterpart of pose6d_tpu/data/linemod.py):
directory scan, gt.yml / info.yml through the port's C++ parser
(data/_native.py; no yaml), and the interleaved split.

Semantics of the reference (data/dataset_rgb.py:32-78,
data/dataset_rgbd.py:32-80):
  - object folders are the numeric subdirectories of the root;
  - per-frame ground truth from gt.yml, intrinsics from info.yml;
  - the interleaved 80/10/10 split by sorted-image position: i % 10 == 8
    is val, 9 test, the rest train;
  - `build_index` keeps the folder's own object only, 0-indexed;
    `build_frame_index` keeps every annotation of a frame.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from . import _native


@dataclasses.dataclass
class Sample:
    img_path: str
    depth_path: Optional[str]
    obj_id: int  # 0-indexed
    bbox: np.ndarray  # [4] x, y, w, h in the original frame
    rot_mat: np.ndarray  # [3, 3] cam_R_m2c
    trans_mm: np.ndarray  # [3] cam_t_m2c in millimetres
    cam_K: np.ndarray  # [3, 3] float32


@dataclasses.dataclass
class FrameSample:
    """One frame with every annotated object: the unit a detector sees."""

    img_path: str
    depth_path: Optional[str]
    cam_K: np.ndarray  # [3, 3]
    objects: List[Sample]  # one per annotation, obj_id 0-indexed


def split_of_index(i: int) -> str:
    cycle = i % 10
    if cycle == 8:
        return "val"
    if cycle == 9:
        return "test"
    return "train"


def _frames(root_dir: str, mode: str, require_depth: bool) -> Iterator[Tuple]:
    """(folder, image path, depth path or None, cam_K, annotations) of every
    frame of `mode` with ground truth and intrinsics, folder by folder in
    sorted order, frames in sorted file order."""
    if not os.path.exists(root_dir):
        raise FileNotFoundError(f"Root dir not found: {root_dir}")
    for obj_folder in sorted(f for f in os.listdir(root_dir) if f.isdigit()):
        base = os.path.join(root_dir, obj_folder)
        gt_path, info_path = os.path.join(base, "gt.yml"), os.path.join(base, "info.yml")
        rgb_dir, depth_dir = os.path.join(base, "rgb"), os.path.join(base, "depth")
        if not (os.path.exists(gt_path) and os.path.exists(info_path)):
            continue
        has_depth = os.path.exists(depth_dir)
        if require_depth and not has_depth:
            continue
        gts, infos = _native.parse_gt(gt_path), _native.parse_info(info_path)
        images = sorted(img for img in os.listdir(rgb_dir) if img.endswith(".png"))
        for i, img_name in enumerate(images):
            if split_of_index(i) != mode:
                continue
            frame_id = int(img_name.split(".")[0])
            if frame_id not in gts or frame_id not in infos:
                continue
            cam_K = np.asarray(infos[frame_id]["cam_K"], dtype=np.float32).reshape(3, 3)
            yield (obj_folder, os.path.join(rgb_dir, img_name),
                   os.path.join(depth_dir, img_name) if has_depth else None, cam_K,
                   gts[frame_id])


def _sample(img_path, depth_path, obj_id: int, anno: dict, cam_K) -> Sample:
    return Sample(img_path=img_path, depth_path=depth_path, obj_id=obj_id,
                  bbox=np.asarray(anno["obj_bb"], dtype=np.float64),
                  rot_mat=np.asarray(anno["cam_R_m2c"], dtype=np.float64).reshape(3, 3),
                  trans_mm=np.asarray(anno["cam_t_m2c"], dtype=np.float64), cam_K=cam_K)


def build_index(root_dir: str, mode: str = "train", require_depth: bool = False) -> List[Sample]:
    """The flat per-object sample list of a split: each frame's annotation
    of its folder's own object."""
    samples: List[Sample] = []
    for folder, img_path, depth_path, cam_K, annos in _frames(root_dir, mode, require_depth):
        for anno in annos:
            if str(int(anno["obj_id"])).zfill(2) == folder:
                samples.append(_sample(img_path, depth_path, int(folder) - 1, anno, cam_K))
    return samples


def build_frame_index(root_dir: str, mode: str = "train",
                      require_depth: bool = False) -> List[FrameSample]:
    """The frame-level index of a split: every annotation of each frame
    (no per-folder object filter), grouped per image."""
    frames: List[FrameSample] = []
    for _, img_path, depth_path, cam_K, annos in _frames(root_dir, mode, require_depth):
        objs = [_sample(img_path, depth_path, int(a["obj_id"]) - 1, a, cam_K) for a in annos]
        if objs:
            frames.append(FrameSample(img_path=img_path, depth_path=depth_path, cam_K=cam_K,
                                      objects=objs))
    return frames
