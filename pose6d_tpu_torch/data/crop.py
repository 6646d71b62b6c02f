"""Constants of the square-crop and depth contract (the port's own copy of
pose6d_tpu/data/crop.py's and data/pipeline.py's constants; reference
data/dataset_rgb.py:83-147, data/dataset_rgbd.py:85-206), and the rgbd
network's depth normalization. rgbd_geometric's depth guards reuse the
depth constants."""

import torch

DEPTH_MIN_M = 0.1
DEPTH_MAX_M = 1.6
DEPTH_INVALID_M = 0.01

# square crop side: CROP_EXPANSION * max(w, h) of the (jittered) box
CROP_EXPANSION = 1.2
# train-time bbox jitter per data flavour: (position, scale) fractions of
# the box (data/dataset_rgb.py:101-110, dataset_rgbd.py:110-118)
JITTER = {"rgb": (0.15, 0.20), "rgbd": (0.05, 0.10)}


def normalize_depth(raw: torch.Tensor) -> torch.Tensor:
    """Metric depth -> the rgbd network's depth channel, same shape:
    clip((raw - 0.1) / 1.5, 0, 1), and 0 where raw < 0.01 m (invalid)."""
    d = torch.clamp((raw - DEPTH_MIN_M) / (DEPTH_MAX_M - DEPTH_MIN_M), 0.0, 1.0)
    return torch.where(raw < DEPTH_INVALID_M, torch.zeros_like(d), d)
