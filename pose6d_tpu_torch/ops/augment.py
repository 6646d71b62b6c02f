"""Eval-time image preprocessing (counterpart of the eval half of
pose6d_tpu/ops/augment.py): uint8 or [0, 1] float images -> ImageNet
normalization. Images are [B, H, W, 3] (NHWC)."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_float01(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]; float images pass through."""
    if rgb.dtype == torch.uint8:
        return rgb.float() / 255.0
    return rgb


def normalize(img: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    mean = torch.tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def eval_preprocess(rgb: torch.Tensor) -> torch.Tensor:
    """Eval path: normalize only (reference train_rgb.py:52-56)."""
    return normalize(to_float01(rgb))
