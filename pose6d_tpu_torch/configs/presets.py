"""Per-variant training presets (counterpart of
pose6d_tpu/configs/presets.py), the reference's script constants
(train_rgb.py:27-33, 70-73 and siblings):
  - 75 epochs, batch 32, AdamW lr 1e-4 wd 1e-4, grad clip 1.0;
  - loss geodesic + 10 x L1;
  - plateau: factor 0.5, patience 5; only rgb adds min_lr 1e-7;
  - augmentation: ColorJitter(0.3, 0.3, 0.3, 0.05) + RandomErasing(0.2);
    only rgb adds RandomGrayscale(0.1).
"""

from __future__ import annotations

import dataclasses

from ..ops.augment import AugmentConfig
from ..train.loop import TrainConfig

_BASE = dict(img_size=224, batch_size=32, epochs=75, learning_rate=1e-4,
             weight_decay=1e-4, grad_clip=1.0, plateau_factor=0.5, plateau_patience=5)

PRESETS = {
    "rgb": TrainConfig(variant="rgb", min_lr=1e-7, augment=AugmentConfig(grayscale_p=0.1),
                       **_BASE),
    "rgb_geometric": TrainConfig(variant="rgb_geometric", min_lr=0.0,
                                 augment=AugmentConfig(grayscale_p=0.0), **_BASE),
    "rgbd": TrainConfig(variant="rgbd", min_lr=0.0, augment=AugmentConfig(grayscale_p=0.0),
                        **_BASE),
    "rgbd_geometric": TrainConfig(variant="rgbd_geometric", min_lr=0.0,
                                  augment=AugmentConfig(grayscale_p=0.0), **_BASE),
}

VARIANTS = tuple(PRESETS)


def get_preset(variant: str, **overrides) -> TrainConfig:
    """PRESETS[variant] with `overrides` (TrainConfig fields) replaced."""
    cfg = PRESETS[variant]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
