"""Serving-side PoseNet forward (counterpart of
pose6d_tpu/models/posenet_serving.py): the towers run over BN-folded trees
(ops/quant.py), optionally through the fused stem/layer1 CUDA kernels, and
the float heads of the PoseNet module finish the pose.

The JAX package needs a second, functional copy of the head math because
its flax module has no seam between towers and heads; here PoseNet.heads is
that seam, so the heads exist once.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.quant import fold_bn_resnet, folded_resnet50_forward
from .posenet import PoseNet, PoseNetConfig


def backbone_features(model: PoseNet, name: str, x: torch.Tensor,
                      compute_dtype=torch.float32,
                      folded: Optional[Dict] = None) -> torch.Tensor:
    """One tower's [B, 2048] f32 features. With `folded` (an entry prepared
    by PosePipeline.fold_backbones: {"tree", optional "pallas_stem",
    "pallas_l1"}) the folded serving path in compute_dtype; else the tower
    is folded on the fly and run in f32 (equal to the float tower)."""
    if folded is not None:
        return folded_resnet50_forward(
            folded["tree"], x, compute_dtype=compute_dtype,
            pallas_l1=folded.get("pallas_l1"), pallas_stem=folded.get("pallas_stem"))
    return folded_resnet50_forward(fold_bn_resnet(getattr(model, name)), x.float())


def serving_forward(model: PoseNet, cfg: PoseNetConfig, rgb: torch.Tensor,
                    depth: torch.Tensor, compute_dtype=torch.float32,
                    folded: Optional[Dict[str, Dict]] = None):
    """Eval-mode rgbd forward with folded towers. `folded` maps tower names
    ('rgb_backbone', 'depth_backbone') to prepared folded entries; a tower
    it does not name runs the exact f32 folded path. Returns (rotation
    [B, 4] unit xyzw, translation [B, 3])."""
    if cfg.variant != "rgbd":
        raise NotImplementedError(f"serving_forward: variant {cfg.variant!r} is not ported")
    fd = folded or {}
    feats = [backbone_features(model, name, x, compute_dtype, fd.get(name))
             for name, x in (("rgb_backbone", rgb), ("depth_backbone", depth))]
    return model.heads(*feats)
