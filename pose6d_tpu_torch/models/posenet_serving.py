"""Serving-side PoseNet forward (counterpart of
pose6d_tpu/models/posenet_serving.py): the ResNet50 towers run over
BN-folded trees (ops/quant.py), optionally through the fused stem, layer1
and stage CUDA kernels, or over int8 trees (int8_resnet50_forward), and
the float heads of the PoseNet module finish the pose, for all four
variants.

The JAX package needs a second, functional copy of the head math
(_mlp_head_eval, _z_backbone_eval, _depth_pinhole_eval, ...) because its
flax module has no seam between towers and heads; here PoseNet.heads is
that seam, so the heads exist once and serve both forwards.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.quant import fold_bn_resnet, folded_resnet50_forward, int8_resnet50_forward
from .posenet import PoseNet, PoseNetConfig


def backbone_features(model: PoseNet, name: str, x: torch.Tensor,
                      compute_dtype=torch.float32,
                      folded: Optional[Dict] = None,
                      quantized: Optional[Dict] = None) -> torch.Tensor:
    """One tower's [B, 2048] f32 features. With `quantized` (an int8 tree,
    ops.quant.quantize_folded) the int8 path, its compute_dtype features
    cast to f32; else with `folded` (an entry prepared by
    PosePipeline.fold_backbones: {"tree", optional "pallas_stem",
    "pallas_l1", "pallas_stages"}) the folded serving path in
    compute_dtype; else the tower is folded on the fly and run in f32
    (equal to the float tower)."""
    if quantized is not None:
        return int8_resnet50_forward(quantized, x, compute_dtype).float()
    if folded is not None:
        return folded_resnet50_forward(
            folded["tree"], x, compute_dtype=compute_dtype,
            pallas_l1=folded.get("pallas_l1"), pallas_stem=folded.get("pallas_stem"),
            pallas_stages=folded.get("pallas_stages"))
    return folded_resnet50_forward(fold_bn_resnet(getattr(model, name)), x.float())


def serving_forward(model: PoseNet, cfg: PoseNetConfig, rgb: torch.Tensor,
                    depth: Optional[torch.Tensor] = None,
                    depth_raw: Optional[torch.Tensor] = None,
                    bbox_center: Optional[torch.Tensor] = None,
                    camera_matrix: Optional[torch.Tensor] = None,
                    compute_dtype=torch.float32,
                    folded: Optional[Dict[str, Dict]] = None,
                    quantized: Optional[Dict[str, Dict]] = None):
    """Eval-mode PoseNet forward with serving towers. `folded` maps tower
    names ('backbone', or 'rgb_backbone' and 'depth_backbone') to prepared
    folded entries, `quantized` to int8 trees (a tower in both runs int8);
    a tower neither names runs the exact f32 folded path. Returns
    (rotation [B, 4] unit xyzw, translation [B, 3]) like PoseNet.forward.

    rgb_geometric's ZBackbone takes f32 crops only: the JAX package's
    serving forward runs its f32 kernels on the crops as they come and
    refuses bf16 crops (mixed conv dtypes), so this refuses them too."""
    if cfg.variant == "rgb_geometric" and not cfg.z_from_backbone and rgb.dtype != torch.float32:
        raise TypeError(f"serving_forward: rgb_geometric's ZBackbone has f32 weights and "
                        f"takes f32 crops, got {rgb.dtype} (the JAX serving forward "
                        f"refuses mixed conv dtypes the same way)")
    fd, q = folded or {}, quantized or {}
    feats = {name: backbone_features(model, name, x, compute_dtype, fd.get(name), q.get(name))
             for name, x in model.tower_inputs(rgb, depth).items()}
    return model.heads(feats, rgb, depth_raw, bbox_center, camera_matrix)
