"""PoseNet, the four variants (counterpart of pose6d_tpu/models/posenet.py).

| variant        | towers                      | rotation head       | translation             |
|----------------|-----------------------------|---------------------|-------------------------|
| rgb            | backbone                    | BN/ReLU MLP (2048)  | BN/ReLU MLP, 3-vector   |
| rgb_geometric  | backbone + ZBackbone        | BN/ReLU MLP (1024)  | learned Z, pinhole X/Y  |
| rgbd           | rgb_backbone + depth_backbone, attention fusion | LN/GELU MLP | LN/GELU MLP, 3-vector |
| rgbd_geometric | backbone                    | BN/ReLU MLP (1024)  | depth at the box centre, pinhole X/Y |

Eval mode only (no dropout, BatchNorm on running statistics). Returns
(rotation [B, 4] unit xyzw, translation [B, 3] metres). Inputs are NHWC.

Attribute names follow the flax scopes (backbone, rot_dense0, rot_norm0,
..., rot_out, z_backbone/conv0, ...) so that convert.py maps a flax tree by
transposes. `PoseNet.heads` is everything after the ResNet50 towers, from
their f32 features; the float forward and the folded serving forward
(posenet_serving.py) share it.

Not ported: the space-to-depth stem (`stem_s2d`, raises) and the training
init rules (`attn_zero_init`, zero-init residual gammas).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..data.crop import DEPTH_INVALID_M, DEPTH_MIN_M
from ..geometry.pinhole import pinhole_xy_from_z
from .resnet import BN_EPS, ResNet50

LN_EPS = 1e-6  # flax LayerNorm default
VARIANTS = ("rgb", "rgb_geometric", "rgbd", "rgbd_geometric")
# (widths, norms) of the heads: the rgb variant's BN/ReLU stack, the
# geometric variants' narrower one, and rgbd's LayerNorm/GELU head
WIDE_HEAD = ((2048, 1024, 512), ("batch", "batch", "none"))
NARROW_HEAD = ((1024, 512), ("batch", "batch"))
GELU_HEAD = ((512, 256), ("layer", "none"))
# rgbd_geometric's depth at the box centre: readings at or below
# DEPTH_INVALID_M become DEPTH_FALLBACK_M, and z is clamped to
# [DEPTH_MIN_M, DEPTH_GUARD_MAX_M]
DEPTH_FALLBACK_M = 0.5
DEPTH_GUARD_MAX_M = 2.0


@dataclasses.dataclass(frozen=True)
class PoseNetConfig:
    variant: str = "rgbd"  # rgb | rgb_geometric | rgbd | rgbd_geometric
    img_size: int = 224
    stem_s2d: bool = False  # not ported: raises
    # the geometric variants' and rgbd's rotation head becomes the rgb
    # variant's 2048/1024/512 BN stack
    rot_head_wide: bool = False
    # rgbd: False fuses by a LayerNorm'd concat without the attention residual
    fusion_attention: bool = True
    # rgb_geometric: z from the ResNet50 features through an rgb-style BN
    # head, or a ZBackbone of doubled channels with a 256/128 z head
    z_from_backbone: bool = False
    z_backbone_wide: bool = False


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax nn.gelu's default form


def _add_mlp_head(module: nn.Module, prefix: str, in_dim: int,
                  head: Tuple[Sequence[int], Sequence[str]], out_dim: int) -> None:
    """posenet._mlp_head's layers as attributes of module: {prefix}dense{i},
    {prefix}norm{i} ('batch' or 'layer'; none for 'none'), {prefix}out."""
    for i, (w, norm) in enumerate(zip(*head)):
        setattr(module, f"{prefix}dense{i}", nn.Linear(in_dim, w))
        if norm == "batch":
            setattr(module, f"{prefix}norm{i}", nn.BatchNorm1d(w, eps=BN_EPS))
        elif norm == "layer":
            setattr(module, f"{prefix}norm{i}", nn.LayerNorm(w, eps=LN_EPS))
        in_dim = w
    setattr(module, f"{prefix}out", nn.Linear(in_dim, out_dim))


def _mlp_head(module: nn.Module, prefix: str, x: torch.Tensor, act) -> torch.Tensor:
    """Dense -> norm -> act per layer, then the output Dense (eval mode)."""
    i = 0
    while hasattr(module, f"{prefix}dense{i}"):
        x = getattr(module, f"{prefix}dense{i}")(x)
        norm = getattr(module, f"{prefix}norm{i}", None)
        if norm is not None:
            x = norm(x)
        x = act(x)
        i += 1
    return getattr(module, f"{prefix}out")(x)


class CrossModalAttention(nn.Module):
    """Q from RGB, K/V from depth. The [B, 2048] features reshape to
    [B, 8, 256] and heads attend to each other: a [B, 8, 8] attention
    matrix (reference models/pose_net_rgbd.py:8-35)."""

    def __init__(self, dim: int = 2048, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, rgb_feat, depth_feat):
        B, dim = rgb_feat.shape
        hd = dim // self.num_heads
        q = self.q_proj(rgb_feat).reshape(B, self.num_heads, hd)
        k = self.k_proj(depth_feat).reshape(B, self.num_heads, hd)
        v = self.v_proj(depth_feat).reshape(B, self.num_heads, hd)
        attn = torch.softmax(torch.einsum("bhd,bgd->bhg", q, k) * hd**-0.5, dim=-1)
        return self.out_proj(torch.einsum("bhg,bgd->bhd", attn, v).reshape(B, dim))


class ZBackbone(nn.Module):
    """The 4-conv Z-depth CNN of rgb_geometric (reference
    models/pose_net_rgb_geometric.py:36-55): conv (with bias) -> BN -> ReLU
    -> 2x2 max-pool (VALID) four times, then the spatial mean. NHWC in,
    [B, 256] (or [B, 512] when wide) out."""

    def __init__(self, wide: bool = False):
        super().__init__()
        c = (64, 128, 256, 512) if wide else (32, 64, 128, 256)
        cin = 3
        for i, (k, stride, pad) in enumerate(((7, 2, 3), (5, 1, 2), (3, 1, 1), (3, 1, 1))):
            setattr(self, f"conv{i}", nn.Conv2d(cin, c[i], k, stride, pad))
            setattr(self, f"bn{i}", nn.BatchNorm2d(c[i], eps=BN_EPS))
            cin = c[i]

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        for i in range(4):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
            x = F.max_pool2d(F.relu(x), 2, 2)
        return x.mean(dim=(2, 3))


class PoseNet(nn.Module):
    def __init__(self, config: PoseNetConfig):
        super().__init__()
        v = config.variant
        if v not in VARIANTS:
            raise ValueError(f"unknown variant: {v}")
        if config.stem_s2d:
            raise NotImplementedError("PoseNet stem_s2d: the space-to-depth stem is not ported")
        self.config = config
        if v == "rgbd":
            self.rgb_backbone = ResNet50(in_channels=3)
            self.depth_backbone = ResNet50(in_channels=1)
            self.rgb_norm = nn.LayerNorm(2048, eps=LN_EPS)
            self.depth_norm = nn.LayerNorm(2048, eps=LN_EPS)
            if config.fusion_attention:
                self.cross_attention = CrossModalAttention()
            self.fusion_dense0 = nn.Linear(4096, 1024)
            self.fusion_norm0 = nn.LayerNorm(1024, eps=LN_EPS)
            self.fusion_dense1 = nn.Linear(1024, 1024)
            self.fusion_norm1 = nn.LayerNorm(1024, eps=LN_EPS)
            _add_mlp_head(self, "rot_", 1024, WIDE_HEAD if config.rot_head_wide else GELU_HEAD, 4)
            _add_mlp_head(self, "trans_", 1024, GELU_HEAD, 3)
            return
        self.backbone = ResNet50(in_channels=3)
        if v == "rgb":
            _add_mlp_head(self, "rot_", 2048, WIDE_HEAD, 4)
            _add_mlp_head(self, "trans_", 2048, WIDE_HEAD, 3)
            return
        _add_mlp_head(self, "rot_", 2048, WIDE_HEAD if config.rot_head_wide else NARROW_HEAD, 4)
        if v == "rgb_geometric" and config.z_from_backbone:
            _add_mlp_head(self, "z_", 2048, WIDE_HEAD, 1)
        elif v == "rgb_geometric":
            wide = config.z_backbone_wide
            self.z_backbone = ZBackbone(wide=wide)
            _add_mlp_head(self, "z_", 512 if wide else 256,
                          ((256, 128) if wide else (128, 64), ("none", "none")), 1)

    @property
    def towers(self) -> tuple:
        """The attribute names of the variant's ResNet50 towers."""
        return ("rgb_backbone", "depth_backbone") if self.config.variant == "rgbd" else ("backbone",)

    def tower_inputs(self, rgb: torch.Tensor, depth: Optional[torch.Tensor] = None) -> dict:
        """{tower name: its NHWC input}: rgb, and for rgbd the normalized depth."""
        if self.config.variant == "rgbd" and depth is None:
            raise ValueError("the rgbd variant needs a normalized depth image")
        return dict(zip(self.towers, (rgb, depth)))

    def heads(self, feats: Dict[str, torch.Tensor], rgb: torch.Tensor,
              depth_raw: Optional[torch.Tensor] = None,
              bbox_center: Optional[torch.Tensor] = None,
              camera_matrix: Optional[torch.Tensor] = None):
        """Everything after the ResNet50 towers, from their f32 [B, 2048]
        features `feats` ({tower name: features}); rgb is the network's
        image input (rgb_geometric's ZBackbone reads it, in f32)."""
        cfg = self.config
        v = cfg.variant
        if v == "rgbd":
            rgb_feat = self.rgb_norm(feats["rgb_backbone"])
            depth_feat = self.depth_norm(feats["depth_backbone"])
            if cfg.fusion_attention:
                rgb_feat = rgb_feat + self.cross_attention(rgb_feat, depth_feat)
            fused = torch.cat([rgb_feat, depth_feat], dim=-1)
            fused = _gelu(self.fusion_norm0(self.fusion_dense0(fused)))
            fused = _gelu(self.fusion_norm1(self.fusion_dense1(fused)))
            rot = _mlp_head(self, "rot_", fused, F.relu if cfg.rot_head_wide else _gelu)
            trans = _mlp_head(self, "trans_", fused, _gelu)
        else:
            feat = feats["backbone"]
            rot = _mlp_head(self, "rot_", feat, F.relu)
            if v == "rgb":
                trans = _mlp_head(self, "trans_", feat, F.relu)
            elif v == "rgb_geometric":
                z_feat = feat if cfg.z_from_backbone else self.z_backbone(rgb.float())
                z = _mlp_head(self, "z_", z_feat, F.relu)
                if bbox_center is not None and camera_matrix is not None:
                    trans = pinhole_xy_from_z(z, bbox_center, camera_matrix)
                else:
                    trans = F.pad(z, (2, 0))  # [0, 0, z]
            elif (depth_raw is not None and bbox_center is not None
                  and camera_matrix is not None):
                trans = self._depth_pinhole_translation(depth_raw, bbox_center, camera_matrix)
            else:
                trans = feat.new_tensor([0.0, 0.0, DEPTH_FALLBACK_M]).expand(feat.shape[0], 3)
        rot = rot / torch.linalg.norm(rot, dim=-1, keepdim=True).clamp_min(1e-8)
        return rot, trans

    def _depth_pinhole_translation(self, depth_raw, bbox_center, camera_matrix):
        """Non-learned translation of rgbd_geometric: the depth map [B, S, S]
        (metres) at the box centre, guarded, back-projected through K
        (reference models/pose_net_rgbd_geometric.py:56-85)."""
        hi = self.config.img_size - 1
        u = bbox_center[:, 0].clamp(0, hi)
        v = bbox_center[:, 1].clamp(0, hi)
        u_idx = u.to(torch.int64).clamp(0, hi)
        v_idx = v.to(torch.int64).clamp(0, hi)
        z = depth_raw[torch.arange(depth_raw.shape[0], device=depth_raw.device), v_idx, u_idx]
        z = torch.where(z > DEPTH_INVALID_M, z, torch.full_like(z, DEPTH_FALLBACK_M))
        z = z.clamp(DEPTH_MIN_M, DEPTH_GUARD_MAX_M)
        return pinhole_xy_from_z(z, torch.stack([u, v], dim=-1), camera_matrix)

    def forward(self, rgb: torch.Tensor, depth: Optional[torch.Tensor] = None,
                depth_raw: Optional[torch.Tensor] = None,
                bbox_center: Optional[torch.Tensor] = None,
                camera_matrix: Optional[torch.Tensor] = None):
        """rgb [B, H, W, 3] normalized; depth [B, H, W, 1] normalized (rgbd);
        depth_raw [B, H, W] metres, bbox_center [B, 2] pixels and
        camera_matrix [B, 3, 3] for the geometric variants. The float path
        runs in f32 whatever the input dtype."""
        feats = {name: getattr(self, name)(x.float())
                 for name, x in self.tower_inputs(rgb, depth).items()}
        return self.heads(feats, rgb, depth_raw, bbox_center, camera_matrix)
