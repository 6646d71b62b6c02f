"""PoseNet, rgbd variant (counterpart of pose6d_tpu/models/posenet.py):
two ResNet50 towers (RGB and a 1-channel depth tower), LayerNorm,
CrossModalAttention over the 8-head axis, a LayerNorm/GELU fusion MLP and
GELU heads. Eval mode only (no dropout, BatchNorm on running statistics).
Returns (rotation [B, 4] unit xyzw, translation [B, 3] metres).

Attribute names follow the flax scopes so that convert.py maps a flax tree
by transposes. The other three variants raise until their slice lands.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
import torch.nn.functional as F

from .resnet import ResNet50

LN_EPS = 1e-6  # flax LayerNorm default


@dataclasses.dataclass(frozen=True)
class PoseNetConfig:
    variant: str = "rgbd"


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax nn.gelu's default form


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


class PoseNet(nn.Module):
    def __init__(self, config: PoseNetConfig):
        super().__init__()
        if config.variant != "rgbd":
            raise NotImplementedError(
                f"PoseNet variant {config.variant!r}: only rgbd is ported so far")
        self.config = config
        self.rgb_backbone = ResNet50(in_channels=3)
        self.depth_backbone = ResNet50(in_channels=1)
        self.rgb_norm = nn.LayerNorm(2048, eps=LN_EPS)
        self.depth_norm = nn.LayerNorm(2048, eps=LN_EPS)
        self.cross_attention = CrossModalAttention()
        self.fusion_dense0 = nn.Linear(4096, 1024)
        self.fusion_norm0 = nn.LayerNorm(1024, eps=LN_EPS)
        self.fusion_dense1 = nn.Linear(1024, 1024)
        self.fusion_norm1 = nn.LayerNorm(1024, eps=LN_EPS)
        for prefix, out_dim in (("rot_", 4), ("trans_", 3)):
            setattr(self, f"{prefix}dense0", nn.Linear(1024, 512))
            setattr(self, f"{prefix}norm0", nn.LayerNorm(512, eps=LN_EPS))
            setattr(self, f"{prefix}dense1", nn.Linear(512, 256))
            setattr(self, f"{prefix}out", nn.Linear(256, out_dim))

    def _head(self, prefix: str, x):
        x = _gelu(getattr(self, f"{prefix}norm0")(getattr(self, f"{prefix}dense0")(x)))
        x = _gelu(getattr(self, f"{prefix}dense1")(x))
        return getattr(self, f"{prefix}out")(x)

    def heads(self, rgb_feat: torch.Tensor, depth_feat: torch.Tensor):
        """Everything after the towers, from f32 [B, 2048] features: the
        part the float and the folded serving forwards share."""
        rgb_feat = self.rgb_norm(rgb_feat)
        depth_feat = self.depth_norm(depth_feat)
        rgb_feat = rgb_feat + self.cross_attention(rgb_feat, depth_feat)
        fused = torch.cat([rgb_feat, depth_feat], dim=-1)
        fused = _gelu(self.fusion_norm0(self.fusion_dense0(fused)))
        fused = _gelu(self.fusion_norm1(self.fusion_dense1(fused)))
        rot = self._head("rot_", fused)
        trans = self._head("trans_", fused)
        rot = rot / torch.linalg.norm(rot, dim=-1, keepdim=True).clamp_min(1e-8)
        return rot, trans

    def forward(self, rgb: torch.Tensor, depth: torch.Tensor):
        """rgb [B, H, W, 3] normalized, depth [B, H, W, 1] normalized; the
        float path runs in f32 whatever the input dtype."""
        return self.heads(self.rgb_backbone(rgb.float()),
                          self.depth_backbone(depth.float()))
