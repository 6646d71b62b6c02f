"""PoseNet, the four variants (counterpart of pose6d_tpu/models/posenet.py).

| variant        | towers                      | rotation head       | translation             |
|----------------|-----------------------------|---------------------|-------------------------|
| rgb            | backbone                    | BN/ReLU MLP (2048)  | BN/ReLU MLP, 3-vector   |
| rgb_geometric  | backbone + ZBackbone        | BN/ReLU MLP (1024)  | learned Z, pinhole X/Y  |
| rgbd           | rgb_backbone + depth_backbone, attention fusion | LN/GELU MLP | LN/GELU MLP, 3-vector |
| rgbd_geometric | backbone                    | BN/ReLU MLP (1024)  | depth at the box centre, pinhole X/Y |

Returns (rotation [B, 4] unit xyzw, translation [B, 3] metres). Inputs are
NHWC. Eval mode (module.eval()) uses the BatchNorm running statistics and
no dropout; train mode (module.train()) uses the batch statistics, updates
the running ones as flax does (resnet.BatchNorm), and drops out where the
flax model does, drawing from the generator the forward is given.

Attribute names follow the flax scopes (backbone, rot_dense0, rot_norm0,
..., rot_out, z_backbone/conv0, ...) so that convert.py maps a flax tree by
transposes; dropouts (rot_drop0, fusion_drop0, ...) hold no state.
`PoseNet.heads` is everything after the ResNet50 towers, from their f32
features; the float forward and the folded serving forward
(posenet_serving.py) share it. The float forward runs the towers in
PoseNetConfig.dtype (`tower_features`): f32, or bf16 under autocast with
the parameters and BN statistics kept f32, as flax's ResNet50(dtype=...).
`flax_init_` is the flax model's from-scratch initialization.

stem_s2d: every ResNet50 tower's stem is the space-to-depth form
(resnet.ResNet50(stem_s2d=True)); the folded and int8 serving modes take
7x7 stems only (ops/quant.fold_bn_resnet raises).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..data.crop import DEPTH_INVALID_M, DEPTH_MIN_M
from ..geometry.pinhole import pinhole_xy_from_z
from .resnet import BatchNorm, ResNet50

LN_EPS = 1e-6  # flax LayerNorm default
VARIANTS = ("rgb", "rgb_geometric", "rgbd", "rgbd_geometric")
# (widths, norms, dropout rates) of the heads: the rgb variant's BN/ReLU
# stack, the geometric variants' narrower one, rgbd's LayerNorm/GELU head
# and rgb_geometric's z heads
WIDE_HEAD = ((2048, 1024, 512), ("batch", "batch", "none"), (0.3, 0.2, 0.0))
NARROW_HEAD = ((1024, 512), ("batch", "batch"), (0.3, 0.2))
GELU_HEAD = ((512, 256), ("layer", "none"), (0.1, 0.0))
Z_HEAD = ((128, 64), ("none", "none"), (0.2, 0.0))
Z_HEAD_WIDE = ((256, 128), ("none", "none"), (0.2, 0.0))
FUSION_DROPOUT = 0.2
ATTENTION_DROPOUT = 0.1
# rgbd_geometric's depth at the box centre: readings at or below
# DEPTH_INVALID_M become DEPTH_FALLBACK_M, and z is clamped to
# [DEPTH_MIN_M, DEPTH_GUARD_MAX_M]
DEPTH_FALLBACK_M = 0.5
DEPTH_GUARD_MAX_M = 2.0


@dataclasses.dataclass(frozen=True)
class PoseNetConfig:
    variant: str = "rgb"  # rgb | rgb_geometric | rgbd | rgbd_geometric
    img_size: int = 224
    # the ResNet50 towers' compute dtype in the float forward (flax's
    # ResNet50(dtype=...)); float32 computes them in the parameters' dtype.
    # Parameters, BN statistics and heads stay in the parameters' dtype
    dtype: torch.dtype = torch.float32
    # the towers' stem as a 2x2 space-to-depth + 4x4/s1 conv (resnet.py)
    stem_s2d: bool = False
    # the geometric variants' and rgbd's rotation head becomes the rgb
    # variant's 2048/1024/512 BN stack
    rot_head_wide: bool = False
    # rgbd: False fuses by a LayerNorm'd concat without the attention residual
    fusion_attention: bool = True
    # rgb_geometric: z from the ResNet50 features through an rgb-style BN
    # head, or a ZBackbone of doubled channels with a 256/128 z head
    z_from_backbone: bool = False
    z_backbone_wide: bool = False
    # rgbd, from-scratch init only: the attention's out_proj starts at zero,
    # so the attention residual starts at identity
    attn_zero_init: bool = False


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax nn.gelu's default form


class Dropout(nn.Module):
    """flax nn.Dropout: in train mode, keep each element with probability
    1 - rate and scale it by 1 / (1 - rate), the keep mask drawn from the
    generator; identity in eval mode or at rate 0.

    Under a mesh (parallel/heads.shard_posenet) `rows` = (this rank's
    block, blocks) and, after a column-parallel layer, `cols` likewise:
    the mask is drawn at the global shape, which every rank's generator
    draws alike, and the rank keeps its block of it, so that the sharded
    step drops what the one-process step drops."""

    rows = None
    cols = None

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in train mode draws from a generator; none was given")
        keep = 1.0 - self.rate
        shape = list(x.shape)
        blocks = ((0, self.rows), (x.dim() - 1, self.cols))
        for dim, block in blocks:
            if block is not None:
                shape[dim] *= block[1]
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        for dim, block in blocks:
            if block is not None:
                mask = mask.narrow(dim, block[0] * x.shape[dim], x.shape[dim])
        return torch.where(mask, x / keep, torch.zeros_like(x))


def _add_mlp_head(module: nn.Module, prefix: str, in_dim: int, head, out_dim: int) -> None:
    """posenet._mlp_head's layers as attributes of module: {prefix}dense{i},
    {prefix}norm{i} ('batch' or 'layer'; none for 'none'), {prefix}drop{i}
    (for a rate above 0), {prefix}out."""
    for i, (w, norm, rate) in enumerate(zip(*head)):
        setattr(module, f"{prefix}dense{i}", nn.Linear(in_dim, w))
        if norm == "batch":
            setattr(module, f"{prefix}norm{i}", BatchNorm(w))
        elif norm == "layer":
            setattr(module, f"{prefix}norm{i}", nn.LayerNorm(w, eps=LN_EPS))
        if rate > 0:
            setattr(module, f"{prefix}drop{i}", Dropout(rate))
        in_dim = w
    setattr(module, f"{prefix}out", nn.Linear(in_dim, out_dim))


def _mlp_head(module: nn.Module, prefix: str, x: torch.Tensor, act,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Dense -> norm -> act -> dropout per layer, then the output Dense."""
    i = 0
    while hasattr(module, f"{prefix}dense{i}"):
        x = getattr(module, f"{prefix}dense{i}")(x)
        norm = getattr(module, f"{prefix}norm{i}", None)
        if norm is not None:
            x = norm(x)
        x = act(x)
        drop = getattr(module, f"{prefix}drop{i}", None)
        if drop is not None:
            x = drop(x, generator)
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
        self.attn_drop = Dropout(ATTENTION_DROPOUT)

    def forward(self, rgb_feat, depth_feat, generator: Optional[torch.Generator] = None):
        B, dim = rgb_feat.shape
        hd = dim // self.num_heads
        q = self.q_proj(rgb_feat).reshape(B, self.num_heads, hd)
        k = self.k_proj(depth_feat).reshape(B, self.num_heads, hd)
        v = self.v_proj(depth_feat).reshape(B, self.num_heads, hd)
        attn = torch.softmax(torch.einsum("bhd,bgd->bhg", q, k) * hd**-0.5, dim=-1)
        attn = self.attn_drop(attn, generator)
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
            setattr(self, f"bn{i}", BatchNorm(c[i]))
            cin = c[i]

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        for i in range(4):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
            x = F.max_pool2d(F.relu(x), 2, 2)
        return x.mean(dim=(2, 3))


class PoseNet(nn.Module):
    mesh = None  # set by parallel/heads.shard_posenet

    def __init__(self, config: PoseNetConfig):
        super().__init__()
        v = config.variant
        if v not in VARIANTS:
            raise ValueError(f"unknown variant: {v}")
        self.config = config
        if v == "rgbd":
            self.rgb_backbone = ResNet50(in_channels=3, stem_s2d=config.stem_s2d)
            self.depth_backbone = ResNet50(in_channels=1, stem_s2d=config.stem_s2d)
            self.rgb_norm = nn.LayerNorm(2048, eps=LN_EPS)
            self.depth_norm = nn.LayerNorm(2048, eps=LN_EPS)
            if config.fusion_attention:
                self.cross_attention = CrossModalAttention()
            self.fusion_dense0 = nn.Linear(4096, 1024)
            self.fusion_norm0 = nn.LayerNorm(1024, eps=LN_EPS)
            self.fusion_drop0 = Dropout(FUSION_DROPOUT)
            self.fusion_dense1 = nn.Linear(1024, 1024)
            self.fusion_norm1 = nn.LayerNorm(1024, eps=LN_EPS)
            _add_mlp_head(self, "rot_", 1024, WIDE_HEAD if config.rot_head_wide else GELU_HEAD, 4)
            _add_mlp_head(self, "trans_", 1024, GELU_HEAD, 3)
            return
        self.backbone = ResNet50(in_channels=3, stem_s2d=config.stem_s2d)
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
            _add_mlp_head(self, "z_", 512 if wide else 256, Z_HEAD_WIDE if wide else Z_HEAD, 1)

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
              camera_matrix: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """Everything after the ResNet50 towers, from their f32 [B, 2048]
        features `feats` ({tower name: features}); rgb is the network's
        image input (rgb_geometric's ZBackbone reads it, in the features'
        dtype); generator
        feeds the dropouts in train mode."""
        cfg = self.config
        v = cfg.variant
        g = generator
        if v == "rgbd":
            rgb_feat = self.rgb_norm(feats["rgb_backbone"])
            depth_feat = self.depth_norm(feats["depth_backbone"])
            if cfg.fusion_attention:
                rgb_feat = rgb_feat + self.cross_attention(rgb_feat, depth_feat, g)
            fused = torch.cat([rgb_feat, depth_feat], dim=-1)
            fused = self.fusion_drop0(_gelu(self.fusion_norm0(self.fusion_dense0(fused))), g)
            fused = _gelu(self.fusion_norm1(self.fusion_dense1(fused)))
            rot = _mlp_head(self, "rot_", fused, F.relu if cfg.rot_head_wide else _gelu, g)
            trans = _mlp_head(self, "trans_", fused, _gelu, g)
        else:
            feat = feats["backbone"]
            rot = _mlp_head(self, "rot_", feat, F.relu, g)
            if v == "rgb":
                trans = _mlp_head(self, "trans_", feat, F.relu, g)
            elif v == "rgb_geometric":
                z_feat = feat if cfg.z_from_backbone else self.z_backbone(rgb.to(feat.dtype))
                z = _mlp_head(self, "z_", z_feat, F.relu, g)
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

    def tower_features(self, inputs: Dict[str, torch.Tensor],
                       tower_dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
        """{tower name: [B, 2048] features} of `inputs` ({tower name: its
        NHWC input}), in the parameters' dtype. The towers compute in
        tower_dtype, or config.dtype when it is None: float32 (or the
        parameters' own dtype) runs them in the parameters' dtype whatever
        the input dtype; torch.bfloat16 runs them under torch.autocast in
        that dtype and rounds their features to it, as flax's
        ResNet50(dtype=...) computes them."""
        dtype = self.rot_out.weight.dtype
        if tower_dtype is None:
            tower_dtype = self.config.dtype
        if tower_dtype in (torch.float32, dtype):
            return {name: getattr(self, name)(x.to(dtype)) for name, x in inputs.items()}
        device = next(iter(inputs.values())).device
        # no cast cache: each weight is cast once a forward anyway, and a
        # cache would outlive a CUDA graph's capture
        with torch.autocast(device.type, dtype=tower_dtype, cache_enabled=False):
            feats = {name: getattr(self, name)(x.to(dtype)) for name, x in inputs.items()}
        return {k: v.to(tower_dtype).to(dtype) for k, v in feats.items()}

    def forward(self, rgb: torch.Tensor, depth: Optional[torch.Tensor] = None,
                depth_raw: Optional[torch.Tensor] = None,
                bbox_center: Optional[torch.Tensor] = None,
                camera_matrix: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                tower_dtype: Optional[torch.dtype] = None):
        """rgb [B, H, W, 3] normalized; depth [B, H, W, 1] normalized (rgbd);
        depth_raw [B, H, W] metres, bbox_center [B, 2] pixels and
        camera_matrix [B, 3, 3] for the geometric variants; generator for
        the dropouts in train mode. The towers compute as tower_features
        says, in tower_dtype (the train step's) or config.dtype (serving);
        the heads stay in the parameters' dtype, on the towers' rounded
        features, as flax promotes them."""
        feats = self.tower_features(self.tower_inputs(rgb, depth), tower_dtype)
        return self.heads(feats, rgb, depth_raw, bbox_center, camera_matrix, generator)


# flax's initializers: lecun_normal is a normal of std sqrt(1 / fan_in)
# truncated at 2 std, its std corrected for the truncation;
# xavier_uniform is uniform on +-sqrt(6 / (fan_in + fan_out))
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    fan_in = w[0].numel()  # torch's [out, in(, kh, kw)]
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


def _xavier_uniform_(w: torch.Tensor, g: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    nn.init.uniform_(w, -limit, limit, generator=g)


@torch.no_grad()
def flax_init_(model: PoseNet, seed: int) -> PoseNet:
    """The flax model's from-scratch initialization, in place, from a
    torch seed (the values are not flax's, the distributions are):
    lecun_normal for every conv and dense kernel, except xavier_uniform for
    rgbd's fusion and its LayerNorm/GELU heads; zero biases; BatchNorm and
    LayerNorm scale 1, bias 0, running mean 0 and variance 1; the last BN
    scale of every bottleneck 0 (zero_init_residual); rgbd's attention
    out_proj 0 with attn_zero_init; the learned z bias 0.5 m (trans_out z,
    rgb_geometric's z_out)."""
    cfg = model.config
    g = torch.Generator().manual_seed(seed)
    xavier = ("fusion_dense", "trans_") + (() if cfg.rot_head_wide else ("rot_",))
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if cfg.variant == "rgbd" and name.startswith(xavier):
                _xavier_uniform_(m.weight, g)
            elif name == "cross_attention.out_proj" and cfg.attn_zero_init:
                m.weight.zero_()
            else:
                _lecun_normal_(m.weight, g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (BatchNorm, nn.LayerNorm)):
            residual_end = ".layer" in name and name.endswith(".bn3")
            m.weight.fill_(0.0 if residual_end else 1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    for key, index in (("trans_out", 2), ("z_out", 0)):
        if hasattr(model, key):
            getattr(model, key).bias[index] = 0.5
    return model
