"""YOLOv8 detector: backbone, PAN-FPN neck, decoupled DFL head
(counterpart of pose6d_tpu/models/yolo/model.py). 'n' is depth 1/3,
width 1/4, ratio 2. `dtype` is the compute type (modules.py): f32 by
default as in the JAX package, bf16 where its benchmark serves."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import nn

from ..posenet import _lecun_normal_
from ..resnet import BatchNorm
from .modules import C2f, ConvBN, OutConv, SPPF, upsample2x


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    num_classes: int = 13  # LineMOD
    depth: float = 1.0 / 3.0
    width: float = 0.25
    ratio: float = 2.0
    reg_max: int = 16
    strides: Tuple[int, ...] = (8, 16, 32)
    dtype: torch.dtype = torch.float32

    def ch(self, c: int) -> int:
        return max(int(round(c * self.width)), 1)

    def depth_n(self, n: int) -> int:
        return max(int(round(n * self.depth)), 1)

    @property
    def c5(self) -> int:
        return int(self.ch(512) * self.ratio)


class YoloBackbone(nn.Module):
    def __init__(self, c: YoloConfig, in_channels: int = 3):
        super().__init__()
        w, d, dt = c.ch, c.depth_n, c.dtype
        self.stem = ConvBN(in_channels, w(64), 3, 2, dt)
        self.down1 = ConvBN(w(64), w(128), 3, 2, dt)
        self.c2f_1 = C2f(w(128), w(128), d(3), True, dt)
        self.down2 = ConvBN(w(128), w(256), 3, 2, dt)
        self.c2f_2 = C2f(w(256), w(256), d(6), True, dt)
        self.down3 = ConvBN(w(256), w(512), 3, 2, dt)
        self.c2f_3 = C2f(w(512), w(512), d(6), True, dt)
        self.down4 = ConvBN(w(512), c.c5, 3, 2, dt)
        self.c2f_4 = C2f(c.c5, c.c5, d(3), True, dt)
        self.sppf = SPPF(c.c5, c.c5, dtype=dt)

    def forward(self, x):
        x = self.c2f_1(self.down1(self.stem(x)))
        p3 = self.c2f_2(self.down2(x))
        p4 = self.c2f_3(self.down3(p3))
        p5 = self.sppf(self.c2f_4(self.down4(p4)))
        return p3, p4, p5


class YoloNeck(nn.Module):
    def __init__(self, c: YoloConfig):
        super().__init__()
        w, d, dt = c.ch, c.depth_n, c.dtype
        self.td_p4 = C2f(c.c5 + w(512), w(512), d(3), False, dt)
        self.td_p3 = C2f(w(512) + w(256), w(256), d(3), False, dt)
        self.bu_down3 = ConvBN(w(256), w(256), 3, 2, dt)
        self.bu_p4 = C2f(w(256) + w(512), w(512), d(3), False, dt)
        self.bu_down4 = ConvBN(w(512), w(512), 3, 2, dt)
        self.bu_p5 = C2f(w(512) + c.c5, c.c5, d(3), False, dt)

    def forward(self, p3, p4, p5):
        t4 = self.td_p4(torch.cat([upsample2x(p5), p4], dim=1))
        t3 = self.td_p3(torch.cat([upsample2x(t4), p3], dim=1))
        b4 = self.bu_p4(torch.cat([self.bu_down3(t3), t4], dim=1))
        b5 = self.bu_p5(torch.cat([self.bu_down4(b4), p5], dim=1))
        return t3, b4, b5


class DetectHead(nn.Module):
    """Per level: box branch -> 4*reg_max DFL logits, cls branch -> nc."""

    def __init__(self, c: YoloConfig, in_channels):
        super().__init__()
        c_box = max(16, in_channels[0] // 4, c.reg_max * 4)
        c_cls = max(in_channels[0], min(c.num_classes, 100))
        self.n_levels = len(in_channels)
        dt = c.dtype
        for i, ci in enumerate(in_channels):
            setattr(self, f"box{i}_0", ConvBN(ci, c_box, 3, dtype=dt))
            setattr(self, f"box{i}_1", ConvBN(c_box, c_box, 3, dtype=dt))
            setattr(self, f"box{i}_out", OutConv(c_box, 4 * c.reg_max, dt))
            setattr(self, f"cls{i}_0", ConvBN(ci, c_cls, 3, dtype=dt))
            setattr(self, f"cls{i}_1", ConvBN(c_cls, c_cls, 3, dtype=dt))
            setattr(self, f"cls{i}_out", OutConv(c_cls, c.num_classes, dt))

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            branch = {}
            for kind in ("box", "cls"):
                y = x
                for part in ("0", "1"):
                    y = getattr(self, f"{kind}{i}_{part}")(y)
                branch[kind] = getattr(self, f"{kind}{i}_out")(y)
            outs.append((branch["box"], branch["cls"]))
        return outs


class YoloV8(nn.Module):
    """Full detector. forward(x [B, H, W, 3] NHWC float) returns a list of
    (box_logits [B, Hi, Wi, 4*reg_max], cls_logits [B, Hi, Wi, nc]) per
    stride level, NHWC like the JAX model, in cfg.dtype."""

    def __init__(self, cfg: YoloConfig = YoloConfig()):
        super().__init__()
        self.cfg = cfg
        w = cfg.ch
        self.backbone = YoloBackbone(cfg)
        self.neck = YoloNeck(cfg)
        self.head = DetectHead(cfg, (w(256), w(512), cfg.c5))

    def forward(self, x_nhwc: torch.Tensor):
        x = x_nhwc.permute(0, 3, 1, 2)
        feats = self.neck(*self.backbone(x))
        return [(b.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1))
                for b, c in self.head(feats)]


@torch.no_grad()
def flax_init_(model: YoloV8, seed: int) -> YoloV8:
    """The flax detector's from-scratch initialization, in place, from a
    torch seed (the values are not flax's, the distributions are):
    lecun_normal for every conv kernel, zero biases, BatchNorm scale 1,
    bias 0, running mean 0 and variance 1, and each cls{i}_out bias the
    prior log(5 / nc / (640 / stride)^2) for rare positives (ultralytics'
    bias_init, pose6d_tpu/models/yolo/model.py:123-131)."""
    cfg = model.cfg
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    for i, stride in enumerate(cfg.strides):
        prior = math.log(5.0 / cfg.num_classes / (640.0 / stride) ** 2)
        getattr(model.head, f"cls{i}_out").bias.fill_(prior)
    return model
