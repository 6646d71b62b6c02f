"""YOLOv8 building blocks (counterpart of pose6d_tpu/models/yolo/modules.py).

Tensors are NCHW inside; attribute names follow the flax scopes (conv, bn,
cv1, cv2, m{i}) so convert.py maps weights by transposes alone. BatchNorm
is flax's with ultralytics' eps=1e-3 and momentum 0.03 (flax momentum
0.97): resnet.BatchNorm, whose train mode updates the running statistics
as flax does, with the biased batch variance.

`dtype` is the compute type, as flax's `dtype=` on nn.Conv / nn.BatchNorm:
parameters stay f32 and are cast at use, convolutions take and give dtype,
and BatchNorm computes in f32 at least (its statistics promote the input)
and rounds its output to dtype.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..resnet import BatchNorm

BN_MOMENTUM = 1.0 - 0.03  # flax momentum = 1 - torch momentum
BN_EPS = 1e-3


def conv_in(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """conv applied in dtype: input, weight and bias cast at use."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride, conv.padding)


class ConvBN(nn.Module):
    """Conv2d + BatchNorm + SiLU (ultralytics `Conv`) in dtype."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)
        self.bn = BatchNorm(cout, momentum=BN_MOMENTUM, eps=BN_EPS)

    def forward(self, x):
        y = conv_in(self.conv, x, self.dtype)
        y = self.bn(y.to(torch.promote_types(y.dtype, torch.float32)))
        return F.silu(y.to(self.dtype))


class OutConv(nn.Conv2d):
    """A head's 1x1 logit conv with a bias (no BN, no activation) in dtype."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, 1)
        self.dtype = dtype

    def forward(self, x):
        return conv_in(self, x, self.dtype)


class Bottleneck(nn.Module):
    """Two 3x3 ConvBNs with an optional residual (ultralytics `Bottleneck`)."""

    def __init__(self, cin: int, features: int, shortcut: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cv1 = ConvBN(cin, features, 3, dtype=dtype)
        self.cv2 = ConvBN(features, features, 3, dtype=dtype)
        self.add = shortcut and cin == features

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with two convs: cv1 splits into two halves, n
    bottlenecks chain on the second, all 2 + n chunks concat into cv2."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = features // 2
        self.n = n
        self.cv1 = ConvBN(cin, 2 * self.hidden, 1, dtype=dtype)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(self.hidden, self.hidden, shortcut, dtype))
        self.cv2 = ConvBN((2 + n) * self.hidden, features, 1, dtype=dtype)

    def forward(self, x):
        chunks = list(self.cv1(x).split(self.hidden, dim=1))
        for i in range(self.n):
            chunks.append(getattr(self, f"m{i}")(chunks[-1]))
        return self.cv2(torch.cat(chunks, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three chained 5x5/s1 max pools."""

    def __init__(self, cin: int, features: int, pool: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = cin // 2
        self.pool = pool
        self.cv1 = ConvBN(cin, hidden, 1, dtype=dtype)
        self.cv2 = ConvBN(hidden * 4, features, 1, dtype=dtype)

    def forward(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], self.pool, 1, self.pool // 2))
        return self.cv2(torch.cat(pools, dim=1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (NCHW)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
