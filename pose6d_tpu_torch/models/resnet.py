"""ResNet-50 backbone, eval-mode float tower (counterpart of
pose6d_tpu/models/resnet.py).

Module attributes carry the flax scope names (conv1, bn1, layer{i}_{j},
downsample_conv, downsample_bn) so that convert.py maps a flax tree onto
this module by transposes alone. The public forward takes NHWC images and
returns globally average-pooled features [B, 2048]; inside, tensors are
NCHW as torch's convolutions expect.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

STAGE_SIZES = (3, 4, 6, 3)
BN_EPS = 1e-5


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


class BottleneckBlock(nn.Module):
    """ResNet v1 bottleneck 1x1 -> 3x3 -> 1x1, expansion 4. The 3x3/s2 conv
    pads (1, 1) on both sides as torchvision does (flax 'SAME' would pad
    (0, 1) and shift the grid by a pixel)."""

    def __init__(self, cin: int, features: int, stride: int):
        super().__init__()
        cout = features * 4
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, features, 1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride, padding=1, bias=False)
        self.bn2 = _bn(features)
        self.conv3 = nn.Conv2d(features, cout, 1, bias=False)
        self.bn3 = _bn(cout)
        if cin != cout or stride != 1:
            self.downsample_conv = nn.Conv2d(cin, cout, 1, stride, bias=False)
            self.downsample_bn = _bn(cout)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + r)


class ResNet50(nn.Module):
    def __init__(self, in_channels: int = 3, num_filters: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, num_filters, 7, 2, padding=3, bias=False)
        self.bn1 = _bn(num_filters)
        cin = num_filters
        for i, n_blocks in enumerate(STAGE_SIZES):
            features = num_filters * 2**i
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                setattr(self, f"layer{i + 1}_{j}", BottleneckBlock(cin, features, stride))
                cin = features * 4

    def blocks(self):
        for i, n_blocks in enumerate(STAGE_SIZES):
            for j in range(n_blocks):
                yield getattr(self, f"layer{i + 1}_{j}")

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for blk in self.blocks():
            x = blk(x)
        return x.mean(dim=(2, 3))
