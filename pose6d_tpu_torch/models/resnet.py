"""ResNet-50 backbone, float tower (counterpart of
pose6d_tpu/models/resnet.py).

Module attributes carry the flax scope names (conv1, bn1, layer{i}_{j},
downsample_conv, downsample_bn) so that convert.py maps a flax tree onto
this module by transposes alone. The public forward takes NHWC images and
returns globally average-pooled features [B, 2048]; inside, tensors are
NCHW as torch's convolutions expect.

BatchNorm is `BatchNorm`, flax's nn.BatchNorm(momentum=0.9, epsilon=1e-5):
in eval mode it normalizes with the running statistics; in train mode
(module.train()) with the batch statistics, and it updates the running
statistics as flax does (see the class).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

STAGE_SIZES = (3, 4, 6, 3)
BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch


class BatchNorm(nn.BatchNorm2d):
    """flax nn.BatchNorm(momentum, epsilon) on [B, C] or [B, C, H, W] maps
    (one class for the towers' 2-D and the heads' 1-D norms, and for the
    detector's ConvBN with momentum 0.97 and eps 1e-3; the state_dict keys
    are torch's). `momentum` is flax's: the weight of the running value.

    Train mode normalizes with the biased batch variance, as torch's
    F.batch_norm does, and updates running = momentum * running +
    (1 - momentum) * batch with the biased batch variance, as flax does
    (torch's own BatchNorm would update with the unbiased one).
    num_batches_tracked stays as it is: flax keeps no such count. A bf16
    input (the towers under bf16 training) is normalized in f32 and comes
    out bf16, and the running statistics stay f32, as flax's
    BatchNorm(dtype=bfloat16) does."""

    def __init__(self, c: int, momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
        super().__init__(c, eps=eps)
        self.flax_momentum = momentum

    def _check_input_dim(self, x):
        if x.dim() not in (2, 4):
            raise ValueError(f"expected a [B, C] or [B, C, H, W] input, got {x.dim()}-D")

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            # the statistics in f32 at least, as flax's are under bf16 compute
            xs = x.to(torch.promote_types(x.dtype, torch.float32))
            var, mean = torch.var_mean(xs, dim=(0,) if x.dim() == 2 else (0, 2, 3),
                                       correction=0)
            m = self.flax_momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return y


class BottleneckBlock(nn.Module):
    """ResNet v1 bottleneck 1x1 -> 3x3 -> 1x1, expansion 4. The 3x3/s2 conv
    pads (1, 1) on both sides as torchvision does (flax 'SAME' would pad
    (0, 1) and shift the grid by a pixel)."""

    def __init__(self, cin: int, features: int, stride: int):
        super().__init__()
        cout = features * 4
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = nn.Conv2d(features, cout, 1, bias=False)
        self.bn3 = BatchNorm(cout)
        if cin != cout or stride != 1:
            self.downsample_conv = nn.Conv2d(cin, cout, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(cout)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + r)


def space_to_depth_2x2(x_nhwc: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C], each 2x2 pixel block's channels
    in (dy, dx, c) order."""
    B, H, W, C = x_nhwc.shape
    x = x_nhwc.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // 2, W // 2, 4 * C)


class ResNet50(nn.Module):
    """stem_s2d: the stem is a 2x2 space-to-depth, then a 4x4/s1 conv with
    pad (2, 1) on a [64, 4C, 4, 4] kernel (models/convert.s2d_conv1_weights
    makes it from a 7x7 one), the JAX package's stem_space_to_depth."""

    def __init__(self, in_channels: int = 3, num_filters: int = 64, stem_s2d: bool = False):
        super().__init__()
        self.stem_s2d = stem_s2d
        if stem_s2d:
            self.conv1 = nn.Conv2d(4 * in_channels, num_filters, 4, 1, bias=False)
        else:
            self.conv1 = nn.Conv2d(in_channels, num_filters, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(num_filters)
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

    def stem_conv(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """conv1 of an NHWC input, NCHW out."""
        if self.stem_s2d:
            x = F.pad(space_to_depth_2x2(x_nhwc).permute(0, 3, 1, 2), (2, 1, 2, 1))
            return self.conv1(x)
        return self.conv1(x_nhwc.permute(0, 3, 1, 2))

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.stem_conv(x_nhwc)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for blk in self.blocks():
            x = blk(x)
        return x.mean(dim=(2, 3))
