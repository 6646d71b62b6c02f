"""BN folding and the folded ResNet50 serving forward (counterpart of the
folding half of pose6d_tpu/ops/quant.py; the int8 mode is a later slice).

`fold_bn_resnet` turns every conv+BN pair of a ResNet50 tower into one conv
with a bias (an inference-only identity). `folded_resnet50_forward` runs
the tower over that tree with activations in compute_dtype and, when given
packed weights, its stem, layer1 and any of its four stages through the
CUDA kernels of ops/fused_block.py; the rest runs on torch's convolutions,
as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..models.resnet import STAGE_SIZES, ResNet50
from .fused_block import fused_layer1, fused_stage, fused_stem


def _fold_one(conv_w: torch.Tensor, bn, eps: float):
    g = bn.weight.detach() / torch.sqrt(bn.running_var + eps)
    w = conv_w.detach() * g[:, None, None, None]  # scale each output channel
    b = bn.bias.detach() - bn.running_mean * g
    return {"w": w.float(), "b": b.float()}


@torch.no_grad()
def fold_bn_resnet(tower: ResNet50, eps: float = 1e-5) -> Dict[str, dict]:
    """{name: {"w": f32 OIHW kernel, "b": f32 [co]}} for every conv of the
    tower; names follow the JAX package ("conv1", "layer1_0/conv1", ...,
    "layer2_0/downsample")."""
    out = {"conv1": _fold_one(tower.conv1.weight, tower.bn1, eps)}
    for i, n_blocks in enumerate(STAGE_SIZES):
        for j in range(n_blocks):
            name = f"layer{i + 1}_{j}"
            blk = getattr(tower, name)
            for c in (1, 2, 3):
                out[f"{name}/conv{c}"] = _fold_one(getattr(blk, f"conv{c}").weight,
                                                   getattr(blk, f"bn{c}"), eps)
            if blk.downsample_conv is not None:
                out[f"{name}/downsample"] = _fold_one(blk.downsample_conv.weight,
                                                      blk.downsample_bn, eps)
    return out


def nn_max_pool(x: torch.Tensor) -> torch.Tensor:
    """ResNet's maxpool 3x3/s2/pad1 on an NCHW tensor (-inf padding)."""
    return F.max_pool2d(x, 3, 2, padding=1)


def folded_resnet50_forward(folded: Dict[str, dict], x: torch.Tensor,
                            compute_dtype=torch.float32, pallas_l1=None,
                            pallas_stem=None, pallas_stages=None) -> torch.Tensor:
    """Tower features [B, 2048] f32 from NHWC x over a folded tree.

    compute_dtype f32 is numerically the float tower in eval mode. bf16 is
    the serving mode: weights, activations, bias adds, ReLUs and residuals
    in bf16 with f32 accumulation inside each conv (the tree's weights and
    biases must already be in compute_dtype; PosePipeline.fold_backbones
    prepares them). `pallas_stem` (pack_stem_weights) replaces conv1 + ReLU
    + maxpool with the fused stem kernel, `pallas_l1`
    (pack_layer1_weights) the three layer1 blocks with the fused layer1
    kernel, and `pallas_stages` ({stage: pack_stage_weights tuple}) whole
    stages with the parametric stage kernel; all need 224x224 inputs. A
    stage named in pallas_stages runs fused_stage, so pallas_l1 applies only
    when 1 is not among them (the JAX package's precedence)."""
    cd = compute_dtype
    stages = pallas_stages or {}

    def conv(name, h, stride=1, padding=0):
        e = folded[name]
        return F.conv2d(h.to(cd), e["w"], e["b"], stride, padding)

    def nchw(h):
        return h.permute(0, 3, 1, 2)

    def nhwc(h):
        return h.permute(0, 2, 3, 1).contiguous()

    if pallas_stem is not None:
        h = nchw(fused_stem(x.to(cd).contiguous(), pallas_stem))
    else:
        h = nn_max_pool(F.relu(conv("conv1", nchw(x), 2, 3)))
    for i, n_blocks in enumerate(STAGE_SIZES):
        if i + 1 in stages:
            h = nchw(fused_stage(nhwc(h), stages[i + 1], i + 1))
            continue
        if i == 0 and pallas_l1 is not None:
            h = nchw(fused_layer1(nhwc(h), pallas_l1))
            continue
        for j in range(n_blocks):
            blk = f"layer{i + 1}_{j}"
            stride = 2 if i > 0 and j == 0 else 1
            y = F.relu(conv(f"{blk}/conv1", h))
            y = F.relu(conv(f"{blk}/conv2", y, stride, 1))
            y = conv(f"{blk}/conv3", y)
            r = conv(f"{blk}/downsample", h, stride) if f"{blk}/downsample" in folded else h
            h = F.relu(y + r)
    return h.float().mean(dim=(2, 3))
