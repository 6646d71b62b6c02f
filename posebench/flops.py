"""Operations and bytes of the work a request does, counted on the
benchmark's own reference networks (reference/nets.py) and shapes, and the
card's peaks they are held against.

FLOPs are 2 x the multiply-adds of every convolution and matrix product
(aten.convolution, mm, addmm, bmm), counted from their shapes by a
dispatch mode over meta tensors, where nothing runs: the arithmetic of the
program's request trace (its counted_flops), frozen here. Bytes are what a
stage must move at least: its input, its weights and its output, each read
or written once, in the dtype the configuration serves them in.
"""

from __future__ import annotations

import contextlib
import math

import torch

from .reference import nets

PEAK_FLOPS = 989e12        # one H100 SXM, dense bf16 (NVIDIA's data sheet)
PEAK_BYTES_PER_S = 3.35e12  # its HBM3
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def counted_flops(fn, *args, **kwargs) -> int:
    """2 x the multiply-adds of the convolutions and matrix products that
    fn(*args, **kwargs) dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    total = 0

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            nonlocal total
            out = func(*args, **(kwargs or {}))
            op = func.overloadpacket
            if op is aten.convolution:
                total += 2 * out.numel() * math.prod(args[1].shape[1:])
            elif op in (aten.mm, aten.addmm, aten.bmm):
                a = args[1] if op is aten.addmm else args[0]
                total += 2 * out.numel() * a.shape[-1]
            return out

    with Count():
        fn(*args, **kwargs)
    return total


@contextlib.contextmanager
def _meta():
    with torch.inference_mode(False), torch.no_grad(), torch.device("meta"):
        yield


def _meta_state(shapes: dict) -> dict:
    return {k: torch.empty(s, dtype=torch.int64 if k.endswith("num_batches_tracked")
                           else torch.float32) for k, s in shapes.items()}


def detector_flops(yolo_shapes: dict, hw) -> int:
    """FLOPs of one frame [H, W] through YOLOv8."""
    with _meta():
        return counted_flops(nets.yolo_levels, _meta_state(yolo_shapes),
                             torch.empty(1, 3, *hw))


def tower_flops(pose_shapes: dict, prefix: str, img: int) -> int:
    """FLOPs of one crop through the ResNet-50 tower under prefix."""
    cin = pose_shapes[prefix + ".conv1.weight"][1]
    with _meta():
        return counted_flops(nets.resnet50, _meta_state(pose_shapes), prefix,
                             torch.empty(1, cin, img, img))


def heads_flops(variant: str, pose_shapes: dict) -> int:
    """FLOPs of one crop through the heads after the towers."""
    with _meta():
        sd = _meta_state(pose_shapes)
        feat = torch.empty(1, 2048)
        if variant == "rgbd":
            return counted_flops(nets.rgbd_heads, sd, feat, feat)
        return counted_flops(nets.rotation_head_bn, sd, feat)


def towers(variant: str) -> tuple:
    return ("rgb_backbone", "depth_backbone") if variant == "rgbd" else ("backbone",)


def posenet_flops(variant: str, pose_shapes: dict, img: int) -> int:
    """FLOPs of one crop through PoseNet: its towers and heads."""
    return (sum(tower_flops(pose_shapes, t, img) for t in towers(variant))
            + heads_flops(variant, pose_shapes))


def param_count(shapes: dict, prefix: str = "") -> int:
    return sum(math.prod(s) for k, s in shapes.items()
               if k.startswith(prefix) and not k.endswith("num_batches_tracked"))


def detector_bytes(yolo_shapes: dict, frames: int, hw, dtype: str, classes: int,
                   reg_max: int = 16) -> int:
    """The detector's least traffic for a batch: the frames in, the
    weights, and every level's box and class logits out."""
    b = BYTES[dtype]
    anchors = sum((hw[0] // s) * (hw[1] // s) for s in (8, 16, 32))
    return b * (frames * hw[0] * hw[1] * 3 + param_count(yolo_shapes)
                + frames * anchors * (4 * reg_max + classes))


def posenet_bytes(variant: str, pose_shapes: dict, crops: int, img: int, dtype: str) -> int:
    """PoseNet's least traffic for a batch of crops: the crops in (RGB, and
    depth where a tower takes it), the towers' weights in dtype, the heads'
    in float32, and the pose out."""
    b = BYTES[dtype]
    tower_params = sum(param_count(pose_shapes, t + ".") for t in towers(variant))
    head_params = param_count(pose_shapes) - tower_params
    channels = 4 if variant == "rgbd" else 3
    return (b * (crops * img * img * channels + tower_params) + 4 * head_params
            + 4 * crops * 7)


def bound_ms(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    its peak and bytes over its bandwidth, in milliseconds."""
    return 1e3 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)
