"""The int8 serving mode of the YOLOv8 detector (counterpart of
pose6d_tpu/models/yolo/quant.py).

The towers' recipe (ops/quant.py): every ConvBN folds its BatchNorm
(eps 1e-3) into the conv, its weights go to per-output-channel symmetric
int8, its input to one static scale from a calibration pass, and the conv
runs s8 x s8 -> s32 (conv_s8s32) with the dequantize and SiLU in
compute_dtype. The six 1x1 head output convs (box and class logits, with a
bias and no BN) stay float, as in the JAX package. The JAX package's
quantize_yolo_folded is ops.quant.quantize_folded, which passes those
through.

Trees are keyed by the JAX package's paths ("backbone/stem",
"backbone/c2f_1/m0/cv1", "head/cls2_out", ...), the port's module names
with "/" for ".". The folded and int8 forwards run the detector's own
wiring: YoloV8 built on the meta device with each ConvBN and head output
conv swapped for the folded or int8 computation (_rewired), so the wiring
exists once, in model.py.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.quant import conv_s8s32, fold_conv_bn, observe_act_scales, quantize_folded
from .model import YoloConfig, YoloV8
from .modules import BN_EPS, ConvBN, OutConv


@torch.no_grad()
def fold_yolo(model: YoloV8) -> Dict[str, dict]:
    """{path: {"w": f32 OIHW kernel, "b": f32 [co]}} for every ConvBN of the
    detector, BN folded in; the head output convs pass through as {"w",
    "b", "float": True}."""
    out = {}
    for name, m in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(m, ConvBN):
            out[path] = fold_conv_bn(m.conv.weight, m.bn, BN_EPS)
        elif isinstance(m, OutConv):
            out[path] = {"w": m.weight.detach().float(), "b": m.bias.detach().float(),
                         "float": True}
    return out


class _Swap(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _rewired(cfg: YoloConfig, convbn: Callable, head_out: Callable) -> YoloV8:
    """YoloV8's wiring with every ConvBN replaced by convbn(path, conv) and
    every head output conv by head_out(path): functions of an NCHW tensor
    (conv is the meta module's nn.Conv2d, for its stride and padding).
    Built on the meta device: no weights of its own."""
    with torch.device("meta"):
        model = YoloV8(cfg)
    for name, m in list(model.named_modules()):
        path = name.replace(".", "/")
        if isinstance(m, ConvBN):
            model.set_submodule(name, _Swap(convbn(path, m.conv)))
        elif isinstance(m, OutConv):
            model.set_submodule(name, _Swap(head_out(path)))
    return model


def _float_out(e: dict) -> Callable:
    return lambda h: F.conv2d(h.float(), e["w"], e["b"])


def yolo_folded_forward(folded: Dict[str, dict], cfg: YoloConfig, x: torch.Tensor,
                        observer=None):
    """The f32 forward over fold_yolo's tree, equal (eval mode) to the
    float detector's; x NHWC, outputs as YoloV8's. `observer(path, h)` is
    called with each ConvBN's NCHW input (the calibration hook)."""

    def convbn(path, conv):
        e = folded[path]

        def run(h):
            if observer is not None:
                observer(path, h)
            return F.silu(F.conv2d(h, e["w"], e["b"], conv.stride, conv.padding))
        return run

    return _rewired(cfg, convbn, lambda path: _float_out(folded[path]))(x)


def yolo_int8_model(q: Dict[str, dict], cfg: YoloConfig,
                    compute_dtype=torch.float32) -> YoloV8:
    """The int8 detector over quantize_folded's tree, built once: call it
    on NHWC frames (any float dtype) for YoloV8's outputs, the logits f32.
    Each ConvBN quantizes its input as round(x_f32 / a) (a division in f32,
    unlike the towers' reciprocal), clipped to +-127, runs conv_s8s32, and
    dequantizes y_cd * (a * s)_cd + b_cd before the SiLU in compute_dtype;
    the head output convs run in f32."""
    cd = compute_dtype

    def convbn(path, conv):
        e = q[path]
        stride, pad = conv.stride[0], conv.padding[0]

        def run(h):
            xq = torch.round(h.float() / e["a"]).clamp(-127, 127).to(torch.int8)
            y = conv_s8s32(xq.permute(0, 2, 3, 1), e["w"], stride, pad)
            y = y.to(cd) * (e["a"] * e["s"]).to(cd) + e["b"].to(cd)
            return F.silu(y).permute(0, 3, 1, 2)
        return run

    return _rewired(cfg, convbn, lambda path: _float_out(q[path]))


def calibrate_yolo(folded: Dict[str, dict], cfg: YoloConfig,
                   batches: Iterable) -> Dict[str, float]:
    """{path: input scale} of every ConvBN: its input's abs max over the f32
    folded forward of `batches` (NHWC frames as the detector takes them)."""
    device = folded["backbone/stem"]["w"].device
    return observe_act_scales(
        lambda x, observer: yolo_folded_forward(folded, cfg, x, observer=observer),
        batches, device)


def quantize_yolo_from_variables(model: YoloV8, calib_batches: Iterable) -> Dict[str, dict]:
    """One-call PTQ of the detector (eval-mode BN folded) over calibration
    frames ([B, H, W, 3], normalized to [0, 1]): the int8 tree for
    yolo_int8_model."""
    folded = fold_yolo(model)
    return quantize_folded(folded, calibrate_yolo(folded, model.cfg, calib_batches))
