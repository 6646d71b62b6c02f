"""Fused ResNet50 stem and layer1 for the folded serving towers
(counterpart of pose6d_tpu/ops/pallas_block.py fused_stem / fused_layer1).

Each wrapper launches its hand-written CUDA kernel (csrc/stem.cu,
csrc/layer1.cu) for a CUDA tensor and runs its plain PyTorch version,
`reference_stem` / `reference_layer1`, for a CPU tensor; any other device
raises. Both kernels and both plain versions take the same packed weights
and keep the TPU kernels' numeric contract: f32 accumulation, bias and
residual added in f32, activations rounded to the compute type (the dtype
of x) at every conv output that the TPU kernel rounded.

Layouts are NHWC like the JAX package: stem [B,224,224,C] -> [B,56,56,64]
(C = 3 for rgb towers, 1 for the rgbd depth tower); layer1 [B,56,56,64] ->
[B,56,56,256].
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

H = W = 56
CIN, CMID, COUT = 64, 64, 256
STEM_IN = 224


def pack_stem_weights(folded: dict, dtype=torch.bfloat16):
    """The folded conv1 entry (OIHW [64,C,7,7]) as the kernel's pair:
    (w [7,7,C,64] HWIO in dtype, b [64] f32). The TPU kernel's space-to-depth
    rearrangement of the same weights is not needed here."""
    w = folded["conv1"]["w"].permute(2, 3, 1, 0).contiguous().to(dtype)
    return w, folded["conv1"]["b"].float().contiguous()


def pack_layer1_weights(folded: dict, dtype=torch.bfloat16):
    """The layer1 entries of a folded tree as the kernel's 20-tuple, in the
    JAX package's order: per block w1 [ci,co], b1, w2 [576,64] in (ky, kx,
    cin) row order, b2, w3 [64,256], b3, and for block 0 wd [64,256], bd.
    Weights are in dtype, biases f32 [co]."""

    def w11(name):
        w = folded[name]["w"]  # [co, ci, 1, 1]
        return w[:, :, 0, 0].t().contiguous().to(dtype)

    def w33(name):
        w = folded[name]["w"]  # [co, ci, 3, 3] -> [(ky, kx, ci), co]
        return w.permute(2, 3, 1, 0).reshape(9 * w.shape[1], w.shape[0]).contiguous().to(dtype)

    def b(name):
        return folded[name]["b"].float().contiguous()

    args = []
    for j in range(3):
        blk = f"layer1_{j}"
        args += [w11(f"{blk}/conv1"), b(f"{blk}/conv1"), w33(f"{blk}/conv2"),
                 b(f"{blk}/conv2"), w11(f"{blk}/conv3"), b(f"{blk}/conv3")]
        if j == 0:
            args += [w11(f"{blk}/downsample"), b(f"{blk}/downsample")]
    return tuple(args)


# ------------------------------------------------------------ plain versions


def reference_stem(x: torch.Tensor, weights) -> torch.Tensor:
    """conv1 7x7/s2/pad3 + bias in f32, ReLU, round to x.dtype, maxpool
    3x3/s2/pad1 (torch's -inf padding) -> [B,56,56,64] in x.dtype."""
    w, b = weights
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float().permute(3, 2, 0, 1),
                 b.float(), stride=2, padding=3)
    y = F.relu(y).to(x.dtype)
    return F.max_pool2d(y, 3, 2, padding=1).permute(0, 2, 3, 1).contiguous()


def reference_layer1(x: torch.Tensor, weights) -> torch.Tensor:
    """The three folded bottlenecks in f32 with the kernel's roundings:
    conv1/conv2 outputs and each block output round to x.dtype; block 0's
    projection shortcut stays f32 until the block's sum."""
    dt = x.dtype
    B = x.shape[0]

    def mm(a, w, b):  # 1x1 conv on the [M, ci] rows, f32
        return a.float() @ w.float() + b

    def conv3x3(a, w, b):  # a [M, 64] rows of the [B,56,56,64] map
        a = a.reshape(B, H, W, CMID).permute(0, 3, 1, 2).float()
        w = w.float().reshape(3, 3, CMID, CMID).permute(3, 2, 0, 1)
        y = F.conv2d(a, w, b, padding=1)
        return y.permute(0, 2, 3, 1).reshape(-1, CMID)

    h = x.reshape(-1, CIN)
    it = iter(weights)
    for j in range(3):
        w1, b1, w2, b2, w3, b3 = (next(it) for _ in range(6))
        shortcut = mm(h, *(next(it) for _ in range(2))) if j == 0 else h.float()
        t = F.relu(mm(h, w1, b1)).to(dt)
        t = F.relu(conv3x3(t, w2, b2)).to(dt)
        h = F.relu(mm(t, w3, b3) + shortcut).to(dt)
    return h.reshape(B, H, W, COUT)


# ------------------------------------------------------------------ kernels


def _dtype_flag(x: torch.Tensor) -> int:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected float32 or bfloat16, got {x.dtype}")
    return int(x.dtype == torch.bfloat16)


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    """What the kernel takes, checked for every device so that the plain
    path refuses the same inputs."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_on_card(x: torch.Tensor, tensors) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}: CPU runs the plain "
                         f"version, CUDA the kernel")
    for t in (x, *tensors):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_stem(x, w, b, out, stream: int) -> None:
    B, _, _, C = x.shape
    code = _build.lib().pose6d_stem_forward(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, C,
        _dtype_flag(x), stream)
    _build.check(code, "fused_stem")


def _launch_layer1(x, weights, scratch, out, stream: int) -> None:
    ptrs = (ctypes.c_void_p * len(weights))(*(t.data_ptr() for t in weights))
    t1, t2, ya, yb = scratch
    code = _build.lib().pose6d_layer1_forward(
        x.data_ptr(), ptrs, t1.data_ptr(), t2.data_ptr(), ya.data_ptr(),
        yb.data_ptr(), out.data_ptr(), x.shape[0], _dtype_flag(x), stream)
    _build.check(code, "fused_layer1")


def fused_stem(x: torch.Tensor, weights) -> torch.Tensor:
    """conv1 + ReLU + maxpool as one kernel. x [B,224,224,C] (C 3 or 1) in
    f32 or bf16; weights from pack_stem_weights in x's dtype. Returns
    [B,56,56,64] in x.dtype."""
    w, b = weights
    _dtype_flag(x)
    if x.ndim != 4 or x.shape[1:3] != (STEM_IN, STEM_IN) or x.shape[3] not in (1, 3):
        raise ValueError(f"fused_stem: x must be [B,224,224,1|3], got {tuple(x.shape)}")
    C = x.shape[3]
    _check("w", w, x.dtype, (7, 7, C, CIN))
    _check("b", b, torch.float32, (CIN,))
    if x.device.type == "cpu":
        return reference_stem(x, weights)
    _check_on_card(x, (w, b))
    out = torch.empty((x.shape[0], H, W, CIN), dtype=x.dtype, device=x.device)
    _launch_stem(x, w, b, out, _stream(x.device))
    _build.launch_counts[f"fused_stem_c{C}"] += 1
    return out


_LAYER1_SHAPES = [(CIN, CMID), (CMID,), (9 * CMID, CMID), (CMID,), (CMID, COUT), (COUT,),
                  (CIN, COUT), (COUT,)] + 2 * [(COUT, CMID), (CMID,), (9 * CMID, CMID),
                                                (CMID,), (CMID, COUT), (COUT,)]


def fused_layer1(x: torch.Tensor, weights) -> torch.Tensor:
    """ResNet50 layer1 (three folded bottlenecks). x [B,56,56,64] in f32 or
    bf16; weights from pack_layer1_weights in x's dtype. Returns
    [B,56,56,256] in x.dtype. On the card this is one logical launch of a
    short sequence of kernels (csrc/layer1.cu)."""
    _dtype_flag(x)
    if x.ndim != 4 or tuple(x.shape[1:]) != (H, W, CIN):
        raise ValueError(f"fused_layer1: x must be [B,56,56,64], got {tuple(x.shape)}")
    if len(weights) != len(_LAYER1_SHAPES):
        raise ValueError(f"fused_layer1: expected {len(_LAYER1_SHAPES)} weights")
    for i, (t, shape) in enumerate(zip(weights, _LAYER1_SHAPES)):
        _check(f"weights[{i}]", t, torch.float32 if len(shape) == 1 else x.dtype, shape)
    if x.device.type == "cpu":
        return reference_layer1(x, weights)
    _check_on_card(x, weights)
    M = x.shape[0] * H * W
    scratch = tuple(torch.empty((M, c), dtype=x.dtype, device=x.device)
                    for c in (CMID, CMID, COUT, COUT))
    out = torch.empty((x.shape[0], H, W, COUT), dtype=x.dtype, device=x.device)
    _launch_layer1(x, weights, scratch, out, _stream(x.device))
    _build.launch_counts["fused_layer1"] += 1
    return out
