"""BN folding, the folded ResNet50 serving forward and the int8 serving
mode (counterpart of pose6d_tpu/ops/quant.py).

`fold_bn_resnet` turns every conv+BN pair of a ResNet50 tower into one conv
with a bias (an inference-only identity). `folded_resnet50_forward` runs
the tower over that tree with activations in compute_dtype and, when given
packed weights, its stem, layer1 and any of its four stages through the
CUDA kernels of ops/fused_block.py; the rest runs on torch's convolutions,
as the JAX package leaves it to XLA.

The int8 mode is post-training quantization: per-output-channel symmetric
int8 weights (`quantize_weights_per_channel`), one static activation scale
per conv input from a calibration pass over the folded forward
(`calibrate_act_scales`: the abs max of x, or a percentile of |x|), and
`int8_resnet50_forward`, whose convolutions are s8 x s8 -> s32
(`conv_s8s32`) with the requantize, ReLU and residual epilogues in
compute_dtype, each cast and rounding where the JAX package has it. The
JAX package leaves its int8 convolution to XLA, outside any Pallas kernel;
here it is im2col in int8 and torch._int_mm, exact on the CPU and on the
card alike.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.nn.functional as F

from ..models.resnet import STAGE_SIZES, ResNet50
from .fused_block import fused_layer1, fused_stage, fused_stem


def fold_conv_bn(conv_w: torch.Tensor, bn, eps: float):
    g = bn.weight.detach() / torch.sqrt(bn.running_var + eps)
    w = conv_w.detach() * g[:, None, None, None]  # scale each output channel
    b = bn.bias.detach() - bn.running_mean * g
    return {"w": w.float(), "b": b.float()}


@torch.no_grad()
def fold_bn_resnet(tower: ResNet50, eps: float = 1e-5) -> Dict[str, dict]:
    """{name: {"w": f32 OIHW kernel, "b": f32 [co]}} for every conv of the
    tower; names follow the JAX package ("conv1", "layer1_0/conv1", ...,
    "layer2_0/downsample"). A space-to-depth stem (stem_s2d) raises: the
    folded and int8 towers run the 7x7 stem."""
    if tower.stem_s2d:
        raise ValueError("fold_bn_resnet: a stem_s2d tower; the folded and int8 serving "
                         "modes take the 7x7 stem")
    out = {"conv1": fold_conv_bn(tower.conv1.weight, tower.bn1, eps)}
    for i, n_blocks in enumerate(STAGE_SIZES):
        for j in range(n_blocks):
            name = f"layer{i + 1}_{j}"
            blk = getattr(tower, name)
            for c in (1, 2, 3):
                out[f"{name}/conv{c}"] = fold_conv_bn(getattr(blk, f"conv{c}").weight,
                                                   getattr(blk, f"bn{c}"), eps)
            if blk.downsample_conv is not None:
                out[f"{name}/downsample"] = fold_conv_bn(blk.downsample_conv.weight,
                                                      blk.downsample_bn, eps)
    return out


def nn_max_pool(x: torch.Tensor) -> torch.Tensor:
    """ResNet's maxpool 3x3/s2/pad1 on an NCHW tensor (-inf padding)."""
    return F.max_pool2d(x, 3, 2, padding=1)


def folded_resnet50_forward(folded: Dict[str, dict], x: torch.Tensor,
                            compute_dtype=torch.float32, pallas_l1=None,
                            pallas_stem=None, pallas_stages=None,
                            observer=None) -> torch.Tensor:
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
    when 1 is not among them (the JAX package's precedence).
    `observer(name, h)` is called with each conv's NCHW input (the
    calibration hook)."""
    cd = compute_dtype
    stages = pallas_stages or {}

    def conv(name, h, stride=1, padding=0):
        if observer is not None:
            observer(name, h)
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


# ------------------------------------------------------------------ int8


def quantize_weights_per_channel(w: torch.Tensor):
    """Symmetric per-output-channel int8 of an OIHW kernel: (codes [co, kh,
    kw, ci] int8, scales [co] f32), the scale the absolute max over each
    output channel's weights / 127, as the JAX package's over every axis
    of its HWIO kernel but the last. The codes are OHWI, the order of
    conv_s8s32's im2col columns."""
    w = w.float()
    scale = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 127.0
    codes = torch.round(w / scale[:, None, None, None]).clamp(-127, 127).to(torch.int8)
    return codes.permute(0, 2, 3, 1).contiguous(), scale


def quantize_folded(folded: Dict[str, dict], act_scales: Dict[str, float]) -> Dict[str, dict]:
    """The int8 serving tree of a folded tree: {name: {"w": int8 OHWI
    codes, "s": f32 [co] weight scales, "b": f32 [co] bias, "a": f32 0-dim
    input scale}} on the folded tree's device. An entry marked "float"
    (the detector's head output convs) passes through as it is; this is
    also the JAX package's quantize_yolo_folded."""
    q = {}
    for name, e in folded.items():
        if e.get("float"):
            q[name] = e
            continue
        codes, scale = quantize_weights_per_channel(e["w"])
        q[name] = {"w": codes, "s": scale, "b": e["b"].float(),
                   "a": torch.tensor(act_scales[name], dtype=torch.float32, device=codes.device)}
    return q


def conv_s8s32(xq: torch.Tensor, w: torch.Tensor, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """s8 x s8 -> s32 convolution: NHWC int8 codes xq [B, H, W, ci] and
    OHWI int8 codes w [co, kh, kw, ci], `pad` zeros on each side ->
    NHWC int32 [B, Ho, Wo, co], exact (the JAX package's
    lax.conv_general_dilated(..., preferred_element_type=int32)).

    im2col in int8: kh * kw shifted, strided slices of the padded input
    concatenated on channels in (kh, kw, ci) order (a 1x1 stride-1 conv is
    a view), then torch._int_mm, on the CPU and on the card alike. On the
    card _int_mm takes only M > 16 and K, N multiples of 8, so K is padded
    with zero columns to a multiple of 8 (ResNet50's conv1 147 -> 152, its
    depth conv1 49 -> 56, YOLOv8's stem 27 -> 32), which is exact; a shape
    it still refuses raises."""
    B, H, W, ci = xq.shape
    co, kh, kw, wci = w.shape
    if wci != ci or xq.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"conv_s8s32: int8 [B, H, W, {wci}] codes expected, got "
                         f"{xq.dtype} {list(xq.shape)} and {w.dtype} {list(w.shape)}")
    ho, wo = (H + 2 * pad - kh) // stride + 1, (W + 2 * pad - kw) // stride + 1
    k = kh * kw * ci
    kp = -(-k // 8) * 8
    wmat = w.reshape(co, k)
    if kp != k:
        wmat = F.pad(wmat, (0, kp - k))
    if kh == kw == 1 and pad == 0:
        cols = [xq[:, ::stride, ::stride]]
    else:
        xp = F.pad(xq, (0, 0, pad, pad, pad, pad))
        cols = [xp[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
                for i in range(kh) for j in range(kw)]
    if kp != k:
        cols.append(xq.new_zeros(B, ho, wo, kp - k))
    a = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
    return torch._int_mm(a.reshape(B * ho * wo, kp), wmat.t()).view(B, ho, wo, co)


def int8_resnet50_forward(q: Dict[str, dict], x: torch.Tensor,
                          compute_dtype=torch.float32) -> torch.Tensor:
    """The int8 serving forward of a ResNet50 tower over quantize_folded's
    tree: NHWC x -> features [B, 2048] in compute_dtype.

    Every conv is s8 x s8 -> s32 (conv_s8s32); block activations live only
    as int8, each epilogue requantizing straight to its consumer's scale,
    as the JAX package's int8-resident design. Its arithmetic, cast for
    cast: quantize round(x_cd * (1/a)_cd) with the reciprocal taken in f32
    (round half to even, clip to +-127); dequantize y_cd * (a_in * s)_cd +
    b_cd with the int32 cast to compute_dtype first; the downsample shares
    conv1's codes and so dequantizes with conv1's scale; the identity
    residual is the block input's codes times their scale; the features
    are the f32 mean cast to compute_dtype."""
    cd = compute_dtype

    def quant(h, a):
        return torch.round(h.to(cd) * torch.reciprocal(a).to(cd)).clamp(-127, 127).to(torch.int8)

    def deq(y, e, a_in):
        return y.to(cd) * (a_in * e["s"]).to(cd) + e["b"].to(cd)

    e1 = q["conv1"]
    y = F.relu(deq(conv_s8s32(quant(x, e1["a"]), e1["w"], 2, 3), e1, e1["a"]))
    xf = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
    blocks = [(i, j, 2 if i > 0 and j == 0 else 1)
              for i, n_blocks in enumerate(STAGE_SIZES) for j in range(n_blocks)]
    a_in = q["layer1_0/conv1"]["a"]
    xq = quant(xf, a_in)
    for idx, (i, j, stride) in enumerate(blocks):
        blk = f"layer{i + 1}_{j}"
        c1, c2, c3 = q[f"{blk}/conv1"], q[f"{blk}/conv2"], q[f"{blk}/conv3"]
        y = F.relu(deq(conv_s8s32(xq, c1["w"]), c1, a_in))
        y = F.relu(deq(conv_s8s32(quant(y, c2["a"]), c2["w"], stride, 1), c2, c2["a"]))
        y = deq(conv_s8s32(quant(y, c3["a"]), c3["w"]), c3, c3["a"])
        ed = q.get(f"{blk}/downsample")
        if ed is not None:
            r = deq(conv_s8s32(xq, ed["w"], stride), ed, a_in)
        else:
            r = xq.to(cd) * a_in.to(cd)
        xf = F.relu(y + r)
        if idx + 1 < len(blocks):
            ni, nj, _ = blocks[idx + 1]
            a_in = q[f"layer{ni + 1}_{nj}/conv1"]["a"]
            xq = quant(xf, a_in)
    return xf.float().mean(dim=(1, 2)).to(cd)


def abs_percentile(x: torch.Tensor, percentile: float) -> torch.Tensor:
    """The percentile of |x| over all its elements by numpy's default
    'linear' rule, as jnp.percentile takes it: the sorted values at floor
    and ceil of q / 100 * (n - 1), interpolated. Two kthvalue selections
    (torch.quantile refuses inputs above 2**24 elements; a layer1 input at
    batch 128 holds 25.7 M)."""
    a = x.detach().abs().reshape(-1)
    pos = percentile / 100.0 * (a.numel() - 1)
    lo = math.floor(pos)
    low = a.kthvalue(lo + 1).values
    if pos == lo:
        return low
    return low + (a.kthvalue(lo + 2).values - low) * (pos - lo)


def observe_act_scales(run: Callable, batches: Iterable, device,
                       percentile: Optional[float] = None, group=None) -> Dict[str, float]:
    """Static activation scales: run(x, observer) is a folded forward over
    each calibration batch (as f32 on `device`) calling observer(name, h)
    with each conv's input; per conv, the largest over the batches of its
    input's abs max (or, with `percentile`, abs_percentile of its input)
    / 127, as Python floats. Reads each statistic back to the host:
    calibration only. group: under a mesh, the data group (a
    parallel.collectives.Group), whose ranks hold different rows of each
    batch: the abs maxes are reduced with MAX over it, and a percentile is
    taken over the inputs gathered from it, so that every rank holds the
    scales of the whole batch."""
    import torch.distributed as dist

    from ..parallel.collectives import all_gather_rows, all_reduce_

    maxes: Dict[str, float] = {}
    for xb in batches:
        vals = {}

        def observer(name, h):
            if percentile is None:
                vals[name] = h.abs().amax()
            else:
                h = h if group is None else all_gather_rows(h.reshape(-1), group)
                vals[name] = abs_percentile(h, percentile)

        run(torch.as_tensor(xb, dtype=torch.float32, device=device), observer)
        if group is not None and percentile is None:
            stacked = torch.stack([v.float() for v in vals.values()])
            vals = dict(zip(vals, all_reduce_(stacked, group, dist.ReduceOp.MAX)))
        for name, v in vals.items():
            maxes[name] = max(maxes.get(name, 0.0), float(v))
    return {name: max(v, 1e-12) / 127.0 for name, v in maxes.items()}


def calibrate_act_scales(folded: Dict[str, dict], batches: Iterable,
                         percentile: Optional[float] = None, group=None) -> Dict[str, float]:
    """{conv name: input scale} of a ResNet50 tower from the f32 folded
    forward over `batches` (NHWC [B, H, W, C]): each conv input's abs max,
    or its `percentile` of |x| (group: see observe_act_scales)."""
    device = folded["conv1"]["w"].device
    return observe_act_scales(
        lambda x, observer: folded_resnet50_forward(folded, x, observer=observer),
        batches, device, percentile, group)


def quantize_resnet_from_variables(tower: ResNet50, calib_batches: Iterable,
                                   percentile: Optional[float] = None,
                                   group=None) -> Dict[str, dict]:
    """One-call PTQ of a ResNet50 tower (eval-mode BN folded) over
    calibration batches: the int8 tree for int8_resnet50_forward."""
    folded = fold_bn_resnet(tower)
    return quantize_folded(folded, calibrate_act_scales(folded, calib_batches, percentile,
                                                        group))
