"""The networks, float32, as plain functions over a state dict whose keys
are the program's state_dict keys (the benchmark makes one set of weights
and hands it to both sides). Tensors are NCHW inside.

YOLOv8 (ultralytics yolov8.yaml, scale n: width 0.25, depth 1/3, ratio 2):
Conv = conv + BatchNorm (eps 1e-3) + SiLU; C2f; SPPF; a PAN-FPN neck; a
decoupled head of 4 x reg_max DFL logits and nc class logits per level.
ResNet-50 (He et al. 2016, torchvision's v1.5: the stride on the 3x3 conv)
with its BatchNorm (eps 1e-5) applied as such, not folded. The rgbd heads:
LayerNorm (eps 1e-6) on both towers' features, cross-modal attention with
8 heads of 256 (Q from RGB, K/V from depth) added to the RGB features, a
LayerNorm/GELU fusion to 1024, LayerNorm/GELU rotation and translation
heads (512, 256). The rgbd_geometric rotation head: Linear/BatchNorm/ReLU
1024, 512.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

YOLO_BN_EPS = 1e-3
RESNET_BN_EPS = 1e-5
LN_EPS = 1e-6
STAGE_BLOCKS = (3, 4, 6, 3)
ATTENTION_HEADS = 8
_SETTLE = contextvars.ContextVar("settle", default=None)


@contextlib.contextmanager
def settle_batchnorm(spread: float):
    """Inside the block every BatchNorm first sets its running statistics
    from its input's batch: running_mean the batch mean, running_var the
    batch variance / spread^2, so that each channel leaves it with the
    standard deviation spread x |weight| (before its bias); it then
    normalises with them, as it will after the block."""
    token = _SETTLE.set(spread)
    try:
        yield
    finally:
        _SETTLE.reset(token)


def _bn(sd: dict, p: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    spread = _SETTLE.get()
    if spread is not None:
        var, mean = torch.var_mean(x, dim=[d for d in range(x.dim()) if d != 1])
        sd[p + ".running_mean"].copy_(mean)
        sd[p + ".running_var"].copy_(var / spread ** 2)
    return F.batch_norm(x, sd[p + ".running_mean"], sd[p + ".running_var"], sd[p + ".weight"],
                        sd[p + ".bias"], False, 0.0, eps)


def _ln(sd: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], sd[p + ".weight"], sd[p + ".bias"], LN_EPS)


def _linear(sd: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, sd[p + ".weight"], sd[p + ".bias"])


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# ------------------------------------------------------------------ YOLOv8

def _conv(sd: dict, p: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    w = sd[p + ".conv.weight"]
    y = F.conv2d(x, w, None, stride, w.shape[-1] // 2)
    return F.silu(_bn(sd, p + ".bn", y, YOLO_BN_EPS))


def _c2f(sd: dict, p: str, x: torch.Tensor, shortcut: bool) -> torch.Tensor:
    y = _conv(sd, p + ".cv1", x)
    chunks = list(y.split(y.shape[1] // 2, dim=1))
    i = 0
    while f"{p}.m{i}.cv1.conv.weight" in sd:
        z = _conv(sd, f"{p}.m{i}.cv2", _conv(sd, f"{p}.m{i}.cv1", chunks[-1]))
        chunks.append(chunks[-1] + z if shortcut else z)
        i += 1
    return _conv(sd, p + ".cv2", torch.cat(chunks, dim=1))


def _sppf(sd: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    pools = [_conv(sd, p + ".cv1", x)]
    for _ in range(3):
        pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
    return _conv(sd, p + ".cv2", torch.cat(pools, dim=1))


def _up(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def yolo_levels(sd: dict, x: torch.Tensor, levels: int = 3) -> list:
    """x [B, 3, H, W] in [0, 1] -> [(box logits [B, 4 reg_max, h, w], class
    logits [B, nc, h, w])] per stride level (8, 16, 32)."""
    b = "backbone."
    x = _c2f(sd, b + "c2f_1", _conv(sd, b + "down1", _conv(sd, b + "stem", x, 2), 2), True)
    p3 = _c2f(sd, b + "c2f_2", _conv(sd, b + "down2", x, 2), True)
    p4 = _c2f(sd, b + "c2f_3", _conv(sd, b + "down3", p3, 2), True)
    p5 = _sppf(sd, b + "sppf", _c2f(sd, b + "c2f_4", _conv(sd, b + "down4", p4, 2), True))
    n = "neck."
    t4 = _c2f(sd, n + "td_p4", torch.cat([_up(p5), p4], 1), False)
    t3 = _c2f(sd, n + "td_p3", torch.cat([_up(t4), p3], 1), False)
    b4 = _c2f(sd, n + "bu_p4", torch.cat([_conv(sd, n + "bu_down3", t3, 2), t4], 1), False)
    b5 = _c2f(sd, n + "bu_p5", torch.cat([_conv(sd, n + "bu_down4", b4, 2), p5], 1), False)
    out = []
    for i, feat in enumerate((t3, b4, b5)[:levels]):
        branch = []
        for kind in ("box", "cls"):
            y = _conv(sd, f"head.{kind}{i}_1", _conv(sd, f"head.{kind}{i}_0", feat))
            branch.append(F.conv2d(y, sd[f"head.{kind}{i}_out.weight"],
                                   sd[f"head.{kind}{i}_out.bias"]))
        out.append(tuple(branch))
    return out


# --------------------------------------------------------------- ResNet-50

def _conv_bn(sd: dict, conv: str, bn: str, x: torch.Tensor, stride: int, pad: int,
             folded) -> torch.Tensor:
    """conv then BatchNorm; with `folded` a dtype, the BatchNorm folded
    into the conv's weight and bias in float32 and the conv run in that
    dtype, its inputs cast to it (a serving tower's arithmetic)."""
    w = sd[conv + ".weight"]
    if folded is None:
        return _bn(sd, bn, F.conv2d(x, w, None, stride, pad), RESNET_BN_EPS)
    g = sd[bn + ".weight"] / torch.sqrt(sd[bn + ".running_var"] + RESNET_BN_EPS)
    b = sd[bn + ".bias"] - sd[bn + ".running_mean"] * g
    if isinstance(folded, tuple):
        dt, fmt = folded
        return F.conv2d(x.to(dt).contiguous(memory_format=fmt),
                        (w * g[:, None, None, None]).to(dt).contiguous(memory_format=fmt),
                        b.to(dt), stride, pad)
    return F.conv2d(x.to(folded), (w * g[:, None, None, None]).to(folded), b.to(folded),
                    stride, pad)


def _bottleneck(sd: dict, p: str, x: torch.Tensor, stride: int, folded) -> torch.Tensor:
    y = F.relu(_conv_bn(sd, p + ".conv1", p + ".bn1", x, 1, 0, folded))
    y = F.relu(_conv_bn(sd, p + ".conv2", p + ".bn2", y, stride, 1, folded))
    y = _conv_bn(sd, p + ".conv3", p + ".bn3", y, 1, 0, folded)
    if p + ".downsample_conv.weight" in sd:
        x = _conv_bn(sd, p + ".downsample_conv", p + ".downsample_bn", x, stride, 0, folded)
    return F.relu(y + x)


def resnet50(sd: dict, p: str, x: torch.Tensor, folded=None) -> torch.Tensor:
    """x [B, C, S, S] -> globally average-pooled features [B, 2048]
    (float32); folded: None, or the dtype of a BatchNorm-folded tower."""
    x = _conv_bn(sd, p + ".conv1", p + ".bn1", x, 2, 3, folded)
    x = F.max_pool2d(F.relu(x), 3, 2, 1)
    for i, n in enumerate(STAGE_BLOCKS):
        for j in range(n):
            x = _bottleneck(sd, f"{p}.layer{i + 1}_{j}", x, 2 if i > 0 and j == 0 else 1,
                            folded)
    return x.float().mean(dim=(2, 3))


# ------------------------------------------------------------------ heads

def _mlp(sd: dict, prefix: str, x: torch.Tensor, act, norm: str) -> torch.Tensor:
    """Linear -> norm ('layer' or 'batch', where the layer has one) -> act,
    per hidden layer, then the output Linear."""
    i = 0
    while f"{prefix}dense{i}.weight" in sd:
        x = _linear(sd, f"{prefix}dense{i}", x)
        if f"{prefix}norm{i}.weight" in sd:
            x = (_ln(sd, f"{prefix}norm{i}", x) if norm == "layer"
                 else _bn(sd, f"{prefix}norm{i}", x, RESNET_BN_EPS))
        x = act(x)
        i += 1
    return _linear(sd, f"{prefix}out", x)


def _unit(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-8)


def rgbd_heads(sd: dict, rgb_feat: torch.Tensor, depth_feat: torch.Tensor):
    """(rotation [N, 4] unit xyzw, translation [N, 3] as the head gives it)."""
    r = _ln(sd, "rgb_norm", rgb_feat)
    d = _ln(sd, "depth_norm", depth_feat)
    if "cross_attention.q_proj.weight" in sd:
        n, dim = r.shape
        hd = dim // ATTENTION_HEADS
        q = _linear(sd, "cross_attention.q_proj", r).reshape(n, ATTENTION_HEADS, hd)
        k = _linear(sd, "cross_attention.k_proj", d).reshape(n, ATTENTION_HEADS, hd)
        v = _linear(sd, "cross_attention.v_proj", d).reshape(n, ATTENTION_HEADS, hd)
        attn = torch.softmax(q @ k.transpose(1, 2) * hd ** -0.5, dim=-1)
        r = r + _linear(sd, "cross_attention.out_proj", (attn @ v).reshape(n, dim))
    x = _gelu(_ln(sd, "fusion_norm0", _linear(sd, "fusion_dense0", torch.cat([r, d], -1))))
    x = _gelu(_ln(sd, "fusion_norm1", _linear(sd, "fusion_dense1", x)))
    return _unit(_mlp(sd, "rot_", x, _gelu, "layer")), _mlp(sd, "trans_", x, _gelu, "layer")


def rotation_head_bn(sd: dict, feat: torch.Tensor) -> torch.Tensor:
    """The geometric variants' rotation head: unit xyzw [N, 4]."""
    return _unit(_mlp(sd, "rot_", feat, F.relu, "batch"))
