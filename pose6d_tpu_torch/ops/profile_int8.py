"""The int8 towers and detector against bf16, split (counterpart of
scripts/profile_int8_stages.py and probe_int8_variants.py), as runs of the
request trace's tool, ops/profile_pipeline.py, whose Clock reads them:

    python -m pose6d_tpu_torch.ops.profile_pipeline --int8-split BATCH [BATCH ...]
    python -m pose6d_tpu_torch.ops.profile_pipeline --int8-variants BATCH [BATCH ...]
        [--frame-hw H W] [--img-size S] [--window N] [--reps N] [--device cuda]

Set-up, the JAX scripts': a ResNet50 tower with seeded weights (the rgb
PoseNet's tower of convert.init_posenet_weights), crops uniform(-2, 2)
[B, S, S, 3] and frames uniform(0, 1) [B, H, W, 3] (--frame-hw, sides that
divide 32: the detector runs at native resolution), both in bf16; the int8
tree is ops/quant.quantize_resnet_from_variables over the first 8 crops in
f32, the detector's models/yolo/quant.quantize_yolo_from_variables over
the first 4 frames. The bf16 tower is ops/quant.folded_resnet50_forward in
bf16 (the JAX script's is the unfolded ResNet50(dtype=bf16); the folded
tower is the one the hand-written kernels serve), with the stem and stage
1-4 kernels at img 224 (without them elsewhere); "tower_bf16"
says which ran, and "tower_bf16_vs_cudnn_rel_l2" is its features' rel-L2
from the same folded tower on cuDNN alone (null without the kernels).

--int8-split: tower_bf16, tower_int8 (int8_resnet50_forward in bf16),
act_quantize (round(x * 8) clipped to +-127 on the crops, the activation
quantize alone), yolo_bf16 (the bf16 YoloV8, which casts its weights at
use), yolo_int8 (yolo_int8_model in bf16).

--int8-variants: probe_int8_variants.py's variants of the int8 tower, as
probe functions here (ops/quant.py has no switch for them):
  bf16  the bf16 tower above;
  A     int8_resnet50_forward in bf16, the serving tower ("A_int8_f32epi"
        keeps the JAX key: the JAX package's A ran its epilogues in f32
        before it took up B's and E's design);
  B     int8-resident: block activations live only as int8 codes, each
        epilogue quantizing straight to the next conv's scale and the
        identity residual the dequantized codes, epilogues in f32 (the
        serving tower's design in f32, so B_vs_A_rel_drift, max |A_f32 -
        B| / max |A_f32|, is 0 where the two round alike);
  C     float-resident with bf16 epilogues: every conv quantizes its own
        float input with its own scale, the residual the float tensor;
  D     A cut after each stage k = 1..4 (the features the f32 mean of
        stage k's output, cast to bf16: D at k = 4 is A bit for bit),
        beside the bf16 tower cut alike; deltas between successive cuts;
  E     B with bf16 epilogues (A with f32 features).

Readings (profile_pipeline.Clock): "ms", CUDA events around a window of
back-to-back launches over its count, warm-up left out; "host_enqueue_ms";
"card_ms", a CUDA-graph replay of one launch; "idle_share". Each launch
reads the next batch of a ring of crop or frame batches past 2x the
card's L2. On the CPU: the host clock; card_ms and idle_share are null.

Output, one JSON line per flag and batch, with the JAX script's keys
(ms) and each reading under "readings":
  {"tool": "int8_split", "tower_bf16_ms", "tower_int8_ms",
   "act_quantize_ms", "yolo_bf16_ms", "yolo_int8_ms", "tower_bf16", ...}
  {"tool": "int8_variants", "bf16_ms", "A_int8_f32epi_ms",
   "C_int8_bf16epi_ms", "B_int8_resident_ms", "B_vs_A_rel_drift",
   "D_int8_prefix_stage<k>_ms", "D_int8_stage<k>_delta_ms",
   "D_int8_stage<k>_card_delta_ms", "D_bf16_prefix_stage<k>_ms",
   "D_bf16_stage<k>_delta_ms", "D_bf16_stage<k>_card_delta_ms",
   "E_int8_resident_bf16epi_ms", "D_last_prefix_equals_A": true,
   "tower_bf16", ...}
each also with "batch", "readings", "kernel_launches" {name: {launch-count
key: launches a call}}, "device", "clock", "tf32", "frame_hw",
"img_size", "window", "ring".
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .profile_pipeline import SEED, Clock, launches_of, ring_size, setting

STAGE_KERNELS = (1, 2, 3, 4)


# ------------------------------------------------------------- the probes

def _quant(h, a, dt):
    """round(h_dt * (1/a)_dt), the reciprocal in f32, clipped to +-127:
    int8 codes (the serving tower's quantize)."""
    return torch.round(h.to(dt) * torch.reciprocal(a).to(dt)).clamp(-127, 127).to(torch.int8)


def _deq(y, e, a_in, dt):
    """The int32 products in dt times (a_in * s)_dt plus b_dt."""
    return y.to(dt) * (a_in * e["s"]).to(dt) + e["b"].to(dt)


def _pool(y):
    """The stem's maxpool on an NHWC map."""
    return F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)


def _blocks(upto: int = 4) -> list:
    from ..models.resnet import STAGE_SIZES

    return [(i, j, 2 if i > 0 and j == 0 else 1)
            for i, n_blocks in enumerate(STAGE_SIZES[:upto]) for j in range(n_blocks)]


def int8_resident(q: dict, x, dt, upto: int = 4):
    """Variants B (dt f32) and E (dt bf16), and A cut after stage `upto`
    (dt the compute dtype): the int8-resident tower over an
    ops/quant.quantize_folded tree, the arithmetic of int8_resnet50_forward
    in dt; returns the f32 mean of the last block's output [B, C]."""
    from .quant import conv_s8s32

    e1 = q["conv1"]
    y = F.relu(_deq(conv_s8s32(_quant(x, e1["a"], dt), e1["w"], 2, 3), e1, e1["a"], dt))
    xf = _pool(y)
    blocks = _blocks(upto)
    a_in = q["layer1_0/conv1"]["a"]
    xq = _quant(xf, a_in, dt)
    for idx, (i, j, stride) in enumerate(blocks):
        blk = f"layer{i + 1}_{j}"
        c1, c2, c3 = q[f"{blk}/conv1"], q[f"{blk}/conv2"], q[f"{blk}/conv3"]
        y = F.relu(_deq(conv_s8s32(xq, c1["w"]), c1, a_in, dt))
        y = F.relu(_deq(conv_s8s32(_quant(y, c2["a"], dt), c2["w"], stride, 1), c2, c2["a"], dt))
        y = _deq(conv_s8s32(_quant(y, c3["a"], dt), c3["w"]), c3, c3["a"], dt)
        ed = q.get(f"{blk}/downsample")
        r = (_deq(conv_s8s32(xq, ed["w"], stride), ed, a_in, dt) if ed is not None
             else xq.to(dt) * a_in.to(dt))
        xf = F.relu(y + r)
        if idx + 1 < len(blocks):
            ni, nj, _ = blocks[idx + 1]
            a_in = q[f"layer{ni + 1}_{nj}/conv1"]["a"]
            xq = _quant(xf, a_in, dt)
    return xf.float().mean(dim=(1, 2))


def int8_float_resident(q: dict, x, dt):
    """Variant C: every conv quantizes its own float input with its own
    scale and dequantizes in dt; the residual is the float tensor; the
    features the f32 mean cast to dt (jnp.mean of a dt tensor)."""
    from .quant import conv_s8s32

    def conv(name, h, stride=1, pad=0):
        e = q[name]
        return _deq(conv_s8s32(_quant(h, e["a"], dt), e["w"], stride, pad), e, e["a"], dt)

    h = _pool(F.relu(conv("conv1", x, 2, 3)))
    for i, j, stride in _blocks():
        blk = f"layer{i + 1}_{j}"
        y = F.relu(conv(f"{blk}/conv1", h))
        y = F.relu(conv(f"{blk}/conv2", y, stride, 1))
        y = conv(f"{blk}/conv3", y)
        r = conv(f"{blk}/downsample", h, stride) if f"{blk}/downsample" in q else h
        h = F.relu(y + r)
    return h.float().mean(dim=(1, 2)).to(dt)


def folded_prefix(entry: dict, x, upto: int, cd):
    """folded_resnet50_forward over entry {"tree", and optionally
    "pallas_stem", "pallas_stages"} cut after stage `upto`: the f32 mean
    of its output [B, C] (at upto 4 the whole tower's features)."""
    from ..models.resnet import STAGE_SIZES
    from .fused_block import fused_stage, fused_stem
    from .quant import nn_max_pool

    tree, stem, stages = entry["tree"], entry.get("pallas_stem"), entry.get("pallas_stages", {})

    def conv(name, h, stride=1, padding=0):
        e = tree[name]
        return F.conv2d(h.to(cd), e["w"], e["b"], stride, padding)

    if stem is not None:
        h = fused_stem(x.to(cd).contiguous(), stem).permute(0, 3, 1, 2)
    else:
        h = nn_max_pool(F.relu(conv("conv1", x.permute(0, 3, 1, 2), 2, 3)))
    for i in range(upto):
        if i + 1 in stages:
            nhwc = h.permute(0, 2, 3, 1).contiguous()
            h = fused_stage(nhwc, stages[i + 1], i + 1).permute(0, 3, 1, 2)
            continue
        for j in range(STAGE_SIZES[i]):
            blk = f"layer{i + 1}_{j}"
            stride = 2 if i > 0 and j == 0 else 1
            y = F.relu(conv(f"{blk}/conv1", h))
            y = F.relu(conv(f"{blk}/conv2", y, stride, 1))
            y = conv(f"{blk}/conv3", y)
            r = conv(f"{blk}/downsample", h, stride) if f"{blk}/downsample" in tree else h
            h = F.relu(y + r)
    return h.float().mean(dim=(2, 3))


# ----------------------------------------------------------------- set-up

def seeded_tower(device):
    """A ResNet50 tower in eval mode on device: the rgb PoseNet's tower of
    convert.init_posenet_weights (random BatchNorm statistics too)."""
    from ..convert import init_posenet_weights
    from ..models.posenet import PoseNetConfig
    from ..models.resnet import ResNet50

    sd = init_posenet_weights(PoseNetConfig(variant="rgb"), SEED + 3)
    tower = ResNet50()
    tower.load_state_dict({k.removeprefix("backbone."): v for k, v in sd.items()
                           if k.startswith("backbone.")}, strict=True)
    return tower.to(device).eval()


def folded_entry(tower, cd, kernels: bool) -> dict:
    """The folded tower as PosePipeline.fold_backbones prepares it, with the
    stem and stage 1-4 kernels' packed weights when `kernels`."""
    from .fused_block import pack_stage_weights, pack_stem_weights
    from .quant import fold_bn_resnet

    tree = fold_bn_resnet(tower)
    entry = {"tree": {k: {"w": v["w"].to(cd).contiguous(memory_format=torch.channels_last),
                          "b": v["b"].to(cd)} for k, v in tree.items()}}
    if kernels:
        entry["pallas_stem"] = pack_stem_weights(tree, cd)
        entry["pallas_stages"] = {n: pack_stage_weights(tree, n, cd) for n in STAGE_KERNELS}
    return entry


def bf16_tower(entry: dict, x, cd=torch.bfloat16):
    from .quant import folded_resnet50_forward

    return folded_resnet50_forward(entry["tree"], x, cd, pallas_stem=entry.get("pallas_stem"),
                                   pallas_stages=entry.get("pallas_stages"))


def _bf16_batches(rng, n: int, shape, lo: float, hi: float, device) -> list:
    return [torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(device,
                                                                               torch.bfloat16)
            for _ in range(n)]


def tower_setup(batch: int, args, rng) -> dict:
    """The crops ring, the tower, its bf16 folded entry (with the kernels
    at img 224) and its int8 tree."""
    from .quant import quantize_resnet_from_variables

    dev, S = torch.device(args.device), args.img_size
    clock = Clock(dev, args.window, args.reps)
    n_ring = ring_size(batch * S * S * 3 * 2) if clock.cuda else 2
    crops = _bf16_batches(rng, n_ring, (batch, S, S, 3), -2.0, 2.0, dev)
    tower = seeded_tower(dev)
    kernels = S == 224
    entry = folded_entry(tower, torch.bfloat16, kernels)
    q = quantize_resnet_from_variables(tower, [crops[0][:8].float()])
    rel = None
    if kernels:
        a = bf16_tower(entry, crops[0]).float()
        b = bf16_tower({"tree": entry["tree"]}, crops[0]).float()
        rel = float((a - b).norm() / b.norm())
    return {"clock": clock, "crops": crops, "n_ring": n_ring, "entry": entry, "q": q,
            "tower_bf16": "folded_bf16" + ("_stem_s1234" if kernels else ""),
            "tower_bf16_vs_cudnn_rel_l2": rel}


def _read(fns: dict, setup: dict) -> tuple[dict, dict]:
    clock, n_ring = setup["clock"], setup["n_ring"]
    readings, launches = {}, {}
    for name, fn in fns.items():
        launches[name] = launches_of(lambda: fn(0))[1]
        readings[name] = clock.reading(fn, n_ring)
    return readings, launches


def _setting(args, setup: dict, batch: int) -> dict:
    return {"batch": batch, **setting(args), "ring": setup["n_ring"],
            "tower_bf16": setup["tower_bf16"],
            "tower_bf16_vs_cudnn_rel_l2": setup["tower_bf16_vs_cudnn_rel_l2"]}


# ------------------------------------------------------------------ tools

def int8_split(batch: int, args) -> dict:
    """scripts/profile_int8_stages.py at `batch` (module docstring)."""
    from ..convert import init_yolo_weights
    from ..models.yolo.model import YoloConfig, YoloV8
    from ..models.yolo.quant import quantize_yolo_from_variables, yolo_int8_model
    from .quant import int8_resnet50_forward

    bf16 = torch.bfloat16
    rng = np.random.default_rng(SEED)
    with torch.inference_mode():
        st = tower_setup(batch, args, rng)
        crops, entry, q = st["crops"], st["entry"], st["q"]
        dev, hw = torch.device(args.device), tuple(args.frame_hw)
        n_frames = ring_size(batch * hw[0] * hw[1] * 3 * 2) if st["clock"].cuda else 2
        frames = _bf16_batches(rng, min(n_frames, st["n_ring"]), (batch, *hw, 3), 0.0, 1.0, dev)
        ycfg = YoloConfig(dtype=bf16)
        yolo = YoloV8(ycfg)
        yolo.load_state_dict(init_yolo_weights(YoloConfig(), SEED + 1), strict=True)
        yolo = yolo.to(dev, memory_format=torch.channels_last).eval()
        yolo_q = yolo_int8_model(quantize_yolo_from_variables(yolo, [frames[0][:4].float()]),
                                 ycfg, bf16)
        nf = len(frames)
        fns = {
            "tower_bf16": lambda i: bf16_tower(entry, crops[i]),
            "tower_int8": lambda i: int8_resnet50_forward(q, crops[i], bf16),
            "act_quantize": lambda i: torch.round(crops[i].float() * 8.0).clamp(
                -127, 127).to(torch.int8),
            "yolo_bf16": lambda i: yolo(frames[i % nf]),
            "yolo_int8": lambda i: yolo_q(frames[i % nf]),
        }
        readings, launches = _read(fns, st)
    return {"tool": "int8_split", **{f"{k}_ms": r["ms"] for k, r in readings.items()},
            **_setting(args, st, batch), "readings": readings, "kernel_launches": launches}


def int8_variants(batch: int, args) -> dict:
    """scripts/probe_int8_variants.py at `batch`, E included (module
    docstring)."""
    from .quant import int8_resnet50_forward

    bf16, f32 = torch.bfloat16, torch.float32
    rng = np.random.default_rng(SEED)
    with torch.inference_mode():
        st = tower_setup(batch, args, rng)
        crops, entry, q = st["crops"], st["entry"], st["q"]
        fns = {
            "bf16": lambda i: bf16_tower(entry, crops[i]),
            "A_int8_f32epi": lambda i: int8_resnet50_forward(q, crops[i], bf16),
            "C_int8_bf16epi": lambda i: int8_float_resident(q, crops[i], bf16),
            "B_int8_resident": lambda i: int8_resident(q, crops[i], f32),
            "E_int8_resident_bf16epi": lambda i: int8_resident(q, crops[i], bf16),
        }
        for k in range(1, 5):
            fns[f"D_int8_prefix_stage{k}"] = (
                lambda i, k=k: int8_resident(q, crops[i], bf16, upto=k).to(bf16))
            fns[f"D_bf16_prefix_stage{k}"] = lambda i, k=k: folded_prefix(entry, crops[i], k, bf16)
        a_out = int8_resnet50_forward(q, crops[0], f32)
        b_out = int8_resident(q, crops[0], f32)
        drift = float((a_out - b_out).abs().max() / (a_out.abs().max() + 1e-9))
        d_equal = torch.equal(fns["D_int8_prefix_stage4"](0), fns["A_int8_f32epi"](0))
        if not d_equal:
            raise RuntimeError("int8_variants: D's last prefix differs from "
                               "int8_resnet50_forward")
        readings, launches = _read(fns, st)
    out = {"tool": "int8_variants", **{f"{k}_ms": r["ms"] for k, r in readings.items()},
           "B_vs_A_rel_drift": drift, "D_last_prefix_equals_A": d_equal}
    for tag in ("int8", "bf16"):
        prev, prev_card = 0.0, 0.0
        for k in range(1, 5):
            r = readings[f"D_{tag}_prefix_stage{k}"]
            out[f"D_{tag}_stage{k}_delta_ms"], prev = r["ms"] - prev, r["ms"]
            card = r["card_ms"]
            out[f"D_{tag}_stage{k}_card_delta_ms"] = None if card is None else card - prev_card
            prev_card = card or 0.0
    return {**out, **_setting(args, st, batch), "readings": readings,
            "kernel_launches": launches}
