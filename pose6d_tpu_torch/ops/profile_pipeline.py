"""The request trace: serving requests split into their stages on the card
(counterpart of scripts/profile_pipeline.py, profile_pipeline_prefix.py and
profile_rgbd_stages.py, as one tool), with the sweeps and the int8 and
train profilers as further runs of it. It records; it changes nothing.

    python -m pose6d_tpu_torch.ops.profile_pipeline [--runs ROW@BATCH ...]
        [--trace-dir DIR] [--eval-batch] [--device cuda]
        [--sweep rgb|rgbd [--sweep-batches B ...]]
        [--int8-split BATCH ...] [--int8-variants BATCH ...]
        [--nomodel BATCH] [--train-split VARIANT@BATCH]
        [--train-step VARIANT@BATCH] [--train-frames N]

Without any of --sweep, --int8-*, --nomodel and --train-*, and without
--runs, the tool runs DEFAULT_RUNS. The other flags are ops/profile_sweep.py
(scripts/bench_sweep.py, bench_sweep_rgbd.py), ops/profile_int8.py
(profile_int8_stages.py, probe_int8_variants.py) and ops/profile_train.py
(profile_nomodel.py, profile_train_stages.py, profile_train_step.py): their
docstrings state their JSON lines.

Set-up, bench.py's (bench.py:29-68): YOLOv8n (YoloConfig's defaults:
width 0.25, depth 1/3, 13 classes) in bf16, conf_thresh 0, nms_pre_topk 32
for rgbd and 64 otherwise, compute bf16, seeded weights, uint8 frames and
metric depth (0.2-1.5 m) drawn by numpy, LineMOD's K, PoseNetConfig's
dtype bf16. The rows (ROWS):
  rgb                    bench.py's headline row: the float pipeline, its
                         towers in bf16 (PoseNetConfig.dtype), their f32
                         weights cast at every call as flax casts them;
  rgb_f32                the same pipeline and weights with f32 towers
                         (PR 17's rgb row);
  rgbd                   bench.py's flagship row: the float rgbd pipeline,
                         bf16 towers, the weights of rgbd_folded;
  rgbd_folded            BN-folded bf16 towers, stem and layer1 kernels;
  rgbd_geometric_folded  BN-folded bf16 tower, stem and stage 1-4 kernels;
  rgb_maxobj4            rgb with 4 poses per frame (towers at 4x the
                         batch), folded bf16 with the stem and layer1
                         kernels;
  rgbd_int8              quantize_backbones(frames, K,
                         include_detector=True) over the folded towers:
                         int8 towers and detector.
The kernels need img 224; at another --img-size the folded rows fold
without them. Each JSON line's "name" says what ran. Default runs: every
row at batch 8 (PERF.md §2's metric), and rgbd and rgbd_folded at 128
(bench_e2e's batch).

For each run:
  1. stages alone, after profile_rgbd_stages.py: the uint8 -> compute
     dtype / 255 conversion, the detector (letterbox and YOLOv8n), decode +
     NMS, the RGB crop, the depth crop, the PoseNet forward, the rgb tower
     with its heads (the other tower's features given) and the depth tower
     alone, each launched alone on inputs the request itself made;
  2. prefixes of one request, after profile_pipeline_prefix.py: the
     request as the pipeline's own methods in order (request_steps:
     _to_compute, _letterbox + _detector, _decode + _frame_boxes,
     _pose_boxes + _crop, eval_preprocess, _pose_inputs, pose_forward,
     _outputs), timed as cumulative prefixes, then PosePipeline.__call__;
     the full prefix's outputs must equal __call__'s bit for bit;
  3. host against card, for every stage, prefix and the request: "ms",
     CUDA events around a window of back-to-back launches over its count
     (warm-up left out), what a stream of such launches costs each;
     "host_enqueue_ms", the host's perf_counter around one launch after a
     synchronize, with no sync (what the host needs to enqueue it);
     "card_ms", CUDA events around one replay of the launch captured as a
     CUDA graph, the card's work alone (a spin ahead of the launch cannot
     hold a request: past ~1,000 queued launches the host waits for room
     in the card's launch queue); "idle_share", 1 - card_ms / ms: the
     card's idle share in a stream of such launches (0 where card_ms >=
     ms); Clock.busy_ms reads the card's time where a graph cannot hold a
     launch (the train profilers). The host's enqueue time includes its
     waits for room in the launch queue where the card is the slower.
     Each request runs once under torch.cuda.set_sync_debug_mode("error"):
     no stage waits for the card;
  4. FLOPs: each stage's FLOPs per frame from the port's own modules and
     shapes (convolution and matrix-product MACs x 2, counted as
     torch.utils.flop_counter counts them, by a dispatch mode over meta
     copies of YoloV8 and PoseNet; the
     crops as crop_resize_matmul's two einsums, channels x 2 x (H W S +
     S H S) per crop), and its share of
     the card's dense bf16 peak, PEAK_FLOPS (989 TFLOP/s), the peak PERF.md
     §6 uses, for every row, int8 included;
  5. --trace-dir DIR: a torch.profiler Chrome trace of one request per run,
     DIR/<row>_b<batch>.json, each step of request_steps in its own
     record_function range ("stage:<name>"); that request synchronizes at
     the end of each range, so that every device operation falls inside its
     stage's range, and the top device operations by time per stage are
     reported under the names the trace gives (on the CPU: the ops each
     range calls);
  6. --eval-batch: one batch of cli/eval_e2e.py split into its PNG decodes
     (_load_frames), the ground truth (_gt_arrays, _gt_quat's
     quaternions), the request and the metrics with their reads from the
     card (_score_batch), on a seeded tree (data/seeded_tree.py, 2 folders
     x 40 frames, its val split: 8 frames) served as eval_e2e
     --folded-backbone --folded-stem --folded-stages 1,2,3,4 serves
     rgbd_geometric (its detector f32 with one class per folder, conf 0.25).

Ring: every timed launch reads the next batch of a ring of batches (on
the card enough uint8 frame batches to exceed 2x its 50 MB L2, at most 16;
on the CPU 2), each with the inputs the request makes from it, so that a
stage's source is not in L2, as chip_smoke's phase 3 times the gather.

Devices: the tool runs on the card; with no card it exits 2 unless
--device cpu is given. It never falls back to the CPU and catches no
failure: a failing run fails the tool. On the CPU there is no card: "ms"
and "host_enqueue_ms" are the host clock, card_ms, idle_share and
peak_share are null.

Output: one JSON line per run on stdout,
  {"row": str, "name": str (what ran), "batch": int, "pose_batch": int,
   "device": str, "clock": "cuda_events" | "host", "tf32": {"cudnn":
   bool, "matmul": bool}, "frame_hw": [H, W], "img_size": int, "ring":
   int, "window": int,
   "stages": {stage: {"ms", "host_enqueue_ms", "card_ms", "idle_share",
              "gflop_per_frame", "peak_share"}},
   "sum_isolated_ms": float (convert + detector + decode_nms + rgb_crop
                      [+ depth_crop] + posenet),
   "prefixes": [{"name": "convert" | "+detector" | ... | "__call__", "ms",
                 "delta_ms", "host_enqueue_ms", "card_ms",
                 "card_delta_ms"}, ...],
   "request": {"ms", "host_enqueue_ms", "card_ms", "idle_share",
               "gflop_per_frame", "peak_share"},
   "overhead_ms": float (request ms - sum_isolated_ms),
   "sum_isolated_card_ms", "card_overhead_ms": the same on the card's
                      time (null on the CPU),
   "full_prefix_equals_call": true, "sync_free": true | null (CPU),
   "kernel_launches": {wrapper count key: launches per request},
   "top_ops": {stage: [[name, ms, count], ...]}, "hand_kernels": {stage:
   {csrc kernel name: launches}}, "trace": path | null}
and with --eval-batch one more line,
  {"eval_batch": {"frames": int, "device", "clock", "decode_ms",
   "ground_truth_ms", "request_enqueue_ms", "request_ms" (to the card's
   completion, host clock), "request_card_ms", "metrics_ms", "total_ms",
   "addmin_launches"}}.
Times are milliseconds, medians where repeated.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import sys
import time

import numpy as np
import torch

SEED = 0
PEAK_FLOPS = 989e12   # H100 SXM dense bf16, the peak PERF.md §6 uses
L2_BYTES = 50e6
ROWS = ("rgb", "rgb_f32", "rgbd", "rgbd_folded", "rgbd_geometric_folded", "rgb_maxobj4",
        "rgbd_int8")
DEFAULT_RUNS = ("rgb@8", "rgb_f32@8", "rgbd@8", "rgbd_folded@8", "rgbd_geometric_folded@8",
                "rgb_maxobj4@8", "rgbd_int8@8", "rgbd@128", "rgbd_folded@128")
SUMMED = ("convert", "detector", "decode_nms", "rgb_crop", "depth_crop", "posenet")
# the hand-written kernels' names (csrc/*.cu), as a trace gives them
# (demangled "void stem_tc_kernel<3>(...)" or mangled "_Z14stem_tc_kernelILi3E...")
HAND_KERNELS = re.compile(r"(?<![A-Za-z_])(stem_tc_kernel|stem_kernel|wgmma_gemm_kernel|"
                          r"gemm_kernel|addmin_kernel|gather_rows_kernel)(?=[<(I]|$)")
EVAL_OBJECTS = {1: (40.0, 800), 10: (55.0, 700)}
EVAL_FRAMES = 40      # frames per folder of the eval tree: 4 of each in its val split


@dataclasses.dataclass(frozen=True)
class Row:
    variant: str
    seed: int              # the pose weights' seed, SEED + 2 + seed
    max_objects: int = 1
    fold: tuple = ()       # the kernels at img 224: "stem", "layer1", stages 1-4
    int8: bool = False
    towers: torch.dtype = torch.bfloat16  # the float towers' dtype (unfolded rows)


ROW_SPECS = {
    "rgb": Row("rgb", 0),
    "rgb_f32": Row("rgb", 0, towers=torch.float32),
    "rgbd": Row("rgbd", 1),
    "rgbd_folded": Row("rgbd", 1, fold=("stem", "layer1")),
    "rgbd_geometric_folded": Row("rgbd_geometric", 2, fold=("stem", 1, 2, 3, 4)),
    "rgb_maxobj4": Row("rgb", 3, max_objects=4, fold=("stem", "layer1")),
    "rgbd_int8": Row("rgbd", 4, fold=("stem", "layer1"), int8=True),
}


# ------------------------------------------------------------------ set-up

def build_pipeline(row: str, img_size: int, det_size: int, device, calib=None,
                   nms_pre_topk: int | None = None):
    """The row's PosePipeline with seeded weights, folded / quantized as the
    row says (calib: (frames, K) numpy, the int8 calibration batch;
    nms_pre_topk: in place of the row's). Returns (pipeline, name: what
    ran)."""
    from ..infer.pipeline import PipelineConfig, PosePipeline
    from ..models.posenet import PoseNetConfig
    from ..models.yolo.model import YoloConfig

    spec = ROW_SPECS[row]
    pose_cfg = PoseNetConfig(variant=spec.variant, img_size=img_size, dtype=spec.towers)
    yolo_state, pose_state = _seeded_weights(spec.variant, img_size, SEED + 2 + spec.seed)
    cfg = PipelineConfig(variant=spec.variant, img_size=img_size, det_size=det_size,
                         conf_thresh=0.0, compute_dtype=torch.bfloat16,
                         max_objects=spec.max_objects,
                         nms_pre_topk=nms_pre_topk or (32 if spec.variant == "rgbd" else 64))
    pipe = PosePipeline(cfg, YoloConfig(dtype=torch.bfloat16), yolo_state, pose_state, pose_cfg,
                        device=device)
    if not spec.fold:
        return pipe, f"{spec.variant}_{_DTYPE_TAGS[spec.towers]}_towers"
    kernels = spec.fold if img_size == 224 else ()
    stages = tuple(k for k in kernels if isinstance(k, int))
    pipe.fold_backbones(pallas_stem="stem" in kernels, pallas_layer1="layer1" in kernels,
                        pallas_stages=stages)
    if spec.int8:
        pipe.quantize_backbones(*calib, include_detector=True)
        return pipe, f"{spec.variant}_int8_towers_detector"
    tags = [k for k in kernels if isinstance(k, str)] + (
        ["s" + "".join(map(str, stages))] if stages else [])
    return pipe, "_".join([row.removesuffix("_folded"), "folded_bf16", *tags])


_DTYPE_TAGS = {torch.bfloat16: "bf16", torch.float32: "f32"}


@functools.lru_cache(maxsize=2)
def _seeded_weights(variant: str, img_size: int, pose_seed: int) -> tuple:
    """The detector's (seed SEED + 1) and the pose net's seeded state_dicts,
    made once for the arms of a sweep (a pipeline copies them)."""
    from ..convert import init_posenet_weights, init_yolo_weights
    from ..models.posenet import PoseNetConfig
    from ..models.yolo.model import YoloConfig

    return init_yolo_weights(YoloConfig(), SEED + 1), init_posenet_weights(
        PoseNetConfig(variant=variant, img_size=img_size), pose_seed)


def ring_size(batch_bytes: int) -> int:
    """Batches in a ring whose inputs of batch_bytes each exceed 2x L2 (2
    to 16)."""
    return int(min(16, max(2, math.ceil(2 * L2_BYTES / batch_bytes))))


def launches_of(fn) -> tuple:
    """(fn(), the kernel launches it made: {launch-count key: n})."""
    from .. import _build

    before = dict(_build.launch_counts)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in _build.launch_counts.items()
                 if v != before.get(k, 0)}


def make_ring(pipe, batch: int, hw, n: int, rng) -> list:
    """n request states {"frames", "K", "depth"} on the pipeline's device."""
    from ..data.seeded_tree import LINEMOD_K

    dev = pipe.device
    depth_variant = pipe.cfg.variant in ("rgbd", "rgbd_geometric")
    ring = []
    for _ in range(n):
        frames = rng.integers(0, 256, (batch, *hw, 3), dtype=np.uint8)
        depth = rng.uniform(0.2, 1.5, (batch, *hw)).astype(np.float32)
        ring.append({"frames": torch.from_numpy(frames).to(dev),
                     "K": torch.from_numpy(LINEMOD_K).to(dev).expand(batch, 3, 3),
                     "depth": torch.from_numpy(depth).to(dev) if depth_variant else None})
    return ring


# --------------------------------------------------------- the request

def request_steps(pipe) -> list:
    """The request as the pipeline's own methods, in the order _run calls
    them: [(stage, step(state))], each step adding to a state that starts
    as {"frames", "K", "depth"}; after the last, state["out"] is _run's
    output."""
    from .augment import eval_preprocess

    cd = pipe.cfg.compute_dtype

    def convert(s):
        s["fn"] = pipe._to_compute(s["frames"])

    def detector(s):
        s["lb"] = pipe._letterbox(s["fn"])
        s["maps"] = pipe._detector(s["lb"][0], pipe._yolo_int8)

    def decode_nms(s):
        s["dets"] = pipe._decode(s["maps"], s["lb"][4])
        s["all_bbox"] = pipe._frame_boxes(s["dets"]["boxes"], *s["lb"][1:4])

    def crop(s):
        s["bbox"], s["params"] = pipe._pose_boxes(s["all_bbox"])
        s["crops"] = pipe._crop(s["fn"], s["params"], cd)

    def normalize(s):
        s["rgb"] = eval_preprocess(s["crops"]).to(cd)

    def pose_inputs(s):
        s["inputs"], s["center"] = pipe._pose_inputs(s["rgb"], s["bbox"], s["params"], s["K"],
                                                     s["depth"])

    def posenet(s):
        s["rot"], s["trans"] = pipe.pose_forward(s["inputs"])

    def outputs(s):
        st = {"dets": s["dets"], "center": s["center"], "bbox_xywh": s["bbox"]}
        s["out"] = pipe._outputs(s["rot"], s["trans"], st, s["K"])

    depth_variant = pipe.cfg.variant in ("rgbd", "rgbd_geometric")
    return [("convert", convert), ("detector", detector), ("decode_nms", decode_nms),
            ("crop", crop), ("normalize", normalize),
            ("depth_crop" if depth_variant else "pose_inputs", pose_inputs),
            ("posenet", posenet), ("outputs", outputs)]


def run_steps(steps, base: dict, span=None) -> dict:
    s = dict(base)
    for name, step in steps:
        with span(name) if span is not None else contextlib.nullcontext():
            step(s)
    return s


def _tower(pipe, name: str, x):
    """One tower's features as the request computes them: the serving tower
    (folded or int8) or the float module's, in its PoseNetConfig.dtype."""
    from ..models.posenet_serving import backbone_features

    model = pipe.posenet
    if pipe._folded or pipe._quantized:
        return backbone_features(model, name, x, pipe.cfg.compute_dtype,
                                 pipe._folded.get(name), pipe._quantized.get(name))
    return model.tower_features({name: x})[name]


def isolated_stages(pipe, states: list) -> dict:
    """{stage: fn(i)}: each stage of profile_rgbd_stages.py launched alone on
    the inputs that ring batch i's request made (states[i], a full
    run_steps state with the towers' features under "feats")."""
    cfg, model = pipe.cfg, pipe.posenet
    cd = cfg.compute_dtype
    stages = {
        "convert": lambda i: pipe._to_compute(states[i]["frames"]),
        "detector": lambda i: pipe._detector(pipe._letterbox(states[i]["fn"])[0],
                                             pipe._yolo_int8),
        "decode_nms": lambda i: pipe._decode(states[i]["maps"], states[i]["lb"][4]),
        "rgb_crop": lambda i: pipe._crop(states[i]["fn"], states[i]["params"], cd),
    }
    if cfg.variant in ("rgbd", "rgbd_geometric"):
        ddt = cd if cfg.variant == "rgbd" and cfg.depth_crop_bf16 else torch.float32
        stages["depth_crop"] = lambda i: pipe._crop(states[i]["depth"][..., None],
                                                    states[i]["params"], ddt)
    stages["posenet"] = lambda i: pipe.pose_forward(states[i]["inputs"])
    rgb_name = model.towers[0]

    def rgb_tower_heads(i):
        inp = states[i]["inputs"]
        feats = dict(states[i]["feats"], **{rgb_name: _tower(pipe, rgb_name, inp["rgb"])})
        return model.heads(feats, inp["rgb"], inp.get("depth_raw"), inp.get("bbox_center"),
                           inp.get("camera_matrix"))

    stages["rgb_tower_heads"] = rgb_tower_heads
    if "depth_backbone" in model.towers:
        stages["depth_tower"] = lambda i: _tower(pipe, "depth_backbone",
                                                 states[i]["inputs"]["depth"])
    return stages


# ------------------------------------------------------------------ FLOPs

def counted_flops(fn, *args, **kwargs) -> int:
    """The FLOPs of fn(*args, **kwargs): 2 x the multiply-adds of every
    convolution and matrix product it dispatches (aten.convolution, mm,
    addmm, bmm), counted from their shapes (on meta tensors nothing runs),
    as torch.utils.flop_counter counts them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    total = 0

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            nonlocal total
            out = func(*args, **(kwargs or {}))
            op = func.overloadpacket
            if op is aten.convolution:
                w = args[1]
                total += 2 * out.numel() * math.prod(w.shape[1:])
            elif op in (aten.mm, aten.addmm, aten.bmm):
                a = args[1] if op is aten.addmm else args[0]
                total += 2 * out.numel() * a.shape[-1]
            return out

    with Count():
        fn(*args, **kwargs)
    return total


@contextlib.contextmanager
def _meta():
    """Meta modules and tensors, out of inference mode (a dispatch mode sees
    no op under it) and without autograd."""
    with torch.inference_mode(False), torch.no_grad(), torch.device("meta"):
        yield


def detector_flops(yolo_cfg, canvas_hw) -> int:
    """FLOPs of one frame through YoloV8 on its canvas."""
    from ..models.yolo.model import YoloV8

    with _meta():
        return counted_flops(YoloV8(yolo_cfg).eval(), torch.empty(1, *canvas_hw, 3))


def tower_flops(in_channels: int, img: int) -> int:
    """FLOPs of one crop through a ResNet50 tower."""
    from ..models.resnet import ResNet50

    with _meta():
        return counted_flops(ResNet50(in_channels=in_channels).eval(),
                             torch.empty(1, img, img, in_channels))


def posenet_flops(pose_cfg) -> dict:
    """{tower name: FLOPs, "heads": FLOPs} of one crop through PoseNet."""
    from ..models.posenet import PoseNet

    S = pose_cfg.img_size
    with _meta():
        net = PoseNet(pose_cfg).eval()
        out = {name: counted_flops(getattr(net, name),
                                   torch.empty(1, S, S, 1 if name == "depth_backbone" else 3))
               for name in net.towers}
        out["heads"] = counted_flops(net.heads, {name: torch.empty(1, 2048) for name in net.towers},
                                     torch.empty(1, S, S, 3), torch.empty(1, S, S),
                                     torch.empty(1, 2), torch.empty(1, 3, 3))
    return out


def crop_flops(channels: int, src_hw, img: int) -> int:
    """crop_resize_matmul's two einsums on one crop: columns ([S, W] over
    the frame's W) then rows ([S, H] over its H)."""
    H, W = src_hw
    return 2 * channels * (H * W * img + img * H * img)


def stage_flops(pipe, frame_hw) -> dict:
    """FLOPs per frame of each stage of isolated_stages and of the request."""
    cfg = pipe.cfg
    M, S = cfg.max_objects, cfg.img_size
    canvas_hw = tuple(pipe._letterbox(torch.empty(1, *frame_hw, 3, device="meta"))[4])
    src = frame_hw if cfg.crop_window is None else (cfg.crop_window, cfg.crop_window)
    net = posenet_flops(pipe.pose_cfg)
    rgb_name = pipe.posenet.towers[0]
    out = {"convert": 0, "detector": detector_flops(pipe.yolo_cfg, canvas_hw), "decode_nms": 0,
           "rgb_crop": M * crop_flops(3, src, S),
           "posenet": M * sum(net.values()),
           "rgb_tower_heads": M * (net[rgb_name] + net["heads"])}
    if cfg.variant in ("rgbd", "rgbd_geometric"):
        out["depth_crop"] = M * crop_flops(1, src, S)
    if "depth_backbone" in net:
        out["depth_tower"] = M * net["depth_backbone"]
    out["request"] = sum(out[k] for k in SUMMED if k in out)
    return out


# ----------------------------------------------------------------- timing

def union_ns(spans) -> int:
    """The length of the union of (start, end) intervals sorted by start:
    the time in which at least one of them runs."""
    total, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


class Clock:
    """Times a launch fn(i) (i: the ring index) on the card by CUDA events,
    or on the CPU by the host clock."""

    def __init__(self, device, window: int, reps: int):
        self.cuda = torch.device(device).type == "cuda"
        self.window, self.reps = window, reps

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def window_ms(self, fn, n_ring: int) -> float:
        """A window of back-to-back launches over its count, warm-up (the
        card's lazy handles and workspaces) left out."""
        if self.cuda:
            for i in range(min(3, n_ring)):
                fn(i)
            self.sync()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for k in range(self.window):
                fn(k % n_ring)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / self.window
        t0 = time.perf_counter()
        for k in range(self.window):
            fn(k % n_ring)
        return (time.perf_counter() - t0) * 1e3 / self.window

    def host_ms(self, fn, n_ring: int) -> float:
        """The host's time to enqueue one launch, after a synchronize, with
        no sync."""
        times = []
        for k in range(self.reps):
            self.sync()
            t0 = time.perf_counter()
            fn(k % n_ring)
            times.append((time.perf_counter() - t0) * 1e3)
        self.sync()
        return statistics.median(times)

    def card_ms(self, fn, n_ring: int) -> float | None:
        """The card's time for one launch with the host out of the way: the
        launch captured as a CUDA graph on ring batch k, then one replay of
        it between CUDA events (a replay is one launch from the host, so
        neither the host's pace nor the depth of the card's launch queue
        enters); the median over reps ring batches. None on the CPU."""
        if not self.cuda:
            return None
        times = []
        for k in range(self.reps):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # lazy handles and workspaces off the capture
                fn(k % n_ring)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn(k % n_ring)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            del graph
        return statistics.median(times)

    def busy_ms(self, fn, n_ring: int) -> float | None:
        """The card's busy time for one launch, for launches that a CUDA
        graph cannot hold (random draws from a generator of their own, a
        train step's optimizer): a window of launches under torch.profiler,
        the union of the intervals of the device operations (kernels,
        copies, sets; user ranges left out) that start inside the window's
        range, over the window's count. The session first runs one launch,
        waits for the card and pauses 20 ms: in a process that has profiled
        before, a session's first device operations can go unrecorded (a
        window of three 0.04 ms launches read none, one of 1 ms launches
        half). A window with no device operation recorded is profiled
        again, up to three times. None on the CPU or where none is."""
        if not self.cuda:
            return None
        from torch.profiler import ProfilerActivity, profile, record_function

        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn(0)
                self.sync()
                time.sleep(0.02)
                with record_function("busy_window"):
                    for k in range(self.window):
                        fn(k % n_ring)
                    self.sync()
            events = _events(prof)
            t0 = min(start for name, is_cuda, start, _, _ in events
                     if name == "busy_window" and not is_cuda)
            spans = sorted((start, start + dur) for _, is_cuda, start, dur, user in events
                           if is_cuda and not user and start >= t0)
            if spans:
                break
        return union_ns(spans) / 1e6 / self.window if spans else None

    def reading(self, fn, n_ring: int, card: str = "graph", before=None) -> dict:
        """host_enqueue_ms, ms (the window) and card_ms (card "graph":
        card_ms, "busy": busy_ms) of fn, and the card's idle share;
        before(), where given, runs ahead of each of the three."""
        before = before or (lambda: None)
        before()
        host = self.host_ms(fn, n_ring)
        before()
        ms = self.window_ms(fn, n_ring)
        before()
        card_ms = (self.card_ms if card == "graph" else self.busy_ms)(fn, n_ring)
        return {"ms": ms, "host_enqueue_ms": host, "card_ms": card_ms,
                "idle_share": None if card_ms is None else max(0.0, 1.0 - card_ms / ms)}


def setting(args) -> dict:
    """What every profiler line states of its run: the device, its clock,
    cuDNN's and matmul's TF32 (f32 convolutions and matrix products on the
    card take TF32 where it is on), the frame and crop sizes, the window."""
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    return {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "clock": "cuda_events" if cuda else "host",
            "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                     "matmul": torch.backends.cuda.matmul.allow_tf32},
            "frame_hw": list(args.frame_hw), "img_size": args.img_size, "window": args.window}


def _with_flops(reading: dict, flops_per_frame: int, batch: int, cuda: bool) -> dict:
    share = (flops_per_frame * batch / (reading["ms"] / 1e3) / PEAK_FLOPS) if cuda else None
    return {**reading, "gflop_per_frame": flops_per_frame / 1e9, "peak_share": share}


# ------------------------------------------------------------------ trace

def _outputs_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_outputs_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _events(prof):
    """(name, device is CUDA, start ns, duration ns, is a user range) of
    each kineto event."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        user = e.is_user_annotation() if hasattr(e, "is_user_annotation") else False
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start, dur, user))
    return out


def traced_request(pipe, steps, base: dict, clock: Clock, path: str | None, top: int = 5):
    """One request under torch.profiler, each step in its own
    record_function range and synchronized at its end. Writes the Chrome
    trace to path (when given); returns ({stage: [[op, ms, count], ...]}:
    the top device operations by time in each stage's range on the card,
    the ops each range calls on the CPU; {stage: {hand-written kernel:
    launches}}: the csrc kernels (HAND_KERNELS) among them)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if clock.cuda else [])

    @contextlib.contextmanager
    def span(name):
        with record_function(f"stage:{name}"):
            yield
            clock.sync()

    with profile(activities=acts) as prof:
        run_steps(steps, base, span)
    if path is not None:
        prof.export_chrome_trace(path)
    if clock.cuda:
        events = _events(prof)
        ranges = {name[6:]: (start, start + dur) for name, is_cuda, start, dur, _ in events
                  if name.startswith("stage:") and not is_cuda}
        per = {stage: {} for stage in ranges}
        for name, is_cuda, start, dur, _ in events:
            if not is_cuda or name.startswith("stage:"):  # the ranges' device copies
                continue
            for stage, (a, b) in ranges.items():
                if a <= start <= b:
                    ms, n = per[stage].get(name, (0.0, 0))
                    per[stage][name] = (ms + dur / 1e6, n + 1)
    else:
        per = {}
        for e in prof.events():
            if e.name.startswith("stage:"):
                agg = per.setdefault(e.name[6:], {})
                for c in e.cpu_children:
                    ms, n = agg.get(c.name, (0.0, 0))
                    agg[c.name] = (ms + c.cpu_time_total / 1e3, n + 1)
    top_ops = {stage: [[op[:160], ms, n] for op, (ms, n) in
                       sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]]
               for stage, ops in per.items()}
    hand = {}
    for stage, ops in per.items():
        for op, (_, n) in ops.items():
            m = HAND_KERNELS.search(op)
            if m:
                hand.setdefault(stage, {})
                hand[stage][m.group(1)] = hand[stage].get(m.group(1), 0) + n
    return top_ops, hand


# -------------------------------------------------------------------- run

def profile_run(row: str, batch: int, args, rng) -> dict:
    """Set up, split and trace one run; returns its JSON line's dict."""
    from ..data.seeded_tree import LINEMOD_K

    dev = torch.device(args.device)
    hw = tuple(args.frame_hw)
    clock = Clock(dev, args.window, args.reps)
    # the CPU has no card's L2 to miss: two batches keep its inputs distinct
    n_ring = ring_size(batch * hw[0] * hw[1] * 3) if clock.cuda else 2
    frames0 = rng.integers(0, 256, (batch, *hw, 3), dtype=np.uint8)

    with torch.inference_mode():
        pipe, name = build_pipeline(row, args.img_size, args.det_size, dev,
                                    calib=(frames0, LINEMOD_K))
        ring = make_ring(pipe, batch, hw, n_ring, rng)
        steps = request_steps(pipe)
        states = []
        for base in ring:
            s = run_steps(steps, base)
            s["feats"] = {n: _tower(pipe, n, x) for n, x in
                          pipe.posenet.tower_inputs(s["inputs"]["rgb"],
                                                    s["inputs"].get("depth")).items()}
            states.append(s)
        call = lambda i: pipe(ring[i]["frames"], ring[i]["K"], ring[i]["depth"])  # noqa: E731
        equal = all(_outputs_equal(states[i]["out"], call(i)) for i in range(n_ring))
        if not equal:
            raise RuntimeError(f"{row}@{batch}: the full prefix's outputs differ from "
                               f"PosePipeline.__call__'s")
        sync_free = None
        if clock.cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                run_steps(steps, ring[0])
                call(0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            sync_free = True
        flops = stage_flops(pipe, hw)
        pose_batch = batch * pipe.cfg.max_objects

        stage_fns = isolated_stages(pipe, states)
        stages = {k: _with_flops(clock.reading(fn, n_ring), flops[k], batch, clock.cuda)
                  for k, fn in stage_fns.items()}
        prefixes, prev, prev_card = [], 0.0, 0.0
        for k in range(1, len(steps) + 1):
            r = clock.reading(lambda i, k=k: run_steps(steps[:k], ring[i]), n_ring)
            prefixes.append({"name": steps[0][0] if k == 1 else f"+{steps[k - 1][0]}", **r})
        request = clock.reading(call, n_ring)
        prefixes.append({"name": "__call__", **request})
        for p in prefixes:
            p["delta_ms"], prev = p["ms"] - prev, p["ms"]
            card = p["card_ms"]
            p["card_delta_ms"] = None if card is None else card - prev_card
            prev_card = card or 0.0
        summed = sum(stages[k]["ms"] for k in SUMMED if k in stages)
        summed_card = (sum(stages[k]["card_ms"] for k in SUMMED if k in stages)
                       if clock.cuda else None)

        _, launches = launches_of(lambda: call(0))
        path = None
        if args.trace_dir:
            os.makedirs(args.trace_dir, exist_ok=True)
            path = os.path.join(args.trace_dir, f"{row}_b{batch}.json")
        top, hand = traced_request(pipe, steps, ring[0], clock, path)
    return {
        "row": row, "name": name, "batch": batch, "pose_batch": pose_batch, **setting(args),
        "ring": n_ring,
        "stages": stages, "sum_isolated_ms": summed, "prefixes": prefixes,
        "request": _with_flops(request, flops["request"], batch, clock.cuda),
        "overhead_ms": request["ms"] - summed, "sum_isolated_card_ms": summed_card,
        "card_overhead_ms": None if summed_card is None else request["card_ms"] - summed_card,
        "full_prefix_equals_call": equal, "sync_free": sync_free,
        "kernel_launches": launches, "top_ops": top, "hand_kernels": hand, "trace": path,
    }


def eval_batch(args, rng) -> dict:
    """One batch of cli/eval_e2e.py split into decode, ground truth, request
    and metrics (see the module docstring)."""
    from .. import _build
    from ..cli.eval_e2e import _gt_arrays, _load_frames, _score_batch
    from ..convert import init_posenet_weights, init_yolo_weights
    from ..data.linemod import build_index
    from ..data.seeded_tree import write_linemod_tree
    from ..infer.pipeline import PipelineConfig, PosePipeline
    from ..losses.add import ADDEvaluator
    from ..models.posenet import PoseNetConfig
    from ..models.yolo.model import YoloConfig

    dev = torch.device(args.device)
    clock = Clock(dev, args.window, args.reps)
    root = os.path.join(os.path.dirname(_build.LIB_PATH), "profile_eval_tree")
    shutil.rmtree(root, ignore_errors=True)
    try:
        tree = write_linemod_tree(root, rng, EVAL_OBJECTS, EVAL_FRAMES, hw=tuple(args.frame_hw))
        chunk = build_index(tree["data"], "val", require_depth=True)[:8]
        folders = sorted({f"{s.obj_id + 1:02d}" for s in chunk})
        cls_to_objid = {i: int(f) - 1 for i, f in enumerate(folders)}
        S = args.img_size
        pose_cfg = PoseNetConfig(variant="rgbd_geometric", img_size=S)
        ycfg = YoloConfig(num_classes=len(folders))
        pipe = PosePipeline(PipelineConfig(variant="rgbd_geometric", img_size=S,
                                           det_size=args.det_size,
                                           compute_dtype=torch.bfloat16),
                            ycfg, init_yolo_weights(ycfg, SEED + 20),
                            init_posenet_weights(pose_cfg, SEED + 21), pose_cfg, device=dev)
        at_224 = S == 224
        pipe.fold_backbones(pallas_stem=at_224, pallas_stages=(1, 2, 3, 4) if at_224 else ())
        evaluator = ADDEvaluator(tree["models"], device=dev)
        paths = [(s.img_path, s.depth_path) for s in chunk]
        parts = {"decode_ms": [], "ground_truth_ms": [], "request_enqueue_ms": [],
                 "request_ms": [], "metrics_ms": [], "total_ms": []}
        addmin = 0
        with torch.inference_mode():
            for rep in range(args.reps + 1):  # the first is the warm-up
                clock.sync()
                tot = {"add": 0.0, "add_s": 0.0, "acc": 0.0, "n_batches": 0, "detected": 0,
                       "cls_correct": 0, "n": 0}
                t0 = time.perf_counter()
                frames, depths = _load_frames(paths, True)
                t1 = time.perf_counter()
                gt_q, gt_t, gt_ids, K = _gt_arrays(chunk)
                t2 = time.perf_counter()
                out = pipe(frames, K, depths)
                t3 = time.perf_counter()
                clock.sync()
                t4 = time.perf_counter()
                before = _build.launch_counts["pairwise_min_dist"]
                _score_batch(out, evaluator, gt_q, gt_t, gt_ids, cls_to_objid, tot)
                t5 = time.perf_counter()
                addmin = _build.launch_counts["pairwise_min_dist"] - before
                if rep:
                    for k, (a, b) in {"decode_ms": (t0, t1), "ground_truth_ms": (t1, t2),
                                      "request_enqueue_ms": (t2, t3), "request_ms": (t2, t4),
                                      "metrics_ms": (t4, t5), "total_ms": (t0, t5)}.items():
                        parts[k].append((b - a) * 1e3)
            frames_t = torch.from_numpy(frames).to(dev)
            K_t, depth_t = torch.from_numpy(K).to(dev), torch.from_numpy(depths).to(dev)
            call = lambda i: pipe(frames_t, K_t, depth_t)  # noqa: E731
            card = clock.card_ms(call, 1)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"frames": len(chunk), "device": torch.cuda.get_device_name(dev) if clock.cuda
            else "cpu", "clock": "host" if not clock.cuda else "host, request_card_ms by "
            "cuda_events", **{k: statistics.median(v) for k, v in parts.items()},
            "request_card_ms": card, "addmin_launches": addmin}


def parse_runs(runs) -> list:
    out = []
    for r in runs:
        row, _, batch = r.partition("@")
        if row not in ROW_SPECS or not batch.isdigit():
            raise SystemExit(f"profile_pipeline: bad run {r!r}: ROW@BATCH with ROW in {ROWS}")
        out.append((row, int(batch)))
    return out


def parse_variant_batch(text: str, flag: str) -> tuple[str, int]:
    from ..models.posenet import VARIANTS

    variant, _, batch = text.partition("@")
    if variant not in VARIANTS or not batch.isdigit():
        raise SystemExit(f"profile_pipeline: bad {flag} {text!r}: VARIANT@BATCH with VARIANT "
                         f"in {VARIANTS}")
    return variant, int(batch)


def main(argv=None) -> int:
    from .. import DEFAULT_DEVICE
    from . import profile_int8, profile_sweep, profile_train

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--runs", nargs="+", default=None,
                    help="ROW@BATCH runs, ROW in " + ", ".join(ROWS) + "; by default "
                    + " ".join(DEFAULT_RUNS) + " when no other run is asked for")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help=f"the card (default {DEFAULT_DEVICE}); cpu only when asked")
    ap.add_argument("--frame-hw", nargs=2, type=int, default=[480, 640], metavar=("H", "W"))
    ap.add_argument("--img-size", type=int, default=224)
    ap.add_argument("--det-size", type=int, default=640,
                    help="the letterbox side, for frames whose sides do not divide 32")
    ap.add_argument("--window", type=int, default=20, help="launches in a timed window")
    ap.add_argument("--reps", type=int, default=5, help="single launches per reading")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--eval-batch", action="store_true",
                    help="also split one batch of cli/eval_e2e.py")
    ap.add_argument("--sweep", choices=sorted(profile_sweep.SWEEP_ROWS),
                    help="scripts/bench_sweep.py (rgb) or bench_sweep_rgbd.py (rgbd)")
    ap.add_argument("--sweep-batches", nargs="+", type=int, default=None,
                    help="rgb: one batch (default 128); rgbd: default 128 192 256")
    ap.add_argument("--int8-split", nargs="+", type=int, metavar="BATCH",
                    help="scripts/profile_int8_stages.py at each batch (e.g. 128 32)")
    ap.add_argument("--int8-variants", nargs="+", type=int, metavar="BATCH",
                    help="scripts/probe_int8_variants.py, variants A-E, at each batch")
    ap.add_argument("--train-split", metavar="VARIANT@BATCH",
                    help="scripts/profile_train_stages.py (e.g. rgbd@32)")
    ap.add_argument("--train-step", metavar="VARIANT@BATCH",
                    help="scripts/profile_train_step.py, f32 against bf16 (e.g. rgbd@32)")
    ap.add_argument("--nomodel", type=int, metavar="BATCH",
                    help="scripts/profile_nomodel.py: the device preprocess's prefixes")
    ap.add_argument("--train-frames", type=int, default=512,
                    help="resident frames of the train profilers")
    args = ap.parse_args(argv)
    others = (args.sweep, args.int8_split, args.int8_variants, args.train_split,
              args.train_step, args.nomodel)
    runs = parse_runs(args.runs if args.runs is not None else
                      () if any(x is not None for x in others) else DEFAULT_RUNS)
    train_split = args.train_split and parse_variant_batch(args.train_split, "--train-split")
    train_step = args.train_step and parse_variant_batch(args.train_step, "--train-step")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("profile_pipeline: no CUDA card; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    rng = np.random.default_rng(SEED)
    lines = [lambda row=row, batch=batch: profile_run(row, batch, args, rng)
             for row, batch in runs]
    if args.eval_batch:
        lines.append(lambda: {"eval_batch": eval_batch(args, rng)})
    if args.nomodel is not None:
        lines.append(lambda: profile_train.nomodel(args.nomodel, args))
    if train_split:
        lines.append(lambda: profile_train.train_split(*train_split, args))
    if train_step:
        lines.append(lambda: profile_train.train_step(*train_step, args))
    for b in args.int8_split or ():
        lines.append(lambda b=b: profile_int8.int8_split(b, args))
    for b in args.int8_variants or ():
        lines.append(lambda b=b: profile_int8.int8_variants(b, args))
    if args.sweep:
        batches = args.sweep_batches or profile_sweep.SWEEP_BATCHES[args.sweep]
        lines.append(lambda: profile_sweep.sweep(args.sweep, batches, args, rng))
    for line in lines:
        print(json.dumps(line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
