"""The system under test and the traffic that drives it.

build(): the program's PosePipeline, through its public API alone, from a
configuration file and seeded weights (weights.py): PipelineConfig and
YoloConfig from the file's "pipeline" and "detector" groups and the mix's
max_objects, then fold_backbones(**"fold"); with control=True also
quantize_backbones(include_detector=True) on the ring's first batch, the
program's own int8 path for the detector and the towers: the
lower-precision control of the correctness check.

make_ring(): seeded request batches on the card, the request trace's
make_ring with the draws made on the device: uint8 frames, metric depth
uniform on the mix's range, the mix's camera K; enough batches that the
ring exceeds RING_L2_MULTIPLE x the card's L2 (at least RING_MIN, at most
RING_MAX batches), so that no batch's frames are still in L2 when it is
served.

closed_loop(): a client that keeps `in_flight` batches in the card's
queue, the double buffering of a stream server: it hands batch i + 1 to
the pipeline before it waits for batch i. A batch is complete when its
outputs (OUTPUT_KEYS) are on the host; each is copied without a wait into
pinned memory, and the client waits on an event recorded after the copy.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from . import weights

OUTPUT_KEYS = ("rotation", "translation", "bbox_xywh", "det_valid", "det_score", "class_id")
L2_BYTES = 50e6
RING_L2_MULTIPLE, RING_MIN, RING_MAX = 2, 2, 16
WARMUP_BATCHES = 8  # set-up: batches served at the cell's shapes before the window
SETTLE_FRAMES = 16
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def seed_for(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each draw (weights, inputs, sample)."""
    return int(np.random.SeedSequence([seed % 2**63, stream]).generate_state(1, np.uint64)[0]
               % 2**63)


def configs(config: dict, traffic: dict):
    """(PipelineConfig, YoloConfig) of a configuration under a mix."""
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig
    from pose6d_tpu_torch.models.yolo.model import YoloConfig

    pipe = dict(config["pipeline"])
    pipe["compute_dtype"] = DTYPES[pipe["compute_dtype"]]
    det = dict(config["detector"])
    det["dtype"] = DTYPES[det["dtype"]]
    det["strides"] = tuple(det["strides"])
    return (PipelineConfig(**pipe, max_objects=traffic["max_objects"]), YoloConfig(**det))


def state_shapes(config: dict, traffic: dict) -> tuple:
    """The program's state_dict shapes: (detector, pose net)."""
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig
    from pose6d_tpu_torch.models.yolo.model import YoloV8

    pipe_cfg, yolo_cfg = configs(config, traffic)
    return (weights.shapes_of(lambda: YoloV8(yolo_cfg)),
            weights.shapes_of(lambda: PoseNet(PoseNetConfig(variant=pipe_cfg.variant,
                                                            img_size=pipe_cfg.img_size))))


def seeded_weights(config: dict, traffic: dict, seed: int, ring: list) -> tuple:
    """(detector state, pose state): float32 on the ring's device, from the
    seed, the detector's BatchNorm statistics settled on the first
    SETTLE_FRAMES frames of the ring (weights.settle_detector)."""
    yolo_shapes, pose_shapes = state_shapes(config, traffic)
    device = ring[0]["frames"].device
    g = torch.Generator(device=device).manual_seed(seed_for(seed, 1))
    state = (weights.seeded_state(yolo_shapes, g, device),
             weights.seeded_state(pose_shapes, g, device))
    weights.outlier_channels(state[1])
    weights.settle_detector(state[0], torch.cat([e["frames"] for e in ring])[:SETTLE_FRAMES])
    return state


def build(config: dict, traffic: dict, state: tuple, device, ring=None, control=False):
    """The program's pipeline over the seeded state, folded as the
    configuration says; with control, in its int8 mode as well."""
    from pose6d_tpu_torch.infer.pipeline import PosePipeline

    pipe_cfg, yolo_cfg = configs(config, traffic)
    with torch.device(device):  # the modules are made on the card, not the host
        pipe = PosePipeline(pipe_cfg, yolo_cfg, state[0], state[1], device=device)
    fold = dict(config["fold"])
    fold["pallas_stages"] = tuple(fold.get("pallas_stages", ()))
    pipe.fold_backbones(**fold)
    if control:
        first = ring[0]
        pipe.quantize_backbones(first["frames"], first["K"], first["depth"],
                                include_detector=True)
    return pipe


def ring_size(frame_bytes: int) -> int:
    n = math.ceil(RING_L2_MULTIPLE * L2_BYTES / frame_bytes)
    return int(min(RING_MAX, max(RING_MIN, n)))


def make_ring(traffic: dict, seed: int, device, depth: bool = True) -> list:
    """The mix's seeded batches on the card: [{"frames" [B, H, W, 3] uint8,
    "K" [B, 3, 3], "depth" [B, H, W] metres or None}]."""
    B, (H, W) = traffic["frames_per_batch"], traffic["frame_hw"]
    g = torch.Generator(device=device).manual_seed(seed_for(seed, 2))
    lo, hi = traffic["depth_m"]
    K = torch.tensor(traffic["camera_K"], dtype=torch.float32, device=device)
    ring = []
    for _ in range(ring_size(B * H * W * 3)):
        frames = torch.randint(0, 256, (B, H, W, 3), generator=g, device=device,
                               dtype=torch.uint8)
        d = torch.rand((B, H, W), generator=g, device=device) * (hi - lo) + lo
        ring.append({"frames": frames, "K": K.expand(B, 3, 3), "depth": d if depth else None})
    return ring


@dataclasses.dataclass
class Batch:
    index: int
    ring: int
    submitted: float      # host clock, s
    enqueue_s: float      # the host's time inside the call
    done: float = math.nan
    outputs: dict | None = None


def closed_loop(call, ring: list, in_flight: int, seconds: float | None = None,
                batches: int | None = None, span=None) -> tuple:
    """Serve ring batches in turn, in_flight at a time, for `seconds` (new
    batches are handed over until then) or `batches` batches; every batch
    handed over is waited for. call(batch) -> the outputs dict; span(name),
    where given, is a context around each wait. On the CPU every call has
    finished when it returns. Returns (start, end of the window on the host
    clock, [Batch] in the order they completed)."""
    cuda = ring[0]["frames"].is_cuda
    slots, done, pending = [], [], collections.deque()

    def complete():
        b, event, host = pending.popleft()
        if event is not None:
            with span("wait") if span is not None else contextlib.nullcontext():
                event.synchronize()
        b.done = time.perf_counter()
        b.outputs = {k: v.numpy().copy() for k, v in host.items()}
        slots.append(host)
        done.append(b)

    start = time.perf_counter()
    end = start + seconds if seconds is not None else None
    i = 0
    while (time.perf_counter() < end) if end is not None else i < batches:
        r = i % len(ring)
        t0 = time.perf_counter()
        out = call(ring[r])
        enqueue = time.perf_counter() - t0
        host = slots.pop() if slots else {
            k: torch.empty(out[k].shape, dtype=out[k].dtype, pin_memory=cuda)
            for k in OUTPUT_KEYS}
        for k in OUTPUT_KEYS:
            host[k].copy_(out[k], non_blocking=cuda)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        pending.append((Batch(i, r, t0, enqueue), event, host))
        i += 1
        while len(pending) >= in_flight:
            complete()
    while pending:
        complete()
    return start, end if end is not None else done[-1].done, done
