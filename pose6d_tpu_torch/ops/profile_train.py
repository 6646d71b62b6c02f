"""The train step split on the card (counterpart of scripts/profile_nomodel.py,
profile_train_stages.py and profile_train_step.py), as runs of the request
trace's tool, ops/profile_pipeline.py, whose Clock reads them:

    python -m pose6d_tpu_torch.ops.profile_pipeline --nomodel BATCH
    python -m pose6d_tpu_torch.ops.profile_pipeline --train-split VARIANT@BATCH
    python -m pose6d_tpu_torch.ops.profile_pipeline --train-step VARIANT@BATCH
        [--train-frames N] [--frame-hw H W] [--img-size S] [--window N]
        [--reps N] [--device cuda]

Set-up, the JAX scripts': --train-frames (512) resident frames of
--frame-hw (480x640) drawn by numpy from the seed, uint8 RGB and uint16
depth millimetres in [300, 1500) held as int16 (the raw layout
expand_device_batch takes), on the card. Crop boxes are the scripts' at
480x640 and scale with the frame's height elsewhere.

--nomodel BATCH: cumulative prefixes of the device preprocess,
train/loop.expand_device_batch then ops/augment.train_augment, each built
from the functions they call:
  gather       gather_frames on the RGB and the depth frames (the gather
               kernel);
  gather_take  index_select on both: the baseline, not a prefix of the next;
  convert      + the f32 conversions (the frames / 255 and the depth / 1000,
               the JAX script's outputs);
  crop_rgb     + the RGB crop+resize matmuls / 255 from the gathered frames;
  crop_depth   + the depth crop / 1000 and normalize_depth;
  augment      + train_augment on the RGB crops.
The augment prefix's outputs must equal expand_device_batch then
train_augment bit for bit, from generators in the same state. Each
metadata batch: idx over the frames, x1 in [0, 300), y1 in [0, 200), size
in [80, 220) at 480x640.

--train-split VARIANT@BATCH: the train step's stages alone, after
profile_train_stages.py: gather_u8 and gather_u16 (gather_frames),
gather_crop_rgb (the gather and the f32 crop / 255 at x1 100, y1 80, size
180), augment (train_augment on ready crops) and fwd_bwd_adamw (one call
of train/loop._make_core: augment, train-mode forward, loss, backward,
clip, AdamW, on ready crops; the module and the optimizer are restored
from a snapshot taken after one step before each reading, so that no
in-place update stacks up in the timing).

--train-step VARIANT@BATCH: the step make_train_epoch dispatches, f32 and
with bf16 towers, over a window of --window steps on the resident frames
(one epoch call of that many steps; metadata from epoch_meta_synth, the
JAX script's, seeded numpy); each with the no-model bracket (the augment
prefix of --nomodel at the same batch) beside it.

Readings (profile_pipeline.Clock): "ms", CUDA events around a window of
back-to-back launches over its count, warm-up left out; "host_enqueue_ms",
the host's time to enqueue one after a synchronize; "card_ms", the card's
time a launch: a CUDA-graph replay (Clock.card_ms), or for the pieces a
graph cannot hold (augment draws from a generator of the train path's
own, a train step steps its optimizer) the busy time in a profiled window
(Clock.busy_ms); "card_clock" says which; "idle_share", 1 - card_ms /
ms. For --train-step a launch is one epoch call of --window steps and
every time is per step. On the CPU: the host clock; card_ms and
idle_share are null.

Output, one JSON line per flag, with the JAX script's keys (ms per step)
and each reading under "readings":
  {"tool": "nomodel", "gather", "gather_take", "convert", "crop_rgb",
   "crop_depth", "augment", "_batch", "_n_frames",
   "full_prefix_equals_expand_augment": true, ...}
  {"tool": "train_split", "gather_u8", "gather_u16", "gather_crop_rgb",
   "augment", "fwd_bwd_adamw", "_batch", "_variant", ...}
  {"tool": "train_step", "nomodel": {"ms_per_step"}, "float32" and
   "bfloat16": {"ms_per_step", "imgs_per_sec", "host_enqueue_ms",
   "card_ms", "idle_share", "losses_finite"}, "speedup", "variant", ...}
each also with "readings" {name: reading}, "kernel_launches" {name:
{launch-count key: launches a call}}, "device", "clock", "tf32" (cuDNN's
and matmul's: the f32 step's convolutions take TF32 where cuDNN's is on,
torch's default), "card_clock" ({name: "cuda_graph" | "profiler_busy"} |
null), "frame_hw", "img_size", "window", "n_frames".
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .profile_pipeline import SEED, Clock, _outputs_equal, launches_of, setting

NOMODEL_STAGES = ("gather", "gather_take", "convert", "crop_rgb", "crop_depth", "augment")
TRAIN_STAGES = ("gather_u8", "gather_u16", "gather_crop_rgb", "augment", "fwd_bwd_adamw")
REF_H = 480.0         # the frame height the JAX scripts' boxes are drawn for
META_RING = 4         # metadata batches the prefixes and stages cycle through
DTYPES = ("float32", "bfloat16")
# the pieces that draw from a generator of their own or step an optimizer:
# their card time is Clock.busy_ms, the others' a CUDA-graph replay
DRAWS = ("augment", "fwd_bwd_adamw")
CARD_CLOCK = {False: "graph", True: "busy"}


def resident_frames(n: int, hw, rng, device) -> tuple:
    """n seeded uint8 RGB frames [n, H, W, 3] and uint16 depth millimetres
    in [300, 1500) held as int16 [n, H, W], on device."""
    rgb = rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
    depth = rng.integers(300, 1500, (n, *hw), dtype=np.uint16).view(np.int16)
    return torch.from_numpy(rgb).to(device), torch.from_numpy(depth).to(device)


def nomodel_meta(rng, batch: int, n_frames: int, hw, device) -> dict:
    """One metadata batch of profile_nomodel.py (its ranges at 480x640)."""
    f = hw[0] / REF_H
    return {"idx": torch.from_numpy(rng.integers(0, n_frames, batch).astype(np.int32)).to(device),
            **{k: torch.from_numpy(rng.uniform(lo * f, hi * f, batch).astype(np.float32)).to(device)
               for k, lo, hi in (("x1", 0, 300), ("y1", 0, 200), ("size", 80, 220))}}


def nomodel_prefix(stage: str, frames, depth, meta: dict, img_size: int, generator) -> list:
    """The outputs of one prefix of the device preprocess (module
    docstring); "augment" gives (train_augment's rgb, depth_raw, depth) as
    expand_device_batch and train_augment give them."""
    from ..data.crop import normalize_depth
    from ..train.loop import _u16_to_f32
    from .augment import AugmentConfig, train_augment
    from .crop_resize import crop_resize_matmul
    from .gather_frames import gather_frames

    idx = meta["idx"]
    if stage == "gather_take":
        rows = idx.long()
        return [frames.index_select(0, rows), depth.index_select(0, rows)]
    src8, src16 = gather_frames(frames, idx), gather_frames(depth, idx)
    if stage == "gather":
        return [src8, src16]
    src, raw_full = src8.float(), _u16_to_f32(src16)
    if stage == "convert":
        return [src / 255.0, raw_full / 1000.0]
    x1, y1, size = meta["x1"], meta["y1"], meta["size"]
    rgb = crop_resize_matmul(src, x1, y1, size, img_size) / 255.0
    if stage == "crop_rgb":
        return [rgb]
    raw = crop_resize_matmul(raw_full[..., None], x1, y1, size, img_size)[..., 0]
    raw = raw / 1000.0
    d = normalize_depth(raw)[..., None]
    if stage == "crop_depth":
        return [rgb, raw, d]
    return [train_augment(generator, rgb, AugmentConfig()), raw, d]


def _setting(args, clock: Clock, busy: dict) -> dict:
    """setting(args), the train frames and how each reading's card_ms was
    read ({name: "cuda_graph" | "profiler_busy"}, null on the CPU)."""
    return {**setting(args), "n_frames": args.train_frames,
            "card_clock": {k: ("profiler_busy" if v else "cuda_graph") for k, v in busy.items()}
            if clock.cuda else None}


def nomodel(batch: int, args, stages=NOMODEL_STAGES, resident=None) -> dict:
    """scripts/profile_nomodel.py: each prefix read by the Clock over a
    ring of metadata batches, and the full prefix held bit-equal to
    expand_device_batch + train_augment; on `resident` (frames, depth),
    or frames drawn here."""
    from ..train.loop import expand_device_batch
    from .augment import AugmentConfig, train_augment

    dev = torch.device(args.device)
    clock = Clock(dev, args.window, args.reps)
    rng = np.random.default_rng(SEED)
    S, hw = args.img_size, tuple(args.frame_hw)
    frames, depth = resident or resident_frames(args.train_frames, hw, rng, dev)
    metas = [nomodel_meta(rng, batch, args.train_frames, hw, dev) for _ in range(META_RING)]
    with torch.no_grad():
        g1 = torch.Generator(device=dev).manual_seed(SEED)
        g2 = torch.Generator(device=dev).manual_seed(SEED)
        got = nomodel_prefix("augment", frames, depth, metas[0], S, g1)
        want = expand_device_batch(frames, depth, metas[0], S)
        want_rgb = train_augment(g2, want["rgb"], AugmentConfig())
        equal = _outputs_equal(dict(zip(("rgb", "depth_raw", "depth"), got)),
                               {"rgb": want_rgb, "depth_raw": want["depth_raw"],
                                "depth": want["depth"]})
        if not equal:
            raise RuntimeError("nomodel: the augment prefix differs from expand_device_batch "
                               "+ train_augment")
        readings, launches = {}, {}
        for stage in stages:
            fn = lambda i, stage=stage: nomodel_prefix(stage, frames, depth, metas[i], S, g1)  # noqa: E731
            launches[stage] = launches_of(lambda: fn(0))[1]
            readings[stage] = clock.reading(fn, len(metas), card=CARD_CLOCK[stage in DRAWS])
    return {"tool": "nomodel", **{k: r["ms"] for k, r in readings.items()}, "_batch": batch,
            "_n_frames": args.train_frames, "full_prefix_equals_expand_augment": equal,
            "readings": readings, "kernel_launches": launches,
            **_setting(args, clock, {k: k in DRAWS for k in stages})}


def ready_batch(variant: str, batch: int, img_size: int, rng, device) -> dict:
    """profile_train_stages.py's batch of ready crops and labels."""
    B, S = batch, img_size

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(device, dtype)

    out = {"rgb": t(rng.uniform(0, 1, (B, S, S, 3))), "quat": t(rng.normal(size=(B, 4))),
           "trans": t(rng.normal(size=(B, 3))), "obj_id": t(np.zeros(B), torch.int32),
           "center_orig": t(np.zeros((B, 2))), "center_crop": t(np.zeros((B, 2))),
           "cam_K": t(np.tile(np.eye(3)[None], (B, 1, 1))),
           "cam_K_crop": t(np.tile(np.eye(3)[None], (B, 1, 1))),
           "valid": t(np.ones(B), torch.bool)}
    if variant.startswith("rgbd"):
        out["depth"] = t(rng.uniform(0, 1, (B, S, S, 1)))
        out["depth_raw"] = t(rng.uniform(0.2, 1.5, (B, S, S)))
    return out


def fwd_bwd_adamw(variant: str, batch: int, img_size: int, device, seed: int = SEED + 1):
    """The train step's core on ready crops (train/loop._make_core):
    (cfg, state, core), the state fresh from `seed`."""
    from ..train.loop import TrainConfig, _make_core, create_train_state

    cfg = TrainConfig(variant=variant, img_size=img_size, batch_size=batch)
    return cfg, create_train_state(cfg, seed=seed, device=device), _make_core(cfg)


def train_split(variant: str, batch: int, args) -> dict:
    """scripts/profile_train_stages.py: each stage read by the Clock, the
    core from a restored snapshot before each reading."""
    from .augment import AugmentConfig, train_augment
    from .crop_resize import crop_resize_matmul
    from .gather_frames import gather_frames

    dev = torch.device(args.device)
    clock = Clock(dev, args.window, args.reps)
    rng = np.random.default_rng(SEED)
    S, hw, B = args.img_size, tuple(args.frame_hw), batch
    frames, depth = resident_frames(args.train_frames, hw, rng, dev)
    idx = [torch.from_numpy(rng.integers(0, args.train_frames, B).astype(np.int32)).to(dev)
           for _ in range(META_RING)]
    f = hw[0] / REF_H
    x1, y1, size = (torch.full((B,), v * f, device=dev) for v in (100.0, 80.0, 180.0))
    batches = [ready_batch(variant, B, S, rng, dev) for _ in range(META_RING)]
    _, state, core = fwd_bwd_adamw(variant, B, S, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    core(state, batches[0], g)  # the optimizer's moments exist from here on
    snap = copy.deepcopy({"model": state.model.state_dict(), "tx": state.tx.state_dict()})

    def restore():
        state.model.load_state_dict(snap["model"])
        state.tx.load_state_dict(copy.deepcopy(snap["tx"]))

    stages = {
        "gather_u8": lambda i: gather_frames(frames, idx[i]),
        "gather_u16": lambda i: gather_frames(depth, idx[i]),
        "gather_crop_rgb": lambda i: crop_resize_matmul(gather_frames(frames, idx[i]).float(),
                                                        x1, y1, size, S) / 255.0,
        "augment": lambda i: train_augment(g, batches[i]["rgb"], AugmentConfig()),
        "fwd_bwd_adamw": lambda i: core(state, batches[i], g),
    }
    readings, launches = {}, {}
    for name, fn in stages.items():
        model_step = name == "fwd_bwd_adamw"
        with torch.no_grad() if not model_step else torch.enable_grad():
            launches[name] = launches_of(lambda: fn(0))[1]
            readings[name] = clock.reading(fn, META_RING, card=CARD_CLOCK[name in DRAWS],
                                           before=restore if model_step else None)
    restore()
    return {"tool": "train_split", **{k: r["ms"] for k, r in readings.items()}, "_batch": B,
            "_variant": variant, "readings": readings, "kernel_launches": launches,
            **_setting(args, clock, {k: k in DRAWS for k in stages})}


def epoch_meta_synth(n_steps: int, batch: int, n_frames: int, hw, img_size: int,
                     seed: int = SEED) -> dict:
    """profile_train_step.py's stacked epoch metadata [n_steps, B, ...]
    (numpy): boxes of 60-180 px in the frame (at 480x640), random unit
    quaternions, translations near 0.5-1.2 m, LineMOD-like intrinsics."""
    from ..data.device_pipeline import _vector_adjust_K, _vector_crop_params

    rng = np.random.default_rng(seed)
    H, W = hw
    f = H / REF_H
    n = n_steps * batch
    x = rng.uniform(0, W - 200 * f, n)
    y = rng.uniform(0, H - 200 * f, n)
    w = rng.uniform(60 * f, 180 * f, n)
    h = rng.uniform(60 * f, 180 * f, n)
    bbox = np.stack([x, y, w, h], axis=-1)
    p = _vector_crop_params(bbox, bbox, W, H, img_size)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    K = np.tile(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32),
                (n, 1, 1))
    meta = {
        "idx": rng.integers(0, n_frames, n).astype(np.int32),
        "x1": p["x1"], "y1": p["y1"], "size": p["size"],
        "quat": q.astype(np.float32),
        "trans": np.concatenate([rng.normal(0, 0.05, (n, 2)), rng.uniform(0.5, 1.2, (n, 1))],
                                axis=1).astype(np.float32),
        "obj_id": rng.integers(0, 6, n).astype(np.int32),
        "center_orig": p["center_orig"], "cam_K": K, "center_crop": p["center_crop"],
        "cam_K_crop": _vector_adjust_K(K, p),
    }
    return {k: v.reshape(n_steps, batch, *v.shape[1:]) for k, v in meta.items()}


def train_step(variant: str, batch: int, args) -> dict:
    """scripts/profile_train_step.py: make_train_epoch's step in f32 and
    with bf16 towers, each an epoch call of --window steps read by the
    Clock (one launch a reading) and divided by the steps; the no-model
    bracket beside them."""
    from ..train.loop import (TrainConfig, TrainState, create_train_state, make_optimizer,
                              make_train_epoch)

    dev = torch.device(args.device)
    n = args.window
    clock = Clock(dev, window=1, reps=1)
    rng = np.random.default_rng(SEED)
    resident = resident_frames(args.train_frames, tuple(args.frame_hw), rng, dev)
    meta = epoch_meta_synth(n, batch, args.train_frames, tuple(args.frame_hw), args.img_size)
    frames, depth = resident[0], resident[1] if variant.startswith("rgbd") else None
    report, readings, launches = {}, {}, {}
    model = create_train_state(TrainConfig(variant=variant, img_size=args.img_size),
                               seed=SEED, device=dev).model
    init = copy.deepcopy(model.state_dict())
    for dtype in DTYPES:
        cfg = TrainConfig(variant=variant, img_size=args.img_size, batch_size=batch,
                          compute_dtype=dtype)
        model.load_state_dict(init)  # each dtype from the same init, with a fresh AdamW
        state = TrainState(model=model, tx=make_optimizer(cfg, model.parameters()))
        epoch = make_train_epoch(cfg)
        g = torch.Generator(device=dev).manual_seed(SEED)
        losses = []

        def run(i, state=state, epoch=epoch, g=g, losses=losses):
            losses.append(epoch(state, frames, depth, meta, g)[1])

        launches[dtype] = {k: v / n for k, v in launches_of(lambda: run(0))[1].items()}
        r = clock.reading(run, 1, card="busy")
        per = {k: (None if r[k] is None else r[k] / n)
               for k in ("ms", "host_enqueue_ms", "card_ms")}
        readings[dtype] = {**per, "idle_share": r["idle_share"]}
        report[dtype] = {"ms_per_step": per["ms"], "imgs_per_sec": batch / (per["ms"] / 1e3),
                         **{k: readings[dtype][k] for k in ("host_enqueue_ms", "card_ms",
                                                            "idle_share")},
                         "losses_finite": bool(all(torch.isfinite(x).all() for x in losses))}
        del state, epoch, g, losses, run
    del model, init
    bracket = nomodel(batch, args, stages=("augment",), resident=resident)
    readings["nomodel"] = bracket["readings"]["augment"]
    launches["nomodel"] = bracket["kernel_launches"]["augment"]
    f32, bf16 = report["float32"]["ms_per_step"], report["bfloat16"]["ms_per_step"]
    return {"tool": "train_step", "nomodel": {"ms_per_step": bracket["augment"]}, **report,
            "speedup": f32 / bf16 if bf16 else None, "variant": variant, "_batch": batch,
            "readings": readings, "kernel_launches": launches,
            **_setting(args, clock, dict.fromkeys(readings, True)), "window": n}
