"""The serving sweeps (counterpart of scripts/bench_sweep.py and
bench_sweep_rgbd.py), as runs of the request trace's tool,
ops/profile_pipeline.py, whose Clock reads them:

    python -m pose6d_tpu_torch.ops.profile_pipeline --sweep rgb|rgbd
        [--sweep-batches B ...] [--frame-hw H W] [--img-size S]
        [--window N] [--reps N] [--device cuda]

Each arm is a pipeline of profile_pipeline.build_pipeline (the JAX
benchmark's set-up, seeded weights) over a ring of requests past 2x the
card's L2; frames/s is batch / the Clock's window ms, warm-up left out.
  rgb   the rgb row (bf16 float towers, bench.py's pipeline, which
        scripts/bench_sweep.py builds) at nms_pre_topk 64 / 32 / 16 and
        bf16_params, at the first of --sweep-batches (128);
  rgbd  the rgbd_folded row (bf16 towers, stem and layer1 kernels) at each
        of --sweep-batches (128 192 256), then bf16_params and
        nms_pre_topk 32 at the best batch (the row's own pre-top-k is 32
        already: that arm repeats the best batch's configuration).
bf16_params casts once the weights the bf16 detector casts at use
(precast_detector_bf16; the towers are left as they are), and its outputs
must equal those of the pipeline without the cast, bit for bit, on every
ring batch. The arms at one batch read the same ring of requests; each
arm's pipeline is freed before the next is built.

Output, one JSON line:
  {"tool": "sweep_rgb" | "sweep_rgbd", <the JAX script's keys>: frames/s,
   "best_batch", "bf16_params_equal": true, "device", "clock", "tf32",
   "frame_hw", "img_size", "window", "arms": {key: {"name", "batch", "pose_batch",
   "nms_pre_topk", "bf16_params_cast", "fps", "ms", "host_enqueue_ms",
   "card_ms", "idle_share", "kernel_launches" (one request's)}},
   "launches_by_batch": {batch: {launch-count key: every launch the sweep
   made at that batch}}}.
"""

from __future__ import annotations

import torch

from .profile_pipeline import (Clock, _outputs_equal, build_pipeline, launches_of, make_ring,
                               ring_size, setting)

SWEEP_ROWS = {"rgb": "rgb", "rgbd": "rgbd_folded"}
SWEEP_BATCHES = {"rgb": (128,), "rgbd": (128, 192, 256)}


def precast_detector_bf16(pipe) -> int:
    """Cast, once, the detector weights that its bf16 forward casts on
    every call (each conv's weight and bias; BatchNorm computes in f32 and
    keeps its own): the JAX sweeps' bf16_params arm. The towers are left
    as they are. Casting once rounds as casting at use does, so the
    outputs do not change. Returns the count of tensors cast."""
    from ..models.yolo.modules import ConvBN, OutConv

    if pipe.yolo_cfg.dtype != torch.bfloat16:
        raise ValueError("bf16_params: the detector computes in "
                         f"{pipe.yolo_cfg.dtype}, not bf16")
    n = 0
    with torch.no_grad():
        for m in pipe.yolo.modules():
            conv = m.conv if isinstance(m, ConvBN) else m if isinstance(m, OutConv) else None
            for p in () if conv is None else (conv.weight, conv.bias):
                if p is not None and p.dtype != torch.bfloat16:
                    p.data = p.data.to(torch.bfloat16)
                    n += 1
    return n


def sweep_arm(row: str, batch: int, args, rng, nms_pre_topk: int | None = None,
              bf16_params: bool = False, ring: list | None = None) -> tuple[dict, object, list]:
    """One arm of a sweep: the row's pipeline at `batch` (nms_pre_topk in
    place of the row's; bf16_params: the detector's weights cast once),
    read by the Clock over a ring of requests (`ring`, or one drawn from
    rng). Returns (its dict: frames/s as batch / the window's ms, warm-up
    left out, the Clock's reading and the kernel launches of one request;
    the pipeline; the ring)."""
    dev = torch.device(args.device)
    hw = tuple(args.frame_hw)
    clock = Clock(dev, args.window, args.reps)
    n_ring = ring_size(batch * hw[0] * hw[1] * 3) if clock.cuda else 2
    with torch.inference_mode():
        pipe, name = build_pipeline(row, args.img_size, args.det_size, dev,
                                    nms_pre_topk=nms_pre_topk)
        cast = precast_detector_bf16(pipe) if bf16_params else 0
        ring = ring or make_ring(pipe, batch, hw, n_ring, rng)
        n_ring = len(ring)
        call = lambda i: pipe(ring[i]["frames"], ring[i]["K"], ring[i]["depth"])  # noqa: E731
        _, launches = launches_of(lambda: call(0))
        r = clock.reading(call, n_ring)
    return {"name": name, "batch": batch, "pose_batch": batch * pipe.cfg.max_objects,
            "nms_pre_topk": pipe.cfg.nms_pre_topk, "bf16_params_cast": cast,
            "fps": batch / (r["ms"] / 1e3), **r, "kernel_launches": launches}, pipe, ring


def sweep(kind: str, batches, args, rng) -> dict:
    """The sweep of `kind` over `batches` (module docstring): its line."""
    row = SWEEP_ROWS[kind]
    arms, by_batch = {}, {}

    def counted(batch, fn):
        """fn(), its kernel launches added to by_batch[batch]."""
        out, launched = launches_of(fn)
        tally = by_batch.setdefault(str(batch), {})
        for k, v in launched.items():
            tally[k] = tally.get(k, 0) + v
        return out

    rings = {}  # the arms at one batch read the same ring; one batch's is kept

    def arm(key, batch, **kwargs):
        if batch not in rings:
            rings.clear()
        arms[key], pipe, rings[batch] = counted(batch, lambda: sweep_arm(
            row, batch, args, rng, ring=rings.get(batch), **kwargs))
        return pipe, rings[batch]

    if kind == "rgb":
        best, cast_key, topk_key = batches[0], "bf16_params", None
        for topk in (64, 32, 16):
            arm("baseline_topk64" if topk == 64 else f"topk{topk}", best, nms_pre_topk=topk)
    else:
        for b in batches:
            arm(f"b{b}", b)
        best = max(batches, key=lambda b: arms[f"b{b}"]["fps"])
        cast_key, topk_key = f"b{best}_bf16params", f"b{best}_topk32"
    cast_pipe, ring = arm(cast_key, best, bf16_params=True)
    with torch.inference_mode():
        base_pipe, _ = build_pipeline(row, args.img_size, args.det_size, cast_pipe.device)
        equal = counted(best, lambda: all(
            _outputs_equal(base_pipe(r["frames"], r["K"], r["depth"]),
                           cast_pipe(r["frames"], r["K"], r["depth"])) for r in ring))
    if not equal:
        raise RuntimeError(f"sweep {kind}: the bf16_params arm's outputs differ from the "
                           f"pipeline's without the cast")
    del base_pipe, cast_pipe
    if topk_key is not None:
        arm(topk_key, best, nms_pre_topk=32)
    rings.clear()
    return {"tool": f"sweep_{kind}", **{k: a["fps"] for k, a in arms.items()},
            "best_batch": best, "bf16_params_equal": equal, **setting(args),
            "arms": arms, "launches_by_batch": by_batch}
