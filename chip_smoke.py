#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pose6d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout (no JAX, no
checkpoint, no network); it exits non-zero without a card or the package.
Phases, each printed on its own line with its seconds:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels (csrc/*.cu), one nvcc per source in parallel, into
     pose6d_tpu_torch/_build/; prints ptxas's registers and spills of the
     stage and bf16 stem kernels (-Xptxas -v) and the count of tensor-core
     HGMMA instructions in each bf16 stage and stem kernel (cuobjdump
     -sass), which must not be 0;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the serving path's shapes (batch 8, the stem C=3 and layer1 again
     at the rgb multi-object path's batch 32, and the stems C=3 and C=1 and
     layer1 at 128 on the rgbd path's crops tiled: phase 16's batch), in f32 with a tight
     tolerance and in bf16 against the f32 plain version with a bf16
     envelope; then its time (CUDA events, median of 20 after warm-up)
     beside the plain version's, one PyTorch library computation of the
     same function and the card's bound for the work. Two bf16 launches of
     the stem and of layer1 must be equal bit for bit. The stage kernel runs stages 1-4 on the
     rgbd_geometric tower's own activations, and fused_layer1 (the same
     kernel at stage 1 behind the rgbd path's own launch count) must equal
     fused_stage at stage 1 bit for bit; each stage and layer1 prints its
     bf16 plan (tile N, tiles and K splits per GEMM) and two bf16 launches
     of it must be equal bit for bit (split-K reduces in split order); the
     frame gather moves B = 1, 3 and 32 rows of the train phase's resident
     store (256 frames at 640x480, RGB and depth words; repeated indices and
     indices outside [0, N) that clamp) bit for bit equal to its plain
     version, and is timed at B = 32, each run on the next batch of a
     permutation of the frames, as a train epoch draws them (its source
     not in L2); the nearest-point kernel at batch 8 (the serving add's)
     and 32 (the eval step's and the multi-object add's), 500 points,
     within 1e-7 m of float64 cdist, the plain version within its own
     envelope in d^2 (addmin.expansion_d2_atol), and bit-equal over two
     launches and under a forced plan other than addmin_plan's, and with its
     argmin output (the ADD-S loss's) the same distances and an index that
     is a nearest GT point, the same under both plans. The stem, layer1, stage,
     addmin and gather rows also carry the launch floor: floor_ms, the same event
     timing around one empty launch, and stream_ms, 50 launches back to
     back in one event pair over 50, of the kernel and of the empty launch;
  4. slice rgbd: PosePipeline rgbd at full width (YOLOv8n on 640x480
     frames, two ResNet50 towers at 224, attention dim 2048) with seeded
     weights, folded bf16 towers with the stem and layer1 kernels, over 3
     requests of 8 frames; checks outputs, launch counts (2 stem + 2 layer1
     per request, each at the pose batch), equal boxes, and tower features
     and poses within a bf16 envelope against the float pipeline; prints
     the requests' host-clock latency as a smoke reading, not a throughput;
  5. slice rgbd_geometric: the same for PosePipeline rgbd_geometric (one
     ResNet50 at 224, BN/ReLU rotation head, translation from the f32 depth
     crop at the box centre) with the stem and stage 1-2 kernels: 1 stem,
     1 stage-1 and 1 stage-2 launch per request, boxes and translations
     equal to the float pipeline's, features and rotations within the
     envelope;
  6. slice rgb multi-object: PosePipeline rgb with max_objects 4,
     conf_thresh 0, nms_pre_topk 64 and a bf16 detector (the JAX benchmark's
     rgb_maxobj4 configuration), the stem and layer1 kernels: outputs
     [8, 4, ...], 1 stem and 1 layer1 launch per request, each at batch 32;
     the decode + NMS of one request's bf16 detector outputs on the card
     under torch.cuda.set_sync_debug_mode("error"), with classes, validity
     and scores bit-equal in every slot to the same call on CPU copies and
     boxes within DECODE_BOX_ATOL, at conf 0, 0.25 and a conf between the
     middle two distinct scores (where some slots must be invalid);
  7. slice rgbd_geometric letterbox: phase 5's pipelines on 1280x720
     frames (720 does not divide the detector's stride 32, so they are
     letterboxed onto the 640x640 canvas); the same checks, and the
     windowed crop (CROP_WINDOW) against the full-frame crop on those
     frames, f32 within F32_RTOL and bf16 within the bf16 envelope;
  8. slice rgbd int8: the JAX benchmark's rgbd_int8 configuration
     (YOLOv8n in bf16, nc 13, conf_thresh 0, nms_pre_topk 32, compute
     bf16, seeded weights, its own generator SEED + 11): the towers folded
     with the stem and layer1 kernels, then quantize_backbones(frames, K,
     include_detector=True) with no calibration depth, as the benchmark
     calls it; 3 requests of 8 frames under
     torch.cuda.set_sync_debug_mode("error"). Checks finite outputs and
     unit quaternions, no stem, stage or layer1 launch (the int8 towers
     win over the folded ones), conv_s8s32 on the card bit-equal to the
     same call on CPU copies for every distinct conv geometry of the
     towers and the detector on the requests' own int8 activations, the
     int8 tower features within INT8_FEAT_REL_L2 of the int8 forward on
     CPU copies of the tree and crops, and the cosine of the int8 towers
     against the folded bf16 ones and of the int8 detector's maps against
     the bf16 detector's above INT8_MIN_COS; then times, by CUDA events,
     the int8 tower beside the folded bf16 tower through the kernels and
     through cuDNN at batch 8 and 32, and the int8 detector beside the
     bf16 one at batch 8, each beside its bound;
  9. add: ADD / ADD-S of each slice's poses (all 32 of the multi-object
     path's) against seeded ground truth through the nearest-point kernel,
     against the plain version;
 10. train rgbd: the device-resident train step at full width (two
     ResNet50 towers at 224, attention dim 2048, LayerNorm/GELU heads with
     their dropout; TrainConfig's defaults: batch 32, f32, lr 1e-4) from a
     seeded from-scratch init, on seeded uint8 frames and uint16 depth
     (256 at 640x480, labels seeded too) packed into the card's
     DeviceFrameStore: one make_train_epoch call of 4 steps (after a
     1-step warm-up call) under torch.cuda.set_sync_debug_mode("error"),
     then one make_eval_step batch. Checks finite losses, every parameter
     and BN running statistic moved, 8 gather launches in the epoch (RGB
     and depth per step) and 2 addmin launches in the eval step (learned
     and deployed translation); prints the step time (CUDA events over the
     4 steps) as a smoke reading;
 11. train rgbd from disk: the JAX training entry point ported,
     get_preset("rgbd") -> Trainer -> fit(), at full width from a seeded
     LineMOD tree it writes itself without cv2 or yaml (objects 01 and 10,
     the eggbox, 160 frames each at 640x480, PNGs from its own encoder
     with all five row filters, each decoded back bit-equal; gt.yml,
     info.yml, ASCII PLY meshes, models_info.yml; generator SEED + 12):
     the device path in f32 for 2 epochs (each epoch call under sync-debug
     "error"; finite losses; every parameter and BN statistic moved;
     gather and addmin launches 2 per step and 2 per val batch; metrics.csv;
     last and best_deploy, and best exactly when val ADD-0.1d rose above
     0), a second Trainer resuming from it bit for
     bit and running exactly one more epoch, the host path (PNG decode and
     crop on threads) for 1 epoch, and the device path in bf16 for 1 epoch
     (finite; towers bf16 in training, f32 in validation); prints ms/step
     (CUDA events), PNG decode ms per frame, the loader's ms per batch and
     the epoch-timing split (phase_train_disk);
 12. train detector from disk: the JAX detector trainer ported,
     DetectionTrainer(DetTrainConfig(epochs=2)) -> fit(), at full width
     (YOLOv8n from the flax init, 640, batch 16, f32, HSV + flip + affine
     on the card, EMA, AdamW with warmup-cosine) on a seeded LineMOD tree
     of the 13 LineMOD folders, 40 RGB frames each (416 train, 52 val;
     generator SEED + 13): one step on the card against the same step on
     the CPU (losses within DET_LOSS_RTOL, fg equal), a poisoned batch
     (one inf pixel) leaving parameters and BN statistics bitwise as they
     were, an epoch's batches resident on the card timed by CUDA events
     and one step profiled, fit() with every step under sync-debug
     "error", metrics.csv and last / best, a second trainer resuming bit
     for bit at step 52 on the 2-epoch schedule and running epoch 3, and
     load_yolo_variables(prefer="best") serving one request through an rgb
     PosePipeline; none of the five kernels runs (phase_train_detector);
 13. the workflow through the CLIs: the README's steps as the port's
     command lines (python -m pose6d_tpu_torch.cli.<name>, run in this
     process on their default device, the card; generator seeds SEED +
     14..16): setup_data --synthetic (13 folders x 80 frames, 640x480),
     reference-layout files from a seed (a PoseNetRGBDGeometric .pth, a
     torchvision resnet50, an ultralytics YOLOv8n) read back bit-equal,
     convert_reference_weights to-port bit-equal to the seeded weights,
     train_yolo (1 epoch, no kernel), train rgbd_geometric
     --pretrained-backbone (the train split resident; the tower equal to the
     torchvision dict before step 1; gather and addmin at batch 32), infer
     (the overlay's box drawn, the pose equal to the pipeline's in this
     process; once more as a subprocess) and eval_e2e through the stem and
     stage 1-4 kernels on the whole val split in 13 batches of 8 (addmin at
     8), its detection rate and ADD-0.1d equal to PosePipeline +
     ADDEvaluator's (phase_cli); each CLI's wall seconds and eval_e2e's
     frames/s over its batches;
 14. mesh: data and head parallelism (pose6d_tpu_torch/parallel/) on the
     one card (phase_mesh, generator SEED + 18): (a) a world of one over
     NCCL, mesh (1, 1): a 2-step rgbd make_train_epoch on phase 10's store
     and phase 4's folded rgbd pipeline sharded on it, each bit-equal to the
     same run without a mesh; (b) two ranks spawned on cuda:0 over gloo
     (NCCL refuses two ranks on one card), at full width: the (2, 1) rgbd
     step at global batch 64 (32 a rank) and the (1, 2) step at 32, each in
     float64 and in f32 against the one-process step made here first (the
     float64 loss and gradient within STEP_F64_RTOL; the f32 loss within
     STEP_LOSS_RTOL and each f32 leaf as close to the float64 step as the
     one-process f32 step's, hold_step), the replicas equal bit for bit,
     an eval batch each; the folded rgbd pipeline
     (stem and layer1 kernels) sharded on (2, 1) over 16 frames and on
     (1, 2) over 8, boxes equal and poses within POSE_ATOL of the unsharded
     one at 8 frames a call; Trainer(get_preset("rgbd", batch_size=64),
     mesh=(2, 1)).fit(epochs=1) on a seeded tree of phase 11's writer (80
     frames a folder) and a second Trainer resuming it bit for bit; every
     rank must launch the gather and addmin at 32 and the stem and layer1
     at 8; prints the gloo steps' ms beside the one-process steps' (CUDA
     events) as smoke readings;
 15. learning: tests/test_torch_learning.py at full width on the card
     (phase_learning): the rgb variant at 224 from one seeded init, 60
     steps on one fixed batch of 8 rotations, once in f32 and once with
     bf16 towers, each loss more than halving and the geodesic distance
     after it under 1.6 rad, ms/step by CUDA events; then cli.parity_run
     in this process on 2 objects x 60 frames for 2 epochs
     (rgbd_geometric, wide rotation head, 224, batch 32, the split
     resident): results.json, 2 finite metrics.csv rows, and the gather
     (2 per step) and addmin (1 per val batch) launches counted from 0;
 16. trace: the request trace, python -m pose6d_tpu_torch.ops.profile_pipeline,
     in this process (phase_trace, generator SEED + 19): the JAX
     benchmark's rows (rgb and rgbd, the float pipeline with bf16 towers;
     rgb_f32, the rgb row with f32 towers; rgbd folded with the stem and
     layer1 kernels, rgbd_geometric folded with the stem and stage 1-4
     kernels, rgb_maxobj4 folded, rgbd int8) at batch 8 and rgbd and rgbd
     folded at 128,
     each split into its stages alone, the prefixes of one request and the
     host's enqueue against the card's time, with a torch.profiler trace of
     one request; then one eval_e2e batch split into its PNG decodes,
     ground truth, request and metrics. Checks each run's full prefix equal
     to __call__ bit for bit, no wait for the card in a request, the
     fused-kernel launches of one request (TRACE_EXPECT) and the stem and
     layer1 / stage kernels in the trace's posenet range under their own
     names (stem_tc_kernel, wgmma_gemm_kernel), every compute share under
     100 % and every time positive; prints each run's sum of isolated
     stages, request and overhead;
 17. evidence: the rest of the accuracy evidence through its CLIs, in this
     process (phase_evidence): cli.parity_run --symmetric-objects
     --rot-head-wide on folders 01, 02, 10 and 11 (80 frames each, 2
     epochs, 224, batch 32, the split resident); parity_symmetric on its
     `last` (ids 9 and 10 flagged symmetric, ADD-S at most ADD + 1e-6 m on
     every object row, addmin once for the one val batch, counted from 0);
     probe_rgbd_gradients at img 64, batch 4, 2 steps (every group of the
     four configurations present and finite, trans_head 0); train_yolo 1
     epoch at 96; selection_study over the run's checkpoints; the four
     serving modes (float, int8, folded, folded with the stem and stage 1-4
     kernels) through eval_e2e at batch 8 on the test split, the kernels
     counted; one multi-object eval; serving_md, multiobj_md,
     parity_summarize, parity_report and parity_diagnosis, and the
     assembled PARITY_RESULTS.md holding every section written;
 19. profilers (run after 17 and before the kernels line, 18, which sums
     its launches too): the sweeps and the int8 and train profilers of the
     request trace's tool (ops/profile_sweep.py, profile_int8.py,
     profile_train.py) in this process at windows of PROFILER_WINDOW and
     readings of one launch (phase_profilers). First the stems (C=3, C=1)
     and layer1 held against their plain versions at 192 and 256 (the rgbd
     path's crops tiled; rows of their own, as phase 3's), the batches the
     rgbd sweep serves at. Then --nomodel 32 (the augment prefix bit-equal
     to expand_device_batch + train_augment, 2 gathers a prefix),
     --train-split rgbd@32, --train-step rgbd@32 (f32 and bf16, 2 gathers a
     step, finite losses) on PROFILER_FRAMES resident frames; --int8-split
     8 and --int8-variants 8 (the bf16 tower through the stem and stage
     1-4 kernels within PROFILER_BF16_REL of cuDNN's, D's last prefix equal
     to A, B_vs_A_rel_drift 0); --sweep rgb at 8 and --sweep rgbd at
     SWEEP_BATCHES, 192 and 256 (phase 16 reads 128; bf16_params equal bit
     for bit to no cast, the stem and layer1 launches of each request).
     Every time positive and every card time read;
 20. bf16 float towers (run after 19 and before the kernels line, 18):
     bench.py's rgb and rgbd rows (phase_bf16_float, generator SEED + 21):
     the float pipeline at full width with no pose_cfg at compute bf16, so
     its towers run in bf16 under autocast (a hook on each tower's last
     conv sees bf16; the same weights with an explicit f32 PoseNetConfig
     f32), no kernel launched; boxes equal to the f32-tower pipeline's and
     poses within POSE_ATOL of them; the same weights folded through the
     stem and stage 1-4 (rgb) or stem and layer1 (rgbd) kernels, their
     launches counted, poses within BF16_PAIR_ATOL of the bf16 float
     pipeline's; ADD / ADD-S of the bf16 poses through the addmin kernel;
     the bf16 request's card ms and host enqueue ms;
 18. kernels: one JSON line with every kernel's numbers; launches are the
     sums over the slice, add, train, CLI, mesh, learning, trace,
     evidence, profiler and bf16 float runs, on the row of the kernel and
     the batch they ran at (the stem and layer1 at 32 in phases 6 and 16,
     at 128 in phases 16 and 19, at 192 and 256 in phase 19, at 8
     elsewhere; addmin at 8 in phases 9, 13, 16, 17 and 20 and at 32 in
     phases 9, 10, 11, 13, 14, 15 and 17; the gather at 32 in phases 10,
     11, 13, 14, 15, 17 and 19; stages 3-4 at 8 in phases 13, 16, 17, 19
     and 20); a launch at a batch
     with no row fails the run. The int8 convolution is
     torch._int_mm, a library call as the JAX package's is XLA's, and has
     no row.

The last line is {"ok": true, "device": {...}}; any failed check raises and
the script exits non-zero without it. f32 comparisons run with TF32 off
for both cuDNN convolutions and matmuls.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

SEED = 0
BATCH = 8
N_REQUESTS = 3
FRAME_H, FRAME_W = 480, 640
N_POINTS = 500
N_OBJ = 15
LINEMOD_K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
                      [0.0, 0.0, 1.0]], np.float32)
# H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores, f32 CUDA cores, HBM3
PEAK_OPS = {torch.bfloat16: 989e12, torch.int8: 1979e12, torch.float32: 67e12}
PEAK_BYTES_S = 3.35e12
F32_RTOL = 1e-4        # kernel vs plain in f32: max err <= F32_RTOL * max(1, |ref|max)
BF16_MEAN_REL = 0.02   # bf16 kernel vs f32 plain: mean err < 0.02 * std(ref)
BF16_MAX_REL = 0.25    # ... and max err < 0.25 * std(ref)
STAGES_SERVED = (1, 2)  # rgbd_geometric folded serving: fused_stage for these
TRAIN_FRAMES = 256     # the train phase's resident split (640x480 frames)
TRAIN_STEPS = 4        # steps of the timed train epoch, at TrainConfig's batch 32
HOLD_CYCLES = 4_000_000  # ~2 ms of spin at the H100's clock, ahead of each timed run
FEAT_REL_L2 = 0.05     # folded bf16 vs float f32 tower features, relative L2
POSE_ATOL = 0.01       # folded bf16 vs float f32 poses: quaternion components, metres
ADDMIN_ATOL = 1e-6     # metres, eval step's kernel (difference form) vs plain (expansion)
MULTI_OBJECTS = 4      # rgb multi-object phase: poses per frame (the JAX benchmark's rgb_maxobj4)
LB_H, LB_W = 720, 1280  # letterbox phase frames: 720 does not divide the stride 32
CROP_WINDOW = 320      # the windowed crop's side in the letterbox phase's check
DECODE_BOX_ATOL = 1e-4  # px, decode on the card vs on the CPU (the DFL softmax's exp)
INT8_FEAT_REL_L2 = 1e-3  # int8 tower features, card vs CPU copies (exact int32 products)
INT8_MIN_COS = 0.9     # int8 vs bf16 towers and detector maps: catches scale or sign faults
TRACE_BIG_BATCH = 128  # the request trace's rgbd folded batch (the JAX benchmark's)
TRACE_WINDOW = 6       # phase 16: launches in a timed window
TRACE_REPS = 2         # phase 16: single launches per host and card reading
SWEEP_BATCHES = (192, 256)  # phase 19's rgbd sweep: bench_sweep_rgbd.py's above phase 16's 128
PROFILER_WINDOW = 3    # phase 19: launches (train steps) in a timed window
PROFILER_FRAMES = 128  # phase 19: resident frames of the train profilers (the tool's 512)
PROFILER_BF16_REL = 0.05  # phase 19: bf16 tower through the kernels vs cuDNN, rel-L2
# phase 20: two bf16 computations of the towers, each within POSE_ATOL of the f32 one
BF16_PAIR_ATOL = 2 * POSE_ATOL


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(device) -> None:
    """Wait for the card, so that a fault in a kernel surfaces here."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps: int = 20, warmup: int = 3, hold_cycles: int = HOLD_CYCLES,
            held: list | None = None) -> float:
    """Median milliseconds of fn() over reps runs, each between CUDA events.
    Each run starts behind a hold_cycles spin on the stream, so that the
    host has enqueued fn's launches before the start event fires: the
    events then time the card's work, not the wrapper's host overhead.
    With `held`, appends per run whether the start event was still pending
    when fn() returned on the host (a query, no wait): whether the spin
    did outlast the enqueue."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        start.record()
        fn()
        if held is not None:
            held.append(not start.query())
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def paced_ms(fn) -> tuple[float, float]:
    """(card ms, host ms) of a call that enqueues hundreds of launches: the
    host's time to enqueue fn() (median of 5, each after a sync), then
    cuda_ms behind a spin meant to outlast that enqueue (HOLD_CYCLES, ~2 ms,
    plus 1.5x the enqueue time), so that the events time the card's work
    alone. Every run checks that its start event was still pending when
    fn() returned; if one was not, the spin ran out and the events timed
    the host's pace, so the reading is taken again with a 4x longer spin,
    and after three tries the phase fails."""
    fn()
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(host)
    hold = HOLD_CYCLES + int(1.5 * host_ms * HOLD_CYCLES / 2)
    for _ in range(3):
        held = []
        ms = cuda_ms(fn, reps=10, warmup=1, hold_cycles=hold, held=held)
        if all(held):
            return ms, host_ms
        log(f"  paced_ms: the spin of {hold} cycles ran out in {held.count(False)} of "
            f"{len(held)} runs (host enqueue {host_ms:.3f} ms); again with a 4x longer spin")
        hold *= 4
    raise CheckFailed(f"paced_ms: a spin of {hold // 4} cycles still ran out before the "
                      f"host had enqueued the call")


def floor_ms() -> float:
    """cuda_ms of one empty launch (torch.cuda._sleep(1)): what the event
    pair and a launch cost with no work in it."""
    return cuda_ms(lambda: torch.cuda._sleep(1))


def launch_costs(fn) -> dict:
    """The floor beside a small kernel's time: floor_ms, and the time per
    launch of 50 back to back in one event pair (addmin_sweep.stream_ms) of
    the kernel and of the empty launch."""
    from pose6d_tpu_torch.ops.addmin_sweep import stream_ms

    return {"floor_ms": floor_ms(), "stream_ms": stream_ms(fn),
            "floor_stream_ms": stream_ms(lambda: torch.cuda._sleep(1))}


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare_f32(got, want, what):
    err = (got.float() - want.float()).abs().max().item()
    lim = F32_RTOL * max(1.0, want.float().abs().max().item())
    check(err <= lim, f"{what}: f32 max err {err:.3g} > {lim:.3g}")
    return err


def compare_bf16(got, want_f32, what):
    err = (got.float() - want_f32).abs()
    std = want_f32.std().item()
    mean_e, max_e = err.mean().item(), err.max().item()
    check(mean_e < BF16_MEAN_REL * std and max_e < BF16_MAX_REL * std,
          f"{what}: bf16 mean err {mean_e:.3g} / max {max_e:.3g} vs std {std:.3g}")
    return mean_e, max_e


# ----------------------------------------------------------------- phases


_STAGE_KERNEL = re.compile(r"(wgmma_gemm_kernel|gemm_kernel)I(?:Li(\d+)E)?Lb(\d)E")
_STEM_KERNEL = re.compile(r"stem_tc_kernelILi(\d)E")
TENSOR_CORE_KERNELS = ("wgmma", "stem_tc")  # name prefixes of the kernels that must hold HGMMA


def _kernel_name(mangled: str):
    """'wgmma_gemm_kernel<bn=128,conv3x3=1>' (stage_wgmma.cu, bf16),
    'gemm_kernel<conv3x3=0>' (stage.cu, f32) or 'stem_tc_kernel<C=3>'
    (stem_tc.cu, bf16) from a mangled name, else None."""
    m = _STEM_KERNEL.search(mangled)
    if m is not None:
        return f"stem_tc_kernel<C={m.group(1)}>"
    m = _STAGE_KERNEL.search(mangled)
    if m is None:
        return None
    return f"{m.group(1)}<{'bn=' + m.group(2) + ',' if m.group(2) else ''}conv3x3={m.group(3)}>"


def ptxas_summary(log: str) -> list[str]:
    """Registers, spills and injected waits of the stage and bf16 stem
    kernels from the build's -Xptxas -v output."""
    rows, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = _kernel_name(entry.group(1))
            continue
        waits = re.search(r"\(C7517\).* in function '(\S+)'", line)
        if waits and _kernel_name(waits.group(1)):
            rows.setdefault(_kernel_name(waits.group(1)), {})["waits"] = "C7517 wait injected"
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            rows.setdefault(name, {})["spills"] = f"spills {spill.group(1)}/{spill.group(2)} B"
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            rows.setdefault(name, {})["regs"] = f"{regs.group(1)} registers"
    return [f"{k}: " + ", ".join(v[f] for f in ("regs", "spills", "waits") if f in v)
            for k, v in sorted(rows.items())]


def hgmma_counts(lib_path: str) -> dict | None:
    """HGMMA (wgmma) instructions per bf16 stage and stem kernel in the
    built library's SASS; None where cuobjdump is not there."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = _kernel_name(fn.group(1))
            if name and name.startswith(TENSOR_CORE_KERNELS):
                counts[name] = 0
            continue
        if name in counts and "HGMMA" in line:
            counts[name] += 1
    return counts


def stage_macs(stage: int) -> int:
    """Multiply-adds of one image through ResNet50 stage `stage` at 224."""
    from pose6d_tpu_torch.ops.fused_block import STAGE_CFGS

    _, n_blocks, stride, cin, cmid, cout, h, w = STAGE_CFGS[stage]
    ho, wo = h // stride, w // stride
    macs = h * w * cin * cmid + ho * wo * cin * cout  # block 0's conv1, shortcut
    macs += (n_blocks - 1) * ho * wo * cout * cmid   # later blocks' conv1
    return macs + n_blocks * ho * wo * (9 * cmid * cmid + cmid * cout)


def library_tree(tree, stage: int) -> dict:
    """One stage's folded convs as cuDNN takes them: bf16, channels-last."""
    prefix = f"layer{stage}_"
    return {k: {"w": v["w"].to(torch.bfloat16).contiguous(memory_format=torch.channels_last),
                "b": v["b"].to(torch.bfloat16)} for k, v in tree.items() if k.startswith(prefix)}


def library_stage(h, stage: int, lib_tree: dict):
    """The stage as a sequence of cuDNN convolutions on an NCHW view (the
    library yardstick; the port never calls it)."""
    import torch.nn.functional as F

    from pose6d_tpu_torch.ops.fused_block import STAGE_CFGS

    name, n_blocks, stride = STAGE_CFGS[stage][:3]

    def conv(t, key, s=1, padding=0):
        e = lib_tree[key]
        return F.conv2d(t, e["w"], e["b"], s, padding)

    for j in range(n_blocks):
        blk, s = f"{name}_{j}/", stride if j == 0 else 1
        y = F.relu(conv(h, blk + "conv1"))
        y = F.relu(conv(y, blk + "conv2", s, 1))
        y = conv(y, blk + "conv3")
        h = F.relu(y + (conv(h, blk + "downsample", s) if j == 0 else h))
    return h


def log_plan(what: str, stage: int, batch: int) -> None:
    """Print the bf16 stage kernel's plan of `stage` at `batch`."""
    from pose6d_tpu_torch.ops.fused_block import stage_plan

    log(f"  {what} plan at batch {batch} (GEMM: M x N x K, tile N, tiles x splits): "
        + ", ".join(f"{g.name} {g.m}x{g.n}x{g.k1}{'+' + str(g.k2) if g.k2 else ''} "
                    f"bn{g.bn} {g.tiles}x{g.splits}" for g in stage_plan(stage, batch)))


def stage_rows(geo_pipe, rgb):
    """fused_stage for stages 1-4 on the rgbd_geometric tower: the stem
    kernel's output of the request's crops feeds stage 1, each stage's
    kernel output the next. f32 and bf16 against the plain version, stage 1
    bit-equal to fused_layer1 (the same kernel behind its own count), then
    timed, with the launch floor."""
    from pose6d_tpu_torch.ops import fused_block as fb
    from pose6d_tpu_torch.ops.quant import fold_bn_resnet

    bf16, f32 = torch.bfloat16, torch.float32
    tree = fold_bn_resnet(geo_pipe.posenet.backbone)
    x = fb.fused_stem(rgb.contiguous(), fb.pack_stem_weights(tree, bf16))
    rows = []
    for stage in fb.STAGE_CFGS:
        what = f"fused_stage s{stage}"
        w32, wbf = fb.pack_stage_weights(tree, stage, f32), fb.pack_stage_weights(tree, stage, bf16)
        err = compare_f32(fb.fused_stage(x.float(), w32, stage),
                          fb.reference_stage(x.float(), w32, stage), what)
        oracle = fb.reference_stage(x.float(), tuple(t.float() for t in wbf), stage)
        out = fb.fused_stage(x, wbf, stage)
        mean_e, max_e = compare_bf16(out, oracle, what)
        check(torch.equal(fb.fused_stage(x, wbf, stage), out),
              f"{what}: two bf16 launches on the same input differ")
        log_plan(f"s{stage}", stage, x.shape[0])
        if stage == 1:
            for xs, ws in ((x.float(), w32), (x, wbf)):
                check(torch.equal(fb.fused_stage(xs, ws, 1), fb.fused_layer1(xs, ws)),
                      f"fused_stage s1 and fused_layer1 differ in {xs.dtype}")
        sync(x.device)
        x_nchw, lib_tree = x.permute(0, 3, 1, 2), library_tree(tree, stage)
        b_ms, b_by = bound_ms(nbytes(x, *wbf, out), 2.0 * x.shape[0] * stage_macs(stage), bf16)
        rows.append({
            **row_id(f"fused_stage_s{stage}", x.shape[0]), "route": "cuda",
            "source": "pose6d_tpu_torch/csrc/stage_wgmma.cu",
            "replaces": "pose6d_tpu/ops/pallas_block.py:310", "max_abs_err": err,
            "ms": cuda_ms(lambda: fb.fused_stage(x, wbf, stage)),
            "plain_ms": cuda_ms(lambda: fb.reference_stage(x, wbf, stage)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lambda: library_stage(x_nchw, stage, lib_tree)),
            "bf16_mean_err": mean_e, "bf16_max_err": max_e,
            **launch_costs(lambda: fb.fused_stage(x, wbf, stage)),
        })
        x = out
    return rows


def gather_row(store, rng):
    """The frame gather on the train phase's resident words: RGB and depth
    rows at batches 1, 3 and 32 (repeated indices, and indices outside
    [0, N) that clamp) bit-equal to the plain version (index_select on the
    int32 view of the clamped indices); then at batch 32 timed beside the
    plain version, index_select alone (the library call) and the bytes
    bound (each row read and written once). Each timed run gathers the
    next of the 8 disjoint batches of one permutation of the 256 frames, as
    a train epoch draws them: its source was last read 7 runs (138 MB of
    depth words) earlier, so it is not in the 50 MB L2, as in the train
    step. Both kinds also carry the launch floor (launch_costs), depth's
    under depth_ keys."""
    from pose6d_tpu_torch.ops import gather_frames as gf

    dev = store.device
    n = len(store)

    perm = torch.randperm(n, generator=torch.Generator().manual_seed(SEED)).to(torch.int32)
    batches = [perm[i:i + 32].to(dev) for i in range(0, n - 31, 32)]

    def epoch_ms(fn):
        it = itertools.cycle(batches)
        return cuda_ms(lambda: fn(next(it)))

    out = {}
    for kind, words in (("rgb", store.rgb_frames), ("depth", store.depth_frames)):
        err = 0.0
        for batch in (1, 3, 32):
            # int32 indices, as the train path's metadata holds them
            picks = rng.integers(0, n, batch)
            picks[::3] = picks[0]  # repeats
            picks[1::4] = np.resize([-5, n, 10**6, -1], len(picks[1::4]))  # clamp to 0, n - 1
            idx = torch.from_numpy(picks.astype(np.int32)).to(dev)
            got, want = gf.gather_rows_u32(words, idx), gf._gather_rows_plain(words, idx)
            check(torch.equal(got, want), f"gather_rows_u32 ({kind} words, batch {batch}) "
                                          f"differs from its plain version")
            err = max(err, float((got.long() - want.long()).abs().max().item()))
        sync(dev)
        b_ms, b_by = bound_ms(2.0 * 32 * words.shape[1] * 4, 0.0, torch.float32)
        out[kind] = {"max_abs_err": err,
                     "ms": epoch_ms(lambda i: gf.gather_rows_u32(words, i)),
                     "plain_ms": epoch_ms(lambda i: gf._gather_rows_plain(words, i)),
                     "library_ms": epoch_ms(lambda i: words.index_select(0, i)),
                     "bound_ms": b_ms, "bound_by": b_by,
                     # the launch floor beside it, as the other rows carry it (the
                     # back-to-back launches gather one batch: its rows stay in L2)
                     **launch_costs(lambda: gf.gather_rows_u32(words, batches[0]))}
    row = {**row_id("gather_rows_u32", 32, home=32), "route": "cuda",
           "source": "pose6d_tpu_torch/csrc/gather.cu",
           "replaces": "pose6d_tpu/ops/gather_frames.py:60", **out["rgb"]}
    row.update({f"depth_{k}": v for k, v in out["depth"].items() if k != "bound_by"})
    row["max_abs_err"] = max(out["rgb"]["max_abs_err"], out["depth"]["max_abs_err"])
    return row


def row_id(kernel: str, batch: int, home: int = BATCH) -> dict:
    """A kernel row's identity: its launch-count key, the batch it was
    measured at, and its name (the key, with _b<batch> off the kernel's
    home batch: the serving batch, or the train batch for the gather)."""
    return {"name": kernel if batch == home else f"{kernel}_b{batch}", "kernel": kernel,
            "batch": batch}


def stem_row(tree, x, kernel: str) -> tuple[dict, torch.Tensor]:
    """The stem kernel on the tower's own crops x [N, 224, 224, C]: f32 and
    bf16 against the plain version, two bf16 launches bit-equal, then timed
    beside the plain version, cuDNN's conv + ReLU + maxpool, its bound and
    the launch floor. Returns the row and the bf16 output (layer1's input)."""
    import torch.nn.functional as F

    from pose6d_tpu_torch.ops import fused_block as fb

    bf16, f32 = torch.bfloat16, torch.float32
    C, ident = x.shape[-1], row_id(kernel, x.shape[0])
    name = ident["name"]
    w32, wbf = fb.pack_stem_weights(tree, f32), fb.pack_stem_weights(tree, bf16)
    err = compare_f32(fb.fused_stem(x.float(), w32), fb.reference_stem(x.float(), w32), name)
    oracle = fb.reference_stem(x.float(), (wbf[0].float(), wbf[1]))
    mean_e, max_e = compare_bf16(fb.fused_stem(x, wbf), oracle, name)
    check(torch.equal(fb.fused_stem(x, wbf), fb.fused_stem(x, wbf)),
          f"{name}: two bf16 launches on the same input differ")
    sync(x.device)
    w_lib = tree["conv1"]["w"].to(bf16).contiguous(memory_format=torch.channels_last)
    b_lib = tree["conv1"]["b"].to(bf16)
    x_nchw = x.permute(0, 3, 1, 2)
    out = fb.fused_stem(x, wbf)
    ops = 2.0 * x.shape[0] * 112 * 112 * 64 * 49 * C
    b_ms, b_by = bound_ms(nbytes(x, *wbf, out), ops, bf16)
    return {
        **ident, "route": "cuda", "source": "pose6d_tpu_torch/csrc/stem_tc.cu",
        "replaces": "pose6d_tpu/ops/pallas_block.py:439", "max_abs_err": err,
        "shape": list(x.shape),
        "ms": cuda_ms(lambda: fb.fused_stem(x, wbf)),
        "plain_ms": cuda_ms(lambda: fb.reference_stem(x, wbf)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: F.max_pool2d(
            F.relu(F.conv2d(x_nchw, w_lib, b_lib, 2, 3)), 3, 2, 1)),
        "bf16_mean_err": mean_e, "bf16_max_err": max_e,
        **launch_costs(lambda: fb.fused_stem(x, wbf)),
    }, out


def layer1_row(tree, x, kernel: str) -> dict:
    """layer1 on the tower's real stem output x [N, 56, 56, 64]: f32 and
    bf16 against the plain version, two bf16 launches bit-equal, then timed
    beside the plain version, the cuDNN bottleneck sequence, its bound and
    the launch floor."""
    from pose6d_tpu_torch.ops import fused_block as fb

    bf16, f32 = torch.bfloat16, torch.float32
    ident = row_id(kernel, x.shape[0])
    name = ident["name"]
    w32, wbf = fb.pack_layer1_weights(tree, f32), fb.pack_layer1_weights(tree, bf16)
    err = compare_f32(fb.fused_layer1(x.float(), w32), fb.reference_layer1(x.float(), w32), name)
    oracle = fb.reference_layer1(x.float(), tuple(t.float() for t in wbf))
    mean_e, max_e = compare_bf16(fb.fused_layer1(x, wbf), oracle, name)
    check(torch.equal(fb.fused_layer1(x, wbf), fb.fused_layer1(x, wbf)),
          f"{name}: two bf16 launches on the same input differ")
    sync(x.device)
    x_nchw = x.permute(0, 3, 1, 2)
    lib_tree = library_tree(tree, 1)
    out = fb.fused_layer1(x, wbf)
    b_ms, b_by = bound_ms(nbytes(x, *wbf, out), 2.0 * x.shape[0] * stage_macs(1), bf16)
    log_plan(name, 1, x.shape[0])
    return {
        **ident, "route": "cuda", "source": "pose6d_tpu_torch/csrc/stage_wgmma.cu",
        "replaces": "pose6d_tpu/ops/pallas_block.py:187", "max_abs_err": err,
        "shape": list(x.shape),
        "ms": cuda_ms(lambda: fb.fused_layer1(x, wbf)),
        "plain_ms": cuda_ms(lambda: fb.reference_layer1(x, wbf)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: library_stage(x_nchw, 1, lib_tree)),
        "bf16_mean_err": mean_e, "bf16_max_err": max_e,
        **launch_costs(lambda: fb.fused_layer1(x, wbf)),
    }


def phase_kernels(pipe, geo_pipe, multi_pipe, tower_inputs, multi_inputs, store, rng):
    """Each kernel against its plain version at the serving shapes, then
    timed beside the plain version, a library computation and its bound:
    the stem (C=3, C=1) and layer1 on the rgbd path's towers at batch 8,
    the stages on rgbd_geometric's, the stem C=3 and layer1 again on the
    rgb multi-object path's tower at its batch (8 frames x 4 objects), and
    the stems and layer1 of the rgbd path at TRACE_BIG_BATCH (its crops
    tiled), the batch phase 16 serves rgbd at."""
    from pose6d_tpu_torch.ops.quant import fold_bn_resnet

    rows = []
    for C, name in ((3, "rgb_backbone"), (1, "depth_backbone")):
        tree = fold_bn_resnet(getattr(pipe.posenet, name))
        x = (tower_inputs["rgb"] if C == 3 else tower_inputs["depth"]).contiguous()
        row, out = stem_row(tree, x, f"fused_stem_c{C}")
        rows.append(row)
        if C == 3:
            rows.append(layer1_row(tree, out, "fused_layer1"))
    rows += stage_rows(geo_pipe, tower_inputs["rgb"])
    tree = fold_bn_resnet(multi_pipe.posenet.backbone)
    x = multi_inputs["rgb"].contiguous()
    row, out = stem_row(tree, x, "fused_stem_c3")
    rows += [row, layer1_row(tree, out, "fused_layer1")]
    # the request trace's rgbd batch (phase 16): the rgbd towers' crops tiled
    reps = TRACE_BIG_BATCH // BATCH
    for C, name in ((3, "rgb_backbone"), (1, "depth_backbone")):
        tree = fold_bn_resnet(getattr(pipe.posenet, name))
        x = (tower_inputs["rgb"] if C == 3 else tower_inputs["depth"]).repeat(reps, 1, 1, 1)
        row, out = stem_row(tree, x.contiguous(), f"fused_stem_c{C}")
        rows.append(row)
        if C == 3:
            rows.append(layer1_row(tree, out, "fused_layer1"))

    # addmin on centred model points under two seeded poses per sample, at
    # the serving add's batch and the train eval step's
    dev = tower_inputs["rgb"].device
    rows.append(addmin_row(*seeded_point_pairs(rng, dev)))
    rows.append(addmin_row(*seeded_point_pairs(np.random.default_rng(SEED + 32), dev, 32)))
    rows.append(gather_row(store, rng))
    for r in rows:
        if "bf16_mean_err" in r:
            extra = f"bf16 mean/max err {r['bf16_mean_err']:.3g}/{r['bf16_max_err']:.3g}"
        elif "f64_max_err" in r:
            extra = f"f64 max err {r['f64_max_err']:.3g}"
        else:
            extra = (f"bit-equal; depth words ms {r['depth_ms']:.4f} plain_ms "
                     f"{r['depth_plain_ms']:.4f} library_ms {r['depth_library_ms']:.4f} "
                     f"bound_ms {r['depth_bound_ms']:.5f}")
        if "floor_ms" in r:
            extra += (f"; floor_ms {r['floor_ms']:.4f} stream_ms {r['stream_ms']:.5f} "
                      f"(empty launch {r['floor_stream_ms']:.5f})")
        log(f"  {r['name']}: f32 max_abs_err {r['max_abs_err']:.3g}, {extra}  "
            f"ms {r['ms']:.4f}  plain_ms {r['plain_ms']:.4f}  "
            f"library_ms {r['library_ms']:.4f}  bound_ms {r['bound_ms']:.5f} ({r['bound_by']})")
    return rows


def addmin_row(pred, gt) -> dict:
    """The nearest-point kernel on [B, 500, 3] pairs: against float64 cdist
    within 1e-7 m, and the plain version (the expansion) within the
    expansion's own envelope in d^2, addmin.expansion_d2_atol: the
    expansion is exact in d^2 only, and near zero it strays past 1e-6 m in
    d from float64 (tests/test_torch_addmin_plan.py). Then bit-equal over
    two launches and under a forced plan that addmin_plan
    never picks (3 splits), and timed beside the plain version, cdist and
    its bound, with the floor."""
    from pose6d_tpu_torch.ops import addmin

    B, P, _ = pred.shape
    plan, other = addmin.addmin_plan(B, P), addmin.AddminPlan(64, 4, 3)
    got = addmin.pairwise_min_dist_kernel(pred, gt)
    want = addmin._pairwise_min_dist(pred, gt)
    err = (got - want).abs().max().item()
    exact = torch.cdist(pred.double(), gt.double()).amin(-1)
    err_exact = (got.double() - exact).abs().max().item()
    what = f"addmin [{B}, {P}, 3]"
    check(err_exact <= 1e-7, f"{what}: max err vs f64 {err_exact:.3g} > 1e-7")
    err_d2 = (got.double() ** 2 - want.double() ** 2).abs().max().item()
    tol = addmin.expansion_d2_atol(pred, gt)
    check(err_d2 <= tol, f"{what}: max err vs plain in d^2 {err_d2:.3g} > {tol:.3g} m^2")
    check(torch.equal(addmin.pairwise_min_dist_kernel(pred, gt), got),
          f"{what}: two launches differ")
    check(torch.equal(addmin.pairwise_min_dist_kernel(pred, gt, plan=other), got),
          f"{what}: plans {plan} and {other} differ")
    # the argmin output of the ADD-S loss: the same distances, one index
    # under both plans, and that index a nearest GT point (its float64
    # distance the float64 minimum, to within f32 ties)
    d_i, idx = addmin.pairwise_min_dist_kernel(pred, gt, return_index=True)
    d_o, idx_o = addmin.pairwise_min_dist_kernel(pred, gt, plan=other, return_index=True)
    check(torch.equal(d_i, got) and torch.equal(d_o, got) and torch.equal(idx, idx_o),
          f"{what}: the index output changed the distances or differs between plans")
    at_idx = (pred.double() - torch.gather(gt, 1, idx[..., None].expand(-1, -1, 3)).double())
    err_idx = (at_idx.norm(dim=-1) - exact).abs().max().item()
    check(err_idx <= 1e-7, f"{what}: the argmin is {err_idx:.3g} m from the nearest point")
    sync(pred.device)
    b_ms, b_by = bound_ms(nbytes(pred, gt, got), 9.0 * B * P * P, torch.float32)
    log(f"  addmin [{B}, {P}, 3] plan {plan}: {plan.blocks(B, P)} blocks x {plan.threads} "
        f"threads; bit-equal over two launches and under {other}")
    return {
        **row_id("pairwise_min_dist", B), "route": "cuda",
        "source": "pose6d_tpu_torch/csrc/addmin.cu",
        "replaces": "pose6d_tpu/ops/pallas_addmin.py:67", "max_abs_err": err,
        "shape": [B, P, 3],
        "ms": cuda_ms(lambda: addmin.pairwise_min_dist_kernel(pred, gt)),
        "plain_ms": cuda_ms(lambda: addmin._pairwise_min_dist(pred, gt)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.cdist(pred, gt).amin(-1)),
        "f64_max_err": err_exact,
        **launch_costs(lambda: addmin.pairwise_min_dist_kernel(pred, gt)),
    }


def seeded_object_models(rng, device):
    from pose6d_tpu_torch.losses.add import SYMMETRIC_OBJECT_IDS, ObjectModels

    radii = rng.uniform(0.03, 0.08, (N_OBJ, 1, 3))
    pts = rng.normal(size=(N_OBJ, N_POINTS, 3))
    pts = (pts / np.linalg.norm(pts, axis=-1, keepdims=True) * radii).astype(np.float32)
    symmetric = np.zeros(N_OBJ, bool)
    symmetric[list(SYMMETRIC_OBJECT_IDS)] = True
    return ObjectModels(
        points=torch.from_numpy(pts), diameters=torch.from_numpy(2 * radii.max(axis=(1, 2))
                                                                 .astype(np.float32)),
        symmetric=torch.from_numpy(symmetric), present=torch.ones(N_OBJ, dtype=torch.bool),
        num_valid=torch.full((N_OBJ,), N_POINTS, dtype=torch.int32)).to(device)


def seeded_poses(rng, n, device):
    from pose6d_tpu_torch.geometry.quat import quat_normalize

    q = quat_normalize(torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32)))
    t = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
                  rng.uniform(0.6, 1.0, n)], -1).astype(np.float32)
    return q.to(device), torch.from_numpy(t).to(device)


def seeded_point_pairs(rng, dev, batch: int = BATCH):
    """Kernel-phase addmin inputs: model points under a GT pose and a pose
    a few degrees and millimetres off it, centred on the GT cloud."""
    from pose6d_tpu_torch.geometry.quat import quat_normalize, quat_to_mat

    models = seeded_object_models(rng, dev)
    q, t = seeded_poses(rng, batch, dev)
    dq = torch.from_numpy(rng.normal(0, 0.03, (batch, 4)).astype(np.float32)).to(dev)
    q2 = quat_normalize(q + dq)
    t2 = t + torch.from_numpy(rng.normal(0, 0.005, (batch, 3)).astype(np.float32)).to(dev)
    pts = models.points[torch.arange(batch, device=dev) % N_OBJ]
    gt = torch.einsum("bpj,bij->bpi", pts, quat_to_mat(q)) + t[:, None]
    pred = torch.einsum("bpj,bij->bpi", pts, quat_to_mat(q2)) + t2[:, None]
    c = gt.mean(1, keepdim=True)
    return (pred - c).contiguous(), (gt - c).contiguous()


def make_requests(rng, h: int = FRAME_H, w: int = FRAME_W):
    """N_REQUESTS + 1 (the first a warm-up) seeded requests of BATCH uint8
    frames [h, w, 3] and metric depth maps (0.3-1.5 m, 5 % invalid)."""
    frames = [rng.integers(0, 256, (BATCH, h, w, 3), dtype=np.uint8)
              for _ in range(N_REQUESTS + 1)]
    depths = []
    for _ in range(N_REQUESTS + 1):
        d = rng.uniform(0.3, 1.5, (BATCH, h, w)).astype(np.float32)
        d[rng.random(d.shape) < 0.05] = 0.0  # invalid depth pixels
        depths.append(d)
    return frames, depths


def phase_slice(pipe, float_pipe, frames, depths, expected: dict, exact_translation: bool):
    """3 requests through the folded pipeline with the launch counts set to
    0 just before and read just after; `expected` is the kernel launches
    per request, and no other kernel may launch; every tower kernel runs
    on the whole pose batch (BATCH frames x max_objects). Then the first
    request against the float pipeline: equal boxes, tower features and
    rotations within the bf16 envelope, translations within it or, where
    they come from the depth map (rgbd_geometric), equal."""
    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.models.posenet_serving import backbone_features
    from pose6d_tpu_torch.ops import quant

    dev = pipe.device
    M = pipe.cfg.max_objects
    K = torch.from_numpy(LINEMOD_K).to(dev)
    reqs = [(torch.from_numpy(f).to(dev), torch.from_numpy(d).to(dev))
            for f, d in zip(frames, depths)]
    pipe(reqs[0][0], K, reqs[0][1])  # warm-up request (cuDNN set-up), not counted
    sync(dev)

    _build.launch_counts.clear()
    lat, outs, calls = [], [], []
    with spy(quant, "fused_stem", calls), spy(quant, "fused_layer1", calls), \
            spy(quant, "fused_stage", calls):
        for f, d in reqs[1:]:
            t0 = time.perf_counter()
            out = pipe(f, K, d)
            sync(dev)
            lat.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
    counts = dict(_build.launch_counts)
    log(f"  launches over {N_REQUESTS} requests: {counts}")
    check(set(counts) == set(expected), f"kernels launched {sorted(counts)}, "
                                        f"expected {sorted(expected)}")
    for key, per_call in expected.items():
        check(counts[key] == per_call * N_REQUESTS,
              f"{key}: {counts[key]} launches, expected {per_call * N_REQUESTS}")
    batches = sorted({args[0].shape[0] for args, _, _ in calls})
    check(batches == [BATCH * M], f"tower kernels ran at batches {batches}, expected "
                                  f"{BATCH} frames x {M} objects")
    del calls
    lead = (BATCH, M) if M > 1 else (BATCH,)
    for out in outs:
        for k in ("rotation", "translation", "bbox_xywh"):
            check(bool(torch.isfinite(out[k]).all()), f"{k} not finite")
        check(tuple(out["rotation"].shape) == lead + (4,), "rotation shape")
        check(tuple(out["translation"].shape) == lead + (3,), "translation shape")
        norms = torch.linalg.norm(out["rotation"], dim=-1)
        check(bool(((norms - 1).abs() < 1e-3).all()), f"rotation norms {norms.tolist()}")

    # the same request through the float pipeline: the detector path is shared
    f, d = reqs[1]
    ref = float_pipe(f, K, d)
    check(torch.equal(ref["bbox_xywh"], outs[0]["bbox_xywh"]),
          "bbox differs between folded and float pipelines")
    rot_diff = (ref["rotation"] - outs[0]["rotation"]).abs().max().item()
    trans_diff = (ref["translation"] - outs[0]["translation"]).abs().max().item()
    check(rot_diff <= POSE_ATOL,
          f"rotation: folded vs float max diff {rot_diff:.3g} > {POSE_ATOL}")
    if exact_translation:
        check(trans_diff == 0.0, f"translation: folded vs float differ by {trans_diff:.3g} m")
    else:
        check(trans_diff <= POSE_ATOL,
              f"translation: folded vs float max diff {trans_diff:.3g} m > {POSE_ATOL} m")
    with torch.inference_mode():
        st = pipe.crop_stage(f, K.expand(BATCH, 3, 3), d)
        rel = {}
        towers = pipe.posenet.tower_inputs(st["inputs"]["rgb"], st["inputs"].get("depth"))
        for name, x in towers.items():
            got = backbone_features(pipe.posenet, name, x, pipe.cfg.compute_dtype,
                                    pipe._folded[name])
            want = getattr(float_pipe.posenet, name)(x.float())
            rel[name] = ((got - want).norm() / want.norm()).item()
            check(rel[name] < FEAT_REL_L2,
                  f"{name}: folded bf16 features rel L2 err {rel[name]:.3g} >= {FEAT_REL_L2}")
    log(f"  tower features rel L2 err (folded bf16 vs float f32): {rel}; "
        f"pose diff rot {rot_diff:.3g} trans {trans_diff:.3g} m")
    med = statistics.median(lat)
    log(f"  smoke reading, not a throughput: request latency ms {[round(x, 3) for x in lat]} "
        f"median {med:.3f}, {BATCH / med * 1e3:.1f} frames/s at batch {BATCH} "
        f"(host clock, {N_REQUESTS} requests, TF32 off)")
    return outs[-1], counts, {"latency_ms": lat, "fps": BATCH / med * 1e3}


def check_decode_on_card(pipe, frames) -> None:
    """The pipeline's decode + NMS of one request's detector outputs (bf16)
    on the card under torch.cuda.set_sync_debug_mode("error"), against the
    same call on CPU copies of those outputs: classes, validity and scores
    equal bit for bit in every slot (the rankings are stable sorts, the
    sigmoid float64 rounded once), boxes within DECODE_BOX_ATOL px. At the
    pipeline's conf_thresh, at the JAX default 0.25, and between the middle
    two distinct scores of the first decode (bf16 logits tie often), where
    some slots must go invalid: those are compacted in index order behind
    the valid ones."""
    from pose6d_tpu_torch.infer.pipeline import PosePipeline

    dev = pipe.device
    with torch.inference_mode():
        f = torch.from_numpy(frames).to(dev)
        canvas, _, _, _, det_hw = pipe._letterbox(f.to(pipe.cfg.compute_dtype) / 255.0)
        outputs = pipe.yolo(canvas.to(pipe.yolo_cfg.dtype))
        check(all(b.dtype == c.dtype == torch.bfloat16 for b, c in outputs),
              "the detector's outputs are not bf16")
        cpu_outputs = [(b.cpu(), c.cpu()) for b, c in outputs]
        sync(dev)
        first = None
        for conf in (pipe.cfg.conf_thresh, 0.25, None):
            median = conf is None
            if median:  # between the middle two distinct scores: some slots go invalid
                u = first["scores"].unique()
                conf = (u[(len(u) - 1) // 2].item() + u[len(u) // 2].item()) / 2
            owner = types.SimpleNamespace(cfg=dataclasses.replace(pipe.cfg, conf_thresh=conf),
                                          yolo_cfg=pipe.yolo_cfg)
            torch.cuda.set_sync_debug_mode("error")  # any wait for the card raises
            try:
                got = PosePipeline._decode(owner, outputs, det_hw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want = PosePipeline._decode(owner, cpu_outputs, det_hw)
            first = want if first is None else first
            for k in ("classes", "valid", "scores"):
                check(torch.equal(got[k].cpu(), want[k]),
                      f"decode {k} at conf {conf:.6g}: card and CPU differ")
            box_err = (got["boxes"].cpu() - want["boxes"]).abs().max().item()
            check(box_err <= DECODE_BOX_ATOL,
                  f"decode boxes at conf {conf:.6g}: card vs CPU {box_err:.3g} px")
            n_valid, n = int(want["valid"].sum()), want["valid"].numel()
            if median:
                check(0 < n_valid < n, f"decode at conf {conf:.6g}: {n_valid} of {n} slots "
                                       f"valid, expected some valid and some invalid")
            log(f"  decode + NMS {tuple(got['boxes'].shape[:2])} at conf {conf:.6g} on the "
                f"card with no wait for it: classes, valid, scores bit-equal to the CPU's in "
                f"every slot, boxes within {box_err:.3g} px; {n_valid} of {n} slots valid")


def check_windowed_crop(frames, rng, dev) -> None:
    """crop_resize_matmul_windowed at CROP_WINDOW against crop_resize_matmul
    on the card, on BATCH frames of the letterbox request and planted
    square crops of side 40-300 px (some past the edges): f32 within
    F32_RTOL, bf16 within the bf16 envelope of the f32 full crop."""
    from pose6d_tpu_torch.ops.crop_resize import (crop_params_from_bbox, crop_resize_matmul,
                                                  crop_resize_matmul_windowed)

    h, w = frames.shape[1:3]
    side = np.repeat(rng.uniform(40, 300, (BATCH, 1)), 2, axis=1) / 1.2  # crop = 1.2 x box
    xy = rng.uniform(0, 1, (BATCH, 2)) * np.array([w, h]) - side / 2
    box = torch.from_numpy(np.concatenate([xy, side], -1).astype(np.float32))
    x1, y1, size = (p.to(dev) for p in crop_params_from_bbox(box))
    with torch.inference_mode():
        img = torch.from_numpy(frames).to(dev).float() / 255.0
        full = crop_resize_matmul(img, x1, y1, size, 224)
        err = compare_f32(crop_resize_matmul_windowed(img, x1, y1, size, 224, CROP_WINDOW),
                          full, "windowed crop")
        mean_e, max_e = compare_bf16(
            crop_resize_matmul_windowed(img.to(torch.bfloat16), x1, y1, size, 224, CROP_WINDOW,
                                        compute_dtype=torch.bfloat16), full, "windowed crop")
    log(f"  windowed crop (window {CROP_WINDOW}, crop sides {size.min().item():.0f}-"
        f"{size.max().item():.0f} px) vs full-frame crop: f32 max err {err:.3g}, "
        f"bf16 mean/max err {mean_e:.3g}/{max_e:.3g}")


def phase_add(out, rng):
    """ADD / ADD-S of a serving phase's poses (all B x M of them) against
    seeded ground truth: one launch of the nearest-point kernel at that
    batch, and the metrics against the plain version on the CPU. Returns
    (launches, batch)."""
    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.geometry.quat import quat_to_mat
    from pose6d_tpu_torch.losses import add as add_mod
    from pose6d_tpu_torch.losses.add import SYMMETRIC_OBJECT_IDS, add_metrics

    rot, trans = out["rotation"].reshape(-1, 4), out["translation"].reshape(-1, 3)
    n, dev = rot.shape[0], rot.device
    models = seeded_object_models(rng, dev)
    gt_q, gt_t = seeded_poses(rng, n, dev)
    ids = torch.from_numpy(rng.integers(0, 13, n)).to(dev)
    ids[0] = SYMMETRIC_OBJECT_IDS[0]  # one symmetric object in the batch
    args = (models.points, models.diameters, models.symmetric, models.present,
            quat_to_mat(rot), trans, quat_to_mat(gt_q), gt_t, ids, models.num_valid)
    _build.launch_counts.clear()
    calls = []
    with spy(add_mod, "pairwise_min_dist_kernel", calls):
        got = add_metrics(*args)
    sync(dev)
    launches = _build.launch_counts.get("pairwise_min_dist", 0)
    check(launches == 1, f"add_metrics launched the addmin kernel {launches} times, expected 1")
    shape = tuple(calls[0][0][0].shape)
    check(shape == (n, N_POINTS, 3), f"addmin ran at {shape}, expected ({n}, {N_POINTS}, 3)")
    want = add_metrics(*(a.cpu() for a in args))  # plain version on the CPU
    for k in ("add_mean", "add_s_mean"):
        diff = abs(got[k].item() - want[k].item())
        check(diff <= 1e-3, f"{k}: kernel {got[k].item()} vs plain {want[k].item()} (mm)")
    check(got["add_01d_acc"].item() == want["add_01d_acc"].item(), "add_01d_acc differs")
    log(f"  addmin at {list(shape)}: " + ", ".join(f"{k} {v.item():.4f}" for k, v in got.items())
        + " (mm, mm, %, n)")
    return launches, n


def seeded_split_arrays(rng, n: int = TRAIN_FRAMES) -> tuple:
    """n seeded uint8 RGB frames and uint16 depth maps (mm, 5 % invalid) at
    640x480 with seeded boxes, rotations, translations, object ids and
    LineMOD intrinsics: DeviceFrameStore's arguments, as numpy."""
    rgb = rng.integers(0, 256, (n, FRAME_H, FRAME_W, 3), dtype=np.uint8)
    depth = rng.integers(300, 1500, (n, FRAME_H, FRAME_W), dtype=np.uint16)
    depth[rng.random(depth.shape) < 0.05] = 0
    wh = rng.uniform(60, 200, (n, 2))
    xy = rng.uniform(0, 1, (n, 2)) * (np.array([FRAME_W, FRAME_H]) - wh)
    q = rng.normal(size=(n, 4))
    x, y, z, w = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    rot = np.stack([np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
                    np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
                    np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)],
                   -2)
    trans_mm = np.stack([rng.uniform(-100, 100, n), rng.uniform(-100, 100, n),
                         rng.uniform(600, 1000, n)], -1)
    return (rgb, depth, np.concatenate([xy, wh], -1), rot, trans_mm, rng.integers(0, 13, n),
            np.repeat(LINEMOD_K[None], n, 0))


def seeded_split(rng, device, n: int = TRAIN_FRAMES):
    """The train phase's split on the card (seeded_split_arrays) in the
    port's DeviceFrameStore (host-packed 32-bit words)."""
    from pose6d_tpu_torch.data.device_pipeline import DeviceFrameStore

    return DeviceFrameStore(*seeded_split_arrays(rng, n), img_size=224, flavor="rgbd",
                            device=device)


@contextlib.contextmanager
def spy(module, name: str, calls: list):
    """Record (args, kwargs, result) of every call of module.name while
    the block runs; the call itself is unchanged."""
    fn = getattr(module, name)

    def recorded(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, recorded)
    try:
        yield
    finally:
        setattr(module, name, fn)


def check_eval_addmin(kernel_calls, metric_calls, batch: int) -> float:
    """The eval step's addmin launches at the train path's own shape
    ([batch, N_POINTS, 3], pred from the trained network): each output
    against the plain version and float64 cdist on the same inputs, then
    each add_metrics result (learned and deployed translation) against
    add_metrics on CPU copies of its inputs, which runs the plain version.
    The point checks hold the kernel within ADDMIN_ATOL of the plain
    version and 1e-7 m of float64, scaled by the largest distance beyond
    1 m, the mm means by 1e-5
    of their value beyond 100 mm (an untrained network's predictions land
    tens of centimetres off, and the card and the CPU sum 32 x 500 f32
    terms in different orders). The accuracies and counts are equal.
    Returns the largest error vs plain."""
    from pose6d_tpu_torch.losses.add import add_metrics
    from pose6d_tpu_torch.ops import addmin

    check(len(kernel_calls) == 2 and len(metric_calls) == 2,
          f"eval step: {len(kernel_calls)} addmin calls, {len(metric_calls)} add_metrics calls")
    worst = 0.0
    for (pred, gt), _, got in kernel_calls:
        check(tuple(pred.shape) == (batch, N_POINTS, 3), f"eval addmin shape {tuple(pred.shape)}")
        want = addmin._pairwise_min_dist(pred, gt)
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        exact = torch.cdist(pred.double(), gt.double()).amin(-1)
        err_exact = (got.double() - exact).abs().max().item()
        check(err <= ADDMIN_ATOL * scale, f"eval addmin: max err vs plain {err:.3g}")
        check(err_exact <= 1e-7 * scale, f"eval addmin: max err vs f64 {err_exact:.3g}")
        worst = max(worst, err)
    to_cpu = lambda v: v.cpu() if torch.is_tensor(v) else v  # noqa: E731
    for args, kwargs, got in metric_calls:
        want = add_metrics(*map(to_cpu, args), **{k: to_cpu(v) for k, v in kwargs.items()})
        for k in ("add_mean", "add_s_mean"):
            diff = abs(got[k].item() - want[k].item())
            check(diff <= max(1e-3, 1e-5 * abs(want[k].item())),
                  f"eval {k}: kernel {got[k].item()} vs plain {want[k].item()} (mm)")
        for k in ("add_01d_acc", "count"):
            check(got[k].item() == want[k].item(), f"eval {k}: {got[k].item()} vs "
                  f"{want[k].item()}")
    log(f"  eval addmin at [{batch}, {N_POINTS}, 3]: max err vs plain {worst:.3g}; "
        f"add_metrics of both calls match the plain version")
    return worst


def phase_train(store, rng):
    """One make_train_epoch call of TRAIN_STEPS rgbd steps at batch 32 on
    the resident split, after a 1-step warm-up call, with the launch
    counts set to 0 just before and read just after; then one eval batch
    through make_eval_step, whose two addmin launches are held against the
    plain version on their own inputs (check_eval_addmin). Returns the
    launch counts, the step time, the losses and the eval addmin error."""
    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.losses import add as add_mod
    from pose6d_tpu_torch.train import loop as tl

    dev = store.device
    cfg = tl.TrainConfig(variant="rgbd")
    check((cfg.img_size, cfg.batch_size, cfg.learning_rate, cfg.compute_dtype)
          == (224, 32, 1e-4, "float32"), "TrainConfig defaults moved")
    state = tl.create_train_state(cfg, seed=SEED + 7, device=dev)
    hw = (store.frame_h, store.frame_w)
    epoch = tl.make_train_epoch(cfg, frame_hw=hw)
    meta, n_steps = store.epoch_meta(cfg.batch_size, rng)
    check(n_steps > TRAIN_STEPS, f"the split holds {n_steps} batches")
    g = torch.Generator(device=dev).manual_seed(SEED)
    state, _ = epoch(state, store.rgb_frames, store.depth_frames,
                     {k: v[TRAIN_STEPS:TRAIN_STEPS + 1] for k, v in meta.items()}, g)
    sync(dev)  # warm-up step (cuDNN plans, optimizer state), not counted
    before = {k: v.clone() for k, v in state.model.state_dict().items()}

    _build.launch_counts.clear()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    torch.cuda.set_sync_debug_mode("error")  # any wait for the card raises
    try:
        state, losses = epoch(state, store.rgb_frames, store.depth_frames,
                              {k: v[:TRAIN_STEPS] for k, v in meta.items()}, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    end.record()
    host_enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    counts = dict(_build.launch_counts)
    log(f"  epoch launches: {counts}")
    check(counts == {"gather_rows_u32": 2 * TRAIN_STEPS},
          f"epoch launched {counts}, expected {2 * TRAIN_STEPS} gathers and nothing else")
    check(tuple(losses.shape) == (TRAIN_STEPS,) and bool(torch.isfinite(losses).all()),
          f"losses {losses.tolist()}")
    check(state.step == TRAIN_STEPS + 1, f"state.step {state.step}")
    after = state.model.state_dict()
    params = {k for k, _ in state.model.named_parameters()}
    stats = {k for k in after if "running_" in k}
    stuck = [k for k in params | stats if torch.equal(before[k], after[k])]
    check(not stuck, f"{len(stuck)} parameters or BN statistics did not move, e.g. {stuck[:3]}")
    del before

    models = seeded_object_models(rng, dev)
    eval_meta = next(store.batches(cfg.batch_size, rng, shuffle=True, drop_remainder=False))
    _build.launch_counts.clear()
    batch = tl.expand_device_batch(store.rgb_frames, store.depth_frames,
                                   tl.to_device(eval_meta, dev), cfg.img_size, hw)
    sync(dev)
    gathers = dict(_build.launch_counts)
    check(gathers == {"gather_rows_u32": 2}, f"eval batch launched {gathers}")
    kernel_calls, metric_calls = [], []
    _build.launch_counts.clear()
    with spy(add_mod, "pairwise_min_dist_kernel", kernel_calls), \
            spy(tl, "add_metrics", metric_calls):
        metrics = tl.make_eval_step(cfg, models)(state, batch)
    sync(dev)
    ev = dict(_build.launch_counts)
    check(ev == {"pairwise_min_dist": 2}, f"eval step launched {ev}, expected 2 addmin")
    addmin_err = check_eval_addmin(kernel_calls, metric_calls, cfg.batch_size)
    check(all(bool(torch.isfinite(v).all()) for v in metrics.values()), "eval metrics not finite")
    check(int(metrics["count"]) == cfg.batch_size, f"eval count {int(metrics['count'])}")
    check(tuple(metrics["pred_rot"].shape) == (cfg.batch_size, 4), "eval pred_rot shape")
    log(f"  losses {[round(x, 4) for x in losses.tolist()]}; eval "
        + ", ".join(f"{k} {float(metrics[k]):.4f}" for k in
                    ("loss", "add_mean", "add_s_mean", "add_01d_acc", "add_01d_acc_deploy")))
    totals = collections.Counter(counts)
    totals.update(gathers)
    totals.update(ev)
    step_meta = {k: v[TRAIN_STEPS + 1:TRAIN_STEPS + 2] for k, v in meta.items()}
    profile_kernels(lambda: epoch(state, store.rgb_frames, store.depth_frames, step_meta, g),
                    "one step", step_ms)
    return totals, {"step_ms": step_ms, "host_enqueue_ms": host_enqueue_ms,
                    "losses": losses.tolist(), "addmin_max_abs_err": addmin_err}


# ------------------------------------------------------- train rgbd from disk

# LineMOD folder -> (cube half-extent in mm, mesh vertices); 10 is the eggbox (ADD-S)
DISK_OBJECTS = {1: (40.0, 800), 10: (55.0, 700)}
DISK_FRAMES = 160    # frames per object folder: 128 train, 16 val, 16 test
METRICS_HEADER = ["epoch", "train_loss", "val_add", "val_add_s", "val_acc", "val_acc_deploy",
                  "lr", "steps_per_sec", "imgs_per_sec"]  # the JAX Trainer's metrics.csv


def write_linemod_tree(root: str, rng, objects: dict = DISK_OBJECTS, frames: int = DISK_FRAMES,
                       depth: bool = True) -> dict:
    """data/seeded_tree.write_linemod_tree at 640x480: a seeded LineMOD tree
    written without cv2 or yaml, every PNG decoded back bit-equal; returns
    the decode times (ms per frame)."""
    from pose6d_tpu_torch.data.seeded_tree import write_linemod_tree as write

    return write(root, rng, objects, frames, depth, (FRAME_H, FRAME_W))


class EpochProbe:
    """Wraps a Trainer's train_epoch_fn: each call runs under
    torch.cuda.set_sync_debug_mode("error") (any wait for the card raises)
    between two CUDA events; keeps the calls' (ms, steps, losses)."""

    def __init__(self, trainer):
        self.fn, self.calls = trainer.train_epoch_fn, []
        trainer.train_epoch_fn = self

    def __call__(self, state, frames, depth, meta, gen):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, losses = self.fn(state, frames, depth, meta, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        end.record()
        self.calls.append((start, end, int(meta["idx"].shape[0]), losses))
        return state, losses

    def ms_per_step(self) -> float:
        for _, end, _, _ in self.calls:
            end.synchronize()
        return (sum(s.elapsed_time(e) for s, e, _, _ in self.calls)
                / sum(n for _, _, n, _ in self.calls))


def csv_rows(save_dir: str) -> list:
    import csv

    with open(os.path.join(save_dir, "metrics.csv"), newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        check(header == METRICS_HEADER, f"metrics.csv header {header}")
        return [dict(zip(header, r)) for r in reader]


def tower_dtypes(model, seen: list):
    """Record (train mode, dtype) of every rgb tower conv1 output."""
    return model.rgb_backbone.conv1.register_forward_hook(
        lambda m, i, o: seen.append((m.training, o.dtype)))


def phase_train_disk(rng, smi: str):
    """The JAX training entry point ported: get_preset("rgbd") -> Trainer
    -> fit() at full width (two ResNet50 towers at 224, attention dim 2048,
    batch 32) from a seeded LineMOD tree on disk (write_linemod_tree):
      A. the device path (device_preprocess=True), f32, 2 epochs: each epoch
         call under sync-debug "error"; finite losses; every parameter and
         BN statistic moved; gather launches 2 x steps x epochs and addmin
         launches 2 x val batches x epochs, and nothing else; metrics.csv
         with the JAX header and 2 rows; last and best_deploy written, best
         written exactly when some epoch's val ADD-0.1d rose above 0 (the
         reference's strict-improvement rule). A second Trainer on the same
         save dir resumes at epoch 2 with best_acc, the scheduler, the
         model and the optimizer state equal bit for bit, and fit(epochs=3)
         runs exactly one epoch;
      B. the host path (scripts/train.py's default), f32, 1 epoch: finite
         loss; the loader's decode + crop ms per batch of 32, alone;
      C. the device path in bf16, 1 epoch: finite losses; the towers ran
         bf16 in training and f32 in validation.
    Returns the launch counts of A, its resume and B and C, and the readings."""
    import shutil

    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.data.pipeline import LineMODPoseLoader
    from pose6d_tpu_torch.train.trainer import Trainer

    root = os.path.join(_build.BUILD_DIR, "smoke_linemod")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    tree = write_linemod_tree(root, rng)
    log(f"  seeded LineMOD tree: {tree['frames']} frames of {FRAME_W}x{FRAME_H} in folders "
        f"{sorted(DISK_OBJECTS)}, every PNG (filters 0-4) decodes bit-equal; decode "
        f"{tree['decode_ms']['rgb']:.3f} ms per RGB frame, {tree['decode_ms']['depth']:.3f} "
        f"ms per depth frame (median, one thread) on the host of {smi} "
        f"({time.perf_counter() - t0:.1f}s)")
    totals, out = collections.Counter(), {"decode_ms": tree["decode_ms"]}
    data, models = tree["data"], tree["models"]
    try:
        # ---- A: device path, f32, 2 epochs, then resume
        t0 = time.perf_counter()
        save_a = os.path.join(root, "save_a")
        cfg = get_preset("rgbd", epochs=2)
        check((cfg.img_size, cfg.batch_size, cfg.compute_dtype) == (224, 32, "float32"),
              f"the rgbd preset moved: {cfg}")
        tr = Trainer(cfg, data, models, save_a, seed=SEED, device_preprocess=True,
                     device="cuda")
        n_train, n_val = len(tr.train_loader), len(tr.val_loader)
        steps = n_train // cfg.batch_size
        val_batches = -(-n_val // cfg.batch_size)
        probe = EpochProbe(tr)
        before = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
        _build.launch_counts.clear()
        tr.fit()
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        totals.update(counts)
        want = {"gather_rows_u32": 2 * steps * cfg.epochs,
                "pairwise_min_dist": 2 * val_batches * cfg.epochs}
        check(counts == want, f"run A launched {counts}, expected {want}")
        losses = torch.cat([c[3] for c in probe.calls]).cpu()
        check(len(probe.calls) == cfg.epochs and len(losses) == steps * cfg.epochs
              and bool(torch.isfinite(losses).all()), f"run A losses {losses.tolist()}")
        after = tr.state.model.state_dict()
        moved = {k for k, _ in tr.state.model.named_parameters()} | {
            k for k in after if "running_" in k}
        stuck = [k for k in moved if torch.equal(before[k], after[k])]
        check(not stuck, f"{len(stuck)} parameters or BN statistics did not move, e.g. {stuck[:3]}")
        del before
        rows = csv_rows(save_a)
        check(len(rows) == cfg.epochs and all(np.isfinite(float(r["train_loss"])) for r in rows),
              f"metrics.csv rows {rows}")
        accs = [float(r["val_acc"]) for r in rows]
        check(tr.ckpt.has_checkpoint("last") and tr.ckpt.has_checkpoint("best_deploy"),
              "last or best_deploy missing")
        check(tr.ckpt.has_checkpoint("best") == (max(accs) > 0.0),
              f"best written {tr.ckpt.has_checkpoint('best')} with val ADD-0.1d {accs}")
        out["a_ms_step"] = probe.ms_per_step()
        out["epoch_timing"] = dict(tr.epoch_timing)
        log(f"  A: device path f32, {cfg.epochs} epochs of {steps} steps (batch 32, "
            f"{n_train} train / {n_val} val samples): {out['a_ms_step']:.3f} ms/step (CUDA "
            f"events over the epoch calls, sync-debug 'error'), losses "
            f"{[round(x, 4) for x in losses.tolist()]}, val ADD-0.1d {accs} (best "
            f"{'written' if max(accs) > 0 else 'not written: no epoch rose above 0'}), "
            f"launches {counts}; last epoch [epoch-timing] meta "
            f"{out['epoch_timing']['meta_s']:.3f}s | dispatch "
            f"{out['epoch_timing']['dispatch_s']:.3f}s | exec+fetch "
            f"{out['epoch_timing']['exec_fetch_s']:.3f}s ({time.perf_counter() - t0:.1f}s)")

        t0 = time.perf_counter()
        sd_a = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
        opt_a = tr.state.tx.state_dict()
        best_a, sched_a, step_a = tr.best_acc, tr.scheduler.state_dict(), tr.state.step
        tr.close()
        del tr, probe
        tr2 = Trainer(cfg, data, models, save_a, seed=SEED, device_preprocess=True,
                      device="cuda")
        check(tr2.try_resume() and tr2.start_epoch == cfg.epochs,
              f"resume: start_epoch {tr2.start_epoch}")
        check(tr2.best_acc == best_a and tr2.scheduler.state_dict() == sched_a
              and tr2.state.step == step_a, "resume: best_acc, scheduler or step differ")
        sd_b = tr2.state.model.state_dict()
        check(set(sd_b) == set(sd_a) and all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a),
              "resume: the model differs from the first trainer's")
        opt_b = tr2.state.tx.state_dict()
        same_opt = (opt_a["param_groups"] == opt_b["param_groups"]
                    and opt_a["state"].keys() == opt_b["state"].keys()
                    and all(opt_a["state"][i][k].device == opt_b["state"][i][k].device
                            and torch.equal(opt_a["state"][i][k], opt_b["state"][i][k])
                            for i in opt_a["state"] for k in opt_a["state"][i]))
        check(same_opt, "resume: the optimizer state (values or devices) differs from the "
                        "first trainer's")
        del sd_a, sd_b, opt_a, opt_b
        probe = EpochProbe(tr2)
        _build.launch_counts.clear()
        tr2.fit(epochs=cfg.epochs + 1)
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        totals.update(counts)
        check(len(probe.calls) == 1 and len(csv_rows(save_a)) == cfg.epochs + 1,
              f"fit(epochs={cfg.epochs + 1}) after resume ran {len(probe.calls)} epochs")
        check(counts == {"gather_rows_u32": 2 * steps, "pairwise_min_dist": 2 * val_batches},
              f"the resumed epoch launched {counts}")
        tr2.close()
        del tr2, probe
        shutil.rmtree(save_a, ignore_errors=True)
        log(f"  A resume: start_epoch {cfg.epochs}, best_acc, scheduler, model and optimizer "
            f"state bit-equal; fit(epochs={cfg.epochs + 1}) ran one epoch, launches {counts} "
            f"({time.perf_counter() - t0:.1f}s)")

        # ---- B: host path, f32, 1 epoch
        t0 = time.perf_counter()
        loader = LineMODPoseLoader(data, mode="train", flavor="rgbd", img_size=224,
                                   compact_arrays=True)
        t1 = time.perf_counter()
        n_b = sum(1 for _ in loader.batches(32, np.random.default_rng(SEED)))
        out["loader_ms_batch"] = (time.perf_counter() - t1) * 1e3 / n_b
        loader.close()
        save_b = os.path.join(root, "save_b")
        tr = Trainer(get_preset("rgbd", epochs=1), data, models, save_b, seed=SEED,
                     device="cuda")
        _build.launch_counts.clear()
        tr.fit()
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        totals.update(counts)
        rows = csv_rows(save_b)
        check(len(rows) == 1 and np.isfinite(float(rows[0]["train_loss"])), f"run B {rows}")
        check(counts == {"pairwise_min_dist": 2 * val_batches}, f"run B launched {counts}")
        out["b_ms_step"] = 1e3 / float(rows[0]["steps_per_sec"])
        tr.close()
        del tr
        shutil.rmtree(save_b, ignore_errors=True)
        log(f"  B: host path f32, 1 epoch: loss {float(rows[0]['train_loss']):.4f}; the "
            f"loader alone (8 threads) {out['loader_ms_batch']:.1f} ms per batch of 32 "
            f"(PNG decode + crop of RGB and depth), the epoch {out['b_ms_step']:.1f} ms/step "
            f"(host clock, loader and step overlapped); launches {counts} "
            f"({time.perf_counter() - t0:.1f}s)")

        # ---- C: device path, bf16, 1 epoch
        t0 = time.perf_counter()
        save_c = os.path.join(root, "save_c")
        cfg_c = get_preset("rgbd", epochs=1, compute_dtype="bfloat16")
        tr = Trainer(cfg_c, data, models, save_c, seed=SEED, device_preprocess=True,
                     device="cuda")
        probe = EpochProbe(tr)
        seen = []
        hook = tower_dtypes(tr.state.model, seen)
        _build.launch_counts.clear()
        tr.fit()
        torch.cuda.synchronize()
        hook.remove()
        counts = dict(_build.launch_counts)
        totals.update(counts)
        losses = torch.cat([c[3] for c in probe.calls]).cpu()
        check(len(losses) == steps and bool(torch.isfinite(losses).all()),
              f"run C losses {losses.tolist()}")
        check({d for t, d in seen if t} == {torch.bfloat16}
              and {d for t, d in seen if not t} == {torch.float32},
              f"run C tower dtypes (train mode, dtype): {sorted(set(seen), key=str)}")
        check(all(p.dtype == torch.float32 for p in tr.state.model.parameters()),
              "run C: parameters left f32")
        check(counts == {"gather_rows_u32": 2 * steps, "pairwise_min_dist": 2 * val_batches},
              f"run C launched {counts}")
        out["c_ms_step"] = probe.ms_per_step()
        # one more bf16 step under the profiler: the card's kernel time
        # against the step's time says whether the host paces it
        fs = tr.frame_store
        meta, _ = fs.epoch_meta(cfg_c.batch_size, np.random.default_rng(SEED))
        one = {k: v[:1] for k, v in meta.items()}
        profile_kernels(lambda: probe.fn(tr.state, fs.rgb_frames, fs.depth_frames, one,
                                         tr._generator(cfg_c.epochs)),
                        "one bf16 step", out["c_ms_step"])
        tr.close()
        del tr, probe
        log(f"  C: device path bf16, 1 epoch: {out['c_ms_step']:.3f} ms/step (CUDA events), "
            f"losses {[round(x, 4) for x in losses.tolist()]}; towers bf16 in training, f32 "
            f"in validation; launches {counts} ({time.perf_counter() - t0:.1f}s)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return totals, out


# ------------------------------------------------------ train detector from disk

# LineMOD's 13 object folders (no 03 or 07, so folder 04 is class 2)
LINEMOD_FOLDERS = (1, 2, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15)
DET_FRAMES = 40      # frames per folder: 32 train, 4 val, 4 test (LineMOD has ~1,200)
DET_LOSS_RTOL = 1e-4  # one step's losses, card vs CPU (f32, TF32 off)
DET_LOG_HEADER = "epoch,train_loss,map50,best_map50,lr,epoch_seconds"  # the JAX trainer's


class StepProbe:
    """Wraps a DetectionTrainer's step_fn: each call runs under
    torch.cuda.set_sync_debug_mode("error") (any wait for the card raises);
    counts the calls."""

    def __init__(self, trainer):
        self.fn, self.calls = trainer.step_fn, 0
        trainer.step_fn = self

    def __call__(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = self.fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        self.calls += 1
        return out


def timed(obj, name: str, seconds: list):
    """Wrap obj.<name> so that each call appends its host-clock seconds."""
    fn = getattr(obj, name)

    def call(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, call)


def det_batch(batch: dict, device) -> dict:
    from pose6d_tpu_torch.train.loop import to_device

    return to_device({k: batch[k] for k in ("image", "gt_boxes", "gt_labels", "gt_mask")}, device)


def check_det_step_card_vs_cpu(tr, batch: dict) -> dict:
    """One guarded step of the trainer's weights on the card and on the CPU
    from copies of the model and optimizer, on the same batch and the same
    augmentation draws: box / cls / dfl / total within DET_LOSS_RTOL and
    num_fg equal; the card's step under sync-debug "error". Then a poisoned
    batch (one inf pixel) on the card: parameters and BatchNorm statistics
    bitwise unchanged, Adam's moments scaled by b1 and b2 as zero gradients
    scale them, the count advanced. Returns the losses."""
    import copy

    from pose6d_tpu_torch.models.yolo.train import (DetOptimizer, bn_buffers, draw_det_augment,
                                                    make_det_train_step)

    cfg = tr.cfg
    runs = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    draws = draw_det_augment(gen, cfg.batch_size, cfg, "cuda")
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(tr.model).to(dev)
        tx = DetOptimizer(model.parameters(), cfg, tr.tx.warmup_steps, tr.tx.total_steps)
        step = make_det_train_step(cfg, tr.ycfg, dev)
        args = (model, tx, det_batch(batch, dev), {k: v.to(dev) for k, v in draws.items()})
        if dev == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            losses = step(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        runs[dev] = ({k: float(v) for k, v in losses.items()}, model, tx, step)
    got, want = runs["cuda"][0], runs["cpu"][0]
    check(got["num_fg"] == want["num_fg"] > 0, f"num_fg card {got['num_fg']} cpu {want['num_fg']}")
    for k in ("total", "box", "cls", "dfl"):
        check(np.isfinite(got[k]) and abs(got[k] - want[k]) <= DET_LOSS_RTOL * abs(want[k]),
              f"{k}: card {got[k]!r} cpu {want[k]!r}")

    _, model, tx, step = runs["cuda"]
    poisoned = det_batch(batch, "cuda")
    poisoned["image"] = poisoned["image"].float() / 255.0
    poisoned["image"][1, 10, 20, 1] = float("inf")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    mu, nu, count = [m.clone() for m in tx.mu], [n.clone() for n in tx.nu], tx.count
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = step(model, tx, poisoned, draw_det_augment(gen, cfg.batch_size, cfg, "cuda"))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(not bool(torch.isfinite(losses["total"])), "the poisoned batch gave a finite loss")
    after = model.state_dict()
    check(all(torch.equal(after[k], state[k]) for k in state),
          "the poisoned step moved a parameter or a BatchNorm statistic")
    check(len(bn_buffers(model)) == 2 * 57, "YOLOv8n has 57 BatchNorms")
    check(tx.count == count + 1
          and all(torch.equal(a, b * tx.B1) for a, b in zip(tx.mu, mu))
          and all(torch.equal(a, b * tx.B2) for a, b in zip(tx.nu, nu)),
          "the poisoned step's moments are not those of zero gradients")
    return got


def phase_train_detector(rng, smi: str):
    """The JAX detector trainer ported: DetectionTrainer(DetTrainConfig(
    epochs=2)) at full width (YOLOv8n, 640, batch 16, f32; nc 13) from the
    flax init on a seeded LineMOD tree of 13 folders (write_linemod_tree,
    RGB only):
      A. one step on the card against the same step on the CPU, and the
         non-finite guard on the card (check_det_step_card_vs_cpu);
      B. an epoch's batches resident on the card, stepped under sync-debug
         "error" between two CUDA events (ms per step), one more step under
         the profiler;
      C. fit(): every step under sync-debug "error"; finite losses;
         metrics.csv with the JAX header and 2 rows; `last` and `best`
         (mAP@50 rises above the initial -1 at epoch 1);
      D. a second trainer resumes `last` bit for bit (parameters, BatchNorm
         statistics, EMA, moments, count, meta) at step 52 with the
         2-epoch schedule (total 52, warmup 51) and fit(epochs=3) runs one
         epoch, the lr of metrics.csv that schedule's at step 78;
      E. load_yolo_variables(prefer="best") serves one request of 8 frames
         through an rgb PosePipeline.
    None of the five kernels runs. Returns the readings."""
    import copy
    import shutil

    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.convert import init_posenet_weights
    from pose6d_tpu_torch.data.png import read_png
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.models.posenet import PoseNetConfig
    from pose6d_tpu_torch.models.yolo.train import (DetOptimizer, DetTrainConfig,
                                                    DetectionTrainer, draw_det_augment,
                                                    load_yolo_variables, make_det_train_step)
    from pose6d_tpu_torch.train.schedule import warmup_cosine_decay

    root = os.path.join(_build.BUILD_DIR, "smoke_linemod_det")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    tree = write_linemod_tree(root, rng, {f: (40.0, 600) for f in LINEMOD_FOLDERS}, DET_FRAMES,
                              depth=False)
    log(f"  seeded LineMOD tree: {tree['frames']} RGB frames of {FRAME_W}x{FRAME_H} in "
        f"{len(LINEMOD_FOLDERS)} folders, every PNG decodes bit-equal "
        f"({time.perf_counter() - t0:.1f}s)")
    out = {}
    _build.launch_counts.clear()
    try:
        t0 = time.perf_counter()
        cfg = DetTrainConfig(epochs=2)
        save = os.path.join(root, "save")
        tr = DetectionTrainer(tree["data"], save, cfg, device="cuda")
        n_train, n_val = len(tr.train_loader), len(tr.val_loader)
        steps = n_train // cfg.batch_size
        check((n_train, n_val, steps, tr.ycfg.num_classes) == (416, 52, 26, 13)
              and (tr.tx.warmup_steps, tr.tx.total_steps) == (51, 52)
              and (cfg.img_size, cfg.batch_size, tr.ycfg.width, tr.ycfg.reg_max) == (640, 16, 0.25, 16),
              f"the detector run's shape: {n_train} train, {n_val} val, {steps} steps, "
              f"nc {tr.ycfg.num_classes}, schedule {tr.tx.warmup_steps}/{tr.tx.total_steps}")
        batches = list(tr.train_loader.batches(cfg.batch_size, np.random.default_rng(SEED)))

        # ---- A: card vs CPU, the guard
        losses = check_det_step_card_vs_cpu(tr, batches[0])
        log(f"  A: one step, card = CPU within {DET_LOSS_RTOL} (total {losses['total']:.6f}, box "
            f"{losses['box']:.6f}, cls {losses['cls']:.6f}, dfl {losses['dfl']:.6f}, "
            f"{int(losses['num_fg'])} fg anchors); a poisoned batch left the parameters and "
            f"BN statistics bitwise unchanged and scaled the moments as zero gradients "
            f"({time.perf_counter() - t0:.1f}s)")

        # ---- B: an epoch's batches resident on the card, CUDA events
        t0 = time.perf_counter()
        model = copy.deepcopy(tr.model)
        tx = DetOptimizer(model.parameters(), cfg, tr.tx.warmup_steps, tr.tx.total_steps)
        step = make_det_train_step(cfg, tr.ycfg, "cuda")
        resident = [det_batch(b, "cuda") for b in batches]
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        step(model, tx, resident[0], draw_det_augment(gen, cfg.batch_size, cfg, "cuda"))  # warm-up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        totals = []
        torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            for b in resident:
                totals.append(step(model, tx, b, draw_det_augment(gen, cfg.batch_size, cfg,
                                                                  "cuda"))["total"])
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        end.synchronize()
        out["ms_step"] = start.elapsed_time(end) / len(resident)
        check(bool(torch.isfinite(torch.stack(totals)).all()), "non-finite resident-step losses")
        profile_kernels(lambda: step(model, tx, resident[1],
                                     draw_det_augment(gen, cfg.batch_size, cfg, "cuda")),
                        "one detector step", out["ms_step"])
        del model, tx, resident, totals
        log(f"  B: {len(batches)} steps resident on the card: {out['ms_step']:.3f} ms/step "
            f"(CUDA events, sync-debug 'error') on {smi} ({time.perf_counter() - t0:.1f}s)")

        # ---- C: fit through the loader
        t0 = time.perf_counter()
        n_b = sum(1 for _ in tr.train_loader.batches(cfg.batch_size, np.random.default_rng(SEED)))
        out["loader_ms_batch"] = (time.perf_counter() - t0) * 1e3 / n_b
        probe = StepProbe(tr)
        epoch_s, val_s = [], []
        timed(tr, "train_epoch", epoch_s)
        timed(tr, "validate_map50", val_s)
        maps = []
        validate = tr.validate_map50

        def record_map(rng_):
            maps.append(validate(rng_))
            return maps[-1]

        tr.validate_map50 = record_map
        tr.fit()
        check(probe.calls == steps * cfg.epochs, f"fit ran {probe.calls} steps")
        with open(os.path.join(save, "metrics.csv")) as f:
            rows = f.read().splitlines()
        check(rows[0] == DET_LOG_HEADER and len(rows) == 3
              and all(np.isfinite(float(r.split(",")[1])) for r in rows[1:]),
              f"metrics.csv {rows}")
        check(os.path.exists(os.path.join(save, "last.pt"))
              and os.path.exists(os.path.join(save, "best.pt")), "last or best missing")
        out["fit_ms_step"] = 1e3 * statistics.mean(epoch_s) / steps
        out["val_s"], out["map50"] = val_s, maps
        log(f"  C: fit, {cfg.epochs} epochs of {steps} steps through the loader: "
            f"{out['fit_ms_step']:.1f} ms/step (host clock, the loader's prefetch thread "
            f"overlapping the steps), the loader alone {out['loader_ms_batch']:.1f} ms per "
            f"batch of 16; losses {[r.split(',')[1] for r in rows[1:]]}; validation "
            f"{', '.join(f'{v:.2f}' for v in val_s)} s, mAP@50 {maps} (plumbing: 2 epochs of "
            f"seeded data) on {smi} ({time.perf_counter() - t0:.1f}s)")

        # ---- D: resume
        t0 = time.perf_counter()
        saved = tr._ckpt_tree()
        tr.close()
        tr2 = DetectionTrainer(tree["data"], save, cfg, device="cuda")
        check(tr2.try_resume(), "resume failed")
        got = tr2._ckpt_tree()
        same = got["meta"] == saved["meta"] and got["opt_state"]["count"] == saved["opt_state"]["count"]
        for part in ("params", "batch_stats", "ema_params"):
            same &= all(torch.equal(got[part][k], saved[part][k]) for k in saved[part])
        for k in ("mu", "nu"):
            same &= all(torch.equal(got["opt_state"][k][n], saved["opt_state"][k][n])
                        for n in saved["opt_state"][k])
        check(same, "the resumed state differs from the saved one")
        lr52 = warmup_cosine_decay(52, 0.0, cfg.learning_rate, 51, 52, cfg.learning_rate * 0.01)
        check(tr2.global_step == 52 and (tr2.tx.warmup_steps, tr2.tx.total_steps) == (51, 52)
              and tr2.tx.lr(tr2.global_step) == lr52,
              f"resumed at step {tr2.global_step}, schedule {tr2.tx.warmup_steps}/"
              f"{tr2.tx.total_steps}, lr {tr2.tx.lr(tr2.global_step)}")
        probe = StepProbe(tr2)
        tr2.fit(epochs=cfg.epochs + 1)
        with open(os.path.join(save, "metrics.csv")) as f:
            rows = f.read().splitlines()
        lr78 = warmup_cosine_decay(78, 0.0, cfg.learning_rate, 51, 52, cfg.learning_rate * 0.01)
        check(probe.calls == steps and tr2.global_step == 78 and len(rows) == 4
              and rows[-1].split(",")[4] == f"{lr78:.8f}",
              f"fit(epochs=3) after resume: {probe.calls} steps, step {tr2.global_step}, "
              f"rows {rows[1:]}")
        tr2.close()
        log(f"  D: resume bit-equal (parameters, BN statistics, EMA, moments, count, meta) at "
            f"step 52, schedule 51/52, lr {lr52:.8f}; fit(epochs=3) ran one epoch to step 78 "
            f"({time.perf_counter() - t0:.1f}s)")

        # ---- E: serve the trained detector
        t0 = time.perf_counter()
        sd = load_yolo_variables(save, tr.ycfg, prefer="best")
        check(sd is not None, "no detector to load from best")
        pose_cfg = PoseNetConfig(variant="rgb")
        pipe = PosePipeline(PipelineConfig(variant="rgb", img_size=224), tr.ycfg, sd,
                            init_posenet_weights(pose_cfg, SEED + 13), pose_cfg, device="cuda")
        names = sorted(os.listdir(os.path.join(tree["data"], "01", "rgb")))[:BATCH]
        frames = np.stack([read_png(os.path.join(tree["data"], "01", "rgb", n)) for n in names])
        with torch.inference_mode():
            res = pipe(frames, LINEMOD_K)
        torch.cuda.synchronize()
        check(res["rotation"].shape[0] == BATCH
              and all(bool(torch.isfinite(res[k]).all()) for k in ("rotation", "translation",
                                                                    "bbox_xywh")),
              "the served request is not finite")
        check(dict(_build.launch_counts) == {},
              f"the detector phase launched kernels: {dict(_build.launch_counts)}")
        log(f"  E: load_yolo_variables(prefer='best') served one request of {BATCH} frames "
            f"through an rgb PosePipeline ({time.perf_counter() - t0:.1f}s)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# the workflow's tree: 13 folders x 80 frames (LineMOD has ~1,200 a folder),
# each 64 train, 8 val (i % 10 == 8), 8 test: the val split is 13 batches of BATCH
CLI_OBJECTS, CLI_FRAMES = 13, 80


def run_cli(name: str, argv: list) -> tuple[str, float]:
    """python -m pose6d_tpu_torch.cli.<name> argv, in this process (so that
    the launch counts see it): its stdout (echoed) and wall seconds. A
    SystemExit with a code other than 0 fails the run."""
    import contextlib
    import io
    import runpy

    buf, old, t0 = io.StringIO(), sys.argv, time.perf_counter()
    sys.argv = [name] + [str(a) for a in argv]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_module(f"pose6d_tpu_torch.cli.{name}", run_name="__main__")
    except SystemExit as e:
        if e.code not in (None, 0):
            raise CheckFailed(f"cli.{name} exited with {e.code!r}: {buf.getvalue()[-2000:]}")
    finally:
        sys.argv = old
    secs = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"    {name}: {line}")
    return buf.getvalue(), secs


def _printed(pattern: str, text: str) -> str:
    m = re.search(pattern, text)
    check(m is not None, f"no {pattern!r} in the CLI's output")
    return m.group(1)


def phase_cli(smi: str, device: str = "cuda"):
    """The README's workflow through the port's CLIs, at full width: each
    one run as `python -m pose6d_tpu_torch.cli.<name>` in this process with
    its argv (run_cli), on the card:
      1. setup_data --synthetic writes a tree of CLI_OBJECTS folders x
         CLI_FRAMES 640x480 frames (data/synthetic.py, no cv2);
      2. reference-layout files from a seed: the reference's PoseNetRGBD-
         Geometric checkpoint (posenet_to_reference of seeded weights, under
         'model_state_dict'), a torchvision resnet50 and an ultralytics
         YOLOv8n (yolo_to_ultralytics, 'model.model.' keys), each read back
         and converted to the port bit-equal;
      3. convert_reference_weights to-port: the Trainer checkpoint it writes
         loads (load_model_variables) bit-equal to the seeded weights;
      4. train_yolo --epochs 1 (YOLOv8n, nc 13, 640, batch 16; no kernel),
         then train --variant rgbd_geometric --epochs 1 --pretrained-backbone
         <the torchvision .pth> (224, batch 32, the train split resident): the
         tower equals the converted torchvision dict before step 1, and the
         gather and addmin kernels launch at batch 32;
      5. infer on one val frame (bf16): the overlay PNG decodes to the
         frame's shape, the box colour is drawn, and the printed pose equals
         the same PosePipeline's run in this process; the same command once
         more as a subprocess (the module entry alone);
      6. eval_e2e --folded-backbone --folded-pallas --folded-stem
         --folded-stages 1,2,3,4 --batch-size 8 on the whole val split (104
         frames, 13 batches): the stem, stages 1-4 and addmin kernels launch
         once a batch, and the printed detection rate and ADD-0.1d equal
         PosePipeline + ADDEvaluator's in this process, batch by batch.
         frames/s as eval_e2e prints it: the host clock over its batches,
         set-up (checkpoints, folding, meshes) excluded.
    The CLIs run on their default device, the card; `device` is that of the
    in-process pipelines they are compared with.
    Returns {(kernel, batch): launches} and the readings."""
    import shutil

    from scipy.spatial.transform import Rotation

    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.convert import (init_posenet_weights, init_torchvision_resnet50,
                                          init_yolo_weights)
    from pose6d_tpu_torch.data.linemod import build_index
    from pose6d_tpu_torch.data.png import read_png
    from pose6d_tpu_torch.geometry.pinhole import DEFAULT_K
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.losses.add import ADDEvaluator
    from pose6d_tpu_torch.models.convert import load_torch_state_dict, resnet50_from_torchvision
    from pose6d_tpu_torch.models.convert_posenet import posenet_to_reference
    from pose6d_tpu_torch.models.posenet import PoseNetConfig
    from pose6d_tpu_torch.models.yolo.convert import yolo_from_ultralytics, yolo_to_ultralytics
    from pose6d_tpu_torch.models.yolo.model import YoloConfig
    from pose6d_tpu_torch.models.yolo.train import load_yolo_variables
    from pose6d_tpu_torch.train import trainer as trainer_mod
    from pose6d_tpu_torch.train.checkpoint import load_model_variables
    from pose6d_tpu_torch.utils.viz import draw_rectangle

    root = os.path.join(_build.BUILD_DIR, "smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    secs, launches = {}, collections.Counter()

    def equal_states(a: dict, b: dict, what: str) -> None:
        check(set(a) == set(b), f"{what}: keys differ: {sorted(set(a) ^ set(b))[:6]}")
        bad = [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k].cpu(), b[k].cpu())]
        check(not bad, f"{what}: {len(bad)} tensors differ, e.g. {bad[:4]}")

    try:
        # 1. the tree
        _, secs["setup_data"] = run_cli("setup_data", ["--dest", root, "--synthetic", "--objects",
                                                       CLI_OBJECTS, "--frames", CLI_FRAMES])
        data = os.path.join(root, "Linemod_synthetic", "data")
        models = os.path.join(root, "Linemod_synthetic", "models")

        # 2. reference-layout files from a seed, read back through the converters
        variant = "rgbd_geometric"
        seeded = init_posenet_weights(PoseNetConfig(variant=variant), SEED + 14)
        ref_pth = os.path.join(root, "best_pose_model.pth")
        torch.save({"model_state_dict": posenet_to_reference(variant, seeded)}, ref_pth)
        tv = init_torchvision_resnet50(SEED + 15)
        tv_pth = os.path.join(root, "resnet50_torchvision.pth")
        torch.save(tv, tv_pth)
        ycfg = YoloConfig(num_classes=CLI_OBJECTS)
        yolo_seeded = init_yolo_weights(ycfg, SEED + 16)
        yolo_pth = os.path.join(root, "yolov8n_ultralytics.pth")
        torch.save({"model": {f"model.model.{k}": v
                              for k, v in yolo_to_ultralytics(yolo_seeded, ycfg).items()}},
                   yolo_pth)
        equal_states(yolo_from_ultralytics(load_torch_state_dict(yolo_pth), ycfg), yolo_seeded,
                     "ultralytics YOLOv8n round trip")

        # 3. the reference checkpoint into a Trainer checkpoint
        port_dir = os.path.join(root, "weights_reference")
        _, secs["convert_reference_weights"] = run_cli(
            "convert_reference_weights", ["to-port", "--variant", variant, "--pth", ref_pth,
                                          "--dest", port_dir])
        equal_states(load_model_variables(port_dir, get_preset(variant)), seeded,
                     "convert_reference_weights to-port")

        # 4. the training CLIs
        yolo_dir = os.path.join(root, "yolo")
        _build.launch_counts.clear()
        _, secs["train_yolo"] = run_cli("train_yolo", ["--data-root", data, "--save-dir",
                                                       yolo_dir, "--epochs", 1])
        check(dict(_build.launch_counts) == {}, f"train_yolo launched kernels: "
                                                f"{dict(_build.launch_counts)}")
        towers_checked = []
        original = trainer_mod.Trainer.train_epoch

        def first_epoch_checks_towers(self, epoch, rng):
            if not towers_checked:  # before step 1: the converted torchvision tower
                equal_states(self.state.model.backbone.state_dict(),
                             resnet50_from_torchvision(tv), "the pretrained tower")
                towers_checked.append(epoch)
            return original(self, epoch, rng)

        pose_dir = os.path.join(root, f"weights_{variant}")
        trainer_mod.Trainer.train_epoch = first_epoch_checks_towers
        try:
            _build.launch_counts.clear()
            _, secs["train"] = run_cli("train", ["--variant", variant, "--data-root", data,
                                                 "--mesh-dir", models, "--save-dir", pose_dir,
                                                 "--epochs", 1,
                                                 "--pretrained-backbone", tv_pth])
            train_counts = dict(_build.launch_counts)
        finally:
            trainer_mod.Trainer.train_epoch = original
        check(towers_checked == [0], "train: the tower check did not run before epoch 1")
        check(set(train_counts) == {"gather_rows_u32", "pairwise_min_dist"}
              and min(train_counts.values()) > 0,
              f"train: the gather and addmin kernels, got {train_counts}")
        for k, v in train_counts.items():
            launches[(k, 32)] += v
        log(f"  train launches (batch 32): {train_counts}")

        # 5. infer on one val frame, in process and as a subprocess
        image = os.path.join(data, "01", "rgb", "0008.png")
        depth = os.path.join(data, "01", "depth", "0008.png")
        overlay = os.path.join(root, "overlay.png")
        infer_args = ["--variant", variant, "--image", image, "--depth", depth,
                      "--yolo-weights", yolo_dir, "--pose-weights", pose_dir,
                      "--mesh-dir", models, "--output", overlay]
        _build.launch_counts.clear()
        text, secs["infer"] = run_cli("infer", infer_args)
        check(dict(_build.launch_counts) == {}, "infer (float towers) launched kernels")
        frame = read_png(image)
        drawn = read_png(overlay)
        check(drawn.shape == frame.shape, f"infer's overlay {drawn.shape} vs {frame.shape}")
        pipe = PosePipeline(PipelineConfig(variant=variant, img_size=224,
                                           compute_dtype=torch.bfloat16), ycfg,
                            load_yolo_variables(yolo_dir, ycfg),
                            load_model_variables(pose_dir, get_preset(variant, img_size=224)),
                            device=device)
        depth_m = read_png(depth).astype(np.float32) / 1000.0
        out = pipe(frame[None], DEFAULT_K, depth_m[None])
        quat = out["rotation"][0].float().cpu().numpy()
        trans = out["translation"][0].float().cpu().numpy()
        # the detection box is drawn last, in BGR (255, 0, 0): every one of
        # its pixels is (0, 0, 255) in the RGB file
        x, y, w, h = out["bbox_xywh"][0].float().cpu().numpy().astype(int)
        box = np.zeros(frame.shape[:2], np.uint8)
        draw_rectangle(box, (x, y), (x + w, y + h), 1, 2)
        check(box.any() and (drawn[box > 0] == np.array([0, 0, 255], np.uint8)).all(),
              f"infer's overlay lacks the detection box [{x}, {y}, {w}, {h}]")
        check(_printed(r"quat\(xyzw\): (.*)", text) == f"{quat}"
              and _printed(r"trans \(m\): (.*)", text) == f"{trans}",
              f"infer's pose differs from the pipeline's in process: {quat} {trans}")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "pose6d_tpu_torch.cli.infer"] + infer_args
                           + ["--output", overlay + ".sub.png"], capture_output=True, text=True,
                           timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
        secs["infer (subprocess)"] = time.perf_counter() - t0
        check(r.returncode == 0 and "saved" in r.stdout,
              f"python -m pose6d_tpu_torch.cli.infer: exit {r.returncode}: {r.stderr[-2000:]}")
        check(read_png(overlay + ".sub.png").shape == frame.shape, "the subprocess overlay")

        # 6. eval_e2e through the fused kernels on the whole val split
        samples = build_index(data, "val", require_depth=True)
        n_batches = CLI_OBJECTS * CLI_FRAMES // 10 // BATCH
        check(len(samples) == n_batches * BATCH,
              f"the val split: {len(samples)} frames, not {n_batches} batches of {BATCH}")
        eval_args = ["--variant", variant, "--data-root", data, "--mesh-dir", models,
                     "--yolo-weights", yolo_dir, "--pose-weights", pose_dir,
                     "--batch-size", BATCH, "--conf-thresh", 0.0,
                     "--folded-backbone", "--folded-pallas", "--folded-stem",
                     "--folded-stages", "1,2,3,4"]
        _build.launch_counts.clear()
        text, secs["eval_e2e"] = run_cli("eval_e2e", eval_args)
        eval_counts = dict(_build.launch_counts)
        want = {k: n_batches for k in ("fused_stem_c3", "fused_stage_s1", "fused_stage_s2",
                                       "fused_stage_s3", "fused_stage_s4", "pairwise_min_dist")}
        check(eval_counts == want, f"eval_e2e: the stem, stage 1-4 and addmin kernels once "
                                   f"in each of {n_batches} batches, got {eval_counts}")
        for k, v in eval_counts.items():
            launches[(k, BATCH)] += v
        log(f"  eval_e2e launches (batch {BATCH}): {eval_counts}")
        fps = float(_printed(rf"evaluated {len(samples)} frames in [\d.]+ s after set-up: "
                             r"([\d.]+) frames/s", text))
        pipe = PosePipeline(PipelineConfig(variant=variant, img_size=224, conf_thresh=0.0,
                                           compute_dtype=torch.bfloat16), ycfg,
                            load_yolo_variables(yolo_dir, ycfg),
                            load_model_variables(pose_dir, get_preset(variant, img_size=224)),
                            PoseNetConfig(variant=variant), device=device)
        pipe.fold_backbones(pallas_stem=True, pallas_stages=(1, 2, 3, 4))
        evaluator = ADDEvaluator(models, device=device)
        detected, accs = 0, []
        for start in range(0, len(samples), BATCH):  # eval_e2e's batches and averages
            chunk = samples[start:start + BATCH]
            frames = np.stack([read_png(s.img_path) for s in chunk])
            depths = np.stack([read_png(s.depth_path).astype(np.float32) / 1000.0 for s in chunk])
            K = np.stack([s.cam_K for s in chunk]).astype(np.float32)
            out = pipe(frames, K, depths)
            valid = out["det_valid"].cpu().numpy()
            ids = np.asarray([s.obj_id for s in chunk])
            m = evaluator.eval_metrics(
                out["rotation"], out["translation"],
                np.asarray([Rotation.from_matrix(s.rot_mat).as_quat() for s in chunk], np.float32),
                np.asarray([s.trans_mm / 1000.0 for s in chunk], np.float32),
                np.where(valid, ids, -1))
            detected += int(valid.sum())
            accs.append(m["add_01d_acc"])
        det_rate = detected / len(samples)
        acc = sum(accs) / len(accs) * det_rate
        check(_printed(r"detection rate: ([\d.]+)%", text) == f"{det_rate * 100:.1f}"
              and _printed(r"undetected = incorrect\): ([\d.]+)%", text) == f"{acc:.2f}",
              f"eval_e2e differs from the pipeline in process: detection {det_rate * 100:.1f}%, "
              f"ADD-0.1d {acc:.2f}%")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("  CLI wall seconds on " + smi + ": "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; eval_e2e {fps:.2f} frames/s by the host clock over its {n_batches} batches "
          f"(set-up excluded)")
    return dict(launches), {"secs": secs, "eval_fps": fps, "det_rate": float(det_rate),
                            "add_01d": float(acc)}


def profile_kernels(fn, what: str, unprofiled_ms: float, top: int = 10) -> None:
    """fn() once more under torch.profiler: the card's kernel time by
    kernel, its sum, and that sum over fn's unprofiled time (the busy
    share; the rest is the card waiting for the host). Printed only; where
    the profiler sees no CUDA kernel, it says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels only: a user range (e.g. the optimizer's step) would count its
    # kernels a second time
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    total_us = sum(e.self_device_time_total for e in kernels)
    if not kernels or total_us <= 0:
        log("  profile: not measured (the profiler recorded no CUDA kernel time)")
        return
    log(f"  profile of {what}: {total_us / 1e3:.3f} ms of kernels in {len(kernels)} kinds, "
        f"{sum(e.count for e in kernels)} launches; busy share "
        f"{total_us / 1e3 / unprofiled_ms:.3f} of the unprofiled {unprofiled_ms:.3f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def conv_geometry_check(calls) -> tuple[int, int]:
    """conv_s8s32 on the card against the same call on CPU copies, once for
    each distinct geometry (input shape, kernel shape, stride, padding)
    among the recorded calls: the int32 outputs equal bit for bit. Returns
    (geometries, multiply-adds checked)."""
    from pose6d_tpu_torch.ops import quant

    seen, macs = set(), 0
    for (xq, w, *rest), _, out in calls:
        key = (tuple(xq.shape), tuple(w.shape), *rest)
        if key in seen:
            continue
        seen.add(key)
        want = quant.conv_s8s32(xq.cpu(), w.cpu(), *rest)
        check(torch.equal(out.cpu(), want), f"conv_s8s32 {key}: the card's int32 output "
                                            f"differs from the CPU's")
        macs += out.numel() * w[0].numel()
    return len(seen), macs


def int8_macs(fn) -> int:
    """Multiply-adds of the int8 convolutions that fn() runs (counted by
    spying on conv_s8s32, K unpadded)."""
    from pose6d_tpu_torch.models.yolo import quant as yquant
    from pose6d_tpu_torch.ops import quant

    calls = []
    with spy(quant, "conv_s8s32", calls), spy(yquant, "conv_s8s32", calls):
        fn()
    return sum(out.numel() * args[1][0].numel() for args, _, out in calls)


def cosine(a, b) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def phase_int8(pipe, rng):
    """The int8 rgbd path (see the module docstring, phase 8): calibration,
    3 requests with no wait for the card and no fused-kernel launch, the
    card's int8 convolutions and towers against the CPU's, the int8 towers
    and detector against bf16, and their times beside the bf16 towers' and
    detector's. Returns the last request's outputs and the readings."""
    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.models.posenet_serving import backbone_features
    from pose6d_tpu_torch.models.yolo import quant as yquant
    from pose6d_tpu_torch.ops import quant

    dev, bf16 = pipe.device, torch.bfloat16
    frames, depths = make_requests(rng)
    K = torch.from_numpy(LINEMOD_K).to(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        pipe.quantize_backbones(frames[0], LINEMOD_K, include_detector=True)
    sync(dev)
    log(f"  quantize_backbones (calibration on {BATCH} frames, no depth, detector "
        f"included): {time.perf_counter() - t0:.1f}s")
    reqs = [(torch.from_numpy(f).to(dev), torch.from_numpy(d).to(dev))
            for f, d in zip(frames, depths)]
    pipe(reqs[0][0], K, reqs[0][1])  # warm-up request (cuBLAS set-up), not counted
    sync(dev)

    _build.launch_counts.clear()
    calls, outs = [], []
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")  # any wait for the card raises
    try:
        with spy(quant, "conv_s8s32", calls), spy(yquant, "conv_s8s32", calls):
            outs.append(pipe(reqs[1][0], K, reqs[1][1]))
        for f, d in reqs[2:]:
            outs.append(pipe(f, K, d))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync(dev)
    request_ms = (time.perf_counter() - t0) * 1e3 / N_REQUESTS
    counts = dict(_build.launch_counts)
    check(counts == {}, f"int8 requests launched {counts}: the int8 towers must win over "
                        f"the folded towers' stem and layer1 kernels")
    for out in outs:
        for k in ("rotation", "translation", "bbox_xywh"):
            check(bool(torch.isfinite(out[k]).all()), f"int8 {k} not finite")
        check(tuple(out["rotation"].shape) == (BATCH, 4), "int8 rotation shape")
        norms = torch.linalg.norm(out["rotation"], dim=-1)
        check(bool(((norms - 1).abs() < 1e-3).all()), f"int8 rotation norms {norms.tolist()}")
    n_geo, geo_macs = conv_geometry_check(calls)
    log(f"  {N_REQUESTS} requests with no wait for the card and no kernel launch; "
        f"conv_s8s32 on the card bit-equal to the CPU's for all {n_geo} distinct conv "
        f"geometries of the towers and the detector ({len(calls)} calls a request, "
        f"{geo_macs / 1e9:.2f} G multiply-adds checked)")
    log(f"  smoke reading, not a throughput: {request_ms:.3f} ms a request, host clock over "
        f"the {N_REQUESTS} requests (the first spied), {BATCH / request_ms * 1e3:.1f} frames/s")
    del calls

    readings = {"request_ms": request_ms}
    with torch.inference_mode():
        f, d = reqs[1]
        st = pipe.crop_stage(f, K.expand(BATCH, 3, 3), d)
        towers = pipe.posenet.tower_inputs(st["inputs"]["rgb"], st["inputs"]["depth"])
        for name, x in towers.items():
            q, fold = pipe._quantized[name], pipe._folded[name]
            got = backbone_features(pipe.posenet, name, x, bf16, quantized=q)
            cpu_q = {k: {f: v.cpu() for f, v in e.items()} for k, e in q.items()}
            want = quant.int8_resnet50_forward(cpu_q, x.cpu(), bf16).float()
            rel = ((got.cpu() - want).norm() / want.norm()).item()
            check(rel <= INT8_FEAT_REL_L2,
                  f"{name}: int8 features, card vs CPU rel L2 {rel:.3g} > {INT8_FEAT_REL_L2}")
            cos = cosine(got, backbone_features(pipe.posenet, name, x, bf16, fold))
            check(cos >= INT8_MIN_COS, f"{name}: int8 vs folded bf16 cosine {cos:.4f}")
            readings[name] = {"card_vs_cpu_rel_l2": rel, "cos_vs_bf16": cos}
        canvas = f.to(bf16) / 255.0
        int8_maps = pipe._yolo_int8(canvas)
        bf16_maps = pipe.yolo(canvas)
        det_cos = cosine(torch.cat([t.flatten() for pair in int8_maps for t in pair]),
                         torch.cat([t.flatten() for pair in bf16_maps for t in pair]))
        check(det_cos >= INT8_MIN_COS, f"int8 vs bf16 detector maps cosine {det_cos:.4f}")
        readings["detector"] = {"cos_vs_bf16": det_cos}
        log(f"  int8 vs CPU and vs bf16: {readings}")
        readings["times"] = int8_times(pipe, towers, canvas)
    return outs[-1], readings


def int8_times(pipe, towers, canvas) -> list:
    """The card's times (paced_ms) of the int8 towers (batch 8 and 32: the
    request's crops, and four copies of them) beside the folded bf16 tower
    through the stem and layer1 kernels and through cuDNN alone, and of the
    int8 detector beside the bf16 one at batch 8, with the host's enqueue
    time of each; each beside its bound: operations (the int8 convs'
    multiply-adds, twice) over the int8 or bf16 peak, or bytes (input,
    weights, output once) over the memory rate."""
    from pose6d_tpu_torch.ops import quant

    bf16, rows = torch.bfloat16, []
    for name, x8 in towers.items():
        q, fold = pipe._quantized[name], pipe._folded[name]
        w_int8 = sum(nbytes(e["w"]) for e in q.values())
        w_bf16 = sum(nbytes(e["w"]) for e in fold["tree"].values())
        for x in (x8, torch.cat([x8] * 4)):
            macs = int8_macs(lambda: quant.int8_resnet50_forward(q, x, bf16))
            out_bytes = x.shape[0] * 2048 * 2
            runs = {
                "int8": (lambda: quant.int8_resnet50_forward(q, x, bf16), torch.int8, w_int8),
                "bf16_kernels": (lambda: quant.folded_resnet50_forward(
                    fold["tree"], x, bf16, pallas_l1=fold["pallas_l1"],
                    pallas_stem=fold["pallas_stem"]), bf16, w_bf16),
                "bf16_cudnn": (lambda: quant.folded_resnet50_forward(fold["tree"], x, bf16),
                               bf16, w_bf16)}
            for kind, (fn, dtype, w_bytes) in runs.items():
                b_ms, b_by = bound_ms(nbytes(x) + w_bytes + out_bytes, 2.0 * macs, dtype)
                ms, host_ms = paced_ms(fn)
                rows.append({"what": f"{name} {kind}", "batch": x.shape[0], "ms": ms,
                             "host_ms": host_ms, "bound_ms": b_ms, "bound_by": b_by})
    macs = int8_macs(lambda: pipe._yolo_int8(canvas))
    q = pipe._quantized["__yolo__"]
    n_out = sum(b.numel() + c.numel() for b, c in pipe._yolo_int8(canvas))
    w_int8 = sum(nbytes(e["w"]) for e in q.values())
    w_bf16 = sum(p.numel() * 2 for p in pipe.yolo.parameters())
    for kind, fn, dtype, w_bytes, out_bytes in (
            ("int8", lambda: pipe._yolo_int8(canvas), torch.int8, w_int8, 4 * n_out),
            ("bf16", lambda: pipe.yolo(canvas), bf16, w_bf16, 2 * n_out)):
        b_ms, b_by = bound_ms(nbytes(canvas) + w_bytes + out_bytes, 2.0 * macs, dtype)
        ms, host_ms = paced_ms(fn)
        rows.append({"what": f"detector {kind}", "batch": canvas.shape[0], "ms": ms,
                     "host_ms": host_ms, "bound_ms": b_ms, "bound_by": b_by})
    for r in rows:
        log(f"  {r['what']} at batch {r['batch']}: ms {r['ms']:.4f} (the card's, CUDA "
            f"events; host enqueue {r['host_ms']:.3f} ms)  bound_ms {r['bound_ms']:.5f} "
            f"({r['bound_by']})")
    x32 = torch.cat([towers["rgb_backbone"]] * 4)
    q = pipe._quantized["rgb_backbone"]
    ms = next(r["ms"] for r in rows
              if r["what"] == "rgb_backbone int8" and r["batch"] == x32.shape[0])
    profile_kernels(lambda: quant.int8_resnet50_forward(q, x32, bf16),
                    f"the int8 rgb tower at batch {x32.shape[0]}", ms, top=8)
    return rows


# ------------------------------------------------- data and head parallelism

MESH_TRAIN_BATCH = 64   # the (2, 1) step's global batch: 32 a rank, the gather's and addmin's row
MESH_SERVE_FRAMES = 16  # the (2, 1) request: 8 frames a rank, the stem's and layer1's row
MESH_STORE_FRAMES = 64  # the gloo ranks' resident split (640x480)
MESH_TREE_FRAMES = 40   # frames per folder of the mesh Trainer's tree: 32 train, 4 val, 4 test
MESH_NCCL_STEPS = 2     # steps of the NCCL world-of-1 epoch, at batch 32
STEP_F64_RTOL = 1e-10   # mesh vs one-process step in float64: the loss, each gradient leaf
STEP_GRAD_RTOL = 1e-4   # f32: each gradient leaf's rel L2 from the float64 step, or ...
STEP_NOISE_X = 1.5      # ... this many times the one-process f32 step's own, where larger
                        # (mesh / one-process read 1.00 on the worst leaves, H100 80GB HBM3)
STEP_LOSS_RTOL = 1e-5   # f32: the loss, mesh vs one-process


def tensors_digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def mesh_step(store, meta, batch: int, mesh, device, dtype=torch.float32, timed: bool = False):
    """One rgbd train step (TrainConfig's defaults, `batch` global, dropout
    and augmentation on) from the seeded init of phase 10, the module in
    `dtype`, on the resident `store`, on `mesh` or without one. Returns
    (state, metrics, gradients as the optimizer saw them, ms of a second
    step by CUDA events when `timed`, else None)."""
    from pose6d_tpu_torch.parallel import shard_state
    from pose6d_tpu_torch.train import loop as tl

    cfg = tl.TrainConfig(variant="rgbd", batch_size=batch)
    state = tl.create_train_state(cfg, seed=SEED + 7, device=device)
    state.model.to(dtype)
    if mesh is not None:
        state = shard_state(state, mesh)
    step = tl.make_train_step(cfg, device_preprocess=True, frame_hw=(store.frame_h, store.frame_w),
                              mesh=mesh)
    g = torch.Generator(device=device).manual_seed(SEED)
    state, metrics = step(state, store.rgb_frames, store.depth_frames, meta, g)
    grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
    ms = None
    if timed:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, store.rgb_frames, store.depth_frames, meta, g)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    return state, {k: float(v) for k, v in metrics.items()}, grads, ms


def leaf_errors(got: dict, want: dict) -> dict:
    """{leaf: relative L2 error of got's gradient against want's}; a leaf
    that is zero in want (a residual branch behind a zero-initialized BN
    scale) reads |got| relative to the whole gradient's norm."""
    total = sum(w.double().norm().item() ** 2 for w in want.values()) ** 0.5
    out = {}
    for k, w in want.items():
        d = (got[k].double().cpu() - w.double()).norm().item()
        n = w.double().norm().item()
        out[k] = d / n if n else d / total
    return out


def hold_step(ref: dict, got: dict) -> dict:
    """A mesh step's gathered gradients and losses (got: {"f32", "f64"},
    each {"loss", "grads"}) against the one-process steps' (ref, CPU
    copies): in float64 the loss and every leaf within STEP_F64_RTOL; in
    f32 the loss within STEP_LOSS_RTOL, and every leaf within STEP_GRAD_RTOL
    of the float64 step or within STEP_NOISE_X times the one-process f32
    step's own distance from it, where that is larger (a leaf summed over
    millions of cancelling terms, the stems' weights, strays ~1e-3 in f32
    whatever the order). Returns the worst float64 error and the worst f32
    leaf's (its error, the one-process f32 error)."""
    r64, g64 = ref["f64"], got["f64"]
    check(set(g64["grads"]) == set(r64["grads"]), "the mesh step's leaves are not the one-process ones")
    check(abs(g64["loss"] - r64["loss"]) <= STEP_F64_RTOL * abs(r64["loss"]),
          f"float64 mesh step loss {g64['loss']} vs one-process {r64['loss']}")
    e64 = leaf_errors(g64["grads"], r64["grads"])
    worst64 = max(e64.items(), key=lambda kv: kv[1])
    check(worst64[1] <= STEP_F64_RTOL, f"float64 mesh step gradient {worst64[0]}: rel L2 err "
                                       f"{worst64[1]:.3g}")
    r32, g32 = ref["f32"], got["f32"]
    check(abs(g32["loss"] - r32["loss"]) <= STEP_LOSS_RTOL * abs(r32["loss"]),
          f"f32 mesh step loss {g32['loss']} vs one-process {r32['loss']}")
    mesh_err = leaf_errors(g32["grads"], r64["grads"])
    one_err = leaf_errors(r32["grads"], r64["grads"])
    top = sorted(mesh_err, key=lambda k: -mesh_err[k])[:4]
    log("    f32 leaves farthest from the float64 step (mesh / one-process): "
        + ", ".join(f"{k} {mesh_err[k]:.3g} / {one_err[k]:.3g}" for k in top))
    over = [k for k in mesh_err if mesh_err[k] > STEP_GRAD_RTOL]
    if over:
        k = max(over, key=lambda k: mesh_err[k] / one_err[k] if one_err[k] else float("inf"))
        log(f"    of the {len(over)} f32 leaves above {STEP_GRAD_RTOL:g}, the largest ratio "
            f"mesh / one-process: {k} {mesh_err[k]:.3g} / {one_err[k]:.3g}")
    for k, err in mesh_err.items():
        bound = max(STEP_GRAD_RTOL, STEP_NOISE_X * one_err[k])
        check(err <= bound, f"f32 mesh step gradient {k}: rel L2 err {err:.3g} from the float64 "
                            f"step, one-process f32 {one_err[k]:.3g}")
    return {"f64": worst64[1], "f32": (mesh_err[top[0]], one_err[top[0]])}


def eval_batch(store, meta, dev) -> dict:
    """A global metadata batch expanded through the gather kernel 32 rows
    at a time (the gather's row) into the global batch the eval step
    takes, every row valid."""
    from pose6d_tpu_torch.train import loop as tl

    meta = tl.to_device(meta, dev)
    n = len(meta["idx"])
    parts = [tl.expand_device_batch(store.rgb_frames, store.depth_frames,
                                    {k: v[i:i + 32] for k, v in meta.items()}, 224,
                                    (store.frame_h, store.frame_w)) for i in range(0, n, 32)]
    batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    batch["valid"] = torch.ones(n, dtype=torch.bool, device=dev)
    return batch


def mesh_rank(rank: int, job: dict) -> None:
    """One of the two gloo ranks on cuda:0 (phase_mesh): the (2, 1) and
    (1, 2) rgbd train steps against the one-process steps, each with an
    eval batch; the folded rgbd pipeline sharded on both meshes against the
    unsharded one; Trainer(mesh=(2, 1)).fit for an epoch and a second
    Trainer resuming it. Writes its readings and launch counts (by kernel
    and batch) to job["out"] % rank."""
    import torch.distributed as dist

    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.data.device_pipeline import DeviceFrameStore
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.models.posenet import PoseNetConfig
    from pose6d_tpu_torch.models.yolo.model import YoloConfig
    from pose6d_tpu_torch.parallel import (gather_params, gather_state, make_mesh, param_spec,
                                           shard_batch)
    from pose6d_tpu_torch.train import loop as tl
    from pose6d_tpu_torch.train.trainer import Trainer

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{job['init']}", world_size=2, rank=rank)
    counts, out = collections.Counter(), {"rank": rank}
    secs, t0 = {"start-up": time.time() - job["t0"]}, time.perf_counter()

    def tally(batch: int) -> None:
        for k, v in _build.launch_counts.items():
            counts[(k, batch)] += v
        _build.launch_counts.clear()

    try:
        meshes = {shape: make_mesh(shape) for shape in ((2, 1), (1, 2))}
        store = DeviceFrameStore(*job["store"], img_size=224, flavor="rgbd", device=dev)
        models = seeded_object_models(np.random.default_rng(SEED + 17), dev)
        for shape, (meta, batch, ref) in job["train"].items():
            mesh = meshes[shape]
            _build.launch_counts.clear()
            state, m64, grads, _ = mesh_step(store, meta, batch, mesh, dev, torch.float64)
            got = {"f64": {"loss": m64["loss"], "grads": gather_params(grads, mesh)}}
            del state, grads
            state, metrics, grads, ms = mesh_step(store, meta, batch, mesh, dev, timed=True)
            tally(batch // mesh.dp)
            got["f32"] = {"loss": metrics["loss"], "grads": gather_params(grads, mesh)}
            res = {"ms": ms, "loss": metrics["loss"]}
            if rank == 0:
                res["worst"] = hold_step(ref, got)
            del got
            sd = state.model.state_dict()
            res["digest"] = tensors_digest(sd.values())
            res["replicated"] = tensors_digest(
                [v for k, v in sd.items() if param_spec(k, v, mesh.tp > 1) is None])
            ev = eval_batch(store, meta, dev)
            tally(32)
            m = tl.make_eval_step(tl.TrainConfig(variant="rgbd", batch_size=batch), models,
                                  mesh)(state, shard_batch(ev, mesh))
            tally(batch // mesh.dp)
            check(all(bool(torch.isfinite(v).all()) for v in m.values()),
                  f"{shape} eval metrics not finite")
            check(int(m["count"]) == batch and tuple(m["pred_rot"].shape) == (batch, 4),
                  f"{shape} eval: count {int(m['count'])}, pred_rot {tuple(m['pred_rot'].shape)}")
            res["eval_add"] = float(m["add_mean"])
            out[f"train {shape}"] = res
            del state, grads, sd, ev, m
            torch.cuda.empty_cache()
            secs[f"steps {shape}"], t0 = time.perf_counter() - t0, time.perf_counter()

        serve = job["serve"]
        K = torch.from_numpy(LINEMOD_K).to(dev)
        for shape, (frames, depths, ref) in serve["requests"].items():
            pipe = PosePipeline(PipelineConfig(variant="rgbd", img_size=224,
                                               compute_dtype=torch.bfloat16),
                                YoloConfig(), serve["yolo"], serve["pose"],
                                PoseNetConfig(variant="rgbd"), device=dev)
            pipe.fold_backbones(pallas_stem=True, pallas_layer1=True).shard(meshes[shape])
            f, d = torch.from_numpy(frames).to(dev), torch.from_numpy(depths).to(dev)
            pipe(f, K, d)  # warm-up (cuDNN set-up), not counted
            _build.launch_counts.clear()
            with torch.inference_mode():
                got = pipe(f, K, d)
            sync(dev)
            tally(len(frames) // meshes[shape].dp)
            check(torch.equal(got["bbox_xywh"].cpu(), ref["bbox_xywh"]),
                  f"{shape} shard: boxes differ from the unsharded pipeline's")
            diff = max((got[k].float().cpu() - ref[k]).abs().max().item()
                       for k in ("rotation", "translation"))
            check(diff <= POSE_ATOL, f"{shape} shard: poses differ by {diff:.3g} > {POSE_ATOL}")
            out[f"serve {shape}"] = {"pose_diff": diff, "digest": tensors_digest(
                [got[k] for k in ("rotation", "translation", "bbox_xywh")])}
            del pipe, got
            torch.cuda.empty_cache()
        secs["serving"], t0 = time.perf_counter() - t0, time.perf_counter()

        tree = job["tree"]
        cfg = get_preset("rgbd", batch_size=MESH_TRAIN_BATCH)
        digests = []
        for resume in (False, True):
            _build.launch_counts.clear()
            tr = Trainer(cfg, tree["data"], tree["models"], tree["save"], seed=SEED,
                         num_workers=2, mesh=meshes[(2, 1)], device_preprocess=True, device=dev)
            try:
                if resume:
                    check(tr.try_resume() and tr.start_epoch == 1,
                          f"the mesh Trainer did not resume its epoch ({tr.start_epoch})")
                else:
                    t0 = time.perf_counter()
                    tr.fit(epochs=1)
                    out["fit_s"] = time.perf_counter() - t0
                full = gather_state(tr.state)
                digests.append(tensors_digest(
                    list(full["model"].values())
                    + [v for s in full["optimizer"]["state"].values() for v in s.values()]))
            finally:
                tr.close()
            tally(MESH_TRAIN_BATCH // 2)
        check(digests[0] == digests[1], "the resumed mesh Trainer's state differs")
        secs["Trainer"] = time.perf_counter() - t0
        out["counts"], out["secs"] = dict(counts), secs
        dist.barrier()
        torch.save(out, job["out"] % rank)
    finally:
        dist.destroy_process_group()


def shard_bf16_float(pipe, states: dict, mesh, f, K, d) -> None:
    """Phase 14 (a)'s unfolded case: a pipeline of `pipe`'s config and of
    the weights in states ({"yolo", "pose"}: state_dicts) built without
    pose_cfg, so that its towers run in the compute dtype (bf16, the JAX
    pipeline's default), served without a mesh and then sharded on `mesh`.
    Checks the towers' conv outputs bf16 by hook in both runs, no kernel
    launched by either, and the sharded outputs bit-equal to the unsharded
    ones."""
    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.infer.pipeline import PosePipeline

    upipe = PosePipeline(pipe.cfg, pipe.yolo_cfg, states["yolo"], states["pose"],
                         device=f.device)
    check(upipe.pose_cfg.dtype == torch.bfloat16,
          f"NCCL (1, 1) unfolded shard: the default towers' dtype {upipe.pose_cfg.dtype}")
    towers = len(upipe.posenet.towers)
    outs = []
    with torch.inference_mode():
        upipe(f, K, d)  # warm-up (cuDNN set-up), not counted
        for m in (None, mesh):
            if m is not None:
                upipe.shard(m)
            seen, hooks = tower_conv_dtypes(upipe)
            sync(f.device)
            _build.launch_counts.clear()
            outs.append(upipe(f, K, d))
            sync(f.device)
            for h in hooks:
                h.remove()
            check(seen == [torch.bfloat16] * towers,
                  f"NCCL (1, 1) unfolded shard (mesh {m is not None}): tower conv outputs {seen}")
            check(not _build.launch_counts,
                  f"NCCL (1, 1) unfolded shard: launched {dict(_build.launch_counts)}")
    for k in ("rotation", "translation", "bbox_xywh", "class_id", "det_score"):
        check(torch.equal(outs[1][k], outs[0][k]), f"NCCL (1, 1) unfolded bf16 shard: {k} differs")


def phase_mesh(store, pipe, frames, depths, smi: str):
    """Data and head parallelism (parallel/) on the one card.
    (a) A world of one over NCCL, mesh (1, 1): a MESH_NCCL_STEPS-step
        make_train_epoch on phase 10's store and the folded rgbd pipeline
        (stem and layer1 kernels) sharded on it, each bit-equal to the same
        run without a mesh (cuDNN deterministic for the epochs); then the
        unfolded pipeline with its default bf16 towers sharded on it
        (shard_bf16_float), bit-equal to itself without a mesh, no kernel.
    (b) Two ranks spawned on cuda:0 over gloo (NCCL refuses two ranks on one
        card), at full width: mesh_rank, against one-process references
        made here first (each step in f32 and in float64; hold_step). Returns
        the launch counts of (a)'s mesh runs and of both ranks, by (kernel,
        batch), and the readings."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.data.device_pipeline import DeviceFrameStore
    from pose6d_tpu_torch.parallel import make_mesh, shard_state
    from pose6d_tpu_torch.train import loop as tl

    dev = store.device
    rng = np.random.default_rng(SEED + 18)
    counts, out = collections.Counter(), {}
    K = torch.from_numpy(LINEMOD_K).to(dev)

    # (b)'s serving references and weights, while `pipe` is unsharded:
    # BATCH frames a call, each rank's batch
    frames16 = rng.integers(0, 256, (MESH_SERVE_FRAMES, FRAME_H, FRAME_W, 3), dtype=np.uint8)
    depths16 = rng.uniform(0.3, 1.5, (MESH_SERVE_FRAMES, FRAME_H, FRAME_W)).astype(np.float32)
    requests = {}
    with torch.inference_mode():
        for shape, n in (((2, 1), MESH_SERVE_FRAMES), ((1, 2), BATCH)):
            parts = [pipe(torch.from_numpy(frames16[i:i + BATCH]).to(dev), K,
                          torch.from_numpy(depths16[i:i + BATCH]).to(dev))
                     for i in range(0, n, BATCH)]
            ref = {k: torch.cat([p[k] for p in parts]).float().cpu()
                   for k in ("rotation", "translation", "bbox_xywh")}
            requests[shape] = (frames16[:n], depths16[:n], ref)
    serve = {"yolo": {k: v.cpu() for k, v in pipe.yolo.state_dict().items()},
             "pose": {k: v.cpu() for k, v in pipe.posenet.state_dict().items()},
             "requests": requests}

    # (a) NCCL, world of one
    t0 = time.perf_counter()
    init = os.path.join(_build.BUILD_DIR, "mesh_nccl_rendezvous")
    if os.path.exists(init):
        os.remove(init)
    dist.init_process_group("nccl", init_method=f"file://{init}", world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1))
        cfg = tl.TrainConfig(variant="rgbd")
        meta, _ = store.epoch_meta(cfg.batch_size, rng)
        meta = {k: v[:MESH_NCCL_STEPS] for k, v in meta.items()}
        runs = []
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            for m in (None, mesh):
                state = tl.create_train_state(cfg, seed=SEED + 7, device=dev)
                if m is not None:
                    state = shard_state(state, m)
                epoch = tl.make_train_epoch(cfg, frame_hw=(store.frame_h, store.frame_w), mesh=m)
                g = torch.Generator(device=dev).manual_seed(SEED)
                sync(dev)
                _build.launch_counts.clear()
                state, losses = epoch(state, store.rgb_frames, store.depth_frames, meta, g)
                sync(dev)
                if m is not None:
                    counts.update({(k, cfg.batch_size): v for k, v in _build.launch_counts.items()})
                runs.append((losses.cpu(), {k: v.cpu() for k, v in state.model.state_dict().items()}))
                del state
        check(torch.equal(runs[0][0], runs[1][0]), f"NCCL (1, 1) epoch losses {runs[1][0].tolist()} "
                                                   f"vs {runs[0][0].tolist()} without a mesh")
        differ = [k for k in runs[0][1] if not torch.equal(runs[0][1][k], runs[1][1][k])]
        check(not differ, f"NCCL (1, 1) epoch: {len(differ)} tensors differ, e.g. {differ[:3]}")
        check(counts[("gather_rows_u32", 32)] == 2 * MESH_NCCL_STEPS,
              f"NCCL (1, 1) epoch launches {dict(counts)}")
        del runs
        f, d = torch.from_numpy(frames).to(dev), torch.from_numpy(depths).to(dev)
        with torch.inference_mode():
            want = pipe(f, K, d)
            pipe.shard(mesh)
            _build.launch_counts.clear()
            got = pipe(f, K, d)
            sync(dev)
        counts.update({(k, len(frames)): v for k, v in _build.launch_counts.items()})
        for k in ("rotation", "translation", "bbox_xywh", "class_id", "det_score"):
            check(torch.equal(got[k], want[k]), f"NCCL (1, 1) shard: {k} differs")
        check(_build.launch_counts["fused_stem_c3"] == 1 and _build.launch_counts["fused_layer1"] == 2,
              f"NCCL (1, 1) shard launches {dict(_build.launch_counts)}")
        shard_bf16_float(pipe, serve, mesh, f, K, d)
    finally:
        dist.destroy_process_group()
    out["nccl_s"] = time.perf_counter() - t0
    log(f"  (a) NCCL world of 1, mesh (1, 1): {MESH_NCCL_STEPS}-step rgbd epoch at batch 32 and "
        f"the folded rgbd pipeline sharded, both bit-equal to the runs without a mesh; the "
        f"unfolded pipeline with its default bf16 towers sharded, bit-equal, no kernel "
        f"({out['nccl_s']:.1f}s)")

    # (b) gloo, two ranks on the one card: the references first
    t0 = time.perf_counter()
    arrays = seeded_split_arrays(rng, MESH_STORE_FRAMES)
    mstore = DeviceFrameStore(*arrays, img_size=224, flavor="rgbd", device=dev)
    train = {}
    for shape, batch in (((2, 1), MESH_TRAIN_BATCH), ((1, 2), MESH_TRAIN_BATCH // 2)):
        meta = mstore.meta_batch(rng.integers(0, MESH_STORE_FRAMES, batch), rng)
        ref = {}
        for key, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            state, metrics, grads, ms = mesh_step(mstore, meta, batch, None, dev, dtype,
                                                  timed=key == "f32")
            ref[key] = {
                "loss": metrics["loss"],
                "grads": {k: v.cpu().share_memory_() for k, v in grads.items()}}
            if ms is not None:
                out[f"one-process {batch}"] = ms
            del state, grads
        train[shape] = (meta, batch, ref)
    del mstore
    root = os.path.join(_build.BUILD_DIR, "smoke_mesh_linemod")
    shutil.rmtree(root, ignore_errors=True)
    tree = write_linemod_tree(root, rng, frames=MESH_TREE_FRAMES)
    job = {"init": os.path.join(_build.BUILD_DIR, "mesh_gloo_rendezvous"),
           "out": os.path.join(_build.BUILD_DIR, "mesh_rank%d.pt"),
           "store": arrays, "train": train,
           "serve": serve,
           "tree": {"data": tree["data"], "models": tree["models"],
                    "save": os.path.join(root, "weights_rgbd_mesh")}}
    if os.path.exists(job["init"]):
        os.remove(job["init"])
    torch.cuda.empty_cache()
    out["gloo_prep_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    job["t0"] = time.time()
    try:
        mp.spawn(mesh_rank, args=(job,), nprocs=2, join=True)
        ranks = [torch.load(job["out"] % r, weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["gloo_s"] = time.perf_counter() - t0
    for shape in ((2, 1), (1, 2)):
        a, b = (r[f"train {shape}"] for r in ranks)
        if shape == (2, 1):
            check(a["digest"] == b["digest"], "(2, 1) step: the data replicas differ")
        check(a["replicated"] == b["replicated"], f"{shape} step: the replicated tensors differ")
        check(a["loss"] == b["loss"], f"{shape} step: the ranks' losses differ")
        out[f"gloo {shape}"] = a
        sa, sb = (r[f"serve {shape}"] for r in ranks)
        check(sa["digest"] == sb["digest"], f"{shape} shard: the ranks' outputs differ")
        out[f"serve {shape}"] = sa
    for r in ranks:
        c = r["counts"]
        for kernel, batch in (("gather_rows_u32", 32), ("pairwise_min_dist", 32),
                              ("fused_stem_c3", BATCH), ("fused_layer1", BATCH)):
            check(c.get((kernel, batch), 0) > 0, f"rank {r['rank']} launched no {kernel} at "
                                                  f"{batch}: {c}")
        counts.update(c)
    out["fit_s"] = ranks[0]["fit_s"]
    for shape in ((2, 1), (1, 2)):
        g = out[f"gloo {shape}"]
        log(f"  (b) gloo {shape} rgbd step at global batch {train[shape][1]}: float64 within "
            f"{g['worst']['f64']:.3g} rel L2 of the one-process step; f32 worst leaf "
            f"{g['worst']['f32'][0]:.3g} from the float64 step (one-process f32: "
            f"{g['worst']['f32'][1]:.3g}); replicas equal; smoke reading: {g['ms']:.1f} ms/step "
            f"(gloo, two ranks on one card) vs {out[f'one-process {train[shape][1]}']:.1f} ms "
            f"one-process (CUDA events)")
        log(f"  (b) gloo {shape} folded rgbd shard on {len(requests[shape][0])} frames: poses "
            f"within {out[f'serve {shape}']['pose_diff']:.3g} of the unsharded pipeline, "
            f"boxes equal")
    log(f"  (b) Trainer(mesh=(2, 1)).fit(epochs=1) at batch {MESH_TRAIN_BATCH} on a tree of "
        f"{tree['frames']} frames: {out['fit_s']:.1f}s, resumed bit for bit; references "
        f"{out['gloo_prep_s']:.1f}s, ranks {out['gloo_s']:.1f}s (rank 0: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in ranks[0]["secs"].items()) + ")")
    return counts, out


LEARN_BATCH, LEARN_STEPS, LEARN_TIMED_FROM = 8, 60, 10  # the learning test's; steps timed after 10
LEARN_IMG = 224        # the test's 64 at full width
LEARN_GEO_MAX = 1.6    # rad, after the steps (random rotations: ~2.2)
PARITY_ARGS = ["--objects", 2, "--frames", 60, "--epochs", 2, "--variants", "rgbd_geometric",
               "--rot-head-wide"]
PARITY_RUN = "rgbd_geometric_widehead"


def learning_run(init: dict, compute_dtype: str, device) -> dict:
    """tests/test_torch_learning.py at full width: the rgb variant at 224
    from the state_dict `init`, LEARN_STEPS steps on one fixed batch of
    LEARN_BATCH distinct rotations (seeded), lr 3e-4, augmentation off,
    each step's generator seeded alike; towers in compute_dtype (bf16:
    autocast, as parity_run --bf16). The loss must more than halve and the
    geodesic distance afterwards (f32 eval) stay under LEARN_GEO_MAX.
    Returns the losses, the distance and ms/step (CUDA events over the
    steps after LEARN_TIMED_FROM)."""
    from scipy.spatial.transform import Rotation

    from pose6d_tpu_torch.geometry.quat import quat_normalize
    from pose6d_tpu_torch.losses.pose_loss import geodesic_distance
    from pose6d_tpu_torch.models.posenet import PoseNet
    from pose6d_tpu_torch.ops.augment import AugmentConfig, eval_preprocess
    from pose6d_tpu_torch.train import loop as tl

    cfg = tl.TrainConfig(variant="rgb", img_size=LEARN_IMG, batch_size=LEARN_BATCH,
                         learning_rate=3e-4, compute_dtype=compute_dtype,
                         augment=AugmentConfig(brightness=0.0, contrast=0.0, saturation=0.0,
                                               hue=0.0, grayscale_p=0.0, erase_p=0.0))
    with torch.device("meta"):
        model = PoseNet(tl.pose_config(cfg))
    model = model.to_empty(device="cpu")
    model.load_state_dict(init, strict=True)
    state = tl.create_train_state(cfg, model=model, device=device)
    step = tl.make_train_step(cfg)
    rng = np.random.default_rng(SEED + 19)
    batch = tl.to_device({
        "rgb": rng.uniform(0, 1, size=(LEARN_BATCH, LEARN_IMG, LEARN_IMG, 3)).astype(np.float32),
        "quat": Rotation.random(LEARN_BATCH, random_state=1).as_quat().astype(np.float32),
        "trans": np.tile(np.array([[0, 0, 0.8]], np.float32), (LEARN_BATCH, 1)),
        "obj_id": np.zeros(LEARN_BATCH, np.int32), "valid": np.ones(LEARN_BATCH, bool)}, device)
    losses = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(LEARN_STEPS):
        if i == LEARN_TIMED_FROM:
            start.record()
        state, m = step(state, batch, torch.Generator(device=device).manual_seed(42))
        losses.append(m["loss"])
    end.record()
    end.synchronize()
    losses = torch.stack(losses).cpu().numpy()
    model = state.model.eval()
    with torch.no_grad():
        pred_rot, _ = model(rgb=eval_preprocess(batch["rgb"]))
    geo = float(geodesic_distance(pred_rot, quat_normalize(batch["quat"])))
    what = f"learning {compute_dtype}"
    check(bool(np.isfinite(losses).all()), f"{what}: losses not finite: {losses}")
    check(losses[-1] < 0.5 * losses[0], f"{what}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
                                         f"not below half")
    check(geo < LEARN_GEO_MAX, f"{what}: geodesic {geo:.3f} rad after {LEARN_STEPS} steps")
    return {"losses": losses, "geo": geo,
            "ms_step": start.elapsed_time(end) / (LEARN_STEPS - LEARN_TIMED_FROM)}


def phase_learning(smi: str, device: str = "cuda"):
    """The port learns, on the card: learning_run in f32 and in bf16 from
    one seeded init (posenet.flax_init_, SEED); then cli.parity_run in this
    process (run_cli) at PARITY_ARGS, the fixture cut to 2 objects x 60
    frames and 2 epochs at full width (224, batch 32, the train split
    resident): results.json holds the run, metrics.csv 2 rows of finite
    values, and the gather (RGB and depth words, per step) and addmin
    (once per val batch: rgbd_geometric evaluates its pinhole translation
    once) kernels ran, counted from 0 just before the run. Its workdir
    under _build/ is deleted at the end. parity_run runs on its default
    device, the card; `device` is that of the learning runs. Returns
    {(kernel, 32): launches} and the readings."""
    import csv

    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig, flax_init_

    dev = torch.device(device)
    init = flax_init_(PoseNet(PoseNetConfig(variant="rgb", img_size=LEARN_IMG)), SEED).state_dict()
    runs = {dt: learning_run(init, dt, dev) for dt in ("float32", "bfloat16")}
    del init
    for dt, r in runs.items():
        log(f"  learning {dt}: loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} in "
            f"{LEARN_STEPS} steps, geodesic {r['geo']:.3f} rad, {r['ms_step']:.3f} ms/step "
            f"(CUDA events, steps {LEARN_TIMED_FROM + 1}-{LEARN_STEPS}) on {smi}")

    wd = os.path.join(_build.BUILD_DIR, "smoke_parity")
    shutil.rmtree(wd, ignore_errors=True)
    try:
        _build.launch_counts.clear()
        text, secs = run_cli("parity_run", ["--workdir", wd] + PARITY_ARGS)
        counts = dict(_build.launch_counts)
        results = json.load(open(os.path.join(wd, "results.json")))
        check(list(results) == [PARITY_RUN], f"parity_run results: {list(results)}")
        with open(os.path.join(wd, f"weights_{PARITY_RUN}", "metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == 2 and all(np.isfinite(float(v)) for r in rows for v in r.values()),
              f"parity_run metrics.csv: {rows}")
        n_frames = 2 * 60
        steps = 2 * (n_frames * 8 // 10 // 32)   # the train split's full batches, 2 epochs
        val_batches = 2 * -(-(n_frames // 10) // 32)
        want = {"gather_rows_u32": 2 * steps, "pairwise_min_dist": val_batches}
        check(counts == want, f"parity_run launches {counts}, expected {want}")
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    log(f"  parity_run {' '.join(map(str, PARITY_ARGS))}: {secs:.1f} s, val ADD-0.1d "
        + " / ".join(f"{float(r['val_acc']):.2f}" for r in rows) + "% by epoch; launches "
        + ", ".join(f"{k}@32 {v}" for k, v in sorted(counts.items())))
    return {(k, 32): v for k, v in counts.items()}, {"runs": runs, "parity_s": secs}


# phase 16: per row, the fused-kernel wrappers one request launches, and the
# csrc kernels its posenet range must show in the trace
TRACE_EXPECT = {
    "rgb": ({}, ()),
    "rgb_f32": ({}, ()),
    "rgbd": ({}, ()),
    "rgbd_folded": ({"fused_stem_c3": 1, "fused_stem_c1": 1, "fused_layer1": 2},
                    ("stem_tc_kernel", "wgmma_gemm_kernel")),
    "rgbd_geometric_folded": ({"fused_stem_c3": 1,
                               **{f"fused_stage_s{k}": 1 for k in (1, 2, 3, 4)}},
                              ("stem_tc_kernel", "wgmma_gemm_kernel")),
    "rgb_maxobj4": ({"fused_stem_c3": 1, "fused_layer1": 1},
                    ("stem_tc_kernel", "wgmma_gemm_kernel")),
    "rgbd_int8": ({}, ()),
}


def phase_trace(smi: str):
    """The request trace (ops/profile_pipeline.py) in this process: every
    row at BATCH and rgbd and rgbd folded at TRACE_BIG_BATCH (windows of
    TRACE_WINDOW, readings of TRACE_REPS, generator SEED + 19), then the
    eval_e2e batch. Checks each run's full prefix equal to __call__ bit for
    bit on the card, its request free of waits for the card, the fused
    kernels it launches (TRACE_EXPECT) and the stem and layer1 / stage
    kernels in its trace's posenet range under their own names, every
    compute share under 100 % and every time positive; prints each run's
    sum of isolated stages, request and overhead. Writes the JSON lines to
    _build/profile_pipeline.jsonl and the traces to _build/trace/. Returns
    (launches by (kernel, batch), the lines, the eval batch's split)."""
    import argparse

    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.ops import profile_pipeline as pp

    build_dir = os.path.dirname(_build.LIB_PATH)
    args = argparse.Namespace(device="cuda", frame_hw=[FRAME_H, FRAME_W], img_size=224,
                              det_size=640, window=TRACE_WINDOW, reps=TRACE_REPS,
                              trace_dir=os.path.join(build_dir, "trace"))
    rng = np.random.default_rng(SEED + 19)
    counts, lines = collections.Counter(), []
    runs = pp.parse_runs(pp.DEFAULT_RUNS)
    check(sorted({row for row, _ in runs}) == sorted(TRACE_EXPECT)
          and {("rgbd", TRACE_BIG_BATCH), ("rgbd_folded", TRACE_BIG_BATCH)} <= set(runs),
          f"the tool's runs {runs}")
    for row, batch in runs:
        t0 = time.perf_counter()
        _build.launch_counts.clear()
        line = pp.profile_run(row, batch, args, rng)
        counts.update({(k, line["pose_batch"]): v for k, v in _build.launch_counts.items()})
        what = f"{line['name']}@{batch}"
        check(line["full_prefix_equals_call"] and line["sync_free"],
              f"{what}: the full prefix differs from __call__, or a stage waits for the card")
        wrappers, kernels = TRACE_EXPECT[row]
        check(line["kernel_launches"] == wrappers,
              f"{what}: one request launched {line['kernel_launches']}, expected {wrappers}")
        seen = line["hand_kernels"].get("posenet", {})
        check(set(seen) == set(kernels) and not set(line["hand_kernels"]) - {"posenet"},
              f"{what}: the trace shows the hand-written kernels {line['hand_kernels']}, "
              f"expected {kernels} in posenet")
        readings = [*line["stages"].values(), line["request"], *line["prefixes"]]
        check(all(r[k] > 0 for r in readings for k in ("ms", "host_enqueue_ms", "card_ms")),
              f"{what}: a stage time is not positive")
        shares = [r["peak_share"] for r in (*line["stages"].values(), line["request"])]
        check(all(0.0 <= x < 1.0 for x in shares), f"{what}: a compute share {shares}")
        req = line["request"]
        log(f"  {what}: sum of isolated stages {line['sum_isolated_ms']:.3f} ms, request "
            f"{req['ms']:.3f} ms, overhead {line['overhead_ms']:.3f} ms; on the card's time "
            f"{line['sum_isolated_card_ms']:.3f} / {req['card_ms']:.3f} / "
            f"{line['card_overhead_ms']:.3f} ms; host enqueue {req['host_enqueue_ms']:.3f} ms, "
            f"idle {req['idle_share']:.3f}; stages (ms / card ms) "
            + ", ".join(f"{k} {v['ms']:.3f} / {v['card_ms']:.3f}"
                        for k, v in line["stages"].items())
            + f"; on {smi} ({time.perf_counter() - t0:.1f}s)")
        lines.append(line)
    t0 = time.perf_counter()
    _build.launch_counts.clear()
    ev = pp.eval_batch(args, rng)
    counts.update({(k, ev["frames"]): v for k, v in _build.launch_counts.items()})
    check(ev["addmin_launches"] > 0 and all(ev[k] > 0 for k in (
        "decode_ms", "ground_truth_ms", "request_ms", "request_card_ms", "metrics_ms")),
          f"the eval_e2e batch's split {ev}")
    log(f"  eval_e2e batch of {ev['frames']}: decode {ev['decode_ms']:.3f} ms, ground truth "
        f"{ev['ground_truth_ms']:.3f}, request {ev['request_ms']:.3f} (enqueue "
        f"{ev['request_enqueue_ms']:.3f}, card {ev['request_card_ms']:.3f}), metrics "
        f"{ev['metrics_ms']:.3f}, total {ev['total_ms']:.3f} ms on {smi} "
        f"({time.perf_counter() - t0:.1f}s)")
    with open(os.path.join(build_dir, "profile_pipeline.jsonl"), "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in (*lines, {"eval_batch": ev}))
    return counts, lines, ev


# phase 19: the launches one request of the rgbd sweep's row makes
SWEEP_RGBD_EXPECT = {"fused_stem_c3": 1, "fused_stem_c1": 1, "fused_layer1": 2}
INT8_BF16_EXPECT = {"fused_stem_c3": 1, **{f"fused_stage_s{k}": 1 for k in (1, 2, 3, 4)}}


def big_batch_rows(pipe, tower_inputs) -> list:
    """The stems (C=3, C=1) and layer1 of the rgbd path at each of
    SWEEP_BATCHES (its crops tiled), against their plain versions and
    timed as phase 3's rows: the batches phase 19's rgbd sweep serves at."""
    from pose6d_tpu_torch.ops.quant import fold_bn_resnet

    rows = []
    for batch in SWEEP_BATCHES:
        reps = batch // BATCH
        for C, name in ((3, "rgb_backbone"), (1, "depth_backbone")):
            tree = fold_bn_resnet(getattr(pipe.posenet, name))
            x = (tower_inputs["rgb"] if C == 3 else tower_inputs["depth"]).repeat(reps, 1, 1, 1)
            row, out = stem_row(tree, x.contiguous(), f"fused_stem_c{C}")
            rows.append(row)
            if C == 3:
                rows.append(layer1_row(tree, out, "fused_layer1"))
            del x, out
    return rows


def phase_profilers(smi: str):
    """The sweeps and the int8 and train profilers in this process (see
    the module docstring, phase 19). Writes the JSON lines to
    _build/profilers.jsonl. Returns (launches by (kernel, batch), the
    lines)."""
    import argparse

    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.ops import profile_int8, profile_sweep, profile_train

    args = argparse.Namespace(device="cuda", frame_hw=[FRAME_H, FRAME_W], img_size=224,
                              det_size=640, window=PROFILER_WINDOW, reps=1,
                              train_frames=PROFILER_FRAMES)
    counts, lines = collections.Counter(), {}

    def run(key, batch, fn):
        t0 = time.perf_counter()
        _build.launch_counts.clear()
        line = fn()
        if batch is not None:
            counts.update({(k, batch): v for k, v in _build.launch_counts.items()})
        readings = [r for r in line.get("readings", {}).values()] + [
            a for a in line.get("arms", {}).values()]
        check(readings and all(r[k] is not None and r[k] > 0 for r in readings
                               for k in ("ms", "host_enqueue_ms", "card_ms")),
              f"{key}: a time is not positive or the card's time was not read: {readings}")
        lines[key] = line
        log(f"  {key}: " + ", ".join(f"{k} {v:.3f}" for k, v in line.items()
                                     if isinstance(v, float))
            + f" on {smi} ({time.perf_counter() - t0:.1f}s)")
        return line

    line = run("nomodel", 32, lambda: profile_train.nomodel(32, args))
    check(line["full_prefix_equals_expand_augment"], "nomodel: the augment prefix differs")
    check(all(line["kernel_launches"][k] == ({} if k == "gather_take"
                                             else {"gather_rows_u32": 2})
              for k in profile_train.NOMODEL_STAGES),
          f"nomodel: launches {line['kernel_launches']}")
    line = run("train_split", 32, lambda: profile_train.train_split("rgbd", 32, args))
    check(line["kernel_launches"]["gather_crop_rgb"] == {"gather_rows_u32": 1}
          and line["kernel_launches"]["fwd_bwd_adamw"] == {},
          f"train_split: launches {line['kernel_launches']}")
    line = run("train_step", 32, lambda: profile_train.train_step("rgbd", 32, args))
    check(all(line[dt]["losses_finite"] for dt in profile_train.DTYPES)
          and all(line["kernel_launches"][dt] == {"gather_rows_u32": 2.0}
                  for dt in profile_train.DTYPES),
          f"train_step: losses or launches {line['kernel_launches']}")
    for tool in ("int8_split", "int8_variants"):
        line = run(tool, BATCH, lambda tool=tool: getattr(profile_int8, tool)(BATCH, args))
        bf16 = "tower_bf16" if tool == "int8_split" else "bf16"
        check(line["kernel_launches"][bf16] == INT8_BF16_EXPECT
              and line["tower_bf16"] == "folded_bf16_stem_s1234"
              and line["tower_bf16_vs_cudnn_rel_l2"] < PROFILER_BF16_REL,
              f"{tool}: the bf16 tower launched {line['kernel_launches'][bf16]}, rel-L2 to "
              f"cuDNN {line['tower_bf16_vs_cudnn_rel_l2']}")
    check(lines["int8_variants"]["D_last_prefix_equals_A"]
          and lines["int8_variants"]["B_vs_A_rel_drift"] == 0.0,
          f"int8_variants: D's last prefix or B's drift {lines['int8_variants']}")
    rng = np.random.default_rng(SEED + 20)
    for kind, batches in (("rgb", (BATCH,)), ("rgbd", SWEEP_BATCHES)):
        line = run(f"sweep_{kind}", None,
                   lambda kind=kind, batches=batches: profile_sweep.sweep(kind, batches, args, rng))
        for b, launched in line["launches_by_batch"].items():
            counts.update({(k, int(b)): v for k, v in launched.items()})
        want = {} if kind == "rgb" else SWEEP_RGBD_EXPECT
        check(line["bf16_params_equal"]
              and all(a["kernel_launches"] == want for a in line["arms"].values()),
              f"sweep {kind}: bf16_params differs or a request launched "
              f"{[a['kernel_launches'] for a in line['arms'].values()]}")
    with open(os.path.join(os.path.dirname(_build.LIB_PATH), "profilers.jsonl"), "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in lines.values())
    return counts, lines


# phase 20: bench.py's rgb and rgbd rows, the float pipeline with bf16 towers, and the
# kernels the same weights go through when folded (fold_backbones' arguments), with
# one request's launches of them
BF16_FLOAT_ROWS = {
    "rgb": ({"pallas_stem": True, "pallas_stages": (1, 2, 3, 4)},
            {"fused_stem_c3": 1, **{f"fused_stage_s{k}": 1 for k in (1, 2, 3, 4)}}),
    "rgbd": ({"pallas_stem": True, "pallas_layer1": True},
             {"fused_stem_c3": 1, "fused_stem_c1": 1, "fused_layer1": 2}),
}


def tower_conv_dtypes(pipe) -> tuple:
    """(seen, hooks): forward hooks on each tower's last conv of `pipe`
    that append its output dtype to seen; remove the hooks after the
    request."""
    seen, hooks = [], []
    for name in pipe.posenet.towers:
        conv = getattr(pipe.posenet, name).layer4_2.conv3
        hooks.append(conv.register_forward_hook(lambda m, a, out: seen.append(out.dtype)))
    return seen, hooks


def phase_bf16_float(smi: str):
    """bench.py's rgb and rgbd rows on the card (generator SEED + 21): the
    float pipeline at full width (a bf16 YOLOv8n of the other phases'
    seeded weights on 640x480 frames, ResNet50 towers at 224, conf_thresh 0,
    nms_pre_topk 32 for rgbd and 64 for rgb, compute bf16, BATCH frames)
    built without pose_cfg, so its towers run in bf16 (PoseNetConfig's dtype
    from compute_dtype); the same weights with an explicit f32
    PoseNetConfig, and folded through the stem and stage (rgb) or layer1
    (rgbd) kernels. Checks the towers' conv outputs bf16 and f32, no
    kernel launched by either float pipeline, the folded one's launches,
    boxes equal across the three, the bf16 poses within POSE_ATOL of the
    f32 ones and the folded poses within BF16_PAIR_ATOL of the bf16 float
    ones (both printed beside the observed distances), and ADD / ADD-S of
    the bf16 poses through the addmin kernel (phase_add); prints the bf16
    request's card ms (a CUDA-graph replay) and host enqueue ms (the
    request trace's Clock). Returns (launches by (kernel, batch), {row:
    its readings})."""
    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.convert import init_posenet_weights, init_yolo_weights
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.models.posenet import PoseNetConfig
    from pose6d_tpu_torch.models.yolo.model import YoloConfig
    from pose6d_tpu_torch.ops import profile_pipeline as pp

    rng = np.random.default_rng(SEED + 21)
    dev = torch.device("cuda")
    K = torch.from_numpy(LINEMOD_K).to(dev)
    yolo_state = init_yolo_weights(YoloConfig(), SEED + 1)
    counts, rows = collections.Counter(), {}
    for i, (variant, (fold, expected)) in enumerate(BF16_FLOAT_ROWS.items()):
        t0 = time.perf_counter()
        cfg = PipelineConfig(variant=variant, img_size=224, conf_thresh=0.0,
                             compute_dtype=torch.bfloat16,
                             nms_pre_topk=32 if variant == "rgbd" else 64)
        pose_state = init_posenet_weights(PoseNetConfig(variant=variant), SEED + 30 + i)

        def make(pose_cfg=None):
            return PosePipeline(cfg, YoloConfig(dtype=torch.bfloat16), yolo_state, pose_state,
                                pose_cfg, device=dev)

        pipes = {"bf16": make(), "f32": make(PoseNetConfig(variant=variant))}
        pipes["folded"] = make().fold_backbones(**fold)
        check(pipes["bf16"].pose_cfg.dtype == torch.bfloat16
              and pipes["f32"].pose_cfg.dtype == torch.float32,
              f"{variant}: the float pipelines' tower dtypes {pipes['bf16'].pose_cfg.dtype}, "
              f"{pipes['f32'].pose_cfg.dtype}")
        frames = torch.from_numpy(rng.integers(0, 256, (BATCH, FRAME_H, FRAME_W, 3),
                                               dtype=np.uint8)).to(dev)
        depth = (torch.from_numpy(rng.uniform(0.2, 1.5, (BATCH, FRAME_H, FRAME_W))
                                  .astype(np.float32)).to(dev) if variant == "rgbd" else None)
        outs, dtypes, launched = {}, {}, {}
        with torch.inference_mode():
            for key, pipe in pipes.items():
                pipe(frames, K, depth)  # warm-up (cuDNN set-up), not counted
                seen, hooks = tower_conv_dtypes(pipe)
                sync(dev)
                _build.launch_counts.clear()
                outs[key] = pipe(frames, K, depth)
                sync(dev)
                launched[key] = dict(_build.launch_counts)
                for h in hooks:
                    h.remove()
                dtypes[key] = seen
        towers = len(pipes["bf16"].posenet.towers)
        check(dtypes["bf16"] == [torch.bfloat16] * towers
              and dtypes["f32"] == [torch.float32] * towers and dtypes["folded"] == [],
              f"{variant}: tower conv outputs {dtypes}")
        check(launched["bf16"] == {} and launched["f32"] == {},
              f"{variant}: a float pipeline launched {launched}")
        check(launched["folded"] == expected,
              f"{variant}: the folded pipeline launched {launched['folded']}, "
              f"expected {expected}")
        counts.update({(k, BATCH): v for k, v in launched["folded"].items()})
        for key, out in outs.items():
            for k in ("rotation", "translation"):
                check(tuple(out[k].shape) == (BATCH, 4 if k == "rotation" else 3)
                      and bool(torch.isfinite(out[k]).all()), f"{variant} {key}: {k}")
            check(torch.equal(out["bbox_xywh"], outs["bf16"]["bbox_xywh"]),
                  f"{variant}: the {key} pipeline's boxes differ from the bf16 one's")

        def dist(a, b):
            return max((outs[a][k] - outs[b][k]).abs().max().item()
                       for k in ("rotation", "translation"))

        d_f32, d_folded = dist("bf16", "f32"), dist("folded", "bf16")
        check(d_f32 <= POSE_ATOL, f"{variant}: bf16 vs f32 towers' poses {d_f32:.3g} > "
                                  f"{POSE_ATOL}")
        check(d_folded <= BF16_PAIR_ATOL, f"{variant}: folded kernels vs bf16 float poses "
                                          f"{d_folded:.3g} > {BF16_PAIR_ATOL}")
        with torch.inference_mode():
            n, batch = phase_add(outs["bf16"], rng)
        counts[("pairwise_min_dist", batch)] += n
        with torch.inference_mode():
            ring = [(frames, K, depth), (frames.flip(0), K, None if depth is None
                                         else depth.flip(0))]
            bf16 = pipes["bf16"]
            r = pp.Clock(dev, TRACE_WINDOW, TRACE_REPS).reading(lambda j: bf16(*ring[j]), 2)
        rows[variant] = {"pose_vs_f32": d_f32, "pose_folded_vs_bf16": d_folded, **r}
        log(f"  {variant} bf16 float towers at {BATCH}: poses vs f32 towers {d_f32:.3g} "
            f"(bound {POSE_ATOL}), folded kernels {launched['folded']} vs bf16 float "
            f"{d_folded:.3g} (bound {BF16_PAIR_ATOL}), boxes equal, addmin {n} at {batch} "
            f"({time.perf_counter() - t0:.1f}s)")
        log(f"  {variant} bf16 float request at {BATCH}: card {r['card_ms']:.3f} ms, host "
            f"enqueue {r['host_enqueue_ms']:.3f} ms, back to back {r['ms']:.3f} ms, idle "
            f"{r['idle_share']:.3f} on {smi}")
        del pipes, outs
    return counts, rows


# phase 17: the evidence tools (cli/parity_symmetric.py, probe_rgbd_gradients.py,
# selection_study.py, serving_md.py, multiobj_md.py, parity_summarize.py,
# parity_report.py, parity_diagnosis.py) on a small symmetric run: folders 01
# and 02 and the symmetric 10 and 11, 80 frames each, so that the val split
# (8 a folder) is one batch of 32 holding all four objects and the test split
# four batches of BATCH
EVIDENCE_ARGS = ["--objects", 2, "--frames", 80, "--epochs", 2, "--variants", "rgbd_geometric",
                 "--rot-head-wide", "--symmetric-objects"]
EVIDENCE_FRAMES = 4 * 80
PROBE_ARGS = ["--img-size", 64, "--batch-size", 4, "--steps", 2]
PROBE_GROUPS = {"rgb": {"rgb_backbone", "rot_head", "trans_head"},
                "rgbd": {"rgb_backbone", "depth_backbone", "attention", "fusion", "rot_head",
                         "trans_head"},
                "rgbd_noattn": {"rgb_backbone", "depth_backbone", "fusion", "rot_head",
                                "trans_head"},
                "rgbd_widehead": {"rgb_backbone", "depth_backbone", "attention", "fusion",
                                  "rot_head", "trans_head"}}
SCENE_FRAMES = 10  # the multi-object eval's scene (objects 1 and 2): 8 train frames, one batch


def run_cli_logged(name: str, argv: list, log_path: str) -> str:
    """run_cli, its stdout also written to log_path (the logs the markdown
    CLIs parse)."""
    text, _ = run_cli(name, argv)
    with open(log_path, "w") as f:
        f.write(text)
    return text


def phase_evidence(smi: str):
    """The rest of the accuracy evidence through its CLIs, in this process
    on the card (run_cli), in _build/smoke_evidence/ (deleted at the end):
    cli.parity_run at EVIDENCE_ARGS (224, batch 32, the split resident);
    parity_symmetric on its `last` (ids 9 and 10 flagged symmetric, ADD-S
    at most ADD + 1e-6 m on every object row, one addmin launch for the one
    val batch); probe_rgbd_gradients at PROBE_ARGS (every group of every
    configuration present and finite, trans_head 0 under trans_weight 0);
    train_yolo 1 epoch at 96; selection_study over the run's checkpoints
    (eval_e2e in this process at its batch 32, one addmin launch each);
    the four serving modes through eval_e2e at BATCH on the test split
    (folded_kernels: the stem and stage 1-4 kernels once per batch); one
    multi-object eval on a scene of objects 1 and 2; then serving_md,
    multiobj_md, parity_summarize, parity_report and parity_diagnosis, and
    the assembled PARITY_RESULTS.md holding every section written. Returns
    ({(kernel, batch): launches}, the readings)."""
    from pose6d_tpu_torch import _build
    from pose6d_tpu_torch.cli import parity_md, selection_study, serving_md
    from pose6d_tpu_torch.data.synthetic import generate_synthetic_scene, recover_object_colors

    wd = os.path.join(_build.BUILD_DIR, "smoke_evidence")
    run = "rgbd_geometric_widehead"
    data, models = os.path.join(wd, "synth", "data"), os.path.join(wd, "synth", "models")
    logs = os.path.join(wd, "logs")
    counts, secs = collections.Counter(), {}
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(logs)
    with open(os.path.join(wd, "device.txt"), "w") as f:
        f.write(smi + "\n")

    def launched(what: str, batch: int, want: dict) -> None:
        got = dict(_build.launch_counts)
        check(got == want, f"{what}: launches {got}, expected {want}")
        counts.update({(k, batch): v for k, v in got.items()})
        _build.launch_counts.clear()

    def eval_argv(*extra) -> list:
        return ["--variant", "rgbd_geometric", "--rot-head-wide", "--data-root", data,
                "--mesh-dir", models, "--yolo-weights", os.path.join(wd, "yolo"),
                "--pose-weights", os.path.join(wd, f"weights_{run}"), *extra]

    try:
        t0 = time.perf_counter()
        _build.launch_counts.clear()
        run_cli("parity_run", ["--workdir", wd] + EVIDENCE_ARGS)
        steps = 2 * (EVIDENCE_FRAMES * 8 // 10 // 32)
        launched("parity_run --symmetric-objects", 32,
                 {"gather_rows_u32": 2 * steps, "pairwise_min_dist": 2})
        check(sorted(os.listdir(data)) == ["01", "02", "10", "11"], f"fixture {os.listdir(data)}")
        secs["parity_run"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        run_cli("parity_symmetric", ["--workdir", wd, "--sym-workdir", wd, "--checkpoint", "last"])
        launched("parity_symmetric", 32, {"pairwise_min_dist": 1})
        with open(os.path.join(wd, "symmetric_breakdown.json")) as f:
            per_obj = {int(k): v for k, v in json.load(f)["per_object"].items()}
        check(sorted(per_obj) == [0, 1, 9, 10]
              and [k for k, o in per_obj.items() if o["symmetric"]] == [9, 10],
              f"symmetric breakdown objects {per_obj}")
        check(all(o["add_s_mm"] <= o["add_mm"] + 1e-3 for o in per_obj.values()),
              f"ADD-S above ADD: {per_obj}")
        secs["parity_symmetric"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        run_cli("probe_rgbd_gradients", ["--workdir", wd] + PROBE_ARGS)
        launched("probe_rgbd_gradients", 0, {})
        with open(os.path.join(wd, "rgbd_gradient_probe.json")) as f:
            probe = json.load(f)
        check(sorted(probe) == sorted(PROBE_GROUPS), f"probe configurations {sorted(probe)}")
        for name, groups in PROBE_GROUPS.items():
            r = probe[name]
            for phase in ("init", "final"):
                g = r["grad_rms"][phase]
                check(set(g) == groups and all(np.isfinite(v) for v in g.values())
                      and g["trans_head"] == 0.0,
                      f"probe {name} {phase}: {g} (groups {sorted(groups)}, trans_head 0)")
            check(np.isfinite(r["loss_first"]) and np.isfinite(r["loss_last"]),
                  f"probe {name} losses {r}")
        secs["probe"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        run_cli("train_yolo", ["--data-root", data, "--save-dir", os.path.join(wd, "yolo"),
                               "--epochs", 1, "--img-size", 96])
        launched("train_yolo", 0, {})
        secs["train_yolo"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        ckpts = [c for c in ("best", "best_deploy", "last")
                 if os.path.isfile(os.path.join(wd, f"weights_{run}", f"{c}.pt"))]

        def in_process(cmd):  # selection_study's eval_e2e, counted in this process
            return 0, run_cli(cmd[2].rsplit(".", 1)[1], cmd[3:])[0]

        selection_study.main(["--workdir", wd, "--variants", run], runner=in_process)
        launched("selection_study", 32, {"pairwise_min_dist": len(ckpts)})
        with open(os.path.join(wd, "selection_results.json")) as f:
            sel = json.load(f)
        check(sorted(sel[run]) == sorted(ckpts)
              and all("add01d_full" in sel[run][c] for c in ckpts),
              f"selection results {sel} for checkpoints {ckpts}")
        secs["selection_study"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        test_batches = EVIDENCE_FRAMES // 10 // BATCH
        kernels = {"fused_stem_c3": test_batches,
                   **{f"fused_stage_s{k}": test_batches for k in (1, 2, 3, 4)}}
        for mode, flags in serving_md.MODE_FLAGS.items():
            run_cli_logged("eval_e2e", eval_argv("--split", "test", "--batch-size", BATCH, *flags),
                           os.path.join(logs, f"e2e_{mode}_{run}.log"))
            launched(f"eval_e2e {mode}", BATCH, {"pairwise_min_dist": test_batches,
                                                 **(kernels if mode == "folded_kernels" else {})})
        rows = serving_md.gate_rows(logs, [run])
        check([k for _, k, _, _ in rows] == list(serving_md.MODE_FLAGS)
              and all(len(r) == len(serving_md.PATTERNS) for *_, r in rows),
              f"serving gate rows {rows}")
        secs["serving"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        scene = os.path.join(wd, "synth_scene")
        colors = recover_object_colors(data)
        generate_synthetic_scene(scene, {k: colors[k] for k in (1, 2)}, frames=SCENE_FRAMES,
                                 seed=9, max_angle_deg=75.0, write_models=False)
        run_cli_logged("eval_e2e", ["--variant", "rgbd_geometric", "--rot-head-wide",
                                    "--data-root", os.path.join(scene, "data"),
                                    "--mesh-dir", models,
                                    "--yolo-weights", os.path.join(wd, "yolo"),
                                    "--pose-weights", os.path.join(wd, f"weights_{run}"),
                                    "--max-objects", 4, "--classes", "1,2,10,11",
                                    "--split", "train", "--batch-size", BATCH],
                       os.path.join(logs, f"e2e_multiobj_base_{run}.log"))
        # addmin runs on the matched pairs only: as many launches as chunks of them
        multi = dict(_build.launch_counts)
        check(set(multi) <= {"pairwise_min_dist"}, f"multi-object eval launches {multi}")
        counts.update({(k, BATCH * 4): v for k, v in multi.items()})
        _build.launch_counts.clear()
        secs["multiobj"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        for name, argv in (("serving_md", ["--variants", run]),
                           ("multiobj_md", ["--variants", run]),
                           ("parity_summarize", ["--objects", 2, "--frames", 80]),
                           ("parity_report", ["--serving-variants", run]),
                           ("parity_diagnosis", [])):
            run_cli(name, ["--workdir", wd] + argv)
        launched("the markdown CLIs", 0, {})
        written = sorted(f[:-3] for f in os.listdir(parity_md.section_dir(wd)))
        want = sorted(["base", "symmetric", "selection", "serving", "multiobj", "narrative",
                       "diagnosis"])
        check(written == want, f"sections written {written}, expected {want}")
        with open(os.path.join(wd, "PARITY_RESULTS.md")) as f:
            doc = f.read()
        missing = [h for n, h in parity_md.SECTIONS if n in written and h not in doc]
        check(not missing and smi in doc, f"PARITY_RESULTS.md lacks {missing} or the card")
        secs["markdown"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    return dict(counts), {"secs": secs, "per_object": per_obj, "selection": sel[run],
                          "checkpoints": ckpts, "serving": rows}


def setup(rng, rng_new, device):
    """Seeded full-width weights; per path (rgbd with the stem and layer1
    kernels, rgbd_geometric with the stem and stage 1-2 kernels, rgb with
    MULTI_OBJECTS poses per frame, a bf16 detector and the stem and layer1
    kernels) the folded pipeline and the float pipeline on the same
    weights; the requests at 640x480 and (from rng_new) at LB_W x LB_H;
    and the first request's tower inputs of the rgbd and the rgb
    multi-object paths."""
    from pose6d_tpu_torch.convert import init_posenet_weights, init_yolo_weights
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.models.posenet import PoseNetConfig
    from pose6d_tpu_torch.models.yolo.model import YoloConfig

    yolo_cfg = YoloConfig()
    yolo_state = init_yolo_weights(yolo_cfg, SEED + 1)
    stem_l1 = {"pallas_stem": True, "pallas_layer1": True}
    multi = {"max_objects": MULTI_OBJECTS, "conf_thresh": 0.0, "nms_pre_topk": 64}
    paths = {}
    for i, (key, variant, fold, extra, ycfg) in enumerate((
            ("rgbd", "rgbd", stem_l1, {}, yolo_cfg),
            ("rgbd_geometric", "rgbd_geometric",
             {"pallas_stem": True, "pallas_stages": STAGES_SERVED}, {}, yolo_cfg),
            ("rgb_multi", "rgb", stem_l1, multi, YoloConfig(dtype=torch.bfloat16)))):
        pose_cfg = PoseNetConfig(variant=variant)
        pose_state = init_posenet_weights(pose_cfg, SEED + 2 * i)
        cfg = PipelineConfig(variant=variant, img_size=224, compute_dtype=torch.bfloat16, **extra)

        def make():
            return PosePipeline(cfg, ycfg, yolo_state, pose_state, pose_cfg, device=device)

        paths[key] = (make().fold_backbones(**fold), make())
    requests = {"native": make_requests(rng), "letterbox": make_requests(rng_new, LB_H, LB_W)}
    store = seeded_split(rng, device)
    frames, depths = requests["native"]
    inputs = {}
    with torch.inference_mode():
        K = torch.from_numpy(LINEMOD_K).to(device).expand(BATCH, 3, 3)
        for key in ("rgbd", "rgb_multi"):
            inputs[key] = paths[key][0].crop_stage(torch.from_numpy(frames[0]).to(device), K,
                                                   torch.from_numpy(depths[0]).to(device))["inputs"]
    return paths, requests, inputs, store


def int8_pipeline(device):
    """The JAX benchmark's rgbd_int8 pipeline (bench.py _build_pipeline and
    bench_e2e): rgbd at 224, a bf16 YOLOv8n (the other paths' seeded
    detector weights), conf_thresh 0, nms_pre_topk 32, compute bf16, with
    seeded pose weights of its own; its towers folded with the stem and
    layer1 kernels, which quantize_backbones then overrides."""
    from pose6d_tpu_torch.convert import init_posenet_weights, init_yolo_weights
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.models.posenet import PoseNetConfig
    from pose6d_tpu_torch.models.yolo.model import YoloConfig

    pose_cfg = PoseNetConfig(variant="rgbd")
    cfg = PipelineConfig(variant="rgbd", img_size=224, compute_dtype=torch.bfloat16,
                         conf_thresh=0.0, nms_pre_topk=32)
    yolo_state = init_yolo_weights(YoloConfig(), SEED + 1)
    pipe = PosePipeline(cfg, YoloConfig(dtype=torch.bfloat16), yolo_state,
                        init_posenet_weights(pose_cfg, SEED + 6), pose_cfg, device=device)
    return pipe.fold_backbones(pallas_stem=True, pallas_layer1=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card", file=sys.stderr)
        return 1
    from pose6d_tpu_torch import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[phase 1 device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"TF32 off for cuDNN and matmul ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    secs = _build.build()
    _build.lib()
    if os.path.exists(_build.LOG_PATH):
        with open(_build.LOG_PATH) as f:
            for line in ptxas_summary(f.read()):
                log(f"  ptxas: {line}")
    else:
        log("  ptxas: not read (the library was built elsewhere, no nvcc.log)")
    hgmma = hgmma_counts(_build.LIB_PATH)
    if hgmma is None:
        log("  sass: not read (no cuobjdump)")
    else:
        log("  sass HGMMA instructions: " + ", ".join(f"{k} {v}" for k, v in sorted(hgmma.items())))
        check(len(hgmma) == 6 and all(hgmma.values()),
              f"the bf16 stage kernels (tile N 64 and 128, 1x1 and 3x3) and stem kernels "
              f"(C=3 and 1) lack tensor-core instructions: {hgmma}")
    log(f"[phase 2 build] nvcc {'built ' + _build.LIB_PATH if secs else 'library up to date'} "
        f"in {secs:.1f}s ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    # the multi-object and letterbox phases draw from a generator of their
    # own, so that adding them left every other phase's inputs as they were
    rng_new = np.random.default_rng(SEED + 10)
    paths, requests, inputs, store = setup(rng, rng_new, "cuda")
    log(f"  set-up: seeded weights, pipelines, requests and the resident split of "
        f"{len(store)} frames, {store.nbytes() / 2**20:.1f} MiB ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    with torch.inference_mode():
        rows = phase_kernels(paths["rgbd"][0], paths["rgbd_geometric"][0], paths["rgb_multi"][0],
                             inputs["rgbd"], inputs["rgb_multi"], store, rng)
    log(f"[phase 3 kernels] each kernel matches its plain version in f32 and bf16, "
        f"fused_stage s1 equals fused_layer1 bit for bit, the gather is bit-equal "
        f"({time.perf_counter() - t0:.1f}s)")

    # launches by kernel row: each (kernel, batch) a run launches has its row
    by_id = {(r["kernel"], r["batch"]): r for r in rows}
    check(len(by_id) == len(rows), "two kernel rows share a kernel and a batch")
    for r in rows:
        r["launches"] = 0

    def count(counts: dict, batch: int) -> None:
        for k, v in counts.items():
            check((k, batch) in by_id, f"{v} launches of {k} at batch {batch}: no row "
                                       f"measured that kernel at that batch")
            by_id[(k, batch)]["launches"] += v

    geo_stages = {"fused_stem_c3": 1, **{f"fused_stage_s{s}": 1 for s in STAGES_SERVED}}
    outs, serving = {}, {}
    for n, (title, key, req, expected, exact) in enumerate((
            ("rgbd", "rgbd", "native",
             {"fused_stem_c3": 1, "fused_stem_c1": 1, "fused_layer1": 2}, False),
            ("rgbd_geometric", "rgbd_geometric", "native", geo_stages, True),
            ("rgb multi-object", "rgb_multi", "native", {"fused_stem_c3": 1, "fused_layer1": 1},
             False),
            ("rgbd_geometric letterbox", "rgbd_geometric", "letterbox", geo_stages, True))):
        t0 = time.perf_counter()
        pipe = paths[key][0]
        frames, depths = requests[req]
        outs[title], counts, serving[title] = phase_slice(*paths[key], frames, depths,
                                                          expected, exact)
        count(counts, BATCH * pipe.cfg.max_objects)
        if key == "rgb_multi":
            check_decode_on_card(pipe, frames[1])
        if req == "letterbox":
            check_windowed_crop(frames[1], rng_new, pipe.device)
        log(f"[phase {4 + n} slice {title}] folded serving, {N_REQUESTS} requests of "
            f"{BATCH} frames {frames[0].shape[2]}x{frames[0].shape[1]}, "
            f"{pipe.cfg.max_objects} pose(s) per frame, detector "
            f"{str(pipe.yolo_cfg.dtype).removeprefix('torch.')} on {smi} "
            f"({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    # the int8 phase draws from a generator of its own too
    rng_int8 = np.random.default_rng(SEED + 11)
    outs["rgbd int8"], int8 = phase_int8(int8_pipeline("cuda"), rng_int8)
    log(f"[phase 8 slice rgbd int8] int8 towers and detector, {N_REQUESTS} requests of "
        f"{BATCH} frames {FRAME_W}x{FRAME_H} on {smi}: cosines vs bf16 "
        + ", ".join(f"{k} {int8[k]['cos_vs_bf16']:.4f}"
                    for k in ("rgb_backbone", "depth_backbone", "detector"))
        + f" ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    gens = {"rgbd": rng, "rgbd_geometric": rng, "rgbd int8": rng_int8}
    with torch.inference_mode():
        for title, out in outs.items():
            log(f"  {title}:")
            n, batch = phase_add(out, gens.get(title, rng_new))
            count({"pairwise_min_dist": n}, batch)
    log(f"[phase 9 add] ADD/ADD-S through the addmin kernel ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    counts, train = phase_train(store, rng)
    count(counts, 32)
    log(f"[phase 10 train rgbd] {TRAIN_STEPS} steps at batch 32, 224, f32 (TF32 off) on {smi}: "
        f"smoke reading, not a throughput: {train['step_ms']:.3f} ms/step (CUDA events over "
        f"the epoch call; host enqueue {train['host_enqueue_ms']:.1f} ms), losses finite, "
        f"every parameter and BN statistic moved, gathers {counts['gather_rows_u32']} "
        f"(8 epoch + 2 eval batch), addmin {counts['pairwise_min_dist']} "
        f"({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    # the train-from-disk phase draws from a generator of its own
    counts, disk = phase_train_disk(np.random.default_rng(SEED + 12), smi)
    count(dict(counts), 32)
    log(f"[phase 11 train rgbd from disk] Trainer(get_preset('rgbd')) on a seeded LineMOD "
        f"tree, 224, batch 32, on {smi}: device path f32 {disk['a_ms_step']:.3f} ms/step, "
        f"bf16 {disk['c_ms_step']:.3f} ms/step (CUDA events over the epoch calls), host "
        f"path {disk['b_ms_step']:.1f} ms/step (host clock); PNG decode "
        f"{disk['decode_ms']['rgb']:.3f} / {disk['decode_ms']['depth']:.3f} ms per RGB / "
        f"depth frame, host loader {disk['loader_ms_batch']:.1f} ms per batch of 32; "
        f"resume exact; gathers {counts['gather_rows_u32']}, addmin "
        f"{counts['pairwise_min_dist']} ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    # the detector phase draws from a generator of its own
    det = phase_train_detector(np.random.default_rng(SEED + 13), smi)
    log(f"[phase 12 train detector from disk] DetectionTrainer(DetTrainConfig(epochs=2)) on a "
        f"seeded LineMOD tree of {len(LINEMOD_FOLDERS)} folders, YOLOv8n at 640, batch 16, f32 "
        f"(TF32 off) on {smi}: {det['ms_step']:.3f} ms/step resident (CUDA events), "
        f"{det['fit_ms_step']:.1f} ms/step through the loader (host clock), the loader "
        f"{det['loader_ms_batch']:.1f} ms per batch of 16, validation "
        f"{max(det['val_s']):.2f} s; card = CPU, the guard, resume exact, the trained detector "
        f"served; none of the five kernels ran ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    cli_counts, cli = phase_cli(smi)
    for (k, batch), v in cli_counts.items():
        count({k: v}, batch)
    log(f"[phase 13 workflow through the CLIs] setup_data, convert_reference_weights, "
        f"train_yolo, train, infer and eval_e2e at full width on {smi}: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in cli["secs"].items())
        + f"; eval_e2e {cli['eval_fps']:.2f} frames/s (host clock, set-up excluded), detection "
          f"{cli['det_rate'] * 100:.1f}%, ADD-0.1d {cli['add_01d']:.2f}% equal in process; "
          f"launches " + ", ".join(f"{k}@{b} {v}" for (k, b), v in sorted(cli_counts.items()))
        + f" ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    frames, depths = requests["native"]
    mesh_counts, mesh = phase_mesh(store, paths["rgbd"][0], frames[1], depths[1], smi)
    for (k, batch), v in sorted(mesh_counts.items()):
        count({k: v}, batch)
    log(f"[phase 14 mesh] parallel/ on {smi}: NCCL world of 1 bit-equal to no mesh; two gloo "
        f"ranks on the card: (2, 1) step {mesh['gloo (2, 1)']['ms']:.1f} ms vs one-process "
        f"{mesh[f'one-process {MESH_TRAIN_BATCH}']:.1f} ms at batch {MESH_TRAIN_BATCH}, (1, 2) "
        f"step {mesh['gloo (1, 2)']['ms']:.1f} ms vs {mesh[f'one-process {MESH_TRAIN_BATCH // 2}']:.1f}"
        f" ms at {MESH_TRAIN_BATCH // 2} (smoke readings, CUDA events); launches "
        + ", ".join(f"{k}@{b} {v}" for (k, b), v in sorted(mesh_counts.items()))
        + f" ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    learn_counts, learn = phase_learning(smi)
    for (k, batch), v in sorted(learn_counts.items()):
        count({k: v}, batch)
    log(f"[phase 15 learning] the rgb step at {LEARN_IMG}, batch {LEARN_BATCH}, {LEARN_STEPS} "
        f"steps on one batch on {smi}: "
        + ", ".join(f"{dt} loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, geodesic "
                    f"{r['geo']:.3f} rad, {r['ms_step']:.3f} ms/step"
                    for dt, r in learn["runs"].items())
        + f"; parity_run {learn['parity_s']:.1f} s, launches "
        + ", ".join(f"{k}@{b} {v}" for (k, b), v in sorted(learn_counts.items()))
        + f" ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    trace_counts, trace, ev = phase_trace(smi)
    for (k, batch), v in sorted(trace_counts.items()):
        count({k: v}, batch)
    log(f"[phase 16 trace] ops/profile_pipeline.py on every row at {BATCH} and rgbd and rgbd "
        f"folded at {TRACE_BIG_BATCH} on {smi}: full prefix == __call__, no wait for the card, the "
        f"kernels in the trace; request ms " + ", ".join(
            f"{x['name']}@{x['batch']} {x['request']['ms']:.3f}" for x in trace)
        + f"; eval_e2e batch {ev['total_ms']:.1f} ms; launches "
        + ", ".join(f"{k}@{b} {v}" for (k, b), v in sorted(trace_counts.items()))
        + f" ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    ev_counts, evidence = phase_evidence(smi)
    for (k, batch), v in sorted(ev_counts.items()):
        count({k: v}, batch)
    sym = [f"obj {oid + 1:02d} {o['add01d_pct']:.1f}%"
           for oid, o in evidence["per_object"].items() if o["symmetric"]]
    log(f"[phase 17 evidence] parity_run --symmetric-objects, parity_symmetric (ADD-0.1d "
        f"{', '.join(sym)} through ADD-S), probe_rgbd_gradients, selection_study over "
        f"{'/'.join(evidence['checkpoints'])}, the four serving gates at {BATCH}, a "
        f"multi-object eval and the markdown CLIs on {smi}: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in evidence["secs"].items())
        + "; launches " + ", ".join(f"{k}@{b} {v}" for (k, b), v in sorted(ev_counts.items()))
        + f" ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    with torch.inference_mode():
        big = big_batch_rows(paths["rgbd"][0], inputs["rgbd"])
    for r in big:
        check((r["kernel"], r["batch"]) not in by_id, f"a second row of {r['name']}")
        r["launches"] = 0
        by_id[(r["kernel"], r["batch"])] = r
        rows.append(r)
        log(f"  {r['name']}: f32 max_abs_err {r['max_abs_err']:.3g}, bf16 mean/max err "
            f"{r['bf16_mean_err']:.3g}/{r['bf16_max_err']:.3g}  ms {r['ms']:.4f}  plain_ms "
            f"{r['plain_ms']:.4f}  library_ms {r['library_ms']:.4f}  bound_ms "
            f"{r['bound_ms']:.5f} ({r['bound_by']})")
    prof_counts, prof = phase_profilers(smi)
    for (k, batch), v in sorted(prof_counts.items()):
        count({k: v}, batch)
    log(f"[phase 19 profilers] the stems and layer1 at "
        f"{'/'.join(str(r['batch']) for r in big if r['kernel'] == 'fused_layer1')} against "
        f"their plain versions; nomodel, train_split and train_step at 32, int8_split and "
        f"int8_variants at {BATCH}, sweep rgb at {BATCH} and rgbd at "
        f"{'/'.join(map(str, SWEEP_BATCHES))} on {smi}: rgbd "
        + ", ".join(f"b{b} {prof['sweep_rgbd'][f'b{b}']:.1f}" for b in SWEEP_BATCHES)
        + f" frames/s; train step f32 {prof['train_step']['float32']['ms_per_step']:.3f} / "
          f"bf16 {prof['train_step']['bfloat16']['ms_per_step']:.3f} ms; tower bf16 "
          f"{prof['int8_split']['tower_bf16_ms']:.3f} / int8 "
          f"{prof['int8_split']['tower_int8_ms']:.3f} ms; launches "
        + ", ".join(f"{k}@{b} {v}" for (k, b), v in sorted(prof_counts.items()))
        + f" ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    bf16_counts, bf16_rows = phase_bf16_float(smi)
    for (k, batch), v in sorted(bf16_counts.items()):
        count({k: v}, batch)
    log(f"[phase 20 bf16 float towers] bench.py's rgb and rgbd rows at {BATCH} on {smi}: "
        + ", ".join(f"{v} poses vs f32 {r['pose_vs_f32']:.3g}, folded kernels vs bf16 "
                    f"{r['pose_folded_vs_bf16']:.3g}, card {r['card_ms']:.3f} ms, host "
                    f"{r['host_enqueue_ms']:.3f} ms" for v, r in bf16_rows.items())
        + "; launches " + ", ".join(f"{k}@{b} {v}" for (k, b), v in sorted(bf16_counts.items()))
        + f" ({time.perf_counter() - t0:.1f}s)")

    # the b32 addmin row: phase 3's inputs and the eval step's
    r = by_id[("pairwise_min_dist", 32)]
    r["max_abs_err"] = max(r["max_abs_err"], train["addmin_max_abs_err"])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("shape", "floor_ms", "stream_ms", "floor_stream_ms")
    log(f"[phase 18 kernels] " + ", ".join(f"{r['name']}: {r['launches']} launches, pass"
                                          for r in rows)
        + "; serving smoke readings " + ", ".join(f"{v} {r['fps']:.1f} frames/s"
                                                   for v, r in serving.items())
        + f"; train rgbd {train['step_ms']:.3f} ms/step, from disk {disk['a_ms_step']:.3f} "
          f"(f32) / {disk['c_ms_step']:.3f} (bf16) ms/step; train detector {det['ms_step']:.3f} "
          f"ms/step"
        + f" ({time.perf_counter() - t_all:.1f}s total)")
    log(json.dumps({"kernels": [{**{k: r[k] for k in keys},
                                 **{k: r[k] for k in extra if k in r},
                                 **{k: v for k, v in r.items() if k.startswith("depth_")}}
                                for r in rows]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
