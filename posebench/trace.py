"""The traced window of a `--trace 1` run and its reduction to a record
that the per-layer metrics (layer_metrics/*.py) read.

The request is driven as the program's own step methods in order
(pose6d_tpu_torch.ops.profile_pipeline.request_steps), each inside a
torch.profiler.record_function range of the benchmark's ("posebench.<step>"),
in the same closed loop as the timed window and with no synchronisation
between steps; each wait for a batch is a range too ("posebench.wait").
Two windows of the same number of batches are profiled. The first records
the card's activity alone: profiling the host's operations too slows the
host by ~40 %, and the card, waiting on it, idles for that time (on an
H100 a window so profiled read an idle share of 0.24 and 0.61 in the rgbd
cells at 128 x 1 and 32 x 8, where untraced windows keep the card busy
~0.9 and ~0.75 of the time). The second records the
host's ranges with the card's operations: a step's device time is the time
of the device operations launched inside its range (each kernel, copy and
set matched to the CUDA runtime call that launched it by the profiler's
correlation id); its window is the range "posebench.window" after a few
batches that warm the profiler.

The record:
  batches              batches in each window
  device_ms            device ms of every operation in the first window
  busy_s, window_s     the union of the device operations' intervals in the
                       first window, and its length on the host's clock
  hand_kernel_ms       device ms in the first window of the operations named
                       as the hand-written kernels (HAND_KERNELS)
  device_ops           [[name, s]]: its 10 operations that took most time
  stage_device_ms      {step: device ms of its operations} in the second
  launched_device_ms   device ms of every operation launched in the second
  idle_gaps            [[host range, s]]: the second window's 10 longest gaps
                       between device operations, named by the benchmark's
                       innermost range the host was in when each began
                       ("host" if none); stretched by the host's profiling
"""

from __future__ import annotations

import bisect
import math
import re
import time

import torch

SPAN = "posebench."
# the program's hand-written kernels (pose6d_tpu_torch/csrc/*.cu) as a trace
# names them: demangled "void stem_tc_kernel<3>(...)" or mangled
# "_Z14stem_tc_kernelILi3E..."; the request trace's HAND_KERNELS
HAND_KERNELS = re.compile(r"(?<![A-Za-z_])(stem_tc_kernel|stem_kernel|wgmma_gemm_kernel|"
                          r"gemm_kernel|addmin_kernel|gather_rows_kernel)(?=[<(I]|$)")
TOP = 10
TRACE_BATCHES = 12         # batches in each profiled window
TRACE_WARMUP_BATCHES = 3   # unprofiled batches before the first window


def stepped_call(pipe, span):
    """call(entry) -> outputs: the request as the program's step methods,
    each inside span(step)."""
    from pose6d_tpu_torch.ops.profile_pipeline import request_steps

    steps = request_steps(pipe)

    @torch.inference_mode()  # as PosePipeline.__call__ runs them
    def call(entry):
        s = {"frames": entry["frames"], "K": entry["K"], "depth": entry["depth"]}
        for name, step in steps:
            with span(name):
                step(s)
        return s["out"]

    return call


def _kineto(prof) -> list:
    """(name, on the device, start ns, end ns, user range, correlation id)
    of each event."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        user = e.is_user_annotation() if hasattr(e, "is_user_annotation") else False
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start, start + dur, user,
                    e.correlation_id()))
    return out


def union(spans: list) -> list:
    """Sorted (start, end) intervals merged where they overlap."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def traced(pipe, ring: list, in_flight: int) -> tuple:
    """Two profiled windows of TRACE_BATCHES batches each, after
    TRACE_WARMUP_BATCHES untimed ones: the card alone (CUDA activity only, so that the host runs
    at its own pace), then the host's ranges with it. Returns (the record,
    the traced Batch lists)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import serve

    def span(name):
        return record_function(SPAN + name)

    batches, warmup = TRACE_BATCHES, TRACE_WARMUP_BATCHES
    call = stepped_call(pipe, span)
    serve.closed_loop(call, ring, in_flight, batches=warmup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as card:
        t0 = time.perf_counter()
        _, _, done_a = serve.closed_loop(call, ring, in_flight, batches=batches)
        window_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as steps:
        serve.closed_loop(call, ring, in_flight, batches=warmup, span=span)
        torch.cuda.synchronize()
        time.sleep(0.02)
        with span("window"):
            _, _, done_b = serve.closed_loop(call, ring, in_flight, batches=batches, span=span)
    record = dict(card_window(card, window_s), **step_window(steps), batches=batches)
    return record, done_a + done_b


def _device(events: list, lo: float = -math.inf, hi: float = math.inf) -> list:
    return [(name, a, b) for name, dev, a, b, user, _ in events
            if dev and not user and lo <= a <= hi]


def card_window(prof, window_s: float) -> dict:
    """The card's side of a window profiled with CUDA activity alone."""
    device = _device(_kineto(prof))
    busy = union([(a, b) for _, a, b in device])
    per_op = {}
    for name, a, b in device:
        per_op[name] = per_op.get(name, 0) + (b - a)
    return {
        "device_ms": sum(b - a for _, a, b in device) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "window_s": window_s,
        "hand_kernel_ms": sum(b - a for name, a, b in device if HAND_KERNELS.search(name)) / 1e6,
        "device_ops": [[name[:160], ns / 1e9] for name, ns in
                       sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def step_window(prof) -> dict:
    """The steps' device time and the idle gaps by host range, from the
    window profiled with the host's ranges (whose own cost stretches the
    gaps). A device operation belongs to the step whose range holds the
    host's call that launched it: the CUDA runtime call with the
    operation's correlation id (kernels that the program launches through
    its own C library have no PyTorch operator around them)."""
    events = _kineto(prof)
    w0, w1 = next((a, b) for name, dev, a, b, _, _ in events
                  if name == SPAN + "window" and not dev)
    ranges = sorted((a, b, name[len(SPAN):]) for name, dev, a, b, _, _ in events
                    if not dev and name.startswith(SPAN) and name != SPAN + "window"
                    and w0 <= a <= w1)
    starts = [a for a, _, _ in ranges]
    launched = {corr: a for name, dev, a, _, user, corr in events
                if not dev and not user and name.startswith("cu")}
    stage_ms, device_ms = {}, 0.0
    for name, dev, a, b, user, corr in events:
        t = launched.get(corr) if dev and not user else None
        if t is None or not w0 <= t <= w1:
            continue
        device_ms += (b - a) / 1e6
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            stage_ms[ranges[i][2]] = stage_ms.get(ranges[i][2], 0.0) + (b - a) / 1e6
    busy = union([(a, b) for _, a, b in _device(events, w0, w1)])
    gaps = []
    for (_, end), (start, _) in zip(busy, busy[1:]):
        inside = [name for a, b, name in ranges if a <= end <= b]
        gaps.append((inside[-1] if inside else "host", (start - end) / 1e9))
    return {"stage_device_ms": stage_ms, "launched_device_ms": device_ms,
            "idle_gaps": [list(g) for g in sorted(gaps, key=lambda g: -g[1])[:TOP]]}
