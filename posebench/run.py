"""The benchmark of pose6d_tpu_torch's serving pipeline on NVIDIA GPUs.

    python3 -m posebench.run --workload CELL --seed N --seconds S --trace 0|1

run from the root of a checkout that holds BENCHMARK.json, posebench/ and
pose6d_tpu_torch/. CELL is a `workloads` name of BENCHMARK.json; its
configuration, traffic mix, limits and per-layer metrics are files found by
name (cells.py).

A run: seeded weights and request batches made on the card (weights.py,
serve.py), the program's PosePipeline built through its public API and
folded as the configuration says, warm-up at the cell's own shapes (the
first run in a checkout also builds the program's CUDA library) -- that is
set-up -- then a closed loop of `in_flight` batches for S seconds. With
--trace 1 there follow a few batches served one at a time, for the host's
own time to hand a batch over, and the profiled windows of the program's
step methods (trace.py). Once the windows have closed and the memory peak is read, the
program is freed and every batch it served is judged against the plain
reference (judge.py).

Output: the last line of standard output is one JSON object, {"correct",
"attempted" (batches handed over in the window), "failed" (batches whose
outputs exceed a limit), "metrics" (--trace 0: the cell's end-to-end
metrics; --trace 1: its per-layer metrics), "device", ["breakdown"],
"checks" (each number compared, with its limit)}; the last lines of
standard error repeat the checks. Exit status 0 with a result; 2 on bad
arguments; 3 without a CUDA card (or fewer than the cell asks for); 4
where the program cannot be imported; 5 where JAX or the JAX package was
loaded. calibrate.py runs the correctness check's lower-precision control,
the program's int8 mode, through serve_cell.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pose6d_tpu")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}


def _environment(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    program builds its CUDA library into pose6d_tpu_torch/_build/ itself)."""
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(root, "posebench_cache", sub)


def loaded_forbidden() -> list:
    """The top-level names of loaded modules that are JAX or the JAX
    package, compared whole (pose6d_tpu_torch is neither)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w():
    """The card's power limit by nvidia-smi, or None where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def percentile(values: list, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def serve_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float,
               control: bool = False) -> dict:
    """Set up, serve, trace and judge one run of a cell on `device`.
    Returns the result's parts: setup_s, the window's batches and numbers,
    the trace record, the memory peak, the judge's verdict."""
    import torch

    from . import judge, serve, trace as tracing

    cfg, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    variant = cfg["pipeline"]["variant"]
    ring = serve.make_ring(traffic, seed, device, depth=variant in ("rgbd", "rgbd_geometric"))
    state = serve.seeded_weights(cfg, traffic, seed, ring)
    pipe = serve.build(cfg, traffic, state, device, ring, control)

    def call(entry):
        return pipe(entry["frames"], entry["K"], entry["depth"])

    in_flight = traffic["in_flight"]
    serve.closed_loop(call, ring, in_flight, batches=serve.WARMUP_BATCHES)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    start, end, batches = serve.closed_loop(call, ring, in_flight, seconds=seconds)
    record, traced = None, []
    if trace:
        # the host's own time to hand a batch over: one in flight, so that
        # the card is idle when each call starts and no launch waits on it
        _, _, alone = serve.closed_loop(call, ring, 1, batches=tracing.TRACE_BATCHES)
        record, traced = tracing.traced(pipe, ring, in_flight)
        record["host_enqueue_ms"] = [b.enqueue_s * 1e3 for b in alone]
        traced = alone + traced
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = judge.Judge(cfg, traffic, state, ring, cell.limits).judge(batches + traced)
    return {"setup_s": setup_s, "start": start, "end": end, "batches": batches,
            "record": record, "memory_peak_bytes": peak, "verdict": verdict,
            "shapes": serve.state_shapes(cfg, traffic)}


def end_to_end(run: dict, traffic: dict) -> dict:
    """frames_per_s: the frames of every batch completed in the window over
    the window; batch_p95_ms: the 95th percentile of every such batch's
    time from its hand-over to its outputs on the host; setup_s."""
    done = [b for b in run["batches"] if b.done <= run["end"]]
    window = run["end"] - run["start"]
    return {"frames_per_s": len(done) * traffic["frames_per_batch"] / window,
            "batch_p95_ms": percentile([(b.done - b.submitted) * 1e3 for b in done], 95),
            "setup_s": run["setup_s"]}


def per_layer(run: dict, cell) -> dict:
    """Each per-layer metric's reader over the trace record, which carries
    the untraced window's numbers too."""
    from . import cells

    done = [b for b in run["batches"] if b.done <= run["end"]]
    rec = dict(run["record"], config=cell.config, traffic=cell.traffic, shapes=run["shapes"],
               frames_per_s=end_to_end(run, cell.traffic)["frames_per_s"] if done else None)
    out = {}
    for m in cell.per_layer:
        value = cells.reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = value
    return out


def judged(verdict: dict, limits: dict) -> tuple:
    """({number: {"value", "limit"}}, correct): correct where every number
    compared is within its limit (a NaN is not)."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in verdict["numbers"].items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import cells, judge

    _environment(cells.ROOT)
    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"posebench: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    try:
        import pose6d_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"posebench: the program under test cannot be imported: {e}", file=sys.stderr)
        return 4
    run = serve_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", _T0)
    bad = loaded_forbidden()
    if bad:
        print(f"posebench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 5
    verdict = run["verdict"]
    checks, correct = judged(verdict, cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    values = per_layer(run, cell) if args.trace else end_to_end(run, cell.traffic)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": run["memory_peak_bytes"], "power_limit_w": power_limit_w()}
    line = {"correct": correct, "attempted": len(run["batches"]), "failed": verdict["failed"],
            "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()}}
    line["device"] = device
    if args.trace:
        rec = run["record"]
        print(f"trace: the steps' ranges hold {sum(rec['stage_device_ms'].values())!r} of "
              f"{rec['launched_device_ms']!r} device ms launched in the window", file=sys.stderr)
        in_window = [b.enqueue_s * 1e3 for b in run["batches"]]
        print(f"trace: the call takes {percentile(rec['host_enqueue_ms'], 50)!r} ms a batch "
              f"with the card idle at its start, {percentile(in_window, 50)!r} ms in the window "
              f"with {cell.traffic['in_flight']} in flight", file=sys.stderr)
        device.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        line["breakdown"] = {"device_ops": rec["device_ops"], "idle_gaps": rec["idle_gaps"]}
    line["checks"] = checks
    for k, (p, y) in verdict["readings"].items():
        print(f"reading {k} q{judge.QUANTILE} program {p!r} bf16 reference {y!r}",
              file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
