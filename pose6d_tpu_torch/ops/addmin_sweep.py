"""Time the ADD-S nearest-point kernel on the card under other plans.

    python -m pose6d_tpu_torch.ops.addmin_sweep [--batch 8 32] [--points 500 2048]
        [--out chiprun_out/addmin_sweep.txt]

For each (B, P): a seeded centred model cloud padded by repetition (as
load_object_models pads one) and predicted points a few millimetres off it;
then every plan (tile, R, splits) of TILES x R_VALUES x SPLITS that the
kernel takes, at 32 threads a block or more. Each plan's output is held bit
for bit against addmin_plan's first. Times, all CUDA events around
launches of the C entry point alone (no wrapper): "single", the median of
single launches behind a ~2 ms spin (as chip_smoke.py times a kernel), and
"stream", one event pair around STREAM launches back to back, over STREAM
(the launches overlap their fixed costs, so plans differ by their work).
Beside them the floor: the same two readings of an empty kernel
(torch.cuda._sleep(1)). Prints each shape's floor, addmin_plan's plan and
the fastest plans by stream time; --out writes every plan's line. addmin_plan's
rule was chosen from this table. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import itertools
import os
import statistics

import numpy as np
import torch

from . import addmin

SPIN_CYCLES = 4_000_000
STREAM = 50
TILES = (8, 16, 32, 64, 128)
SPLITS = (1, 2, 4, 8, 16, 32)


def single_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stream_ms(fn, n: int = STREAM, reps: int = 10) -> float:
    """Median over reps of one event pair around n launches, over n. A spin
    ahead of the start event holds the card while the host enqueues all n;
    if the start event has fired by the time the host is done, the card
    may have waited for it, so the run is repeated behind a longer spin."""
    fn()
    times, spin = [], SPIN_CYCLES
    while len(times) < reps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(n):
            fn()
        held = not start.query()
        end.record()
        end.synchronize()
        if held:
            times.append(start.elapsed_time(end) / n)
        else:
            spin *= 2
    return statistics.median(times)


def plans():
    for tile, r, splits in itertools.product(TILES, addmin.R_VALUES, SPLITS):
        if tile % r or splits * (tile // r) > addmin.MAX_THREADS or splits * (tile // r) < 32:
            continue
        yield addmin.AddminPlan(tile, r, splits)


def inputs(B: int, P: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    n_real = max(1, P * 3 // 4)
    gt = np.empty((B, P, 3))
    for b in range(B):
        pts = rng.normal(0, 0.05, (n_real, 3))
        gt[b] = np.concatenate([pts, pts[rng.choice(n_real, P - n_real)]])
    gt -= gt.mean(1, keepdims=True)
    pred = gt + rng.normal(0, 0.004, gt.shape)
    dev = torch.device("cuda")
    return (torch.from_numpy(pred.astype(np.float32)).to(dev),
            torch.from_numpy(gt.astype(np.float32)).to(dev))


def sweep(B: int, P: int) -> tuple[list[str], list[str]]:
    """(summary lines, every plan's line) for one shape."""
    pred, gt = inputs(B, P)
    chosen = addmin.addmin_plan(B, P)
    want = addmin.pairwise_min_dist_kernel(pred, gt)
    out = torch.empty_like(want)
    stream = torch.cuda.current_stream().cuda_stream
    floor = (single_ms(lambda: torch.cuda._sleep(1)), stream_ms(lambda: torch.cuda._sleep(1)))
    rows = []
    for plan in dict.fromkeys([*plans(), chosen]):
        def launch(plan=plan):
            addmin._launch_addmin(pred, gt, out, plan, stream)

        out.fill_(float("nan"))
        launch()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise RuntimeError(f"addmin at B {B}, P {P}: plan {plan} differs from {chosen}")
        rows.append((stream_ms(launch), single_ms(launch), plan))
    rows.sort(key=lambda row: row[0])

    def line(row):
        s, t, p = row
        mark = " (addmin_plan)" if p == chosen else ""
        return (f"  tile {p.tile:3d} R {p.r} splits {p.splits:2d}: {p.blocks(B, P):5d} blocks x "
                f"{p.threads:4d} threads; stream {s:.5f} single {t:.5f}{mark}")

    rank = next(i for i, row in enumerate(rows) if row[2] == chosen)
    head = [f"B {B}, P {P}: ms (CUDA events); floor (torch.cuda._sleep(1)) single "
            f"{floor[0]:.5f} stream {floor[1]:.5f}; addmin_plan {chosen} ranks {rank + 1} "
            f"of {len(rows)} by stream", line(rows[rank])]
    head += [line(row) for row in rows[:8]]
    return head, [head[0]] + [line(row) for row in rows]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--points", type=int, nargs="+", default=[500, 2048])
    ap.add_argument("--out", default=None, help="write every plan's line here")
    args = ap.parse_args()
    full = []
    for B, P in itertools.product(args.batch, args.points):
        head, rows = sweep(B, P)
        for line in head:
            print(line, flush=True)
        full += rows
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(full) + "\n")


if __name__ == "__main__":
    main()
