"""The readings that a cell's limits are set from, many seeds in one process.

    python3 -m posebench.calibrate --workload CELL --seeds N ... [--control-seeds N ...]
        [--seconds S] [--out FILE]

For each seed: the run's set-up, a closed-loop window of S seconds at the
cell's own load, and the judge's numbers (judge.NUMBERS), as one run makes
them; with the seed also in --control-seeds, the same again with the
program in its int8 mode (the lower-precision control). One JSON line per
reading on standard output (and appended to FILE): {"cell", "seed",
"control", "numbers" (judge.NUMBERS), "readings" (judge.READINGS: the
program's and the bf16 reference's 99th percentiles), "judged",
"attempted", "frames_per_s", "setup_s"}.
The limits (limits/<cell>.json) lie above the largest reading of the
program and below the smallest of the control; PERF.md gives both.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from . import cells, run

    run._environment(cells.ROOT)
    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("posebench.calibrate: no CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        for control in (False, True) if seed in args.control_seeds else (False,):
            r = run.serve_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                               control)
            e2e = run.end_to_end(r, cell.traffic)
            line = json.dumps({"cell": cell.name, "seed": seed, "control": control,
                               "numbers": r["verdict"]["numbers"],
                               "readings": r["verdict"]["readings"],
                               "judged": r["verdict"]["judged"],
                               "attempted": len(r["batches"]),
                               "frames_per_s": e2e["frames_per_s"], "setup_s": e2e["setup_s"]})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            del r
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
