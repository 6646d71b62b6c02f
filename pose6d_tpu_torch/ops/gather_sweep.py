"""Time the frame gather on the card at other grids.

    python -m pose6d_tpu_torch.ops.gather_sweep [--batch 32 ...] [--frames 256]

On seeded resident stores of LineMOD's 640x480 frames as 32-bit words (RGB
rows of 230,400 words, depth rows of 153,600), for each number of blocks
per SM of csrc/gather.cu's grid, the gather of `batch` rows:
"cold", cycling through the disjoint batches of one permutation of the
frames, as a train epoch draws them (each run reads frames that the last
runs did not, so its source is not in the 50 MB L2), and "warm", the same
batch every run; beside them index_select, the library call, in both
modes, and a contiguous copy of the same bytes (copy_ of `batch` whole
rows: what the card's copy rate allows a gather). Each output is held bit
for bit against the plain version first. Times are CUDA-event medians of single launches behind a ~2 ms spin (the
launch's host path is hidden); BLOCKS_PER_SM in ops/gather_frames.py was
chosen from this table. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import itertools
import statistics

import torch

from . import gather_frames as gf

SPIN_CYCLES = 4_000_000
BLOCKS_PER_SM = (1, 2, 3, 4, 6, 8)
ROW_WORDS = {"rgb": 640 * 480 * 3 // 4, "depth": 640 * 480 * 2 // 4}


def event_ms(fn, reps: int = 24, warmup: int = 3) -> float:
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


def sweep(batch: int, frames: int, seed: int = 0) -> list[str]:
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(frames, generator=gen).to(torch.int32).to(dev)
    batches = [perm[i:i + batch] for i in range(0, frames - batch + 1, batch)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    lines = [f"batch {batch}, {frames} frames, {len(batches)} disjoint batches; ms "
             f"(CUDA-event medians), cold / warm"]
    for kind, r in ROW_WORDS.items():
        words = torch.randint(-2**31, 2**31 - 1, (frames, r), dtype=torch.int32,
                              generator=gen).to(dev)
        bound = 2.0 * batch * r * 4 / 3.35e12 * 1e3

        def timed(fn):
            cold = itertools.cycle(batches)
            return (event_ms(lambda: fn(next(cold))), event_ms(lambda: fn(batches[0])))

        lib = timed(lambda idx: words.index_select(0, idx))
        out = torch.empty(batch, r, dtype=torch.int32, device=dev)
        starts = itertools.cycle(range(0, frames - batch + 1, batch))
        copy = (event_ms(lambda: out.copy_(words[next(starts):][:batch])),
                event_ms(lambda: out.copy_(words[:batch])))
        lines.append(f"{kind}: bound {bound:.5f}; index_select {lib[0]:.4f} / {lib[1]:.4f}; "
                     f"contiguous copy_ {copy[0]:.4f} / {copy[1]:.4f}")
        want = gf._gather_rows_plain(words, batches[0])
        for per_sm in BLOCKS_PER_SM:
            def launch(idx, per_sm=per_sm):
                gf._launch_gather(words, idx, out, stream, blocks_per_sm=per_sm)

            launch(batches[0])
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"gather ({kind} words, {per_sm} blocks per SM) differs "
                                   f"from its plain version")
            cold, warm = timed(launch)
            mark = " (wrapper's)" if per_sm == gf.BLOCKS_PER_SM else ""
            lines.append(f"  x{per_sm} per SM{mark}: {cold:.4f} / {warm:.4f}")
        del words
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[32])
    ap.add_argument("--frames", type=int, default=256)
    args = ap.parse_args()
    for batch in args.batch:
        for line in sweep(batch, args.frames):
            print(line, flush=True)


if __name__ == "__main__":
    main()
