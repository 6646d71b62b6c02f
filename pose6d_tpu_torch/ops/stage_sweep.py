"""Time the bf16 stage kernel's GEMMs on the card under other tilings.

    python -m pose6d_tpu_torch.ops.stage_sweep [--batch 8] [--stages 1 2 3 4]

For each stage at the batch: the whole bf16 fused_stage call, then every
GEMM geometry of its plan (block 0's conv1, conv2 and conv3 with the
shortcut; block 1's conv1, conv2 and conv3 with the residual) launched
alone through pose6d_gemm_bf16 at the plan's (tile N, splits) and at each
alternative, on seeded random inputs. Times are CUDA-event medians of
single launches behind a ~2 ms spin (the launch's host path is hidden);
stage_plan's rule was chosen from this table. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import statistics

import torch

from .. import _build
from . import fused_block as fb

SPIN_CYCLES = 4_000_000
SPLITS = (1, 2, 3, 4, 6, 8)


def event_ms(fn, reps: int = 9, warmup: int = 2) -> float:
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


def _gemm_inputs(stage: int, name: str, batch: int, gen: torch.Generator) -> dict:
    """Operands of one GEMM of the stage: A1 (dense [M, K1] or, for a 3x3,
    the [B, h, w, C] map), W1, bias, and the shortcut pair or the residual;
    geometry (h, w, ho, wo, stride) as the stage passes it."""
    _, _, stride, cin, cmid, cout, h, w = fb.STAGE_CFGS[stage]
    ho, wo = h // stride, w // stride
    dev = torch.device("cuda")

    def rand(*shape, scale=0.1):
        return (torch.randn(*shape, generator=gen) * scale).to(torch.bfloat16).to(dev)

    block0 = name.startswith("b0")
    conv = name.split(".")[1]
    d = {"a2": None, "res": None, "K2": 0, "conv3x3": conv == "conv2"}
    if conv == "conv1":
        hi, wi = (h, w) if block0 else (ho, wo)
        d.update(a1=rand(batch * hi * wi, cin if block0 else cout), N=cmid,
                 geo=(hi, wi, hi, wi, 1))
    elif conv == "conv2":
        hi, wi, s = (h, w, stride) if block0 else (ho, wo, 1)
        d.update(a1=rand(batch, hi, wi, cmid), N=cmid, geo=(hi, wi, hi // s, wi // s, s))
    else:
        d.update(a1=rand(batch * ho * wo, cmid), N=cout)
        if block0:
            d.update(a2=rand(batch, h, w, cin), K2=cin, geo=(h, w, ho, wo, stride))
        else:
            d.update(res=rand(batch * ho * wo, cout), geo=(ho, wo, ho, wo, 1))
    d["K1"] = cmid * 9 if d["conv3x3"] else d["a1"].shape[-1]
    d["M"] = batch * d["geo"][2] * d["geo"][3]
    d["w1"] = rand(d["K1"], d["N"], scale=d["K1"] ** -0.5)
    d["w2"] = rand(d["K2"], d["N"], scale=0.05) if d["K2"] else None
    d["bias"] = torch.zeros(d["N"], device=dev)
    d["bias2"] = torch.zeros(d["N"], device=dev) if d["K2"] else None
    return d


def _gemm_launch(d: dict, bn: int, splits: int):
    M, N = d["M"], d["N"]
    dev = torch.device("cuda")
    out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    ws = torch.empty(splits * M * N if splits > 1 else 0, device=dev)
    tickets = torch.zeros(-(-M // fb.TILE_M) * (N // bn), dtype=torch.int32, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    h, w, ho, wo, s = d["geo"]
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.lib()

    def run():
        code = lib.pose6d_gemm_bf16(
            ptr(d["a1"]), ptr(d["w1"]), ptr(d["a2"]), ptr(d["w2"]), ptr(d["bias"]),
            ptr(d["bias2"]), ptr(d["res"]), ptr(out), ptr(ws), ptr(tickets), M, N, d["K1"],
            d["K2"], h, w, ho, wo, s, int(d["conv3x3"]), bn, splits, stream)
        _build.check(code, "pose6d_gemm_bf16")

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--stages", type=int, nargs="+", default=[1, 2, 3, 4])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stage_sweep needs a CUDA card")
    _build.lib()
    gen = torch.Generator().manual_seed(0)
    print(f"{torch.cuda.get_device_name(0)}, batch {args.batch}; times in us")
    for stage in args.stages:
        _, n_blocks, _, cin, _, _, h, w = fb.STAGE_CFGS[stage]
        shapes = fb._stage_shapes(stage)
        weights = tuple((torch.randn(*s, generator=gen) * (0.1 if len(s) == 1 else s[0] ** -0.5))
                        .to(torch.float32 if len(s) == 1 else torch.bfloat16).cuda()
                        for s in shapes)
        x = torch.randn(args.batch, h, w, cin, generator=gen).to(torch.bfloat16).cuda()
        total = event_ms(lambda: fb.fused_stage(x, weights, stage)) * 1e3
        print(f"stage {stage}: fused_stage {total:.1f}")
        for g in fb.stage_plan(stage, args.batch)[:6]:
            d = _gemm_inputs(stage, g.name, args.batch, gen)
            times = {}
            for bn in (64, 128):
                for splits in SPLITS:
                    if g.n % bn == 0 and splits <= g.k_steps:
                        times[bn, splits] = event_ms(_gemm_launch(d, bn, splits)) * 1e3
            times.setdefault((g.bn, g.splits), event_ms(_gemm_launch(d, g.bn, g.splits)) * 1e3)
            best = sorted(times.items(), key=lambda kv: kv[1])[:4]
            print(f"  {g.name} M{g.m} N{g.n} K{g.k1}{'+' + str(g.k2) if g.k2 else ''}: plan "
                  f"bn{g.bn} x{g.splits} {times[g.bn, g.splits]:.1f}; fastest "
                  + ", ".join(f"bn{bn} x{sp} {t:.1f}" for (bn, sp), t in best))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
