"""Checkpoint-selection study: the reference's rule against the
deployment-aligned one (counterpart of scripts/selection_study.py).

The reference selects `best` by val ADD-0.1d on the LEARNED translation,
but the deployed pipeline re-derives X/Y by pinhole from the predicted Z
(infer/pipeline.py's geometric correction), so the rule ranks checkpoints
by a pathway that deployment throws away. For every trained run this
deploys each of the Trainer's checkpoints

  best         the reference's rule (val ADD-0.1d, learned translation)
  best_deploy  the deployment-aligned rule (val ADD-0.1d with X/Y
               pinhole-corrected from the predicted Z; train/loop.make_eval_step)
  last         the final epoch (no selection)

through `python -m pose6d_tpu_torch.cli.eval_e2e ... --checkpoint <name>`
(the detector in <workdir>/yolo, the --split split) and writes the
comparison as the `selection` section of <workdir>/PARITY_RESULTS.md.

  python -m pose6d_tpu_torch.cli.selection_study --workdir /tmp/p6d \\
      --variants rgbd_geometric rgbd_geometric_widehead

A run name carries parity_run's suffixes (_widehead, ...), which become
eval_e2e's flags. Results merge into <workdir>/selection_results.json
across calls, and the table shows every run in it, "—" where a checkpoint
has no result. A run without `last.pt` is skipped, and so is a checkpoint
file that is missing; an eval that fails is logged, the others still run
and the table is written, and then the command exits non-zero.
"""

import argparse
import json
import os
import subprocess
import sys

from pose6d_tpu_torch.cli import add_device_arg
from pose6d_tpu_torch.cli.parity_e2e import eval_args, parse_e2e

ORDER = ["rgb", "rgb_geometric", "rgbd", "rgbd_geometric"]


def run_eval(cmd: list) -> tuple:
    """cmd in a subprocess: (exit code, its stdout and stderr)."""
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout


def markdown(results: dict, split: str, device: str, card: str) -> str:
    def cell(v, c):
        r = results.get(v, {}).get(c)
        if not r:
            return "—"
        return f"{r.get('add01d_full', float('nan')):.2f}"

    lines = [
        "## Checkpoint-selection study: the reference's rule vs deployment-aligned "
        "selection, pose6d_tpu_torch\n\n",
        "The reference selects `best` by val ADD-0.1d on the LEARNED translation; the "
        "deployed pipeline re-derives X/Y by pinhole from the predicted Z "
        "(`infer/pipeline.py`). The Trainer also keeps `best_deploy`, selected by the same "
        "val metric on the pinhole-corrected translation (`train/loop.make_eval_step`), and "
        "`last`. Full-system ADD-0.1d (%) of each, detector in the loop "
        f"(`python -m pose6d_tpu_torch.cli.selection_study`, {split} split, device {device}; "
        f"{card}):\n\n",
        "| variant | best (reference rule) | best_deploy (deployment-aligned) "
        "| last (no selection) |\n",
        "|---|---|---|---|\n",
    ]
    for v in ORDER + sorted(set(results) - set(ORDER)):
        if v in results:
            lines.append(f"| {v} | {cell(v, 'best')} | {cell(v, 'best_deploy')} "
                         f"| {cell(v, 'last')} |\n")
    lines.append(
        "\nFor the geometric variants both rules score the same translation (X/Y are "
        "pinhole-derived in training too), so their columns differ only where val ties and "
        "noise pick other epochs. A \"—\" is a checkpoint with no result.\n")
    return "".join(lines)


def main(argv=None, runner=run_eval):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default="/tmp/pose6d_torch_parity")
    ap.add_argument("--split", default="test", choices=["val", "test"])
    ap.add_argument("--variants", nargs="+", default=ORDER,
                    help="run names (parity_run's, with their suffixes)")
    ap.add_argument("--checkpoints", nargs="+", default=["best", "best_deploy", "last"])
    ap.add_argument("--md-only", action="store_true",
                    help="rewrite the section from selection_results.json, run nothing")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.cli.parity_md import card_of, write_section

    data_root = os.path.join(args.workdir, "synth", "data")
    mesh_dir = os.path.join(args.workdir, "synth", "models")
    yolo_dir = os.path.join(args.workdir, "yolo")
    out_json = os.path.join(args.workdir, "selection_results.json")
    log_dir = os.path.join(args.workdir, "logs")
    os.makedirs(log_dir, exist_ok=True)

    results = {}
    if os.path.exists(out_json):
        with open(out_json) as f:
            results = json.load(f)

    failed = []
    if not args.md_only:
        for name in args.variants:
            pose_dir = os.path.join(args.workdir, f"weights_{name}")
            if not os.path.isfile(os.path.join(pose_dir, "last.pt")):
                print(f"[selection] {name}: no trained weights, skipping")
                continue
            variant, flags = eval_args(name)
            results.setdefault(name, {})
            for ckpt in args.checkpoints:
                if not os.path.isfile(os.path.join(pose_dir, f"{ckpt}.pt")):
                    print(f"[selection] {name}/{ckpt}: missing, skipping")
                    continue
                cmd = [sys.executable, "-m", "pose6d_tpu_torch.cli.eval_e2e",
                       "--variant", variant, "--data-root", data_root, "--mesh-dir", mesh_dir,
                       "--yolo-weights", yolo_dir, "--pose-weights", pose_dir,
                       "--split", args.split, "--checkpoint", ckpt,
                       "--device", args.device] + flags
                print("+", " ".join(cmd), flush=True)
                rc, out = runner(cmd)
                with open(os.path.join(log_dir, f"selection_{name}_{ckpt}.log"), "w") as f:
                    f.write(out)
                if rc != 0:
                    print(f"[selection] {name}/{ckpt} FAILED rc={rc}\n{out[-1500:]}")
                    failed.append(f"{name}/{ckpt}")
                    continue
                results[name][ckpt] = parse_e2e(out)
                with open(out_json, "w") as f:
                    json.dump(results, f, indent=2)

    path = write_section(args.workdir, "selection",
                         markdown(results, args.split, args.device, card_of(args.workdir)))
    print(f"wrote selection section {path} and reassembled the document")
    if failed:
        sys.exit(f"[selection] {len(failed)} eval(s) failed: {', '.join(failed)}")


if __name__ == "__main__":
    main()
