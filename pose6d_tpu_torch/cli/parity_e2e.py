"""Full-system parity evidence: the detector in the loop on the fixture
(counterpart of scripts/parity_e2e.py), the second stage after
cli/parity_run.py:

  1. train YOLOv8n on parity_run's synthetic tree through cli.train_yolo
     (the reference recipe: 5 epochs, 640, batch 16), resumable;
     --skip-detector reuses <workdir>/yolo;
  2. run cli.eval_e2e (trained detector -> crop on the card -> pose net) on
     the test split for each variant whose weights_<variant>/best.pt
     exists; a run name's parity_run suffixes (_widehead, ...) become
     eval_e2e's flags;
  3. write e2e_results.json (merged across calls) and E2E.md, the table
     (also the `e2e` section of <workdir>/PARITY_RESULTS.md,
     cli/parity_md.py).

  python -m pose6d_tpu_torch.cli.parity_e2e --workdir /tmp/pose6d_torch_parity \\
      --variants rgbd_geometric

Each stage runs as `python -m pose6d_tpu_torch.cli.<name> ... --device <d>`
in a subprocess, its output appended to <workdir>/e2e_run.log. --md-only
rewrites the table from e2e_results.json and runs nothing.
"""

import argparse
import json
import os
import re
import subprocess
import sys

from pose6d_tpu_torch.cli import add_device_arg
from pose6d_tpu_torch.cli.parity_run import flags_of

# eval_e2e's report lines (cli/eval_e2e.py, the single-object path)
E2E_PATTERNS = {
    "det_rate": r"detection rate: ([\d.]+)%",
    "cls_acc": r"class acc \(of detected\): ([\d.]+)%",
    "add_mm": r"ADD \(detected\): ([\d.]+)mm",
    "add_s_mm": r"ADD-S \(detected\): ([\d.]+)mm",
    "add01d_det": r"ADD-0\.1d \(detected\): ([\d.]+)%",
    "add01d_full": r"full system, undetected = incorrect\): ([\d.]+)%",
    "frames_per_s": r"after set-up: ([\d.]+) frames/s",
}


def run(cmd, log_path):
    """cmd in a subprocess, its output appended to log_path; its stdout.
    A non-zero exit raises."""
    print("+", " ".join(cmd), flush=True)
    with open(log_path, "a") as log:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.write(proc.stdout)
    print(proc.stdout[-2000:], flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[2]} failed rc={proc.returncode}")
    return proc.stdout


def parse_e2e(stdout: str) -> dict:
    """The metrics of eval_e2e's report, by E2E_PATTERNS' keys (those
    printed)."""
    out = {}
    for key, pat in E2E_PATTERNS.items():
        m = re.search(pat, stdout)
        if m:
            out[key] = float(m.group(1))
    return out


def eval_args(name: str) -> tuple:
    """(base variant, eval_e2e's architecture flags) of a parity_run run
    name."""
    f = flags_of(name)
    flags = [flag for flag, on in (("--rot-head-wide", f["rot_head_wide"]),
                                   ("--no-fusion-attention", not f["fusion_attention"]),
                                   ("--z-from-backbone", f["z_from_backbone"]),
                                   ("--z-backbone-wide", f["z_backbone_wide"])) if on]
    return f["variant"], flags


def write_markdown(args, results: dict) -> str:
    """E2E.md and the `e2e` section; returns E2E.md's path."""
    from pose6d_tpu_torch.cli.parity_md import card_of, write_section

    path = os.path.join(args.workdir, "E2E.md")
    parts = [
        "## Full-system (detector-in-the-loop) evaluation, pose6d_tpu_torch\n\n"
        f"YOLOv8n trained {args.epochs} epochs on the fixture (the reference recipe), then "
        "the deployed pipeline, detector -> crop on the card -> pose net, evaluated on the "
        f"{args.split} split by `python -m pose6d_tpu_torch.cli.eval_e2e` "
        f"(device {args.device}; {card_of(args.workdir)}).\n\n"
        "| variant | det rate % | cls acc % | ADD mm | ADD-S mm | "
        "ADD-0.1d (detected) % | ADD-0.1d (full system) % |\n"
        "|---|---|---|---|---|---|---|\n"
    ]
    nan = float("nan")
    for v, r in results.items():
        parts.append(f"| {v} | {r.get('det_rate', nan):.1f} | {r.get('cls_acc', nan):.1f} "
                     f"| {r.get('add_mm', nan):.1f} | {r.get('add_s_mm', nan):.1f} "
                     f"| {r.get('add01d_det', nan):.2f} | {r.get('add01d_full', nan):.2f} |\n")
    with open(path, "w") as f:
        f.writelines(parts)
    write_section(args.workdir, "e2e", "".join(parts))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default="/tmp/pose6d_torch_parity")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--split", default="test", choices=["val", "test"])
    ap.add_argument("--variants", nargs="+",
                    default=["rgb", "rgb_geometric", "rgbd", "rgbd_geometric"])
    ap.add_argument("--skip-detector", action="store_true",
                    help="reuse the detector already trained in <workdir>/yolo")
    ap.add_argument("--md-only", action="store_true",
                    help="rewrite the table from e2e_results.json without running anything")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    data_root = os.path.join(args.workdir, "synth", "data")
    mesh_dir = os.path.join(args.workdir, "synth", "models")
    yolo_dir = os.path.join(args.workdir, "yolo")
    log_path = os.path.join(args.workdir, "e2e_run.log")
    out_json = os.path.join(args.workdir, "e2e_results.json")

    if args.md_only:
        with open(out_json) as f:
            write_markdown(args, json.load(f))
        return

    cli = [sys.executable, "-m"]
    if not args.skip_detector:
        run(cli + ["pose6d_tpu_torch.cli.train_yolo", "--data-root", data_root,
                   "--save-dir", yolo_dir, "--epochs", str(args.epochs),
                   "--batch-size", str(args.batch_size), "--img-size", str(args.img_size),
                   "--device", args.device], log_path)

    results = {}
    if os.path.exists(out_json):  # merged across calls
        with open(out_json) as f:
            results = json.load(f)
    for name in args.variants:
        pose_dir = os.path.join(args.workdir, f"weights_{name}")
        if not os.path.isfile(os.path.join(pose_dir, "best.pt")):
            print(f"[e2e] {name}: no trained weights, skipping")
            continue
        variant, flags = eval_args(name)
        stdout = run(cli + ["pose6d_tpu_torch.cli.eval_e2e", "--variant", variant,
                            "--data-root", data_root, "--mesh-dir", mesh_dir,
                            "--yolo-weights", yolo_dir, "--pose-weights", pose_dir,
                            "--split", args.split, "--device", args.device] + flags, log_path)
        results[name] = parse_e2e(stdout)

    with open(out_json, "w") as f:
        json.dump(results, f, indent=2)
    path = write_markdown(args, results)
    print(f"wrote {out_json} and {path}")


if __name__ == "__main__":
    main()
