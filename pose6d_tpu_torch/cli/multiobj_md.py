"""The `multiobj` section of the evidence document: multi-object frames
with the base and the scene-fine-tuned detector (counterpart of
scripts/multiobj_md.py).

Parses, under <workdir>/logs/:
  e2e_multiobj_{base,ftlast}_<run>.log    eval_e2e --max-objects 4 --classes
                                          1,2,3,4,5,6 --split train on the
                                          held-out scene (objects 1-4, seed 9),
                                          with the base detector and with the
                                          fine-tuned one's `last`
  yolo_ft.log                             train_yolo's fine-tune on the two
                                          training scenes (--scene-roots, lr 1e-4)
  e2e_ftlast_singleobj_<run>.log          the fine-tuned detector on the
                                          single-object test split (the
                                          regression gate)

parity_torch/run_evidence.sh stage 10 makes the scenes and runs these;
with no multi-object log this exits non-zero.

  python -m pose6d_tpu_torch.cli.multiobj_md --workdir /tmp/p6d \\
      --variants rgbd_geometric rgbd_geometric_widehead
"""

import argparse
import os
import re
import sys

from pose6d_tpu_torch.cli import add_device_arg

DETECTORS = (("base", "base (single-object trained)"), ("ftlast", "scene fine-tuned (last)"))
PATTERNS = {
    "objects": r"(\d+) GT objects",
    "det_rate": r"class-matched\): ([\d.]+)%",
    "add_mm": r"ADD \(matched\): ([\d.]+)mm",
    "add01d_matched": r"ADD-0\.1d \(matched\): ([\d.]+)%",
    "add01d_full": r"full system, unmatched = incorrect\): ([\d.]+)%",
}
SINGLE_PATTERNS = (("det_rate", r"detection rate: ([\d.]+)%"),
                   ("cls", r"class acc \(of detected\): ([\d.]+)%"),
                   ("full", r"undetected = incorrect\): ([\d.]+)%"))
FT_EPOCH = r"epoch (\d+)/\d+ loss ([\d.a-z]+) mAP@50 ([\d.]+)"


def _search(path: str, patterns):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        text = f.read()
    out = {}
    for k, p in patterns:
        m = re.search(p, text)
        if m:
            out[k] = float(m.group(1))
    return out or None


def parse_log(path: str):
    """A multi-object eval's numbers (PATTERNS), or None."""
    return _search(path, PATTERNS.items())


def parse_single(path: str):
    """A single-object regression gate's det rate, class accuracy and
    full-system ADD-0.1d, or None."""
    return _search(path, SINGLE_PATTERNS)


def markdown(logs: str, variants, device: str, card: str) -> str:
    rows = []
    for v in variants:
        for det, tag in DETECTORS:
            r = parse_log(os.path.join(logs, f"e2e_multiobj_{det}_{v}.log"))
            if r:
                rows.append((v, det, tag, r))
    if not rows:
        sys.exit(f"no multi-object logs e2e_multiobj_<detector>_<run>.log in {logs}")
    nan = float("nan")
    lines = [
        "### Multi-object frames (max_objects=4): base vs scene-fine-tuned detector, "
        "pose6d_tpu_torch\n\n",
        "A held-out scene of `generate_synthetic_scene`, every GT object matched to the "
        "best-scoring unused detection of its class (`python -m pose6d_tpu_torch.cli.eval_e2e "
        "--max-objects 4`). In parity_torch/run_evidence.sh stage 10 the scene holds objects "
        "1-4 in each of 120 frames (seed 9), and the fine-tuned detector resumes the base one "
        "to 9 epochs at lr 1e-4 on two training scenes (seeds 11 and 13, objects 1-4 and 3-6, "
        "300 frames each) mixed with the single-object frames (`train_yolo --scene-roots`) and "
        f"deploys its `last` (device {device}; {card}).\n\n",
        "| variant | detector | objects | det rate (class-matched) % | "
        "ADD mm | ADD-0.1d (matched) % | ADD-0.1d (full system) % |\n",
        "|---|---|---|---|---|---|---|\n",
    ]
    for v, _, tag, r in rows:
        lines.append(f"| {v} | {tag} | {int(r.get('objects', 0))} "
                     f"| {r.get('det_rate', nan):.1f} | {r.get('add_mm', nan):.1f} "
                     f"| {r.get('add01d_matched', nan):.2f} | {r.get('add01d_full', nan):.2f} |\n")
    lines.append("\n")

    ft_log = os.path.join(logs, "yolo_ft.log")
    if os.path.exists(ft_log):
        with open(ft_log) as f:
            epochs = re.findall(FT_EPOCH, f.read())
        if epochs:
            ep, loss, map50 = epochs[-1]
            lines.append(f"The fine-tune's last epoch: epoch {ep}, loss {loss}, mixed-val "
                         f"mAP@50 {map50} (`logs/yolo_ft.log`).\n\n")

    by = {(v, det): r for v, det, _, r in rows}
    for v in variants:
        b, f_ = by.get((v, "base")), by.get((v, "ftlast"))
        if b and f_:
            lines.append(f"Scene fine-tuning moves {v} class-matched recall "
                         f"{b.get('det_rate', 0):.1f}% -> {f_.get('det_rate', 0):.1f}% and "
                         f"full-system ADD-0.1d {b.get('add01d_full', 0):.2f}% -> "
                         f"{f_.get('add01d_full', 0):.2f}%.\n")

    gates = {v: parse_single(os.path.join(logs, f"e2e_ftlast_singleobj_{v}.log"))
             for v in variants}
    parts = [f"{v} det {g.get('det_rate', 0):.1f}% / class acc {g.get('cls', 0):.1f}% / "
             f"full-system {g.get('full', 0):.2f}%" for v, g in gates.items() if g]
    if parts:
        lines.append("\nSingle-object regression gates (the fine-tuned `last` detector on the "
                     "single-object test split; compare the full-system table): "
                     + "; ".join(parts) + ".\n")
    return "".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default="/tmp/pose6d_torch_parity")
    ap.add_argument("--variants", nargs="+", default=["rgbd_geometric", "rgbd_geometric_widehead"],
                    help="run names whose eval logs to read")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.cli.parity_md import card_of, write_section

    text = markdown(os.path.join(args.workdir, "logs"), args.variants, args.device,
                    card_of(args.workdir))
    path = write_section(args.workdir, "multiobj", text)
    print(f"wrote multiobj section {path}")


if __name__ == "__main__":
    main()
