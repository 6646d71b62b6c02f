"""The `serving` section of the evidence document: the serving modes'
accuracy gates on trained weights (counterpart of scripts/serving_md.py).

A serving mode counts only if it keeps the trained system's accuracy.
This parses <workdir>/logs/e2e_<mode>_<run>.log, the output of
`python -m pose6d_tpu_torch.cli.eval_e2e` on the test split for each mode:

  float           f32 towers (no flag)
  int8            --int8-backbone: int8 towers and detector, calibrated on
                  the first batch
  folded          --folded-backbone: BatchNorm folded, bf16, cuDNN's
                  convolutions
  folded_kernels  --folded-backbone --folded-stem --folded-stages 1,2,3,4:
                  the same through the port's stem and stage kernels
                  (csrc/stem_tc.cu, csrc/stage_wgmma.cu)

parity_torch/run_evidence.sh stage 9 runs the evals; a run whose logs are
all missing is left out, and with no log at all this exits non-zero.

  python -m pose6d_tpu_torch.cli.serving_md --workdir /tmp/p6d \\
      --variants rgbd_geometric rgbd_geometric_widehead
"""

import argparse
import os
import re
import sys

from pose6d_tpu_torch.cli import add_device_arg

MODES = (("float", "float (f32 eval)"),
         ("int8", "int8 PTQ, int8 towers + detector"),
         ("folded", "folded bf16 (cuDNN convolutions)"),
         ("folded_kernels", "folded bf16, stem + stage 1-4 kernels"))
# eval_e2e's flags per mode, for the stage that runs the evals
MODE_FLAGS = {"float": [], "int8": ["--int8-backbone"], "folded": ["--folded-backbone"],
              "folded_kernels": ["--folded-backbone", "--folded-stem",
                                 "--folded-stages", "1,2,3,4"]}
PATTERNS = {
    "det_rate": r"detection rate: ([\d.]+)%",
    "add_mm": r"ADD \(detected\): ([\d.]+)mm",
    "add01d_det": r"ADD-0\.1d \(detected\): ([\d.]+)%",
    "add01d_full": r"undetected = incorrect\): ([\d.]+)%",
}


def parse_log(path: str):
    """The gate's numbers from an eval_e2e log, or None (no file, or
    none of PATTERNS in it)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        text = f.read()
    out = {}
    for k, p in PATTERNS.items():
        m = re.search(p, text)
        if m:
            out[k] = float(m.group(1))
    return out or None


def gate_rows(logs: str, variants) -> list:
    """[(run, mode, label, numbers)] of every log present, runs then modes."""
    rows = []
    for v in variants:
        for key, label in MODES:
            r = parse_log(os.path.join(logs, f"e2e_{key}_{v}.log"))
            if r:
                rows.append((v, key, label, r))
    return rows


def markdown(rows: list, variants, device: str, card: str) -> str:
    nan = float("nan")
    lines = [
        "## Serving-mode accuracy gates, pose6d_tpu_torch\n\n",
        "Each serving mode deploys the trained runs through `python -m "
        "pose6d_tpu_torch.cli.eval_e2e` on the test split, detector in the loop "
        "(`--int8-backbone`, `--folded-backbone`, and `--folded-backbone --folded-stem "
        "--folded-stages 1,2,3,4`, which puts the hand-written stem and stage kernels "
        f"behind the gate; logs `logs/e2e_<mode>_<run>.log`; device {device}; {card}).\n\n",
        "| variant | mode | det rate % | ADD mm | ADD-0.1d (detected) % | "
        "ADD-0.1d (full system) % |\n",
        "|---|---|---|---|---|---|\n",
    ]
    for v, key, label, r in rows:
        lines.append(f"| {v} | {label} | {r.get('det_rate', nan):.1f} "
                     f"| {r.get('add_mm', nan):.1f} | {r.get('add01d_det', nan):.2f} "
                     f"| {r.get('add01d_full', nan):.2f} |\n")
    by = {(v, k): r for v, k, _, r in rows}
    notes = []
    for v in variants:
        base = by.get((v, "float"))
        for key, _ in MODES[1:]:
            r = by.get((v, key))
            if base and r and "add01d_full" in base and "add01d_full" in r:
                notes.append(f"{v} {key} {r['add01d_full'] - base['add01d_full']:+.2f}")
    if notes:
        lines.append("\nFull-system ADD-0.1d against float, in percentage points: "
                     + "; ".join(notes) + ".\n")
    return "".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default="/tmp/pose6d_torch_parity")
    ap.add_argument("--variants", nargs="+", default=["rgbd_geometric", "rgbd_geometric_widehead"],
                    help="run names whose gate logs to read")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.cli.parity_md import card_of, write_section

    rows = gate_rows(os.path.join(args.workdir, "logs"), args.variants)
    if not rows:
        sys.exit(f"no gate logs e2e_<mode>_<run>.log in {args.workdir}/logs")
    path = write_section(args.workdir, "serving",
                         markdown(rows, args.variants, args.device, card_of(args.workdir)))
    print(f"wrote serving section {path}")


if __name__ == "__main__":
    main()
