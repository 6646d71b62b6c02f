"""The `narrative` section of the evidence document (counterpart of
scripts/parity_report.py): what the port's tables show, read from the
port's own files in the workdir, and nothing else:

  results.json            parity_run / parity_summarize: val ADD-0.1d per run
  e2e_results.json        parity_e2e: the detector in the loop
  selection_results.json  selection_study: best / best_deploy / last
  logs/e2e_<mode>_<run>.log  the serving gates (cli/serving_md.py)

A file that is missing leaves its paragraph out.

  python -m pose6d_tpu_torch.cli.parity_report --workdir /tmp/p6d
"""

import argparse
import json
import os

from pose6d_tpu_torch.cli import add_device_arg


def _load(workdir: str, name: str) -> dict:
    path = os.path.join(workdir, name)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def markdown(workdir: str, results: dict, e2e: dict, selection: dict, serving_variants,
             device: str, card: str) -> str:
    from pose6d_tpu_torch.cli.serving_md import gate_rows

    parts = ["## Reading the tables, pose6d_tpu_torch\n\n",
             f"Read from the port's files in this workdir (device {device}; {card}).\n\n"]
    if results:
        ranked = sorted(results.items(), key=lambda kv: -kv[1]["best_add01d"])
        parts.append(
            "**Val split (GT-box crops).** Best val ADD-0.1d by run: "
            + ", ".join(f"{n} {r['best_add01d']:.2f}% (epoch {r['best_epoch']} of "
                        f"{r['epochs_run']})" for n, r in ranked) + ".")
        fast = [(n, r) for n, r in ranked if r.get("epoch_half_best")]
        if fast:
            parts.append(" Epoch at which each first reached half its best: "
                         + ", ".join(f"{n} {r['epoch_half_best']}" for n, r in fast) + ".")
        parts.append("\n\n")
    if e2e:
        parts.append(
            "**Deployed (detector in the loop, test split).** Full-system ADD-0.1d by run: "
            + ", ".join(f"{n} {r['add01d_full']:.2f}% (detection rate {r.get('det_rate', 0):.1f}%"
                        + (f", val {results[n]['best_add01d']:.2f}%" if n in results else "")
                        + ")" for n, r in e2e.items() if "add01d_full" in r) + ".\n\n")
    if selection:
        cells = []
        for n, by in selection.items():
            got = {c: r["add01d_full"] for c, r in by.items() if "add01d_full" in r}
            if got:
                best = max(got, key=got.get)
                cells.append(f"{n}: " + ", ".join(f"{c} {v:.2f}%" for c, v in got.items())
                             + f" (highest: {best})")
        if cells:
            parts.append("**Checkpoint selection.** Full-system ADD-0.1d per checkpoint: "
                         + "; ".join(cells) + ".\n\n")
    rows = gate_rows(os.path.join(workdir, "logs"), serving_variants)
    if rows:
        by = {(v, k): r for v, k, _, r in rows}
        deltas = [f"{v} {k} {r['add01d_full'] - by[(v, 'float')]['add01d_full']:+.2f}"
                  for (v, k), r in by.items()
                  if k != "float" and (v, "float") in by and "add01d_full" in r]
        parts.append("**Serving modes.** Full-system ADD-0.1d of each mode against float, in "
                     "percentage points: " + ("; ".join(deltas) or "no pair with a float row")
                     + ".\n")
    return "".join(parts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default="/tmp/pose6d_torch_parity")
    ap.add_argument("--serving-variants", nargs="+",
                    default=["rgbd_geometric", "rgbd_geometric_widehead"],
                    help="run names whose serving gate logs to read")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.cli.parity_md import card_of, write_section

    text = markdown(args.workdir, _load(args.workdir, "results.json"),
                    _load(args.workdir, "e2e_results.json"),
                    _load(args.workdir, "selection_results.json"), args.serving_variants,
                    args.device, card_of(args.workdir))
    path = write_section(args.workdir, "narrative", text)
    print(f"wrote narrative section {path} and reassembled the document")


if __name__ == "__main__":
    main()
