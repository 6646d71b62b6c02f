"""Rebuild results.json and the base table from the metrics.csv curves on
disk (counterpart of scripts/parity_summarize.py and
scripts/refresh_parity_base.py, which do this one job): no training.

A parity_run cut before fit() returns never writes its summary, and a
resumed one logs its restart window twice; this re-applies
cli/parity_run.summarize_variant (which keeps the last row of each epoch)
to every <workdir>/weights_*/metrics.csv, taking each run's best val
ADD-0.1d as the curve's maximum, merges the entries into results.json
(runs whose weights are gone keep theirs) and rewrites PARITY.md and the
`base` section. The flags are the table header's, parity_run's defaults.

  python -m pose6d_tpu_torch.cli.parity_summarize --workdir /tmp/p6d
"""

import argparse
import csv
import glob
import json
import os

from pose6d_tpu_torch.cli import add_device_arg
from pose6d_tpu_torch.cli.parity_run import summarize_variant, write_markdown


def summarize(workdir: str) -> dict:
    """results.json merged with a fresh entry for every run whose
    metrics.csv has a row; written back and returned."""
    results_path = os.path.join(workdir, "results.json")
    results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    for save_dir in sorted(glob.glob(os.path.join(workdir, "weights_*"))):
        csv_path = os.path.join(save_dir, "metrics.csv")
        if not os.path.isfile(csv_path):
            continue
        with open(csv_path) as f:
            best = max((float(r["val_acc"]) for r in csv.DictReader(f)), default=None)
        if best is None:
            continue
        results[os.path.basename(save_dir)[len("weights_"):]] = summarize_variant(save_dir, best)
    with open(results_path, "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default="/tmp/pose6d_torch_parity")
    # the base table header's parameters (parity_run's defaults)
    ap.add_argument("--objects", type=int, default=6)
    ap.add_argument("--frames", type=int, default=700)
    ap.add_argument("--max-angle-deg", type=float, default=75.0)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--patience", type=int, default=15)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--early-stop-acc", type=float, default=97.0)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    results = summarize(args.workdir)
    write_markdown(args, results)
    for v, r in results.items():
        print(f"{v:<26} best {r['best_add01d']:6.2f}% @ epoch {r['best_epoch']} "
              f"({r['epochs_run']} run)")


if __name__ == "__main__":
    main()
