"""Pack the trained weights into one zip (counterpart of
scripts/package_weights.py; the reference's
scripts/setup/package_weights.py:25-76): the four pose variants' save
directories and the detector's, every file in them (the port's
{best,last,best_deploy}.pt and metrics.csv), under their paths relative to
--root.

  python -m pose6d_tpu_torch.cli.package_weights --out pretrained_weights.zip
"""

import argparse
import os
import sys
import zipfile

WEIGHT_DIRS = [
    "weights_rgb",
    "weights_rgb_geometric",
    "weights_rgbd",
    "weights_rgbd_geometric",
    os.path.join("runs", "detect", "linemod_yolo"),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=".")
    ap.add_argument("--out", default="pretrained_weights.zip")
    args = ap.parse_args(argv)

    found = [d for d in WEIGHT_DIRS if os.path.isdir(os.path.join(args.root, d))]
    if not found:
        sys.exit("no weight directories found")
    with zipfile.ZipFile(args.out, "w", zipfile.ZIP_DEFLATED) as zf:
        for d in found:
            for dirpath, _, files in os.walk(os.path.join(args.root, d)):
                for fn in sorted(files):
                    full = os.path.join(dirpath, fn)
                    zf.write(full, os.path.relpath(full, args.root))
            print(f"packaged {d}")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
