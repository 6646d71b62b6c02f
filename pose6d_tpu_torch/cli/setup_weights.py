"""Unpack a pretrained-weights zip into the layout the other CLIs read
(counterpart of scripts/setup_weights.py; the reference's
scripts/setup/setup_weights.py:25-130) and check it: each of the four pose
variants' directories and the detector's must hold best.pt or last.pt.

It downloads nothing: the zip (package_weights makes one) must already be
on disk, and a missing zip is an error that says where to put it.

  python -m pose6d_tpu_torch.cli.setup_weights --zip pretrained_weights.zip --dest .
"""

import argparse
import os
import sys
import zipfile

EXPECTED = [
    "weights_rgb",
    "weights_rgb_geometric",
    "weights_rgbd",
    "weights_rgbd_geometric",
    os.path.join("runs", "detect", "linemod_yolo"),
]


def missing_checkpoints(dest: str) -> list:
    """The expected directories under dest with neither best.pt nor last.pt."""
    return [os.path.join(d, "best.pt") for d in EXPECTED
            if not any(os.path.isfile(os.path.join(dest, d, f"{n}.pt")) for n in ("best", "last"))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--zip", dest="zip_path", default="pretrained_weights.zip")
    ap.add_argument("--dest", default=".")
    args = ap.parse_args(argv)

    if not os.path.exists(args.zip_path):
        sys.exit(f"{args.zip_path} not found: nothing is downloaded; put the weights zip "
                 f"(package_weights writes one) at {os.path.abspath(args.zip_path)}")
    with zipfile.ZipFile(args.zip_path) as zf:
        zf.extractall(args.dest)
    print(f"extracted {args.zip_path} -> {args.dest}")
    missing = missing_checkpoints(args.dest)
    for m in missing:
        print(f"warning: expected checkpoint missing: {m}")
    if not missing:
        print("all expected checkpoints present")


if __name__ == "__main__":
    main()
