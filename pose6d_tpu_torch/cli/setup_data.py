"""Fetch or synthesize the dataset (counterpart of scripts/setup_data.py).

The reference downloads Linemod_preprocessed.zip from Google Drive with
gdown (scripts/setup/setup_data.py:24-64). This extracts that zip when it
already lies at <dest>/Linemod_preprocessed.zip, downloads it where gdown
is installed, and otherwise exits naming the alternatives; --synthetic
writes the synthetic LineMOD tree (data/synthetic.py) instead.

  python -m pose6d_tpu_torch.cli.setup_data --dest datasets               # the zip
  python -m pose6d_tpu_torch.cli.setup_data --dest datasets --synthetic   # offline
"""

import argparse
import os
import sys
import zipfile

GDRIVE_FILE_ID = "1YFUra533pxS_IHsb9tB87lLoxbcHYXt8"  # Linemod_preprocessed.zip


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dest", default="datasets")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--objects", type=int, default=2)
    ap.add_argument("--frames", type=int, default=50)
    args = ap.parse_args(argv)

    os.makedirs(args.dest, exist_ok=True)
    if args.synthetic:
        from pose6d_tpu_torch.data.synthetic import generate_synthetic_linemod

        root = os.path.join(args.dest, "Linemod_synthetic")
        paths = generate_synthetic_linemod(root, obj_ids=tuple(range(1, args.objects + 1)),
                                           frames_per_obj=args.frames)
        print(f"synthetic dataset ready: {paths}")
        return

    target = os.path.join(args.dest, "Linemod_preprocessed")
    if os.path.exists(target):
        print(f"{target} already exists")
        return
    zip_path = os.path.join(args.dest, "Linemod_preprocessed.zip")
    if not os.path.exists(zip_path):
        try:
            import gdown  # optional; not a dependency of the port
        except ImportError:
            sys.exit("gdown is unavailable in this environment. Either install it, place "
                     f"Linemod_preprocessed.zip at {zip_path} manually, or use --synthetic.")
        gdown.download(id=GDRIVE_FILE_ID, output=zip_path, quiet=False)
    print("Extracting...")
    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(args.dest)
    print(f"done: {target}")


if __name__ == "__main__":
    main()
