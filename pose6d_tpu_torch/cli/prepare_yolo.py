"""LineMOD ground truth -> the YOLO dataset layout (counterpart of
scripts/prepare_yolo.py; the reference's scripts/setup/prepare_yolo.py:37-135:
its split, one annotation per image, classes by sorted folder index, its
dataset.yaml).

  python -m pose6d_tpu_torch.cli.prepare_yolo \\
      --source datasets/Linemod_preprocessed/data --dest datasets/yolo_ready
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--source", required=True)
    ap.add_argument("--dest", required=True)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.data.detection import prepare_yolo_dataset

    stats = prepare_yolo_dataset(args.source, args.dest)
    print("Dataset preparation complete!")
    for split, n in stats.items():
        print(f"  {split}: {n}")


if __name__ == "__main__":
    main()
