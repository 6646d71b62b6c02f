"""Evaluate every trained pose variant on a split and print the table
(counterpart of scripts/compare.py; the reference's
scripts/visualization/compare_all_models.py:107-181, which evaluates the
'val' split; --split test is the honest alternative).

  python -m pose6d_tpu_torch.cli.compare --data-root .../data --mesh-dir .../models \\
      --weights-root .   # reads weights_{variant}/ directories
"""

import argparse
import json
import os

import numpy as np
import torch

from pose6d_tpu_torch.cli import add_device_arg

VARIANTS = ["rgb", "rgb_geometric", "rgbd", "rgbd_geometric"]
KEYS = ("add_mean", "add_s_mean", "add_01d_acc")


def evaluate_variant(variant, state, data_root, mesh_dir, batch_size, split, img_size=None,
                     device="cuda"):
    """The mean over the split's batches of each batch's ADD metrics, for a
    PoseNet state_dict of `variant`."""
    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.data.pipeline import LineMODPoseLoader
    from pose6d_tpu_torch.losses.add import ADDEvaluator
    from pose6d_tpu_torch.models.posenet import PoseNet
    from pose6d_tpu_torch.train.loop import TrainState, make_eval_step, pose_config

    cfg = get_preset(variant, **({"img_size": img_size} if img_size else {}))
    flavor = "rgbd" if variant.startswith("rgbd") else "rgb"
    loader = LineMODPoseLoader(data_root, mode=split, flavor=flavor, img_size=cfg.img_size,
                               augment_bbox=False, num_workers=8, compact_arrays=True)
    evaluator = ADDEvaluator(mesh_dir, device=device)
    model = PoseNet(pose_config(cfg))
    model.load_state_dict(state, strict=True)
    eval_step = make_eval_step(cfg, evaluator)
    st = TrainState(model=model.to(device), tx=None)
    sums = {k: [] for k in KEYS}
    try:
        for batch in loader.batches(batch_size, np.random.default_rng(0), shuffle=False,
                                    drop_remainder=False):
            m = eval_step(st, batch)
            for k in KEYS:
                sums[k].append(m[k].float())
    finally:
        loader.close()
    return {k: float(torch.stack(v).mean()) if v else 0.0 for k, v in sums.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--mesh-dir", required=True)
    ap.add_argument("--weights-root", default=".")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--img-size", type=int, default=None,
                    help="override the preset crop size (the towers are fully convolutional)")
    ap.add_argument("--split", default="val", choices=["val", "test"])
    ap.add_argument("--variants", nargs="+", default=VARIANTS)
    ap.add_argument("--json-out", default=None, help="also write the metrics as JSON")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.train.checkpoint import load_model_variables

    results = {}
    for variant in args.variants:
        save_dir = os.path.join(args.weights_root, f"weights_{variant}")
        state = load_model_variables(save_dir, get_preset(variant))
        if state is None:
            print(f"[skip] no checkpoint for {variant} in {save_dir}")
            continue
        print(f"Evaluating {variant}...")
        results[variant] = evaluate_variant(variant, state, args.data_root, args.mesh_dir,
                                            args.batch_size, args.split,
                                            img_size=args.img_size, device=args.device)
    if not results:
        print("No models evaluated.")
        return

    print(f"\n{'Model':<18} {'ADD (mm)':>10} {'ADD-S (mm)':>11} {'ADD-0.1d (%)':>13}")
    print("-" * 56)
    for variant, m in results.items():
        print(f"{variant:<18} {m['add_mean']:>10.1f} {m['add_s_mean']:>11.1f} "
              f"{m['add_01d_acc']:>13.2f}")
    best = max(results, key=lambda v: results[v]["add_01d_acc"])
    print(f"\nBest model: {best} (ADD-0.1d: {results[best]['add_01d_acc']:.2f}%)")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"wrote {args.json_out}")


if __name__ == "__main__":
    main()
