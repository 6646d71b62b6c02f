"""Ground truth beside every trained variant on random val frames, one PNG
grid per sample (counterpart of scripts/compare_visual.py; the reference's
scripts/visualization/compare_visual.py:215-293).

Crops come from the ground-truth box (no detector). Each panel is the whole
frame with the ground-truth 3D box in green and, after the first (GT)
panel, one variant's predicted box in red; X/Y are re-derived from the
predicted Z, the box centre and the original intrinsics for every variant
(compare_visual.py:201-206). The panels' order is printed (the JAX script
writes each panel's name on it with cv2, which the port does not use).

  python -m pose6d_tpu_torch.cli.compare_visual --data-root .../data \\
      --mesh-dir .../models --weights-root . --num-samples 3 --out-dir results
"""

import argparse
import os
import sys

import numpy as np
import torch

from pose6d_tpu_torch.cli import add_device_arg

VARIANTS = ["rgb", "rgb_geometric", "rgbd", "rgbd_geometric"]
GT_COLOR, PRED_COLOR = (0, 255, 0), (0, 0, 255)  # on the BGR canvas, as the JAX script


def variant_inputs(variant: str, s: dict, device) -> dict:
    """The PoseNet keyword arguments of one loader sample, batched."""
    t = lambda k: torch.as_tensor(s[k])[None].to(device)  # noqa: E731
    if variant == "rgb_geometric":
        return {"bbox_center": t("center_orig"), "camera_matrix": t("cam_K")}
    if variant == "rgbd":
        return {"depth": t("depth")}
    if variant == "rgbd_geometric":
        return {"depth_raw": t("depth_raw"), "bbox_center": t("center_crop"),
                "camera_matrix": t("cam_K_crop")}
    return {}


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--mesh-dir", required=True)
    ap.add_argument("--weights-root", default=".")
    ap.add_argument("--num-samples", type=int, default=3)
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--img-size", type=int, default=224,
                    help="pose crop size (checkpoints are size-independent)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.data.pipeline import LineMODPoseLoader
    from pose6d_tpu_torch.data.png import read_png, write_png
    from pose6d_tpu_torch.geometry.pinhole import pinhole_xy_from_z
    from pose6d_tpu_torch.models.posenet import PoseNet
    from pose6d_tpu_torch.ops.augment import eval_preprocess
    from pose6d_tpu_torch.train.checkpoint import load_model_variables
    from pose6d_tpu_torch.train.loop import pose_config
    from pose6d_tpu_torch.utils import draw_3d_box, load_mesh_corners, project_points

    os.makedirs(args.out_dir, exist_ok=True)
    loader = LineMODPoseLoader(args.data_root, mode="val", flavor="rgbd",
                               img_size=args.img_size, augment_bbox=False, num_workers=0)
    if len(loader) == 0:
        sys.exit("no val samples found")

    models = {}
    for variant in VARIANTS:
        cfg = get_preset(variant, img_size=args.img_size)
        state = load_model_variables(os.path.join(args.weights_root, f"weights_{variant}"), cfg)
        if state is not None:
            model = PoseNet(pose_config(cfg))
            model.load_state_dict(state, strict=True)
            models[variant] = model.to(args.device).eval()
    if not models:
        sys.exit("no trained models found")
    print("panels: GT, " + ", ".join(models))

    rng = np.random.default_rng(args.seed)
    idxs = rng.choice(len(loader), min(args.num_samples, len(loader)), replace=False)
    for si, idx in enumerate(idxs):
        s = loader.load_sample(int(idx), rng)
        raw = loader.samples[int(idx)]
        bgr_full = np.ascontiguousarray(read_png(raw.img_path)[:, :, ::-1])
        folder = f"{raw.obj_id + 1:02d}"
        corners = load_mesh_corners(args.mesh_dir, folder)
        K = raw.cam_K
        gt_2d = None if corners is None else project_points(corners, s["quat"], s["trans"], K)

        gt_panel = bgr_full.copy()
        if gt_2d is not None:
            draw_3d_box(gt_panel, gt_2d, GT_COLOR)
        panels = [gt_panel]
        rgb_in = eval_preprocess(torch.as_tensor(s["rgb"])[None].to(args.device))
        center = torch.as_tensor(s["center_orig"])[None].to(args.device)
        for variant, model in models.items():
            quat, trans = model(rgb_in, **variant_inputs(variant, s, args.device))
            # the reference recomputes X/Y from Z for every model (:201-206)
            trans = pinhole_xy_from_z(trans[:, 2], center,
                                      torch.as_tensor(K, dtype=torch.float32).to(args.device))
            panel = bgr_full.copy()
            if gt_2d is not None:
                draw_3d_box(panel, gt_2d, GT_COLOR)
                draw_3d_box(panel, project_points(corners, quat[0].cpu().numpy(),
                                                  trans[0].cpu().numpy(), K), PRED_COLOR)
            panels.append(panel)
        out_path = os.path.join(args.out_dir, f"comparison_{si}_obj{folder}.png")
        write_png(out_path, np.ascontiguousarray(np.concatenate(panels, axis=1)[:, :, ::-1]))
        print(f"saved {out_path}")


if __name__ == "__main__":
    main()
