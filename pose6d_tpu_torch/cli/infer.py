"""Detect -> crop -> pose on one image, with the 3D box, the axes and the
detection box drawn over it (counterpart of scripts/infer.py, which stands
for the reference's four scripts/inference/inference_*.py). Depth for the
rgbd variants is found by the reference's file naming ("{obj}_{frame}.png"
-> <data-root>/{obj}/depth/{frame}.png) or passed with --depth. The
overlay is written as an RGB PNG (data/png.py).

  python -m pose6d_tpu_torch.cli.infer --variant rgbd_geometric \\
      --image path/to/01_0000.png --yolo-weights runs/detect/linemod_yolo \\
      --pose-weights weights_rgbd_geometric --mesh-dir .../models --output out.png
"""

import argparse
import os
import sys

import numpy as np
import torch

from pose6d_tpu_torch.cli import add_device_arg, read_depth_m
from pose6d_tpu_torch.data.png import read_png

# class id (sorted-folder index) -> LineMOD folder, the reference's map
# (inference_rgb.py:28-31); LineMOD has no folders 03 and 07
LINEMOD_FOLDERS = ["01", "02", "04", "05", "06", "08", "09", "10", "11", "12", "13", "14", "15"]


def locate_depth(image_path, data_root):
    """The reference's naming: {obj}_{frame}.png."""
    name = os.path.basename(image_path)
    if "_" not in name or data_root is None:
        return None
    obj, frame = name.split("_", 1)
    cand = os.path.join(data_root, obj, "depth", frame)
    return cand if os.path.exists(cand) else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", required=True,
                    choices=["rgb", "rgb_geometric", "rgbd", "rgbd_geometric"])
    ap.add_argument("--image", required=True)
    ap.add_argument("--depth", default=None)
    ap.add_argument("--yolo-weights", required=True)
    ap.add_argument("--pose-weights", required=True)
    ap.add_argument("--mesh-dir", required=True)
    ap.add_argument("--data-root", default=None, help="for the depth lookup")
    ap.add_argument("--output", default="inference_result.png")
    ap.add_argument("--num-classes", type=int, default=13)
    ap.add_argument("--img-size", type=int, default=224,
                    help="pose crop size (checkpoints do not depend on it)")
    ap.add_argument("--f32", action="store_true", help="compute in float32 (default bfloat16)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.data.png import write_png
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.models.yolo.model import YoloConfig
    from pose6d_tpu_torch.models.yolo.train import load_yolo_variables
    from pose6d_tpu_torch.train.checkpoint import load_model_variables
    from pose6d_tpu_torch.utils import (DEFAULT_K, draw_3d_box, draw_axes, draw_rectangle,
                                        load_mesh_corners, project_points)

    ycfg = YoloConfig(num_classes=args.num_classes)
    yolo_state = load_yolo_variables(args.yolo_weights, ycfg)
    if yolo_state is None:
        sys.exit(f"no detector checkpoint in {args.yolo_weights}")
    pose_state = load_model_variables(args.pose_weights,
                                      get_preset(args.variant, img_size=args.img_size))
    if pose_state is None:
        sys.exit(f"no pose checkpoint in {args.pose_weights}")
    pipe = PosePipeline(
        PipelineConfig(variant=args.variant, img_size=args.img_size,
                       compute_dtype=torch.float32 if args.f32 else torch.bfloat16),
        ycfg, yolo_state, pose_state, device=args.device)

    if not os.path.exists(args.image):
        sys.exit(f"cannot read {args.image}")
    rgb = read_png(args.image)
    depth_m = None
    if args.variant.startswith("rgbd"):
        dpath = args.depth or locate_depth(args.image, args.data_root)
        if not dpath:
            print("warning: no depth found, using zeros")
        depth_m = read_depth_m(dpath, rgb.shape[:2])

    out = pipe(rgb[None], DEFAULT_K, depth_m[None] if depth_m is not None else None)
    quat = out["rotation"][0].float().cpu().numpy()
    trans = out["translation"][0].float().cpu().numpy()
    cls_id = int(out["class_id"][0])
    score = float(out["det_score"][0])
    folder = LINEMOD_FOLDERS[cls_id] if 0 <= cls_id < len(LINEMOD_FOLDERS) else "??"
    print(f"detected class {cls_id} (obj {folder}) score {score:.3f}")
    print(f"quat(xyzw): {quat}")
    print(f"trans (m): {trans}")

    # drawn on the BGR frame with the JAX script's BGR colours, written as RGB
    canvas = np.ascontiguousarray(rgb[:, :, ::-1])
    corners = load_mesh_corners(args.mesh_dir, folder)
    if corners is not None:
        draw_3d_box(canvas, project_points(corners, quat, trans, DEFAULT_K), color=(0, 255, 0))
    draw_axes(canvas, quat, trans, DEFAULT_K)
    bb = out["bbox_xywh"][0].float().cpu().numpy().astype(int)
    draw_rectangle(canvas, (bb[0], bb[1]), (bb[0] + bb[2], bb[1] + bb[3]), (255, 0, 0), 2)
    write_png(args.output, np.ascontiguousarray(canvas[:, :, ::-1]))
    print(f"saved {args.output}")


if __name__ == "__main__":
    main()
