"""The system end to end on a small synthetic tree, no downloads
(counterpart of scripts/demo.py, the answer to the reference's Colab
notebook): 1. a synthetic LineMOD tree, 2. the YOLO export, 3. a short
detector training, 4. a short pose training, 5. validation, 6. one
image's inference with an overlay PNG.

  python -m pose6d_tpu_torch.cli.demo --workdir demo_workdir [--epochs 2]
"""

import argparse
import os

import numpy as np
import torch

from pose6d_tpu_torch.cli import add_device_arg, read_depth_m
from pose6d_tpu_torch.data.png import read_png


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default="demo_workdir")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--variant", default="rgbd_geometric")
    ap.add_argument("--img-size", type=int, default=64, help="pose crop size")
    ap.add_argument("--det-size", type=int, default=320)
    ap.add_argument("--frames", type=int, default=30, help="synthetic frames per object")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)

    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.data.detection import prepare_yolo_dataset
    from pose6d_tpu_torch.data.png import write_png
    from pose6d_tpu_torch.data.synthetic import generate_synthetic_linemod
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.models.yolo.train import DetTrainConfig, DetectionTrainer
    from pose6d_tpu_torch.ops.augment import AugmentConfig
    from pose6d_tpu_torch.train.trainer import Trainer
    from pose6d_tpu_torch.utils import DEFAULT_K, draw_3d_box, load_mesh_corners, project_points

    print("== 1. synthetic dataset")
    paths = generate_synthetic_linemod(os.path.join(args.workdir, "Linemod_synthetic"),
                                       obj_ids=(1, 2), frames_per_obj=args.frames)
    print(paths)
    print("== 2. prepare_yolo export")
    print(prepare_yolo_dataset(paths["data"], os.path.join(args.workdir, "yolo_ready")))

    print("== 3. detector training")
    det = DetectionTrainer(paths["data"], os.path.join(args.workdir, "yolo_ckpt"),
                           DetTrainConfig(img_size=args.det_size, batch_size=8,
                                          epochs=args.epochs), device=args.device)
    map50 = det.fit()
    det.close()

    print("== 4. pose training")
    cfg = get_preset(args.variant, img_size=args.img_size, batch_size=8, epochs=args.epochs,
                     augment=AugmentConfig(grayscale_p=0.0))
    trainer = Trainer(cfg, paths["data"], paths["models"],
                      os.path.join(args.workdir, f"weights_{args.variant}"), num_workers=0,
                      device=args.device)
    best = trainer.fit()

    print("== 5. evaluation")
    metrics = trainer.validate(np.random.default_rng(0))
    print({k: round(v, 3) for k, v in metrics.items()})

    print("== 6. inference overlay")
    sample = trainer.val_loader.samples[0]
    trainer.close()
    frame = read_png(sample.img_path)
    depth = read_depth_m(sample.depth_path, frame.shape[:2]) if sample.depth_path else None
    pipe = PosePipeline(
        PipelineConfig(variant=args.variant, img_size=args.img_size, det_size=args.det_size,
                       conf_thresh=0.0, compute_dtype=torch.float32),
        det.ycfg, det.model.state_dict(), trainer.state.model.state_dict(), device=args.device)
    out = pipe(frame[None], DEFAULT_K, depth[None] if depth is not None else None)
    quat = out["rotation"][0].float().cpu().numpy()
    trans = out["translation"][0].float().cpu().numpy()
    print("pred quat:", np.round(quat, 3), "trans:", np.round(trans, 3))
    canvas = frame.copy()
    corners = load_mesh_corners(paths["models"], f"{sample.obj_id + 1:02d}")
    if corners is not None:
        draw_3d_box(canvas, project_points(corners, quat, trans, DEFAULT_K))
    out_path = os.path.join(args.workdir, "demo_result.png")
    write_png(out_path, canvas)
    print(f"saved {out_path}")
    print(f"\ndemo complete: mAP@50 {map50:.3f}, best ADD-0.1d {best:.2f}%")


if __name__ == "__main__":
    main()
