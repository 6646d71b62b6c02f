"""Train the YOLOv8n detector on LineMOD (counterpart of
scripts/train_yolo.py): the reference's recipe (scripts/training/
train_yolo.py:27-64: 5 epochs, imgsz 640, batch 16, seed 42) through
models/yolo/train.DetectionTrainer, which resumes from <save-dir>/last.pt.

  python -m pose6d_tpu_torch.cli.train_yolo \\
      --data-root datasets/Linemod_preprocessed/data --save-dir runs/detect/linemod_yolo
"""

import argparse

from pose6d_tpu_torch.cli import add_device_arg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--save-dir", default="runs/detect/linemod_yolo")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--lr", type=float, default=None,
                    help="peak learning rate (default: DetTrainConfig's 1e-3); a resumed "
                         "fine-tune of a converged checkpoint wants ~1e-4")
    ap.add_argument("--scene-roots", default="",
                    help="comma list of multi-object scene trees (generate_synthetic_scene "
                         "layout) mixed into both splits")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.models.yolo.train import DetTrainConfig, DetectionTrainer

    cfg = DetTrainConfig(img_size=args.img_size, batch_size=args.batch_size, epochs=args.epochs,
                         seed=args.seed,
                         **({"learning_rate": args.lr} if args.lr is not None else {}))
    scene_roots = tuple(s for s in args.scene_roots.split(",") if s)
    trainer = DetectionTrainer(args.data_root, args.save_dir, cfg, scene_roots=scene_roots,
                               device=args.device)
    print(f"Training YOLOv8n: {len(trainer.train_loader)} train / {len(trainer.val_loader)} val "
          f"images, {trainer.ycfg.num_classes} classes")
    try:
        trainer.fit()  # prints the mAP@50
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
