"""Train a pose variant on LineMOD (counterpart of scripts/train.py): one
CLI for the reference's four training scripts, the recipe constants in
configs/presets.py, through train/trainer.Trainer (resumes from
<save-dir>/last.pt).

  python -m pose6d_tpu_torch.cli.train --variant rgb \\
      --data-root datasets/Linemod_preprocessed/data \\
      --mesh-dir datasets/Linemod_preprocessed/models --save-dir weights_rgb \\
      [--pretrained-backbone resnet50.pth]

--pretrained-backbone takes a torchvision resnet50 state_dict (.pth): the
towers start from it (models/pretrained.py). The train split is kept
resident on the card and each batch is gathered and cropped there (the
gather kernel; Trainer(device_preprocess=True)), as scripts/parity_run.py
trains; the JAX script trains from the host loader instead.

--mesh DP,TP trains over DP x TP processes, data-parallel over DP and the
head MLPs split over TP (parallel/), one process per rank as torchrun
starts them:

  torchrun --nproc-per-node 4 -m pose6d_tpu_torch.cli.train --mesh 2,2 \
      --variant rgbd --data-root ... --mesh-dir ... --save-dir weights_rgbd

Each process reads RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT from torchrun; the backend follows --device: NCCL for cuda (on
cuda:LOCAL_RANK), gloo for cpu. Rank 0 prints and writes the checkpoints,
in the one-process layout.
"""

import argparse
import os
import sys

from pose6d_tpu_torch.cli import add_device_arg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", required=True,
                    choices=["rgb", "rgb_geometric", "rgbd", "rgbd_geometric"])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--mesh-dir", required=True)
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--img-size", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-workers", type=int, default=8)
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the second epoch there")
    ap.add_argument("--pretrained-backbone", default=None,
                    help="path to a torchvision resnet50 state_dict (.pth) for the towers")
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="device mesh shape (data x tensor parallel), under torchrun")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.train.trainer import Trainer

    device, mesh = args.device, None
    if args.mesh is not None:
        device, mesh = init_distributed(tuple(int(x) for x in args.mesh.split(",")), device)
    overrides = {k: v for k, v in (("epochs", args.epochs), ("batch_size", args.batch_size),
                                   ("img_size", args.img_size), ("learning_rate", args.lr))
                 if v is not None}
    cfg = get_preset(args.variant, **overrides)
    save_dir = args.save_dir or f"weights_{args.variant}"
    primary = mesh is None or mesh.is_primary
    if primary:
        print(f"Training {args.variant} -> {save_dir}"
              + ("" if mesh is None else f" on a mesh {mesh.shape}"))
    trainer = Trainer(cfg, args.data_root, args.mesh_dir, save_dir, seed=args.seed,
                      num_workers=args.num_workers, profile_dir=args.profile_dir,
                      pretrained_backbone=args.pretrained_backbone, mesh=mesh,
                      device_preprocess=True, device=device)
    if primary:
        print(f"Train: {len(trainer.train_loader)}, Val: {len(trainer.val_loader)} samples")
    try:
        trainer.fit()
    finally:
        trainer.close()
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(shape, device: str):
    """This process's rank of a torchrun launch: the process group (NCCL
    for a cuda device, on cuda:LOCAL_RANK; gloo for the CPU) and the mesh.
    Returns (device, mesh)."""
    import torch
    import torch.distributed as dist

    from pose6d_tpu_torch.parallel import make_mesh

    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        sys.exit(f"--mesh {shape[0]},{shape[1]} runs one process per rank; launch it with "
                 f"torchrun --nproc-per-node {shape[0] * shape[1]} -m "
                 f"pose6d_tpu_torch.cli.train ... (missing {', '.join(missing)})")
    if device.startswith("cuda"):
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return device, make_mesh(shape)


if __name__ == "__main__":
    main()
