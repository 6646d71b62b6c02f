"""Carry trained pose checkpoints between the reference and the port
(counterpart of scripts/convert_reference_weights.py).

The reference publishes trained weights as weights_<variant>/
best_pose_model.pth with the model under 'model_state_dict'
(scripts/training/train_rgb.py:146-161). models/convert_posenet.py maps
its keys onto the port's PoseNet and back.

Import (reference .pth -> a Trainer checkpoint directory that compare,
infer and eval_e2e read):
  python -m pose6d_tpu_torch.cli.convert_reference_weights to-port \\
      --variant rgb --pth weights_rgb/best_pose_model.pth --dest weights_rgb_port

Export (a Trainer checkpoint -> a .pth the reference loads):
  python -m pose6d_tpu_torch.cli.convert_reference_weights to-torch \\
      --variant rgb --weights weights_rgb_port --out best_pose_model.pth

Both run on the host; the .pth is read with torch.load(weights_only=True).
"""

import argparse

VARIANTS = ["rgb", "rgb_geometric", "rgbd", "rgbd_geometric"]


def cmd_to_port(args):
    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.models.convert import load_torch_state_dict
    from pose6d_tpu_torch.models.convert_posenet import posenet_from_reference
    from pose6d_tpu_torch.models.posenet import PoseNet
    from pose6d_tpu_torch.train.checkpoint import CheckpointManager
    from pose6d_tpu_torch.train.loop import create_train_state, pose_config
    from pose6d_tpu_torch.train.schedule import ReduceLROnPlateau

    state = posenet_from_reference(args.variant, load_torch_state_dict(args.pth))
    cfg = get_preset(args.variant)
    model = PoseNet(pose_config(cfg))
    model.load_state_dict(state, strict=True)
    train_state = create_train_state(cfg, model=model, device="cpu")
    sched = ReduceLROnPlateau(lr=cfg.learning_rate, factor=cfg.plateau_factor,
                              patience=cfg.plateau_patience, min_lr=cfg.min_lr)
    CheckpointManager(args.dest).save(train_state, epoch=0, best_acc=0.0, curr_acc=0.0,
                                      curr_add=0.0, scheduler_state=sched.state_dict(),
                                      is_best=True)
    print(f"imported {args.pth} [{args.variant}] -> {args.dest}/{{best,last}}.pt")


def cmd_to_torch(args):
    import torch

    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.models.convert_posenet import posenet_to_reference
    from pose6d_tpu_torch.train.checkpoint import load_model_variables

    state = load_model_variables(args.weights, get_preset(args.variant), name=args.ckpt)
    if state is None:
        raise SystemExit(f"no checkpoint under {args.weights}")
    torch.save({"model_state_dict": posenet_to_reference(args.variant, state)}, args.out)
    print(f"exported {args.weights} [{args.variant}] -> {args.out}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("to-port", help="reference .pth -> Trainer checkpoint directory")
    p1.add_argument("--variant", required=True, choices=VARIANTS)
    p1.add_argument("--pth", required=True)
    p1.add_argument("--dest", required=True)
    p1.set_defaults(fn=cmd_to_port)
    p2 = sub.add_parser("to-torch", help="Trainer checkpoint directory -> reference .pth")
    p2.add_argument("--variant", required=True, choices=VARIANTS)
    p2.add_argument("--weights", required=True)
    p2.add_argument("--out", required=True)
    p2.add_argument("--ckpt", default="best", choices=["best", "last"])
    p2.set_defaults(fn=cmd_to_torch)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
