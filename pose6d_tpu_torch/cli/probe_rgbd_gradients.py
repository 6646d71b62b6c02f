"""Gradient-flow probe of the rgbd fusion stall (counterpart of
scripts/probe_rgbd_gradients.py).

rgbd is the fixture's worst learner while rgbd_geometric saturates with a
wide rotation head; rgbd differs in its fusion stack (LayerNorm'd tower
features -> cross-head attention residual -> concat -> 4096->1024->1024
GELU/LayerNorm bottleneck -> GELU heads). This measures, per module group,
the RMS gradient of the ROTATION loss (PoseLossConfig(trans_weight=0.0))
at the first step and at the last of --steps steps of plain AdamW (lr 5e-4,
weight decay 1e-4) on one seeded batch, for four configurations:

  rgb             the baseline (feature -> wide BN/ReLU heads)
  rgbd            the reference fusion (attention + bottleneck + GELU heads)
  rgbd_noattn     no attention residual (concat fusion only)
  rgbd_widehead   the reference fusion, wide BN/ReLU rotation head

Backbone gradients orders smaller for rgbd than for rgb would point at
the fusion attenuating the rotation signal; comparable ones at the
optimization dynamics.

  python -m pose6d_tpu_torch.cli.probe_rgbd_gradients --workdir /tmp/p6d
  python -m pose6d_tpu_torch.cli.probe_rgbd_gradients --img-size 32 --batch-size 2 \\
      --steps 2 --device cpu --workdir /tmp/p6d

Writes <workdir>/rgbd_gradient_probe.json ({config: {"loss_first",
"loss_last", "grad_rms": {"init"|"final": {group: rms}}}}, the JAX
script's schema) and prints it. Each configuration starts from the port's
flax-style init of seed 0; the dropouts draw from a torch.Generator
seeded 1 at every step, as the JAX script passes key(1) at every step.
"""

import argparse
import json
import os
import sys

from pose6d_tpu_torch.cli import add_device_arg

CONFIGS = {
    "rgb": {"variant": "rgb"},
    "rgbd": {"variant": "rgbd"},
    "rgbd_noattn": {"variant": "rgbd", "fusion_attention": False},
    "rgbd_widehead": {"variant": "rgbd", "rot_head_wide": True},
}
LR, WEIGHT_DECAY = 5e-4, 1e-4
DROPOUT_SEED = 1


def group_of(path: str) -> str:
    """The module group of a parameter: its top-level scope, in a port
    state_dict name (dotted) or a flax path (slashed)."""
    top = path.replace("/", ".").split(".")[0]
    if top.startswith("rgb_backbone") or top == "backbone":
        return "rgb_backbone"
    if top.startswith("depth_backbone"):
        return "depth_backbone"
    if top.startswith("cross_attention"):
        return "attention"
    if top.startswith("fusion") or top in ("rgb_norm", "depth_norm"):
        return "fusion"
    if top.startswith("rot_"):
        return "rot_head"
    if top.startswith("trans_") or top.startswith("z_"):
        return "trans_head"
    return "other"


def probe_inputs(img: int, batch: int, seed: int = 0) -> dict:
    """The JAX script's batch, drawn alike from numpy: rgb uniform in
    [-2, 2], depth in [0, 1], unit quaternions, translations about
    (0, 0, 0.8) m."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rgb = rng.uniform(-2, 2, (batch, img, img, 3)).astype(np.float32)
    depth = rng.uniform(0, 1, (batch, img, img, 1)).astype(np.float32)
    q = rng.normal(size=(batch, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    trans = rng.normal(0, 0.1, (batch, 3)) + [0, 0, 0.8]
    return {"rgb": rgb, "depth": depth, "quat": q.astype(np.float32),
            "trans": trans.astype(np.float32)}


def grad_rms_by_group(model) -> dict:
    """{group: RMS of the parameters' gradients}, summed in float64 (a
    parameter the loss does not reach counts as zeros)."""
    import math

    sq, n = {}, {}
    for name, p in model.named_parameters():
        g = group_of(name)
        sq[g] = sq.get(g, 0.0) + (0.0 if p.grad is None else float(p.grad.double().square().sum()))
        n[g] = n.get(g, 0) + p.numel()
    return {k: math.sqrt(sq[k] / max(n[k], 1)) for k in sq}


def probe_model(model, inputs: dict, steps: int) -> dict:
    """`steps` AdamW steps of the rotation-only loss on `inputs` (numpy,
    probe_inputs) for `model` (train mode, on its device and dtype):
    {"loss_first", "loss_last", "grad_rms": {"init", "final"}}, unrounded."""
    import torch

    from pose6d_tpu_torch.losses.pose_loss import PoseLossConfig, pose_loss

    p0 = next(model.parameters())
    dev, dtype = p0.device, p0.dtype
    t = {k: torch.from_numpy(v).to(dev, dtype) for k, v in inputs.items()}
    kwargs = {"rgb": t["rgb"]}
    if model.config.variant == "rgbd":
        kwargs["depth"] = t["depth"]
    loss_cfg = PoseLossConfig(trans_weight=0.0)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WEIGHT_DECAY)
    model.train()
    snaps, losses = {}, []
    for i in range(steps):
        opt.zero_grad(set_to_none=False)
        gen = torch.Generator(device=dev).manual_seed(DROPOUT_SEED)
        rot, tr = model(**kwargs, generator=gen)
        loss = pose_loss(rot, tr, t["quat"], t["trans"], loss_cfg)
        loss.backward()
        if i == 0:
            snaps["init"] = grad_rms_by_group(model)
        losses.append(float(loss.detach()))
        opt.step()
    snaps["final"] = grad_rms_by_group(model)
    return {"loss_first": losses[0], "loss_last": losses[-1], "grad_rms": snaps}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default="/tmp/pose6d_torch_parity")
    ap.add_argument("--img-size", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=10)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig, flax_init_

    inputs = probe_inputs(args.img_size, args.batch_size)
    report = {}
    for name, flags in CONFIGS.items():
        model = flax_init_(PoseNet(PoseNetConfig(img_size=args.img_size, **flags)), 0)
        r = probe_model(model.to(args.device), inputs, args.steps)
        report[name] = {
            "loss_first": round(r["loss_first"], 4),
            "loss_last": round(r["loss_last"], 4),
            "grad_rms": {k: {g: float(f"{v:.3e}") for g, v in d.items()}
                         for k, d in r["grad_rms"].items()},
        }
        print(f"== {name}: loss {r['loss_first']:.4f} -> {r['loss_last']:.4f}", file=sys.stderr)
        for phase, d in r["grad_rms"].items():
            for g, v in sorted(d.items()):
                print(f"   {phase:<6} {g:<16} {v:.3e}", file=sys.stderr)
    os.makedirs(args.workdir, exist_ok=True)
    with open(os.path.join(args.workdir, "rgbd_gradient_probe.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
