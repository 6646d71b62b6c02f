"""Seeded weights, made on the device in a few large calls.

The keys and shapes are the program's state_dict's (read from its modules
built on the meta device); the values come from the benchmark's own
generator, so that the program and the reference get the same tensors and
the program makes none of them. Rules, by leaf:

  conv weight        normal, std sqrt(2 / fan_in) (He)
  linear weight      normal, std sqrt(1 / fan_in) (LeCun)
  BatchNorm weight   uniform [0.5, 1.2]; [0.2, 0.5] at the end of a ResNet
                     residual branch (bn3, downsample_bn), so that 16
                     stacked blocks keep their activations in range
  LayerNorm weight   uniform [0.8, 1.2]
  running_mean       normal, std 0.1; running_var uniform [0.5, 1.5]
  bias               normal, std 0.1 (BatchNorm) or 0.02 (others)
  trans_out.bias[2]  0.5 (the translation head's Z starts at half a metre)
  num_batches_tracked 0

Then settle_detector() replaces the detector's BatchNorm statistics by
those of its input on the seed's own frames, through the reference
detector, scaled so that every channel leaves its BatchNorm with the
standard deviation DETECTOR_SPREAD times its weight. With the rules above
alone its SiLU layers lose the frame: its class logits vary by 0.06 over a
frame's anchors and by 0.003 from frame to frame, so the detections are
the same whatever the frames, and no check of them can tell a right
detector from a broken one. Settled at a spread of 1 the signal stays, but
the network turns chaotic: bf16 rounding moves the logits by 14 % of their
spread (and towers so settled move a pose by 0.1-0.8 m). At 0.25 the SiLUs
work near their linear part: the logits vary by 0.17 (0.10 over a frame's
anchors, 0.22 from frame to frame), bf16 rounding moves them by 3 % of
that and int8 by 17 % (seeds 1 and 2, 480x640, on the CPU). The towers
keep the rules above: their poses differ by ~0.4 m from crop to crop, bf16
moves them by 3-4 mm and int8 by 13-24 mm (img 64, the same seeds).

Last, outlier_channels() multiplies the BatchNorm weight of one channel
in 32 of the towers by 8 (not their downsample BatchNorms): trained
networks carry a few channels of much larger activations, and those set
a per-tensor int8 scale. Without them, int8 rounding moves the towers'
poses so little past bf16's that the lower-precision control of the
correctness check could not be told from the program: on an H100 the
pose number (judge.py) read at most 1.58 for the program and at least
3.89 for the control (seeds 101-106, 3000000007 and 201-205, 301-306, in
the three cells); with them 1.35 and 5.07. bf16's
relative rounding does not see the scale.

Every normal leaf is a slice of one draw of standard normals and every
uniform leaf a slice of one draw of uniforms, each scaled and shifted by
its rule in one elementwise pass.
"""

from __future__ import annotations

import math

import torch

DETECTOR_SPREAD = 0.25
OUTLIER_EVERY, OUTLIER_FACTOR = 32, 8.0


def _rule(key: str, shape: tuple, keys: set) -> tuple:
    """(kind, scale, shift) of a leaf: value = shift + scale * draw, the
    draw standard normal ("normal") or uniform on [0, 1) ("uniform")."""
    scope, leaf = key.rsplit(".", 1)
    is_bn = f"{scope}.running_mean" in keys
    residual_end = ".layer" in scope and scope.endswith(("bn3", "downsample_bn"))
    if leaf == "running_mean":
        return "normal", 0.1, 0.0
    if leaf == "running_var":
        return "uniform", 1.0, 0.5
    if leaf == "weight" and is_bn:
        return ("uniform", 0.3, 0.2) if residual_end else ("uniform", 0.7, 0.5)
    if leaf == "weight" and len(shape) == 1:
        return "uniform", 0.4, 0.8
    if leaf == "weight":
        gain = 2.0 if len(shape) == 4 else 1.0
        return "normal", math.sqrt(gain / math.prod(shape[1:])), 0.0
    if leaf == "bias":
        return "normal", 0.1 if is_bn else 0.02, 0.0
    raise KeyError(f"weights: no rule for {key}")


def seeded_state(shapes: dict, generator: torch.Generator, device) -> dict:
    """{key: float32 tensor on device} for shapes ({key: shape}, the
    program's state_dict order); num_batches_tracked leaves are int64 0."""
    keys = set(shapes)
    plan = {"normal": [], "uniform": []}
    out = {}
    for key, shape in shapes.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        kind, scale, shift = _rule(key, shape, keys)
        plan[kind].append((key, shape, scale, shift))
    for kind, leaves in plan.items():
        if not leaves:
            continue
        sizes = [math.prod(s) for _, s, _, _ in leaves]
        counts, total = torch.tensor(sizes, device=device), sum(sizes)
        flat = torch.empty(total, device=device)
        if kind == "normal":
            flat.normal_(generator=generator)
        else:
            flat.uniform_(generator=generator)
        scale = torch.tensor([c for _, _, c, _ in leaves], device=device)
        shift = torch.tensor([b for _, _, _, b in leaves], device=device)
        flat.mul_(scale.repeat_interleave(counts, output_size=total)).add_(
            shift.repeat_interleave(counts, output_size=total))
        for (key, shape, _, _), part in zip(leaves, flat.split(sizes)):
            out[key] = part.view(shape)
    if "trans_out.bias" in out:
        out["trans_out.bias"][2] = 0.5
    return {key: out[key] for key in shapes}


@torch.no_grad()
def settle_detector(sd_yolo: dict, frames: torch.Tensor, spread: float = DETECTOR_SPREAD) -> None:
    """Set the detector's BatchNorm statistics in place from the reference
    detector run on frames [N, H, W, 3] uint8 (nets.settle_batchnorm)."""
    from .reference import nets, pipeline

    with pipeline.tf32_off(), nets.settle_batchnorm(spread):
        pipeline.detections(sd_yolo, frames)


@torch.no_grad()
def outlier_channels(sd_pose: dict, every: int = OUTLIER_EVERY,
                     factor: float = OUTLIER_FACTOR) -> None:
    """In place: in every BatchNorm of the pose net's ResNet-50 towers but
    the downsample ones (keys "...backbone....bn<i>.weight"), the weight of
    every `every`-th channel times `factor`."""
    for key, t in sd_pose.items():
        if "backbone" in key and ".bn" in key and key.endswith(".weight"):
            t[::every] *= factor


def shapes_of(module_factory) -> dict:
    """{state_dict key: shape} of the module module_factory() builds, built
    on the meta device."""
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in module_factory().state_dict().items()}
