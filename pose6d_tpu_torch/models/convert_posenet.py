"""The reference's PoseNet* checkpoints <-> the port's PoseNet state_dict
(counterpart of pose6d_tpu/models/convert_posenet.py).

The reference publishes trained .pth files for its four pose variants. Its
models wrap torchvision's resnet50 in nn.Sequential, so tower keys are
positional (`backbone.0.*` conv1, `.1` bn1, `.4`-`.7` layer1-4), and its
heads are nn.Sequential of Linear / BatchNorm1d / LayerNorm / Conv2d at
fixed indices (`rot_head.4.*`, `z_backbone.12.*`). Both sides keep torch's
layouts, so the mapping renames keys and copies values:

  rgb:             models/pose_net_rgb.py:14-54
  rgb_geometric:   models/pose_net_rgb_geometric.py:14-68
  rgbd:            models/pose_net_rgbd.py:8-116
  rgbd_geometric:  models/pose_net_rgbd_geometric.py:15-38

The maps below are the JAX package's `_MAPS` with the port's module names
(its flax scopes joined by dots).
"""

from __future__ import annotations

from typing import Mapping

import torch

from .convert import _f32, resnet50_from_torchvision, resnet50_to_torchvision

# nn.Sequential(*list(resnet.children())[:-1]) index -> torchvision name
_SEQ_TO_TV = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3",
              "7": "layer4"}
_TV_TO_SEQ = {v: k for k, v in _SEQ_TO_TV.items()}

# per variant: "seq" (port tower, reference Sequential attribute) and
# (port module, reference module) pairs of each kind
MAPS = {
    "rgb": {
        "seq": [("backbone", "backbone")],
        "linear": [("rot_dense0", "rot_head.0"), ("rot_dense1", "rot_head.4"),
                   ("rot_dense2", "rot_head.8"), ("rot_out", "rot_head.10"),
                   ("trans_dense0", "trans_head.0"), ("trans_dense1", "trans_head.4"),
                   ("trans_dense2", "trans_head.8"), ("trans_out", "trans_head.10")],
        "bn": [("rot_norm0", "rot_head.1"), ("rot_norm1", "rot_head.5"),
               ("trans_norm0", "trans_head.1"), ("trans_norm1", "trans_head.5")],
        "ln": [],
        "conv": [],
    },
    "rgb_geometric": {
        "seq": [("backbone", "rgb_backbone")],
        "linear": [("rot_dense0", "rot_head.0"), ("rot_dense1", "rot_head.4"),
                   ("rot_out", "rot_head.8"),
                   ("z_dense0", "z_predictor.0"), ("z_dense1", "z_predictor.3"),
                   ("z_out", "z_predictor.5")],
        "bn": [("rot_norm0", "rot_head.1"), ("rot_norm1", "rot_head.5"),
               ("z_backbone.bn0", "z_backbone.1"), ("z_backbone.bn1", "z_backbone.5"),
               ("z_backbone.bn2", "z_backbone.9"), ("z_backbone.bn3", "z_backbone.13")],
        "ln": [],
        "conv": [("z_backbone.conv0", "z_backbone.0"), ("z_backbone.conv1", "z_backbone.4"),
                 ("z_backbone.conv2", "z_backbone.8"), ("z_backbone.conv3", "z_backbone.12")],
    },
    "rgbd": {
        "seq": [("rgb_backbone", "rgb_backbone"), ("depth_backbone", "depth_backbone")],
        "linear": [("cross_attention.q_proj", "cross_attention.q_proj"),
                   ("cross_attention.k_proj", "cross_attention.k_proj"),
                   ("cross_attention.v_proj", "cross_attention.v_proj"),
                   ("cross_attention.out_proj", "cross_attention.out_proj"),
                   ("fusion_dense0", "fusion.0"), ("fusion_dense1", "fusion.4"),
                   ("rot_dense0", "rot_head.0"), ("rot_dense1", "rot_head.4"),
                   ("rot_out", "rot_head.6"),
                   ("trans_dense0", "trans_head.0"), ("trans_dense1", "trans_head.4"),
                   ("trans_out", "trans_head.6")],
        "bn": [],
        "ln": [("rgb_norm", "rgb_norm"), ("depth_norm", "depth_norm"),
               ("fusion_norm0", "fusion.1"), ("fusion_norm1", "fusion.5"),
               ("rot_norm0", "rot_head.1"), ("trans_norm0", "trans_head.1")],
        "conv": [],
    },
    "rgbd_geometric": {
        "seq": [("backbone", "backbone")],
        "linear": [("rot_dense0", "rot_head.0"), ("rot_dense1", "rot_head.4"),
                   ("rot_out", "rot_head.8")],
        "bn": [("rot_norm0", "rot_head.1"), ("rot_norm1", "rot_head.5")],
        "ln": [],
        "conv": [],
    },
}
# the leaves of each kind of module
_LEAVES = {"linear": ("weight", "bias"), "conv": ("weight", "bias"), "ln": ("weight", "bias"),
           "bn": ("weight", "bias", "running_mean", "running_var")}


def _tower_from_sequential(sd: Mapping, seq_attr: str) -> dict:
    """`<seq_attr>.<idx>.` positional keys -> torchvision names."""
    out = {}
    pref = seq_attr + "."
    for key, val in sd.items():
        if key.startswith(pref):
            idx, _, tail = key[len(pref):].partition(".")
            if idx in _SEQ_TO_TV:
                out[_SEQ_TO_TV[idx] + ("." + tail if tail else "")] = val
    return out


def posenet_from_reference(variant: str, state_dict: Mapping) -> dict:
    """A reference PoseNet* state_dict (tensors or arrays) -> the port's
    PoseNet state_dict for PoseNetConfig(variant=variant)."""
    m = MAPS[variant]
    out = {}
    for tower, seq_attr in m["seq"]:
        for k, v in resnet50_from_torchvision(_tower_from_sequential(state_dict, seq_attr)).items():
            out[f"{tower}.{k}"] = v
    for kind in ("linear", "conv", "bn", "ln"):
        for ours, theirs in m[kind]:
            for leaf in _LEAVES[kind]:
                out[f"{ours}.{leaf}"] = _f32(state_dict[f"{theirs}.{leaf}"])
            if kind == "bn":
                out[f"{ours}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return out


def posenet_to_reference(variant: str, state: Mapping) -> dict:
    """Inverse of posenet_from_reference: the port's PoseNet state_dict ->
    reference-keyed float32 tensors (num_batches_tracked 0), loadable into
    the reference's model classes."""
    m = MAPS[variant]
    out = {}
    for tower, seq_attr in m["seq"]:
        pref = tower + "."
        tower_sd = {k[len(pref):]: v for k, v in state.items() if k.startswith(pref)}
        for tv_key, val in resnet50_to_torchvision(tower_sd).items():
            name, _, tail = tv_key.partition(".")
            out[f"{seq_attr}.{_TV_TO_SEQ[name]}.{tail}"] = val
    for kind in ("linear", "conv", "bn", "ln"):
        for ours, theirs in m[kind]:
            for leaf in _LEAVES[kind]:
                out[f"{theirs}.{leaf}"] = _f32(state[f"{ours}.{leaf}"])
            if kind == "bn":
                out[f"{theirs}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return out
