"""ImageNet-pretrained towers for the pose networks (counterpart of
pose6d_tpu/models/pretrained.py).

The reference's published accuracies start from torchvision's ImageNet
ResNet50 (pose_net_rgb.py:18-19), and its depth tower's conv1 is that
conv1 summed over the input channels (pose_net_rgbd.py:53-59). Given a
torchvision resnet50 state_dict (a .pth file the user provides, or a
mapping), this builds a PoseNet whose towers hold those weights and whose
heads keep the flax-rule from-scratch init (posenet.flax_init_).
"""

from __future__ import annotations

from typing import Mapping, Union

import torch

from .convert import load_torch_state_dict, resnet50_from_torchvision, s2d_conv1_weights
from .posenet import PoseNet, PoseNetConfig, flax_init_


@torch.no_grad()
def init_posenet_with_pretrained(cfg: PoseNetConfig, seed: int,
                                 resnet_state_dict: Union[str, Mapping]) -> PoseNet:
    """A PoseNet (on the CPU) initialized by the flax rules from `seed`,
    with its ResNet50 towers loaded from a torchvision resnet50 state_dict
    or a path to one: rgbd's depth tower takes conv1 summed to one channel,
    and with cfg.stem_s2d each conv1 is folded to the space-to-depth kernel
    after that sum."""
    if isinstance(resnet_state_dict, str):
        resnet_state_dict = load_torch_state_dict(resnet_state_dict)
    model = flax_init_(PoseNet(cfg), seed)
    for name in model.towers:
        sd = resnet50_from_torchvision(resnet_state_dict,
                                       sum_conv1_to_1ch=name == "depth_backbone")
        if cfg.stem_s2d:
            sd["conv1.weight"] = s2d_conv1_weights(sd["conv1.weight"])
        getattr(model, name).load_state_dict(sd, strict=True)
    return model
