"""pose6d_tpu_torch.models.pretrained (ImageNet towers from a torchvision
resnet50 state_dict) against the JAX package's init_posenet_with_pretrained,
and the Trainer's pretrained_backbone=.

A seeded torchvision-layout state_dict (convert.init_torchvision_resnet50)
goes through both packages; after convert.posenet_from_jax, every tower
leaf of JAX's variables is bit-equal to the port's model: for rgb, for
rgbd (the depth tower's conv1 summed over the RGB channels) and with
stem_s2d (the conv1 folded to the space-to-depth kernel after that sum).
The heads keep each package's own from-scratch init and are not compared.
Trainer(..., pretrained_backbone=<.pth>) builds, and its towers equal the
loaded dict before the first step."""

import os

import jax
import numpy as np
import pytest
import torch

from pose6d_tpu.models.posenet import PoseNetConfig as JPoseNetConfig
from pose6d_tpu.models.pretrained import init_posenet_with_pretrained as j_init
from pose6d_tpu_torch.configs.presets import get_preset
from pose6d_tpu_torch.convert import init_torchvision_resnet50, posenet_from_jax
from pose6d_tpu_torch.data.synthetic import generate_synthetic_linemod
from pose6d_tpu_torch.models.convert import resnet50_from_torchvision
from pose6d_tpu_torch.models.posenet import PoseNetConfig
from pose6d_tpu_torch.models.pretrained import init_posenet_with_pretrained
from pose6d_tpu_torch.train.trainer import Trainer

from torch_port_utils import few_torch_threads  # noqa: F401

S = 64


@pytest.fixture(scope="module")
def tv_sd():
    return init_torchvision_resnet50(21)


@pytest.mark.parametrize("variant,s2d", [("rgb", False), ("rgbd", False), ("rgbd", True)],
                         ids=["rgb", "rgbd", "rgbd-stem_s2d"])
def test_towers_bit_equal_to_jax(tv_sd, variant, s2d):
    jvars = j_init(JPoseNetConfig(variant=variant, img_size=S, stem_s2d=s2d),
                   jax.random.key(0), tv_sd)
    want = posenet_from_jax(jax.tree.map(np.asarray, jvars))
    model = init_posenet_with_pretrained(PoseNetConfig(variant=variant, img_size=S,
                                                       stem_s2d=s2d), 0, tv_sd)
    got = model.state_dict()
    towers = ("rgb_backbone", "depth_backbone") if variant == "rgbd" else ("backbone",)
    keys = [k for k in got if k.split(".")[0] in towers]
    assert len(keys) == len(towers) * len(resnet50_from_torchvision(tv_sd))
    for k in keys:
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k
    if variant == "rgbd":
        c_in = 4 if s2d else 1
        assert got["depth_backbone.conv1.weight"].shape[1] == c_in


def test_trainer_loads_the_towers_before_the_first_step(tv_sd, tmp_path):
    paths = generate_synthetic_linemod(str(tmp_path / "tree"), obj_ids=(1,), frames_per_obj=10,
                                       img_w=160, img_h=120, seed=2)
    pth = str(tmp_path / "resnet50.pth")
    torch.save({"state_dict": tv_sd}, pth)  # a checkpoint dict, unwrapped on load
    tr = Trainer(get_preset("rgb", img_size=S, batch_size=4), paths["data"], paths["models"],
                 str(tmp_path / "save"), num_workers=0, pretrained_backbone=pth, device="cpu")
    try:
        want = resnet50_from_torchvision(tv_sd)
        got = tr.state.model.backbone.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        # the heads are the flax-rule init, as without a pretrained tower
        assert float(tr.state.model.trans_out.bias.detach()[2]) == 0.5
    finally:
        tr.close()
        for name in os.listdir(tmp_path / "save"):
            os.remove(tmp_path / "save" / name)
