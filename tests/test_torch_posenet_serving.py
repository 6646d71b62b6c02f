"""pose6d_tpu_torch PoseNet (rgbd) and its folded serving forward against
pose6d_tpu's PoseNet.apply and serving_forward.

flax weights with every BatchNorm randomised go through
convert.posenet_from_jax. At img_size 64 (B=2): the port's float PoseNet
against PoseNet.apply and the port's folded f32 serving_forward against
the JAX folded f32 serving_forward, atol 1e-4 on rotation and translation.
At img_size 224 (B=1) both serving forwards route their towers through the
stem and layer1 hooks (the port's plain versions on the CPU, the Pallas
kernels in interpret mode in JAX), atol 1e-4. Seeded weights load for all
four variants (the others are held against JAX in
tests/test_torch_posenet_variants.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
from pose6d_tpu.models.posenet_serving import serving_forward as j_serving_forward
from pose6d_tpu.ops.pallas_block import pack_layer1_weights as j_pack_l1
from pose6d_tpu.ops.pallas_block import pack_stem_weights as j_pack_stem
from pose6d_tpu.ops.quant import fold_bn_resnet as j_fold
from pose6d_tpu_torch.convert import init_posenet_weights, posenet_from_jax
from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig
from pose6d_tpu_torch.models.posenet_serving import serving_forward
from pose6d_tpu_torch.ops.fused_block import pack_layer1_weights, pack_stem_weights
from pose6d_tpu_torch.ops.quant import fold_bn_resnet

from torch_port_utils import random_flax_variables

ATOL = 1e-4
TOWERS = ("rgb_backbone", "depth_backbone")


def _setup(S, B, seed=0):
    jcfg = JPoseNetConfig(variant="rgbd", img_size=S)
    jmodel = JPoseNet(jcfg)
    rng = np.random.default_rng(seed)
    rgb = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    depth = rng.uniform(0, 1, (B, S, S, 1)).astype(np.float32)
    variables = random_flax_variables(jmodel, jnp.asarray(rgb), depth=jnp.asarray(depth),
                                      seed=seed + 1)
    tcfg = PoseNetConfig(variant="rgbd")
    tmodel = PoseNet(tcfg)
    tmodel.load_state_dict(posenet_from_jax(variables), strict=True)
    return jcfg, jmodel, variables, tcfg, tmodel.eval(), rgb, depth


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_float_and_folded_match_jax():
    jcfg, jmodel, variables, tcfg, tmodel, rgb, depth = _setup(64, 2)
    want = jmodel.apply(variables, jnp.asarray(rgb), depth=jnp.asarray(depth))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(rgb), torch.from_numpy(depth))
        got_served = serving_forward(tmodel, tcfg, torch.from_numpy(rgb), torch.from_numpy(depth))
    _close(got, want)
    want_served = j_serving_forward(variables, jcfg, jnp.asarray(rgb), depth=jnp.asarray(depth))
    _close(got_served, want_served)
    _close(got_served, want)


def test_fold_matches_jax_fold():
    _, _, variables, _, tmodel, _, _ = _setup(64, 1)
    for name in TOWERS:
        j = j_fold(variables["params"][name], variables["batch_stats"][name])
        t = fold_bn_resnet(getattr(tmodel, name))
        assert set(j) == set(t)
        for k in j:
            np.testing.assert_allclose(t[k]["w"].numpy(), j[k]["w"].transpose(3, 2, 0, 1),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(t[k]["b"].numpy(), j[k]["b"], rtol=1e-6, atol=1e-7)


def test_fused_prefix_hooks_match_jax_at_224():
    jcfg, _, variables, tcfg, tmodel, rgb, depth = _setup(224, 1)
    jfold, tfold = {}, {}
    for name in TOWERS:
        jt = j_fold(variables["params"][name], variables["batch_stats"][name])
        jfold[name] = {"tree": jt, "pallas_stem": j_pack_stem(jt, jnp.float32),
                       "pallas_l1": j_pack_l1(jt, jnp.float32)}
        tt = fold_bn_resnet(getattr(tmodel, name))
        tfold[name] = {"tree": tt, "pallas_stem": pack_stem_weights(tt, torch.float32),
                       "pallas_l1": pack_layer1_weights(tt, torch.float32)}
    want = j_serving_forward(variables, jcfg, jnp.asarray(rgb), depth=jnp.asarray(depth),
                             folded=jfold)
    with torch.no_grad():
        got = serving_forward(tmodel, tcfg, torch.from_numpy(rgb), torch.from_numpy(depth),
                              folded=tfold)
    _close(got, want)


@pytest.mark.parametrize("variant", ["rgb", "rgb_geometric", "rgbd", "rgbd_geometric"])
def test_seeded_weights_load_and_other_variants_raise(variant):
    """Seeded weights load strictly for every variant; the space-to-depth
    stem builds, and folding it for serving raises."""
    cfg = PoseNetConfig(variant=variant)
    sd = init_posenet_weights(cfg, 0)
    PoseNet(cfg).load_state_dict(sd, strict=True)
    tower = "rgb_backbone" if variant == "rgbd" else "backbone"
    # every BatchNorm is randomised, residual-branch ends included
    assert float(sd[f"{tower}.layer1_0.bn3.weight"].min()) > 0
    assert float(sd[f"{tower}.layer1_0.bn3.running_var"].std()) > 0
    z_bias = {"rgb_geometric": ("z_out.bias", 0), "rgbd_geometric": None}.get(
        variant, ("trans_out.bias", 2))
    if z_bias is not None:  # the learned z starts at 0.5 m
        assert float(sd[z_bias[0]][z_bias[1]]) == 0.5
    # the space-to-depth stem builds (tests/test_torch_convert_resnet.py
    # holds it to JAX); the folded serving towers take the 7x7 stem only
    s2d = PoseNet(PoseNetConfig(variant=variant, stem_s2d=True))
    assert s2d.state_dict()[f"{tower}.conv1.weight"].shape == (64, 12, 4, 4)
    with pytest.raises(ValueError, match="stem_s2d"):
        fold_bn_resnet(getattr(s2d, tower))
