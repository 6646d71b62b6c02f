"""pose6d_tpu_torch PoseNet's rgb, rgb_geometric and rgbd_geometric
variants (and the config flags serving reads) against pose6d_tpu's
PoseNet.apply and serving_forward.

flax weights with every BatchNorm randomised go through
convert.posenet_from_jax. At img_size 64 (B=2), with box centres that
straddle the crop's edges and depth maps with invalid pixels: the port's
float PoseNet against PoseNet.apply, and the port's folded f32
serving_forward against the JAX folded f32 serving_forward, atol 1e-4 on
rotation and translation. The JAX serving forward has no z_from_backbone
branch (it reads the ZBackbone's parameters, which that config does not
have), so there the port's serving forward is held against
PoseNet.apply. At img_size 224 (B=1) rgbd_geometric's tower runs through
the stem and stage 1-2 hooks in both packages (the port's plain versions
on the CPU, the Pallas kernels in interpret mode in JAX), atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
from pose6d_tpu.models.posenet_serving import serving_forward as j_serving_forward
from pose6d_tpu.ops.pallas_block import pack_stage_weights as j_pack_stage
from pose6d_tpu.ops.pallas_block import pack_stem_weights as j_pack_stem
from pose6d_tpu.ops.quant import fold_bn_resnet as j_fold
from pose6d_tpu_torch.convert import posenet_from_jax
from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig
from pose6d_tpu_torch.models.posenet_serving import serving_forward
from pose6d_tpu_torch.ops.fused_block import pack_stage_weights, pack_stem_weights
from pose6d_tpu_torch.ops.quant import fold_bn_resnet

from torch_port_utils import random_flax_variables

ATOL = 1e-4
CONFIGS = [
    ("rgb", {}),
    ("rgb_geometric", {}),
    ("rgb_geometric", {"z_from_backbone": True}),
    ("rgb_geometric", {"z_backbone_wide": True, "rot_head_wide": True}),
    ("rgbd_geometric", {}),
    ("rgbd_geometric", {"rot_head_wide": True}),
    ("rgbd", {"rot_head_wide": True, "fusion_attention": False}),
]


def _inputs(S, B, variant, seed):
    rng = np.random.default_rng(seed)
    inputs = {"rgb": rng.standard_normal((B, S, S, 3)).astype(np.float32)}
    if variant == "rgbd":
        inputs["depth"] = rng.uniform(0, 1, (B, S, S, 1)).astype(np.float32)
    if variant in ("rgb_geometric", "rgbd_geometric"):
        # centres inside and beyond the crop's edges (clipped)
        inputs["bbox_center"] = rng.uniform(-6, S + 6, (B, 2)).astype(np.float32)
        K = np.array([[150.0, 0, S / 2], [0, 160.0, S / 2 - 2], [0, 0, 1]], np.float32)
        inputs["camera_matrix"] = np.repeat(K[None], B, 0)
    if variant == "rgbd_geometric":
        d = rng.uniform(0.05, 2.5, (B, S, S)).astype(np.float32)
        d[:, ::2] = 0.0  # invalid rows: the fallback depth
        inputs["depth_raw"] = d
    return inputs


def _setup(variant, flags, S, B, seed=0):
    jcfg = JPoseNetConfig(variant=variant, img_size=S, **flags)
    jmodel = JPoseNet(jcfg)
    inputs = _inputs(S, B, variant, seed)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    variables = random_flax_variables(jmodel, seed=seed + 1, **jin)
    tcfg = PoseNetConfig(variant=variant, img_size=S, **flags)
    tmodel = PoseNet(tcfg)
    tmodel.load_state_dict(posenet_from_jax(variables), strict=True)
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    return jcfg, jmodel, variables, tcfg, tmodel.eval(), jin, tin


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("variant,flags", CONFIGS,
                         ids=[v + "".join(f"-{k}" for k in f) for v, f in CONFIGS])
def test_float_and_folded_match_jax(variant, flags):
    jcfg, jmodel, variables, tcfg, tmodel, jin, tin = _setup(variant, flags, 64, 2)
    want = jmodel.apply(variables, **jin)
    with torch.no_grad():
        got = tmodel(**tin)
        served = serving_forward(tmodel, tcfg, **tin)
    _close(got, want)
    if flags.get("z_from_backbone"):
        _close(served, want)
    else:
        _close(served, j_serving_forward(variables, jcfg, **jin))


def test_rgbd_geometric_stage_hooks_match_jax_at_224():
    """The rgbd_geometric tower through the stem and stages 1-2, the graph
    the folded serving runs, in both packages."""
    jcfg, _, variables, tcfg, tmodel, jin, tin = _setup("rgbd_geometric", {}, 224, 1)
    jt = j_fold(variables["params"]["backbone"], variables["batch_stats"]["backbone"])
    jfold = {"backbone": {"tree": jt, "pallas_stem": j_pack_stem(jt, jnp.float32),
                          "pallas_stages": {s: j_pack_stage(jt, s, jnp.float32)
                                            for s in (1, 2)}}}
    tt = fold_bn_resnet(tmodel.backbone)
    tfold = {"backbone": {"tree": tt, "pallas_stem": pack_stem_weights(tt, torch.float32),
                          "pallas_stages": {s: pack_stage_weights(tt, s, torch.float32)
                                            for s in (1, 2)}}}
    want = j_serving_forward(variables, jcfg, folded=jfold, **jin)
    with torch.no_grad():
        got = serving_forward(tmodel, tcfg, folded=tfold, **tin)
    _close(got, want)


def test_rgb_geometric_bf16_serving_raises_in_both():
    """The JAX serving forward runs rgb_geometric's ZBackbone with f32
    kernels on the bf16 crops and lax refuses the mixed dtypes; the port
    raises a TypeError there too rather than inventing a bf16 ZBackbone."""
    jcfg, _, variables, tcfg, tmodel, jin, tin = _setup("rgb_geometric", {}, 64, 1)
    jt = j_fold(variables["params"]["backbone"], variables["batch_stats"]["backbone"])
    jfold = {"backbone": {"tree": {k: {"w": jnp.asarray(v["w"], jnp.bfloat16), "b": v["b"]}
                                   for k, v in jt.items()}}}
    tt = fold_bn_resnet(tmodel.backbone)
    tfold = {"backbone": {"tree": {k: {"w": v["w"].bfloat16(), "b": v["b"].bfloat16()}
                                   for k, v in tt.items()}}}
    with pytest.raises(TypeError):
        j_serving_forward(variables, jcfg, compute_dtype=jnp.bfloat16, folded=jfold,
                          **{**jin, "rgb": jin["rgb"].astype(jnp.bfloat16)})
    with torch.no_grad(), pytest.raises(TypeError, match="ZBackbone"):
        serving_forward(tmodel, tcfg, compute_dtype=torch.bfloat16, folded=tfold,
                        **{**tin, "rgb": tin["rgb"].bfloat16()})
