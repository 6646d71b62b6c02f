"""The slices as a whole: pose6d_tpu_torch's PosePipeline against the JAX
PosePipeline on the same weights and frames, for rgbd, rgbd_geometric and
rgb.

Small size: 64x64 uint8 frames (native-resolution detection), a narrow
YOLOv8 (width 0.125, nc 2), img_size 64, conf_thresh 0, compute f32, float
and folded towers. The JAX pipeline runs with jit disabled (op by op) to
keep the CPU compile out of the test's time. Boxes agree within 1e-3 px,
rotations within 1e-4 and translations within 1e-4 m. The fused stem,
layer1 and stages need img_size 224; tests/test_torch_posenet_serving.py
and tests/test_torch_posenet_variants.py cover them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.infer import PipelineConfig as JPipelineConfig, PosePipeline as JPosePipeline
from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
from pose6d_tpu.models.yolo.model import YoloConfig as JYoloConfig, YoloV8 as JYoloV8
from pose6d_tpu_torch.convert import (init_posenet_weights, init_yolo_weights, posenet_from_jax,
                                      yolo_from_jax)
from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
from pose6d_tpu_torch.models.posenet import PoseNetConfig
from pose6d_tpu_torch.models.yolo.model import YoloConfig

from torch_port_utils import random_flax_variables

S = IMG = 64
B = 2


def _make_pipelines(variant):
    jy = JYoloConfig(num_classes=2, width=0.125)
    yvars = random_flax_variables(JYoloV8(jy), jnp.zeros((1, S, S, 3)), seed=1)
    jp = JPoseNetConfig(variant=variant, img_size=IMG, dtype=jnp.float32)
    extra = {"depth": jnp.zeros((1, IMG, IMG, 1))} if variant == "rgbd" else {}
    pvars = random_flax_variables(JPoseNet(jp), jnp.zeros((1, IMG, IMG, 3)), seed=3, **extra)
    jcfg = JPipelineConfig(variant=variant, img_size=IMG, conf_thresh=0.0,
                           compute_dtype=jnp.float32)
    jpipe = JPosePipeline(jcfg, jy, yvars, pvars, jp)
    tcfg = PipelineConfig(variant=variant, img_size=IMG, conf_thresh=0.0,
                          compute_dtype=torch.float32)
    tpipe = PosePipeline(tcfg, YoloConfig(num_classes=2, width=0.125), yolo_from_jax(yvars),
                         posenet_from_jax(pvars), PoseNetConfig(variant=variant, img_size=IMG),
                         device="cpu")
    return jpipe, tpipe


@pytest.fixture(scope="module")
def pipelines():
    return _make_pipelines("rgbd")


@pytest.fixture(scope="module", params=["rgbd_geometric", "rgb"])
def variant_pipelines(request):
    return request.param, _make_pipelines(request.param)


@pytest.fixture(scope="module")
def request_data():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    depth = rng.uniform(0.2, 1.5, (B, S, S)).astype(np.float32)
    depth[:, :8] = 0.0  # invalid depth rows
    K = np.array([[150.0, 0, 32], [0, 150.0, 30], [0, 0, 1]], np.float32)
    return frames, K, depth


def _compare(got, want):
    np.testing.assert_allclose(got["bbox_xywh"].numpy(), np.asarray(want["bbox_xywh"]), atol=1e-3)
    np.testing.assert_allclose(got["det_score"].numpy(), np.asarray(want["det_score"]), atol=1e-5)
    np.testing.assert_array_equal(got["class_id"].numpy(), np.asarray(want["class_id"]))
    np.testing.assert_allclose(got["rotation"].numpy(), np.asarray(want["rotation"]), atol=1e-4)
    np.testing.assert_allclose(got["translation"].numpy(), np.asarray(want["translation"]),
                               atol=1e-4)


@pytest.mark.parametrize("folded", [False, True])
def test_pipeline_matches_jax(pipelines, request_data, folded):
    jpipe, tpipe = pipelines
    if folded:
        jpipe.fold_backbones()
        tpipe.fold_backbones()
    with jax.disable_jit():
        want = jpipe(*request_data)
    got = tpipe(*request_data)
    assert got["rotation"].shape == (B, 4) and got["translation"].shape == (B, 3)
    _compare(got, want)


@pytest.mark.parametrize("folded", [False, True])
def test_pipeline_variants_match_jax(variant_pipelines, request_data, folded):
    """rgbd_geometric (f32 depth crop, crop-frame centre and intrinsics,
    depth at the centre) and rgb (one tower, learned translation, X/Y
    re-derived) against the JAX pipelines."""
    variant, (jpipe, tpipe) = variant_pipelines
    frames, K, depth = request_data
    args = (frames, K, depth) if variant == "rgbd_geometric" else (frames, K)
    if folded:
        jpipe.fold_backbones()
        tpipe.fold_backbones()
    with jax.disable_jit():
        want = jpipe(*args)
    got = tpipe(*args)
    assert got["rotation"].shape == (B, 4) and got["translation"].shape == (B, 3)
    _compare(got, want)


def test_pipeline_refuses_what_is_not_ported(pipelines, request_data):
    _, tpipe = pipelines
    frames, K, depth = request_data
    with pytest.raises(NotImplementedError):  # letterbox branch
        tpipe(frames[:, :60], K, depth[:, :60])
    with pytest.raises(ValueError):  # the fused prefix needs 224 inputs
        tpipe.fold_backbones(pallas_stem=True)
    with pytest.raises(ValueError):  # and so do the fused stages
        tpipe.fold_backbones(pallas_stages=(2,))
    yolo_cfg = YoloConfig(num_classes=2, width=0.125)
    yolo_state = init_yolo_weights(yolo_cfg, 1)
    with pytest.raises(NotImplementedError):  # the space-to-depth stem
        PosePipeline(PipelineConfig(variant="rgb"), yolo_cfg, yolo_state, {},
                     PoseNetConfig(variant="rgb", stem_s2d=True), device="cpu")
    # rgb_geometric's folded bf16 serving: the JAX package raises there too
    pose_cfg = PoseNetConfig(variant="rgb_geometric", img_size=IMG)
    geo = PosePipeline(PipelineConfig(variant="rgb_geometric", img_size=IMG, conf_thresh=0.0,
                                      compute_dtype=torch.bfloat16),
                       yolo_cfg, yolo_state, init_posenet_weights(pose_cfg, 2), pose_cfg,
                       device="cpu")
    with pytest.raises(TypeError, match="ZBackbone"):
        geo.fold_backbones()(frames, K)
