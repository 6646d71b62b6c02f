"""The slices as a whole: pose6d_tpu_torch's PosePipeline against the JAX
PosePipeline on the same weights and frames, for rgbd, rgbd_geometric and
rgb.

Small size: 64x64 uint8 frames (native-resolution detection), a narrow
YOLOv8 (width 0.125, nc 2), img_size 64, conf_thresh 0, compute f32, float
and folded towers. The JAX pipeline runs with jit disabled (op by op) to
keep the CPU compile out of the test's time. Boxes agree within 1e-3 px,
rotations within 1e-4 and translations within 1e-4 m; also 60x64 frames
through the letterbox (det_size 640) and rgb with geometric_correction
off. tests/test_torch_letterbox.py and tests/test_torch_nms.py hold the
letterbox, crop window and max_objects > 1 configurations. The fused stem,
layer1 and stages need img_size 224; tests/test_torch_posenet_serving.py
and tests/test_torch_posenet_variants.py cover them.
"""

import jax
import pytest
import torch

from pose6d_tpu_torch.convert import init_posenet_weights, init_yolo_weights
from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
from pose6d_tpu_torch.models.posenet import PoseNetConfig
from pose6d_tpu_torch.models.yolo.model import YoloConfig

from torch_port_utils import PIPE_IMG as IMG, assert_pipeline_parity, make_pipeline_pair, \
    pipeline_request

S = IMG
B = 2


@pytest.fixture(scope="module")
def pipelines():
    return make_pipeline_pair("rgbd")


@pytest.fixture(scope="module", params=["rgbd_geometric", "rgb"])
def variant_pipelines(request):
    return request.param, make_pipeline_pair(request.param)


@pytest.fixture(scope="module")
def request_data():
    return pipeline_request(0, (S, S), B)


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
    assert_pipeline_parity(got, want)


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
    assert_pipeline_parity(got, want)


def test_pipeline_refuses_what_is_not_ported(pipelines, request_data):
    jpipe, tpipe = pipelines
    frames, K, depth = request_data
    # 60 rows do not divide the stride 32: the letterbox branch (det_size
    # 640), which the port serves as the JAX pipeline does
    with jax.disable_jit():
        want = jpipe(frames[:, :60], K, depth[:, :60])
    assert_pipeline_parity(tpipe(frames[:, :60], K, depth[:, :60]), want)
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


@pytest.mark.parametrize("folded", [False, True])
def test_rgb_no_correction(request_data, folded):
    """Mirror of tests/test_infer_pipeline.py::test_rgb_no_correction:
    geometric_correction=False serves the head's translation as it is (no
    X/Y re-derivation), as the JAX pipeline does."""
    jpipe, tpipe = make_pipeline_pair("rgb", geometric_correction=False)
    _, corrected = make_pipeline_pair("rgb")
    frames, K, _ = request_data
    if folded:
        jpipe.fold_backbones()
        tpipe.fold_backbones()
        corrected.fold_backbones()
    with jax.disable_jit():
        want = jpipe(frames, K)
    got = tpipe(frames, K)
    assert_pipeline_parity(got, want)
    assert not torch.allclose(got["translation"][:, :2], corrected(frames, K)["translation"][:, :2])
