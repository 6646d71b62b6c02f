"""The letterbox and the windowed crop of pose6d_tpu_torch against the
JAX package, and the pipeline configurations that use them.

Small size: frames of tens of pixels, a narrow YOLOv8 (width 0.125, nc 2)
at det_size 64, img_size 64, compute f32, the JAX pipeline with jit
disabled. Tolerances:
- the letterbox canvas within 1e-6 in f32; in bf16 within 2 bf16 ulps of
  the JAX value, because jax.image.resize rounds its weights and each
  axis's result to bf16 while the port resizes in f32 and rounds once (2
  ulps is what this CPU reads);
- crops within 1e-5 in f32 and within one bf16 ulp in bf16 (equal on this
  CPU); the windowed crop equals the full-frame crop within 1e-5 where the
  sizes stay under window - 2;
- boxes through the pipeline within 1e-3 px (the unmapping divides by the
  letterbox scale), scores within 1e-5, classes and validity equal,
  rotations within 1e-4, translations within 1e-4 m.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.infer import PipelineConfig as JPipelineConfig, PosePipeline as JPosePipeline
from pose6d_tpu.models.yolo.model import YoloConfig as JYoloConfig
from pose6d_tpu.ops import crop_resize as jcr
from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
from pose6d_tpu_torch.models.yolo.model import YoloConfig
from pose6d_tpu_torch.ops import crop_resize as tcr

from torch_port_utils import assert_pipeline_parity, make_pipeline_pair, pipeline_request

DET = 64
DOWN, UP = (72, 112), (40, 48)  # frames that shrink / grow onto the 64x64 canvas
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def bf16_ulp(x):
    """The bf16 spacing at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hw", [DOWN, UP], ids=["down", "up"])
def test_letterbox_matches_jax(hw, dtype):
    td, jd = DTYPES[dtype]
    frames = np.random.default_rng(0).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    owner = lambda cfg, ycfg: types.SimpleNamespace(cfg=cfg, yolo_cfg=ycfg)  # noqa: E731
    want = JPosePipeline._letterbox(owner(JPipelineConfig(det_size=DET), JYoloConfig()),
                                    jnp.asarray(frames).astype(jd) / 255.0)
    got = PosePipeline._letterbox(owner(PipelineConfig(det_size=DET), YoloConfig()),
                                  torch.from_numpy(frames).to(td) / 255.0)
    assert got[1:] == tuple(want[1:])  # scale, pad_l, pad_t, det_hw
    assert got[0].dtype == td and got[0].shape == (2, DET, DET, 3)
    canvas, ref = got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32))
    err = np.abs(canvas - ref)
    if dtype == "f32":
        assert err.max() <= 1e-6
    else:
        assert (err <= 2 * bf16_ulp(ref)).all()
    pad_t = got[3]
    np.testing.assert_allclose(canvas[:, :pad_t], np.float32(114 / 255.0), rtol=0,
                               atol=0 if dtype == "f32" else 2e-3)


def test_native_frames_skip_the_letterbox():
    pipe = types.SimpleNamespace(cfg=PipelineConfig(det_size=DET), yolo_cfg=YoloConfig())
    frames = torch.rand(1, 64, 96, 3)
    canvas, scale, pad_l, pad_t, det_hw = PosePipeline._letterbox(pipe, frames)
    assert canvas is frames and (scale, pad_l, pad_t, det_hw) == (1.0, 0, 0, (64, 96))


@pytest.mark.parametrize("hw", [DOWN, UP], ids=["down", "up"])
def test_detect_best_unmaps_boxes(hw):
    """_detect_best on a letterboxed frame: the general decode (8 slots, as
    max_objects=3 asks) mapped back to the frame, [B, 8, 4] xywh."""
    jpipe, tpipe = make_pipeline_pair("rgb", det_size=DET, max_objects=3)
    frames = pipeline_request(1, hw)[0].astype(np.float32) / 255.0
    with jax.disable_jit():
        want_box, want = jpipe._detect_best(jpipe.yolo_variables, jnp.asarray(frames))
    with torch.no_grad():
        got_box, got = tpipe._detect_best(torch.from_numpy(frames))
    assert got_box.shape == (2, 8, 4)
    np.testing.assert_allclose(got_box.numpy(), np.asarray(want_box), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0,
                               atol=1e-4)
    for k in ("classes", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0,
                               atol=1e-5)
    # the frame boxes are the canvas boxes unmapped: (b - pad) / scale
    scale = min(DET / hw[1], DET / hw[0])
    assert not np.allclose(got_box[..., 2:].numpy(), (got["boxes"][..., 2:] -
                                                      got["boxes"][..., :2]).numpy())
    np.testing.assert_allclose(got_box[..., 2].numpy() * scale,
                               (got["boxes"][..., 2] - got["boxes"][..., 0]).numpy(),
                               rtol=1e-5, atol=1e-4)


def _crop_case(seed=0, src="rgb"):
    """Frames [6, 72, 112, C] and crop parameters with negative origins, a
    crop past the right edge and sizes 8-60: src "rgb" is uint8 frames
    /255 (C = 3), "depth" metric depth in 0.2-1.5 m (C = 1)."""
    rng = np.random.default_rng(seed)
    if src == "rgb":
        img = (rng.integers(0, 256, (6, 72, 112, 3)) / 255.0).astype(np.float32)
    else:
        img = rng.uniform(0.2, 1.5, (6, 72, 112, 1)).astype(np.float32)
    x1 = np.array([-10, 5, 30, 90, 0, 60], np.float32)
    y1 = np.array([-4, 2, 20, 40, 50, 30], np.float32)
    size = np.array([30, 17, 40, 45, 60, 8], np.float32)
    return img, x1, y1, size


def _assert_crop_close(got, want, dtype):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want)
    if dtype == "f32":
        assert err.max() <= 1e-5
    else:
        assert (err <= bf16_ulp(want)).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("src", ["rgb", "depth"])
@pytest.mark.parametrize("window", [None, 48], ids=["full", "window48"])
def test_crop_matches_jax(window, src, dtype):
    """crop_resize_matmul and crop_resize_matmul_windowed on frames /255
    and on metric depth maps."""
    td, jd = DTYPES[dtype]
    img, x1, y1, size = _crop_case(src=src)
    t = [torch.from_numpy(a) for a in (img, x1, y1, size)]
    j = [jnp.asarray(a) for a in (img, x1, y1, size)]
    if window is None:
        got = tcr.crop_resize_matmul(*t, 24, compute_dtype=td)
        want = jcr.crop_resize_matmul(*j, 24, compute_dtype=jd)
    else:
        got = tcr.crop_resize_matmul_windowed(*t, 24, window, compute_dtype=td)
        want = jcr.crop_resize_matmul_windowed(*j, 24, window, compute_dtype=jd)
    assert got.shape == (6, 24, 24, img.shape[-1]) and got.dtype == torch.float32
    _assert_crop_close(got, want, dtype)


def test_windowed_crop_equals_full_crop():
    """Sizes under window - 2: the window changes nothing but the work.
    A size above it is clamped (its outer border lost), as in JAX."""
    t = [torch.from_numpy(a) for a in _crop_case(1)]
    full = tcr.crop_resize_matmul(*t, 24)
    np.testing.assert_allclose(tcr.crop_resize_matmul_windowed(*t, 24, 64).numpy(),
                               full.numpy(), rtol=0, atol=1e-5)
    clamped = tcr.crop_resize_matmul_windowed(*t, 24, 40)  # sizes 40, 45, 60 -> 38
    fits, cut = [0, 1, 5], [2, 3, 4]
    np.testing.assert_allclose(clamped[fits].numpy(), full[fits].numpy(), rtol=0, atol=1e-5)
    for i in cut:
        assert not np.allclose(clamped[i].numpy(), full[i].numpy(), atol=1e-3)
    # a window larger than the frame is the frame
    np.testing.assert_allclose(tcr.crop_resize_matmul_windowed(*t, 24, 500).numpy(),
                               full.numpy(), rtol=0, atol=1e-5)


CASES = {
    # name: (variant, frame hw, PipelineConfig fields)
    "letterbox_rgb_down": ("rgb", DOWN, {"det_size": DET}),
    "letterbox_rgbd_geometric_up": ("rgbd_geometric", UP, {"det_size": DET}),
    "crop_window_rgbd": ("rgbd", (64, 96), {"crop_window": 40}),
    "crop_window_letterbox_rgbd_geometric": ("rgbd_geometric", DOWN,
                                             {"det_size": DET, "crop_window": 48}),
}


@pytest.mark.parametrize("folded", [False, True], ids=["float", "folded"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_matches_jax(case, folded):
    variant, hw, cfg = CASES[case]
    jpipe, tpipe = make_pipeline_pair(variant, **cfg)
    if folded:
        jpipe.fold_backbones()
        tpipe.fold_backbones()
    frames, K, depth = pipeline_request(2, hw)
    args = (frames, K) if variant.startswith("rgb_") or variant == "rgb" else (frames, K, depth)
    with jax.disable_jit():
        want = jpipe(*args)
    got = tpipe(*args)
    assert got["rotation"].shape == (2, 4) and got["translation"].shape == (2, 3)
    assert_pipeline_parity(got, want)


def test_rgbd_depth_crop_dtype():
    """rgbd with bf16 compute: depth_crop_bf16 (the default) crops the depth
    map in bf16, depth_crop_bf16=False in f32, each equal to the JAX
    package's crop of that dtype on the same boxes."""
    from pose6d_tpu_torch.data.crop import normalize_depth

    frames, K, depth = pipeline_request(3, (64, 64))
    outs = {}
    for flag in (True, False):
        _, tpipe = make_pipeline_pair("rgbd", compute_dtype=torch.bfloat16,
                                      depth_crop_bf16=flag)
        with torch.no_grad():
            st = tpipe.crop_stage(torch.from_numpy(frames), torch.from_numpy(K).expand(2, 3, 3),
                                  torch.from_numpy(depth))
        x1, y1, size = (jnp.asarray(p.numpy()) for p in tcr.crop_params_from_bbox(st["bbox_xywh"]))
        jd = jnp.bfloat16 if flag else jnp.float32
        crop = jcr.crop_resize_matmul(jnp.asarray(depth)[..., None].astype(jd), x1, y1, size,
                                      64, compute_dtype=jd)
        want = normalize_depth(torch.from_numpy(np.asarray(crop)))[..., 0:1].to(torch.bfloat16)
        assert st["inputs"]["depth"].dtype == torch.bfloat16
        assert torch.equal(st["inputs"]["depth"], want)
        outs[flag] = st["inputs"]["depth"]
    assert not torch.equal(outs[True], outs[False])
