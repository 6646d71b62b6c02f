"""The host half of the crop contract (pose6d_tpu_torch/data/crop.py)
against the JAX package's (pose6d_tpu/data/crop.py, cv2): jitter_bbox,
compute_crop_params and adjust_K_for_crop exactly equal over
hypothesis-drawn boxes, boxes outside the frame included; crop_resize_image
against cv2's copyMakeBorder + resize(INTER_LINEAR): uint8 bit-equal at
every downscale and within 1 everywhere (the share of pixels off by one
printed; it reads 0 here), uint16 within 1 (cv2's float arithmetic is not
reproduced in its order)."""

import dataclasses

import cv2
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from pose6d_tpu.data import crop as jcrop
from pose6d_tpu_torch.data import crop as tcrop

W, H = 640, 480

boxes = st.tuples(st.integers(-150, W + 50), st.integers(-150, H + 50),
                  st.integers(1, 400), st.integers(1, 400)).map(
                      lambda b: np.asarray(b, dtype=np.float64))


@settings(max_examples=200, deadline=None)
@given(bbox=boxes, seed=st.integers(0, 2**31 - 1), flavor=st.sampled_from(["rgb", "rgbd"]),
       img_size=st.sampled_from([224, 64]))
def test_crop_bookkeeping_exact(bbox, seed, flavor, img_size):
    pos, sc = tcrop.JITTER[flavor]
    got_j = tcrop.jitter_bbox(bbox, np.random.default_rng(seed), pos, sc)
    want_j = jcrop.jitter_bbox(bbox, np.random.default_rng(seed), pos, sc)
    assert got_j.dtype == want_j.dtype and np.array_equal(got_j, want_j)
    for jittered in (got_j, bbox):
        got = tcrop.compute_crop_params(jittered, bbox, W, H, img_size)
        want = jcrop.compute_crop_params(jittered, bbox, W, H, img_size)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]],
                     np.float32)
        k_got, k_want = tcrop.adjust_K_for_crop(K, got), jcrop.adjust_K_for_crop(K, want)
        assert k_got.dtype == k_want.dtype and np.array_equal(k_got, k_want)


def _images(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    rgb = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (0, 0), 1.5)
    depth = rng.integers(0, 3000, (h, w)).astype(np.uint16)
    depth[rng.random(depth.shape) < 0.1] = 0
    return rgb, depth


IMAGES = _images(0)
OFF_BY_ONE = []


@settings(max_examples=120, deadline=None)
@given(bbox=boxes, img_size=st.sampled_from([224, 64]))
def test_crop_resize_against_cv2(bbox, img_size):
    p = jcrop.compute_crop_params(bbox, bbox, W, H, img_size)
    if p.size <= 0:
        return
    rgb, depth = IMAGES
    got, want = tcrop.crop_resize_image(rgb, p), jcrop.crop_resize_image(rgb, p)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= 1
    if p.size >= img_size:  # a downscale (or 1:1): bit for bit
        assert diff.max() == 0, (p.size, img_size)
    OFF_BY_ONE.append(float((diff > 0).mean()))
    dgot, dwant = tcrop.crop_resize_image(depth, p), jcrop.crop_resize_image(depth, p)
    assert dgot.dtype == dwant.dtype == np.uint16
    assert np.abs(dgot.astype(int) - dwant).max() <= 1


@pytest.mark.parametrize("n", [17, 40, 111, 223, 224, 225, 300, 448, 500])
def test_resize_linear_sizes(n):
    """Up- and downscales of a square crop straight through resize_linear,
    one channel and three: uint8 against cv2 within 1 (bit-equal from n >=
    224), uint16 within 1."""
    rgb, depth = _images(n, n, n)
    for img in (rgb, rgb[..., 0]):
        want = cv2.resize(img, (224, 224), interpolation=cv2.INTER_LINEAR)
        diff = np.abs(tcrop.resize_linear(img, 224).astype(int) - want)
        assert diff.max() <= (0 if n >= 224 else 1)
        OFF_BY_ONE.append(float((diff > 0).mean()))
    want = cv2.resize(depth, (224, 224), interpolation=cv2.INTER_LINEAR)
    assert np.abs(tcrop.resize_linear(depth, 224).astype(int) - want).max() <= 1
    with pytest.raises(TypeError):
        tcrop.resize_linear(depth.astype(np.float32), 224)


def test_report_off_by_one_share():
    """Prints the share of uint8 pixels off by one over the tests above."""
    print(f"uint8 pixels off by one vs cv2: mean share {np.mean(OFF_BY_ONE or [0.0]):.3g}, "
          f"max {max(OFF_BY_ONE or [0.0]):.3g} over {len(OFF_BY_ONE)} crops")


def test_normalize_depth_np_matches_jax():
    raw = np.random.default_rng(3).uniform(-0.1, 2.0, (5, 7)).astype(np.float32)
    raw[0, :3] = [0.0, 0.005, 0.01]
    got, want = tcrop.normalize_depth_np(raw), jcrop.normalize_depth(raw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
