"""The train half of pose6d_tpu_torch.ops.augment against
pose6d_tpu/ops/augment.py: each deterministic op with explicit factors
within 1e-6 (f32 elementwise math on [0, 1] images; the HSV round trip
within 1e-5, its divisions near grey pixels amplify rounding), the erasing
of the box JAX chose bit-exact. The random ops draw from a
torch.Generator, whose numbers differ from JAX's keys by construction, so
they are tested for their ranges, shapes and generator determinism."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.ops import augment as ja
from pose6d_tpu_torch.ops import augment as ta

B, HW = 4, 24


@pytest.fixture
def img():
    x = np.random.default_rng(0).uniform(0, 1, (B, HW, HW, 3)).astype(np.float32)
    x[0, :4, :4] = 0.5  # grey pixels: zero saturation, hue 0
    x[1, :2, :2] = 0.0
    x[2, :2, :2] = 1.0
    return x


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_grayscale_and_normalize(img):
    _close(ta.rgb_to_grayscale(torch.from_numpy(img)), ja.rgb_to_grayscale(jnp.asarray(img)))
    _close(ta.normalize(torch.from_numpy(img)), ja.normalize(jnp.asarray(img)))
    u8 = (img * 255).astype(np.uint8)
    _close(ta.eval_preprocess(torch.from_numpy(u8)), ja.eval_preprocess(jnp.asarray(u8)))


@pytest.mark.parametrize("op", ["brightness", "contrast", "saturation"])
def test_blend_ops_with_explicit_factors(img, op):
    f = np.array([0.7, 1.0, 1.15, 1.3], np.float32).reshape(B, 1, 1, 1)
    want = getattr(ja, f"adjust_{op}")(jnp.asarray(img), jnp.asarray(f))
    got = getattr(ta, f"adjust_{op}")(torch.from_numpy(img), torch.from_numpy(f))
    _close(got, want)


def test_hsv_round_trip_and_hue(img):
    hsv_t = ta._rgb_to_hsv(torch.from_numpy(img))
    hsv_j = ja._rgb_to_hsv(jnp.asarray(img))
    _close(hsv_t, hsv_j)
    _close(ta._hsv_to_rgb(hsv_t), ja._hsv_to_rgb(hsv_j), atol=1e-5)
    _close(ta._hsv_to_rgb(hsv_t), img, atol=1e-5)  # the round trip
    d = np.array([-0.05, 0.0, 0.02, 0.05], np.float32).reshape(B, 1, 1)
    _close(ta.adjust_hue(torch.from_numpy(img), torch.from_numpy(d)),
           ja.adjust_hue(jnp.asarray(img), jnp.asarray(d)), atol=1e-5)


def test_erasing_of_the_box_jax_chose(img):
    """JAX's random_erasing_batch with p=1 zeroes one box per image; the
    port's erase_boxes given that box reproduces it bit for bit."""
    x = np.array(ja.normalize(jnp.asarray(img)))
    cfg = ja.AugmentConfig(erase_p=1.0)
    want = np.asarray(ja.random_erasing_batch(jax.random.key(3), jnp.asarray(x), cfg))
    zero = (want == 0).all(-1)
    take = zero.any((1, 2))
    assert take.sum() >= 2
    boxes = []
    for b in range(B):
        rows, cols = np.nonzero(zero[b]) if take[b] else (np.array([0]), np.array([0]))
        boxes.append((rows.min(), cols.min(), rows.max() - rows.min() + 1,
                      cols.max() - cols.min() + 1))
    y0, x0, h, w = (torch.tensor([bx[i] for bx in boxes]) for i in range(4))
    got = ta.erase_boxes(torch.from_numpy(x), torch.from_numpy(take), y0, x0, h, w)
    np.testing.assert_array_equal(got.numpy(), want)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_color_jitter_ranges_and_determinism(img):
    x = torch.from_numpy(img)
    cfg = ta.AugmentConfig()
    a = ta.color_jitter_batch(_gen(1), x, cfg)
    assert a.shape == x.shape and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert torch.equal(a, ta.color_jitter_batch(_gen(1), x, cfg))
    assert not torch.equal(a, ta.color_jitter_batch(_gen(2), x, cfg))
    # zero-width factor ranges: every op is the identity up to the HSV
    # round trip's rounding, whatever the order
    off = ta.AugmentConfig(brightness=0, contrast=0, saturation=0, hue=0)
    _close(ta.color_jitter_batch(_gen(3), x, off), img, atol=1e-5)
    # brightness alone: each image scaled by one factor in [0.7, 1.3]
    only_b = ta.AugmentConfig(contrast=0, saturation=0, hue=0)
    x = x.clamp_min(0.05) * 0.5  # positive: the ratio is defined
    ratio = (ta.color_jitter_batch(_gen(4), x, only_b) / x).reshape(B, -1)
    assert torch.allclose(ratio, ratio[:, :1].expand_as(ratio), atol=1e-3, rtol=0)
    assert float(ratio.min()) >= 0.7 - 1e-4 and float(ratio.max()) <= 1.3 + 1e-4


def test_random_grayscale():
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (64, 4, 4, 3)).astype(np.float32))
    assert torch.equal(ta.random_grayscale_batch(_gen(0), x, 0.0), x)
    gray = ta.random_grayscale_batch(_gen(0), x, 1.0)
    assert torch.allclose(gray, ta.rgb_to_grayscale(x).expand_as(x))
    mixed = ta.random_grayscale_batch(_gen(0), x, 0.5)
    n_gray = int((mixed[..., 0] == mixed[..., 1]).all(-1).all(-1).sum())
    assert 16 <= n_gray <= 48


def test_random_erasing_ranges():
    x = torch.randn(64, 32, 32, 3, generator=_gen(0)) + 5.0  # no exact zeros
    cfg = ta.AugmentConfig(erase_p=1.0)
    y = ta.random_erasing_batch(_gen(1), x, cfg)
    zero = (y == 0).all(-1)
    area = zero.float().mean((1, 2))
    erased = area > 0
    assert int(erased.sum()) >= 48  # p = 1: all but the boxes that do not fit
    # each erased region is one rectangle of 2-10 % of the image (rounding)
    for b in torch.nonzero(erased).flatten().tolist():
        rows, cols = torch.nonzero(zero[b], as_tuple=True)
        h, w = int(rows.max() - rows.min() + 1), int(cols.max() - cols.min() + 1)
        assert int(zero[b].sum()) == h * w
        assert 0.015 <= h * w / 1024 <= 0.11
    assert torch.equal(ta.random_erasing_batch(_gen(1), x, ta.AugmentConfig(erase_p=0.0)), x)


def test_train_augment_shapes_and_determinism():
    u8 = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (B, HW, HW, 3), dtype=np.uint8))
    a = ta.train_augment(_gen(9), u8)
    assert a.shape == (B, HW, HW, 3) and a.dtype == torch.float32
    assert torch.isfinite(a).all()
    assert torch.equal(a, ta.train_augment(_gen(9), u8.float() / 255.0))
    assert not torch.equal(a, ta.train_augment(_gen(10), u8))
    # normalized range: [0, 1] images map into [-2.2, 2.7]
    assert float(a.min()) >= -2.2 and float(a.max()) <= 2.7
