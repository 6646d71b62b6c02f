"""pose6d_tpu_torch.ops.crop_resize and ops.augment against the JAX package.

crop_params_from_bbox must match exactly, including float32 values within
1e-3 of an integer (the snap before int() truncation) and negative crop
origins. crop_resize_matmul in f32 matches JAX within 1e-5 and the
gather oracle within 1e-4 (both are the same bilinear weights summed in a
different order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.ops import augment as jaug
from pose6d_tpu.ops import crop_resize as jcr
from pose6d_tpu_torch.ops import augment as taug
from pose6d_tpu_torch.ops import crop_resize as tcr


def _boxes(rng, n=64):
    xy = rng.uniform(-60, 500, (n, 2))
    wh = rng.uniform(1, 300, (n, 2))
    return np.concatenate([xy, wh], -1).astype(np.float32)


def test_crop_params_match_jax(rng):
    b = _boxes(rng)
    # near-integer cases: cx - size/2 and size land within 1e-3 of integers
    b[0] = [19.9999, 10.0, 50.0, 40.0]
    b[1] = [-20.0004, -7.9996, 100.0, 10.0]
    b[2] = [3.0, 4.0, 16.666666, 16.666666]
    got = tcr.crop_params_from_bbox(torch.from_numpy(b))
    want = jcr.crop_params_from_bbox(jnp.asarray(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] < 0).any() and (got[1] < 0).any()  # negative origins covered


def _crop_inputs(rng, B=4, H=48, W=64, C=3):
    img = rng.uniform(0, 1, (B, H, W, C)).astype(np.float32)
    x1 = np.array([-10, 5, 30, 0], np.float32)[:B]
    y1 = np.array([-4, 2, 20, 40], np.float32)[:B]
    size = np.array([30, 17, 50, 1], np.float32)[:B]
    return img, x1, y1, size


@pytest.mark.parametrize("C", [3, 1])
def test_crop_resize_matmul_matches_jax_and_oracle(rng, C):
    img, x1, y1, size = _crop_inputs(rng, C=C)
    t = [torch.from_numpy(a) for a in (img, x1, y1, size)]
    got = tcr.crop_resize_matmul(*t, 24).numpy()
    want = np.asarray(jcr.crop_resize_matmul(*(jnp.asarray(a) for a in (img, x1, y1, size)), 24))
    np.testing.assert_allclose(got, want, atol=1e-5)
    oracle = tcr.crop_resize_bilinear(*t, 24).numpy()
    np.testing.assert_allclose(got, oracle, atol=1e-4)
    j_oracle = np.asarray(jcr.crop_resize_bilinear(*(jnp.asarray(a) for a in (img, x1, y1, size)), 24))
    np.testing.assert_allclose(oracle, j_oracle, atol=1e-5)


def test_crop_resize_matmul_bf16_close(rng):
    """bf16 crops (the serving path) stay within bf16 rounding of f32."""
    img, x1, y1, size = _crop_inputs(rng)
    t = [torch.from_numpy(a) for a in (img, x1, y1, size)]
    got = tcr.crop_resize_matmul(*t, 24, compute_dtype=torch.bfloat16).numpy()
    want = tcr.crop_resize_matmul(*t, 24).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_eval_preprocess_matches_jax(rng):
    u8 = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_allclose(taug.eval_preprocess(torch.from_numpy(u8)).numpy(),
                               np.asarray(jaug.eval_preprocess(jnp.asarray(u8))), atol=1e-6)
    f = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(taug.eval_preprocess(torch.from_numpy(f)).numpy(),
                               np.asarray(jaug.eval_preprocess(jnp.asarray(f))), atol=1e-6)
