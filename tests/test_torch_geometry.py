"""pose6d_tpu_torch.geometry against pose6d_tpu.geometry (f32, atol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.geometry import pinhole as jpin
from pose6d_tpu.geometry import quat as jquat
from pose6d_tpu_torch.geometry import pinhole as tpin
from pose6d_tpu_torch.geometry import quat as tquat

ATOL = 1e-6


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quat_normalize_and_to_mat(rng):
    q = rng.normal(size=(32, 4)).astype(np.float32) * 3
    q[0] = 0.0  # safe at zero
    np.testing.assert_allclose(tquat.quat_normalize(torch.from_numpy(q)).numpy(),
                               np.asarray(jquat.quat_normalize(jnp.asarray(q))), atol=ATOL)
    qu = _quats(rng)
    np.testing.assert_allclose(tquat.quat_to_mat(torch.from_numpy(qu)).numpy(),
                               np.asarray(jquat.quat_to_mat(jnp.asarray(qu))), atol=ATOL)


def test_mat_to_quat_every_pivot(rng):
    qu = _quats(rng, 256)
    # force each of the four Shepperd pivots to be the largest somewhere
    qu[:4] = np.eye(4, dtype=np.float32)[[3, 0, 1, 2]]
    m = np.array(jquat.quat_to_mat(jnp.asarray(qu)))
    got = tquat.mat_to_quat(torch.from_numpy(m)).numpy()
    want = np.asarray(jquat.mat_to_quat(jnp.asarray(m)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("batched_k", [True, False])
def test_pinhole_xy_from_z(rng, batched_k):
    B = 16
    z = rng.uniform(0.3, 1.5, (B,)).astype(np.float32)
    c = rng.uniform(0, 640, (B, 2)).astype(np.float32)
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
    if batched_k:
        K = np.broadcast_to(K, (B, 3, 3)) * rng.uniform(0.9, 1.1, (B, 1, 1)).astype(np.float32)
    got = tpin.pinhole_xy_from_z(torch.from_numpy(z), torch.from_numpy(c),
                                 torch.from_numpy(np.ascontiguousarray(K))).numpy()
    want = np.asarray(jpin.pinhole_xy_from_z(jnp.asarray(z), jnp.asarray(c), jnp.asarray(K)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)


def test_adjust_intrinsics_for_crop(rng):
    B = 8
    K = np.broadcast_to(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                                 np.float32), (B, 3, 3)).copy()
    x1, y1 = rng.uniform(-40, 400, (2, B)).astype(np.float32)
    scale = rng.uniform(0.5, 3.0, (B,)).astype(np.float32)
    zeros = np.zeros(B, np.float32)
    args = (K, x1, y1, zeros, zeros, scale)
    got = tpin.adjust_intrinsics_for_crop(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(jpin.adjust_intrinsics_for_crop(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
