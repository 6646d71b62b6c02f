"""pose6d_tpu_torch.data.device_pipeline and train.loop.expand_device_batch
against the JAX package: the vectorised crop bookkeeping and the store's
metadata batches equal under the same numpy rng, and the device batch
(gather + crop on packed or raw frames) exact for labels and within 1e-5
for the crops ([0, 1] RGB, metres, the normalized depth channel).

The JAX DeviceFrameStore decodes a LineMOD split with cv2; here it is
built around the same label arrays without its constructor, so that its
batch logic runs on exactly the port store's inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pose6d_tpu.data import device_pipeline as jdp
from pose6d_tpu.ops.gather_frames import pack_frames_host
from pose6d_tpu.train.loop import expand_device_batch as jexpand
from pose6d_tpu_torch.data import device_pipeline as tdp
from pose6d_tpu_torch.train.loop import expand_device_batch as texpand

N, H, W, S = 12, 32, 64, 32


def _labels(rng, n=N, h=H, w=W):
    bw, bh = rng.uniform(6, 20, n), rng.uniform(6, 20, n)
    bbox = np.stack([rng.uniform(-4, w - 10, n), rng.uniform(-4, h - 10, n), bw, bh], -1)
    rot = Rotation.from_quat(rng.normal(size=(n, 4))).as_matrix()
    trans_mm = np.stack([rng.uniform(-90, 90, n), rng.uniform(-90, 90, n),
                         rng.uniform(500, 1100, n)], -1)
    K = np.tile(np.array([[572.4114, 0, w / 2], [0, 573.57043, h / 2], [0, 0, 1]]), (n, 1, 1))
    return bbox, rot, trans_mm, rng.integers(0, 13, n), K.astype(np.float32)


def _stores(seed=0, flavor="rgbd", augment_bbox=True, h=H, w=W):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (N, h, w, 3), dtype=np.uint8)
    depth = rng.integers(0, 1800, (N, h, w)).astype(np.uint16)
    depth[rng.random(depth.shape) < 0.1] = 0
    bbox, rot, trans_mm, obj_id, K = _labels(rng, h=h, w=w)
    port = tdp.DeviceFrameStore(rgb, depth, bbox, rot, trans_mm, obj_id, K, img_size=S,
                                flavor=flavor, augment_bbox=augment_bbox, device="cpu")
    jax_store = object.__new__(jdp.DeviceFrameStore)
    jax_store.img_size, jax_store.flavor, jax_store.augment_bbox = S, flavor, augment_bbox
    jax_store.frame_h, jax_store.frame_w = h, w
    jax_store.samples = list(range(N))
    jax_store._bbox = bbox.astype(np.float64)
    jax_store._quat = Rotation.from_matrix(rot).as_quat().astype(np.float32)
    jax_store._trans = (trans_mm / 1000.0).astype(np.float32)
    jax_store._obj_id = obj_id.astype(np.int32)
    jax_store._cam_K = K
    return port, jax_store, rgb, depth


def test_vector_crop_params_and_K_match_jax():
    rng = np.random.default_rng(3)
    bbox, *_, K = _labels(rng, 64)
    bbox_j = bbox + np.trunc(rng.uniform(-3, 3, bbox.shape))
    want = jdp._vector_crop_params(bbox_j, bbox, W, H, S)
    got = tdp._vector_crop_params(bbox_j, bbox, W, H, S)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(tdp._vector_adjust_K(K, got), jdp._vector_adjust_K(K, want))


def test_quat_from_matrix_matches_scipy():
    rng = np.random.default_rng(4)
    rot = Rotation.from_quat(rng.normal(size=(64, 4))).as_matrix()
    rot[:8] += rng.normal(0, 1e-6, (8, 3, 3))  # not orthogonal: projected first
    rot[8] = np.diag([1.0, -1.0, -1.0])        # each pivot of the four
    rot[9] = np.diag([-1.0, 1.0, -1.0])
    rot[10] = np.diag([-1.0, -1.0, 1.0])
    np.testing.assert_allclose(tdp.quat_from_matrix(rot),
                               Rotation.from_matrix(rot).as_quat(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("flavor,augment_bbox", [("rgbd", True), ("rgb", True), ("rgb", False)])
def test_meta_batches_match_jax(flavor, augment_bbox):
    port, jax_store, *_ = _stores(flavor=flavor, augment_bbox=augment_bbox)
    assert len(port) == N
    got = list(port.batches(5, np.random.default_rng(7), shuffle=True, drop_remainder=False))
    want = list(jax_store.batches(5, np.random.default_rng(7), shuffle=True,
                                  drop_remainder=False))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    meta, n = port.epoch_meta(4, np.random.default_rng(8))
    jmeta, jn = jax_store.epoch_meta(4, np.random.default_rng(8))
    assert n == jn == 3
    for k in jmeta:
        np.testing.assert_array_equal(meta[k], jmeta[k], err_msg=k)
    assert port.epoch_meta(N + 1, np.random.default_rng(0)) == (None, 0)


def test_store_holds_packed_words():
    port, _, rgb, depth = _stores()
    assert port.rgb_packed and port.depth_packed
    assert port.rgb_frames.dtype == torch.int32 and tuple(port.rgb_frames.shape) == (N, H * W * 3 // 4)
    assert tuple(port.depth_frames.shape) == (N, H * W // 2)
    np.testing.assert_array_equal(port.rgb_frames.numpy().view(np.uint8).reshape(rgb.shape), rgb)
    assert port.nbytes() == rgb.nbytes + depth.nbytes


@pytest.mark.parametrize("frame_hw", [(H, W), (30, 50)])  # packed words; raw frames
def test_expand_device_batch_matches_jax(frame_hw):
    h, w = frame_hw
    port, jax_store, rgb, depth = _stores(seed=5, h=h, w=w)
    packed = port.rgb_packed
    assert packed == (frame_hw == (H, W))
    meta = port.meta_batch(np.array([3, 0, 11, 3]), np.random.default_rng(9))
    if packed:
        jf, jd = pack_frames_host(rgb), pack_frames_host(depth)
    else:
        jf, jd = rgb, depth
    want = jexpand(jnp.asarray(jf), jnp.asarray(jd), {k: jnp.asarray(v) for k, v in meta.items()},
                   S, frame_hw if packed else None)
    got = texpand(port.rgb_frames, port.depth_frames,
                  {k: torch.from_numpy(v) for k, v in meta.items()}, S,
                  frame_hw if packed else None)
    assert set(got) == set(want)
    for k in meta:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("rgb", "depth_raw", "depth"):
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert float(got["rgb"].max()) > 0.5 and float(got["depth_raw"].max()) > 0.5
