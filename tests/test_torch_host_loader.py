"""The port's host loader and the store built from it against the JAX
package on a tree from its own generator: LineMODPoseLoader.batches equal
to JAX's under the same seed (rgb and rgbd flavours, compact and not,
train with jitter and val with padding and `valid`): labels and
bookkeeping exact, images within the host crop's bound (uint8 within 1,
bit-equal at downscales; tests/test_torch_host_crop.py); and
DeviceFrameStore.from_loader's frames bit-equal to cv2's decode, its
epoch_meta equal to the JAX store's (built by JAX from its own loader)
under the same seed."""

import cv2
import numpy as np
import pytest
import torch

from pose6d_tpu.data.device_pipeline import DeviceFrameStore as JStore
from pose6d_tpu.data.pipeline import LineMODPoseLoader as JLoader
from pose6d_tpu.data.synthetic import generate_synthetic_linemod
from pose6d_tpu_torch.data.device_pipeline import DeviceFrameStore
from pose6d_tpu_torch.data.pipeline import LineMODPoseLoader

S = 64
IMAGE_KEYS = ("rgb", "depth", "depth_raw", "depth_mm")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("loader_tree")
    return generate_synthetic_linemod(str(root), obj_ids=(1, 10), frames_per_obj=20,
                                      img_w=320, img_h=240, seed=6)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if k in IMAGE_KEYS:
                # uint8 within 1 (one step of 1/255 as float), depth within
                # 1 mm (1e-3 m; the normalized channel within 1/1500)
                tol = {"rgb": 1.0 if a[k].dtype == np.uint8 else 1 / 255 + 1e-7,
                       "depth_mm": 1.0, "depth_raw": 1e-3 + 1e-7, "depth": 1e-3 / 1.5 + 1e-7}[k]
                assert np.abs(a[k].astype(np.float64) - b[k]).max() <= tol, k
            else:
                assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("flavor", ["rgb", "rgbd"])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("mode", ["train", "val"])
def test_batches_match_jax(tree, flavor, compact, mode):
    train = mode == "train"
    kw = dict(mode=mode, flavor=flavor, img_size=S, num_workers=2, compact_arrays=compact)
    jl, tl = JLoader(tree["data"], **kw), LineMODPoseLoader(tree["data"], **kw)
    assert len(tl) == len(jl)
    bs = 8 if train else 3  # val: 4 samples -> a padded last batch
    got = list(tl.batches(bs, np.random.default_rng(5), shuffle=train, drop_remainder=train))
    want = list(jl.batches(bs, np.random.default_rng(5), shuffle=train, drop_remainder=train))
    _assert_batches_equal(got, want)
    if not train:
        assert not got[-1]["valid"].all() and got[0]["valid"].all()
    tl.close()


def test_cache_decoded_and_no_threads(tree):
    """cache_decoded and num_workers 0 give the same batches."""
    kw = dict(mode="train", flavor="rgbd", img_size=S, compact_arrays=True)
    a = LineMODPoseLoader(tree["data"], num_workers=0, **kw)
    b = LineMODPoseLoader(tree["data"], num_workers=2, cache_decoded=True, **kw)
    for _ in range(2):  # the second pass reads b's cache
        for x, y in zip(a.batches(8, np.random.default_rng(1)),
                        b.batches(8, np.random.default_rng(1))):
            assert all(np.array_equal(x[k], y[k]) for k in x)
    assert len(b._decoded) == 2 * len(b.samples)
    b.close()


@pytest.mark.parametrize("mode", ["train", "val"])
def test_batches_rows_are_the_global_rows(tree, mode):
    """rows=slice(4, 8) (a rank's share of a batch of 8 on a data axis of
    2) yields rows 4-8 of each unsliced batch bit for bit, the bbox jitter
    and a padded last batch's `valid` included, and loads 4 samples a
    batch; rng ends where the unsliced pass leaves it."""
    train = mode == "train"
    kw = dict(mode=mode, flavor="rgbd", img_size=S, num_workers=2, compact_arrays=True)
    full, part = LineMODPoseLoader(tree["data"], **kw), LineMODPoseLoader(tree["data"], **kw)
    rng_full, rng_part = np.random.default_rng(9), np.random.default_rng(9)
    want = list(full.batches(8, rng_full, shuffle=train, drop_remainder=train))
    loads = []
    load_sample = part.load_sample
    part.load_sample = lambda idx, rng: loads.append(idx) or load_sample(idx, rng)
    got = list(part.batches(8, rng_part, shuffle=train, drop_remainder=train,
                            rows=slice(4, 8)))
    assert len(got) == len(want) > 0 and len(loads) == 4 * len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k][4:8]), k
    if not train:
        assert not got[-1]["valid"].all()
    assert rng_part.integers(2**31) == rng_full.integers(2**31)
    full.close()
    part.close()


@pytest.mark.parametrize("flavor", ["rgb", "rgbd"])
def test_store_from_loader(tree, flavor):
    tl = LineMODPoseLoader(tree["data"], mode="train", flavor=flavor, img_size=S, num_workers=2)
    store = DeviceFrameStore.from_loader(tl, device="cpu")
    assert len(store) == len(tl.samples) and store.samples is tl.samples
    assert (store.frame_h, store.frame_w) == (240, 320) and store.with_depth == (flavor == "rgbd")
    rgb = np.stack([cv2.imread(s.img_path)[:, :, ::-1] for s in tl.samples])
    words = rgb.reshape(len(rgb), -1).view(np.int32)
    assert store.rgb_packed and np.array_equal(store.rgb_frames.numpy(), words)
    if flavor == "rgbd":
        depth = np.stack([cv2.imread(s.depth_path, cv2.IMREAD_UNCHANGED) for s in tl.samples])
        assert np.array_equal(store.depth_frames.numpy(),
                              depth.reshape(len(depth), -1).view(np.int32))
    else:
        assert store.depth_frames is None

    jstore = JStore(JLoader(tree["data"], mode="train", flavor=flavor, img_size=S,
                            num_workers=0))
    got, n_got = store.epoch_meta(8, np.random.default_rng(3))
    want, n_want = jstore.epoch_meta(8, np.random.default_rng(3))
    assert n_got == n_want > 0 and set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    tl.close()


def test_store_refuses_mixed_frame_sizes(tree, tmp_path):
    tl = LineMODPoseLoader(tree["data"], mode="val", flavor="rgb", img_size=S, num_workers=0)
    odd = tmp_path / "odd.png"
    cv2.imwrite(str(odd), np.zeros((10, 12, 3), np.uint8))
    tl.samples[1].img_path = str(odd)
    with pytest.raises(ValueError, match="non-uniform"):
        DeviceFrameStore.from_loader(tl, device="cpu")
    tl.samples = []
    with pytest.raises(ValueError, match="empty"):
        DeviceFrameStore.from_loader(tl, device="cpu")


def test_device_batch_from_disk_is_finite(tree):
    """One device-preprocessing batch of the disk-built store through
    expand_device_batch (the store's frames as the train step reads them)."""
    from pose6d_tpu_torch.train.loop import expand_device_batch

    tl = LineMODPoseLoader(tree["data"], mode="train", flavor="rgbd", img_size=S, num_workers=0)
    store = DeviceFrameStore.from_loader(tl, device="cpu")
    meta = next(store.batches(4, np.random.default_rng(0)))
    out = expand_device_batch(store.rgb_frames, store.depth_frames,
                              {k: torch.from_numpy(v) for k, v in meta.items()}, S,
                              (store.frame_h, store.frame_w))
    assert out["rgb"].shape == (4, S, S, 3) and out["depth"].shape == (4, S, S, 1)
    assert torch.isfinite(out["rgb"]).all() and float(out["depth_raw"].max()) > 0
