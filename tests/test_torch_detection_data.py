"""The port's detection data (pose6d_tpu_torch/data/detection.py) against
the JAX package's (pose6d_tpu/data/detection.py, which reads through yaml
and cv2) on trees of the JAX package's generators: DetectionLoader batches
bit for bit at img 64 (a downscale) and 320 (an upscale), train and val,
with and without a multi-object scene root; prepare_yolo_dataset's tree
byte for byte; the sample scans, class ids, letterbox parameters and the
YOLO box conversion."""

import os
import shutil

import numpy as np
import pytest

from pose6d_tpu.data import detection as jdet
from pose6d_tpu.data.synthetic import generate_synthetic_linemod, generate_synthetic_scene
from pose6d_tpu_torch.data import detection as tdet
from pose6d_tpu_torch.data.png import png_size
from torch_port_utils import few_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Objects 01, 02 and 04 (folder 04 is class 2), 20 frames of 200x150
    each, and a 10-frame scene of objects 01 and 02."""
    root = tmp_path_factory.mktemp("det_linemod")
    synth = generate_synthetic_linemod(str(root), obj_ids=(1, 2, 4), frames_per_obj=20,
                                       img_w=200, img_h=150, seed=5)
    scene = str(tmp_path_factory.mktemp("det_scene"))
    generate_synthetic_scene(scene, {1: (220, 90, 90), 2: (90, 220, 90)}, frames=10, img_w=200,
                             img_h=150, seed=3, write_models=False)
    return synth["data"], os.path.join(scene, "data")


def test_convert_bbox_and_letterbox_params():
    for size, box in (((640, 480), [100, 80, 60, 40]), ((200, 150), [3.5, 7.25, 90.0, 61.0])):
        assert tdet.convert_bbox_to_yolo(size, box) == jdet.convert_bbox_to_yolo(size, box)
    for w, h, t in ((640, 480, 640), (200, 150, 64), (200, 150, 320), (150, 200, 96)):
        assert tdet.letterbox_params(w, h, t) == jdet.letterbox_params(w, h, t)


def test_scans_match_jax(trees):
    data, scene = trees
    got, got_folders = tdet._scan_detection_samples(data)
    want, want_folders = jdet._scan_detection_samples(data)
    assert got_folders == want_folders == ["01", "02", "04"]
    assert len(got) == len(want) == 60

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if k == "annos":
                assert [(bb.tolist(), c) for bb, c in a[k]] == [(bb.tolist(), c) for bb, c in b[k]]
            elif isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k

    for a, b in zip(got, want):
        same(a, b)
    assert {s["folder"]: s["class_id"] for s in got} == {"01": 0, "02": 1, "04": 2}
    got_s = tdet._scan_scene_samples(scene, got_folders, 8)
    want_s = jdet._scan_scene_samples(scene, want_folders, 8)
    assert len(got_s) == len(want_s) == 10
    for a, b in zip(got_s, want_s):
        same(a, b)


@pytest.mark.parametrize("img_size", [64, 320])
@pytest.mark.parametrize("mode,scene", [("train", False), ("val", True), ("train", True)])
def test_loader_batches_match_jax(trees, img_size, mode, scene):
    """Every batch of a pass, shuffled by the same generator, bit for bit
    (the uint8 letterbox resize equals cv2's); the last short batch padded."""
    data, scene_root = trees
    roots = (scene_root,) if scene else ()
    got_l = tdet.DetectionLoader(data, mode, img_size, scene_roots=roots)
    want_l = jdet.DetectionLoader(data, mode, img_size, scene_roots=roots)
    assert len(got_l) == len(want_l) and got_l.num_classes == want_l.num_classes == 3
    try:
        got = list(got_l.batches(8, np.random.default_rng(1), shuffle=True, drop_remainder=False))
        want = list(want_l.batches(8, np.random.default_rng(1), shuffle=True,
                                   drop_remainder=False))
    finally:
        got_l.close()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    if scene:
        assert max(int(b["gt_mask"].sum(1).max()) for b in got) == 2


def test_prepare_yolo_dataset_byte_identical(trees, tmp_path):
    """The same dest path written by JAX, then by the port: every file
    (images, labels, dataset.yaml with its absolute path) byte for byte."""
    data, _ = trees
    dest = str(tmp_path / "yolo")
    want_stats = jdet.prepare_yolo_dataset(data, dest)
    kept = str(tmp_path / "jax_tree")
    shutil.move(dest, kept)
    got_stats = tdet.prepare_yolo_dataset(data, dest)
    assert got_stats == want_stats == {"train": 48, "val": 6, "test": 6}

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(dest) == files(kept)
    for rel in files(dest):
        with open(os.path.join(dest, rel), "rb") as a, open(os.path.join(kept, rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert png_size(os.path.join(dest, "images", "train", "01_0000.png")) == (200, 150)
