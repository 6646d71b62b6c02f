"""pose6d_tpu_torch.data.synthetic (the LineMOD generator without cv2) and
data/raster.py against the JAX package's generator and cv2 (5.0, with
PyYAML, an oracle in this environment only).

Same seed and arguments in both packages: obj_ids (1, 10) (10 draws the
symmetric marker colours), 6 frames each at 640x480, and one
generate_synthetic_scene of both objects. gt.yml and info.yml parse equal
under yaml and are the same text; the PLY files and models_info.yml are
byte-equal; every RGB and depth pixel, background noise, silhouette, 2-px
edges, corner dots and depth mask included, equals cv2's (0 differing
pixels, within the 0.5 % of a frame asked of the port). recover_object_colors agrees with JAX's. The
rasterizers alone equal cv2's on 400 random shapes that cross the image
borders: convex hull + fill, lines of thickness 1-3, filled circles and
rectangles."""

import filecmp
import os

import cv2
import numpy as np
import pytest
import yaml

from pose6d_tpu.data import synthetic as jsyn
from pose6d_tpu_torch.data import raster
from pose6d_tpu_torch.data import synthetic as psyn
from pose6d_tpu_torch.data.png import read_png

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    j = str(tmp_path_factory.mktemp("jax_tree"))
    p = str(tmp_path_factory.mktemp("port_tree"))
    kw = dict(obj_ids=(1, 10), frames_per_obj=6, seed=4)
    out = {"jax": jsyn.generate_synthetic_linemod(j, **kw),
           "port": psyn.generate_synthetic_linemod(p, **kw)}
    colors = jsyn.recover_object_colors(out["jax"]["data"])
    skw = dict(frames=3, seed=9, max_angle_deg=60.0)
    out["jax_scene"] = jsyn.generate_synthetic_scene(os.path.join(j, "scene"), colors, **skw)
    out["port_scene"] = psyn.generate_synthetic_scene(os.path.join(p, "scene"), colors, **skw)
    return out


def _assert_frames_match(jdir, pdir, n):
    for fr in range(n):
        want = cv2.imread(os.path.join(jdir, "rgb", f"{fr:04d}.png"))[:, :, ::-1]
        got = read_png(os.path.join(pdir, "rgb", f"{fr:04d}.png"))
        assert got.shape == want.shape == (480, 640, 3)
        differ = (got != want).any(axis=-1)
        assert not differ.any(), f"frame {fr}: {int(differ.sum())} px differ from cv2's"
        dwant = cv2.imread(os.path.join(jdir, "depth", f"{fr:04d}.png"), cv2.IMREAD_UNCHANGED)
        dgot = read_png(os.path.join(pdir, "depth", f"{fr:04d}.png"))
        assert dgot.dtype == dwant.dtype == np.uint16
        assert np.array_equal(dgot, dwant), f"depth frame {fr}"


@pytest.mark.parametrize("folder", ["01", "10"])
def test_linemod_tree_equals_jax(trees, folder):
    jd = os.path.join(trees["jax"]["data"], folder)
    pd = os.path.join(trees["port"]["data"], folder)
    for name in ("gt.yml", "info.yml"):
        with open(os.path.join(jd, name)) as a, open(os.path.join(pd, name)) as b:
            assert yaml.safe_load(a) == yaml.safe_load(b)
        assert filecmp.cmp(os.path.join(jd, name), os.path.join(pd, name), shallow=False)
    _assert_frames_match(jd, pd, 6)


def test_models_byte_equal(trees):
    jm, pm = trees["jax"]["models"], trees["port"]["models"]
    assert sorted(os.listdir(jm)) == sorted(os.listdir(pm))
    for name in os.listdir(jm):
        assert filecmp.cmp(os.path.join(jm, name), os.path.join(pm, name), shallow=False), name


def test_scene_equals_jax(trees):
    jd = os.path.join(trees["jax_scene"]["data"], "01")
    pd = os.path.join(trees["port_scene"]["data"], "01")
    for name in ("gt.yml", "info.yml"):
        assert filecmp.cmp(os.path.join(jd, name), os.path.join(pd, name), shallow=False)
    _assert_frames_match(jd, pd, 3)
    for name in os.listdir(trees["jax_scene"]["models"]):
        assert filecmp.cmp(os.path.join(trees["jax_scene"]["models"], name),
                           os.path.join(trees["port_scene"]["models"], name), shallow=False)


def test_recover_object_colors_agrees(trees):
    want = jsyn.recover_object_colors(trees["jax"]["data"])
    assert psyn.recover_object_colors(trees["port"]["data"]) == want
    assert psyn.recover_object_colors(trees["jax"]["data"]) == want
    assert sorted(want) == [1, 10]


def test_rasterizers_equal_cv2():
    rng = np.random.default_rng(3)
    H, W = 96, 128
    for trial in range(400):
        pts = np.stack([rng.integers(-30, W + 30, 8), rng.integers(-30, H + 30, 8)], 1)
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        a = np.zeros((H, W, 3), np.uint8)
        b = a.copy()
        cv2.fillConvexPoly(a, cv2.convexHull(pts.astype(np.int32)), color)
        raster.fill_convex_poly(b, raster.convex_hull(pts), color)
        assert np.array_equal(a, b), ("poly", trial)
        p1 = tuple(int(x) for x in rng.integers(-20, W + 20, 2))
        p2 = tuple(int(x) for x in rng.integers(-20, H + 20, 2))
        for t in (1, 2, 3):
            a[:] = 0
            b[:] = 0
            cv2.line(a, p1, p2, color, t)
            raster.line(b, p1, p2, color, t)
            assert np.array_equal(a, b), ("line", t, p1, p2)
        a[:] = 0
        b[:] = 0
        c = tuple(int(x) for x in rng.integers(-5, W + 5, 2))
        cv2.circle(a, c, 4, color, -1)
        raster.circle_filled(b, c, 4, color)
        cv2.rectangle(a, p1, p2, color, 2)
        raster.rectangle(b, p1, p2, color, 2)
        assert np.array_equal(a, b), ("circle, rectangle", trial)
