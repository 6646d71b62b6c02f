"""The PNG writer (data/png.encode_png), the geometry added for the
overlays (project_points, quat_canonical / quat_conj / quat_mul /
quat_rotate) and utils/ (camera, mesh, viz) against cv2 and the JAX
package.

cv2 decodes the port's PNGs bit for bit (8-bit RGB and 16-bit grey, each
row filter, as row y % 5 takes it), and the port decodes cv2's. project_points
matches JAX's within 1e-4 px (its integer form in utils.viz within 1 px),
quaternion and matrix forms; the quaternion functions within 1e-6.
get_gt_and_K and load_mesh_corners equal JAX's on a generated tree;
draw_3d_box / draw_axes / draw_rectangle equal cv2's drawing pixel for
pixel (0 differing, within the 0.5 % asked of the port)."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.geometry import pinhole as jpin
from pose6d_tpu.geometry import quat as jquat
from pose6d_tpu.utils import camera as jcam
from pose6d_tpu.utils import mesh as jmesh
from pose6d_tpu.utils import viz as jviz
from pose6d_tpu_torch.data.png import decode_png, encode_png, read_png, write_png
from pose6d_tpu_torch.data.synthetic import generate_synthetic_linemod
from pose6d_tpu_torch.geometry import pinhole as ppin
from pose6d_tpu_torch.geometry import quat as pquat
from pose6d_tpu_torch.utils import camera as pcam
from pose6d_tpu_torch.utils import mesh as pmesh
from pose6d_tpu_torch.utils import viz as pviz

def _images(rng, h=37, w=53):
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    rgb[:, :w // 2] = rgb[:, :1]  # runs, so that Sub / Up / Paeth see zeros
    depth = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    depth[h // 3:h // 2] = 1234
    return rgb, depth


# row y takes filter y % 5: 37 rows use all five; 1 row only None, 4 rows
# all but Paeth; a width of 1 leaves Sub and Paeth no left neighbour
@pytest.mark.parametrize("h,w", [(37, 53), (1, 7), (4, 9), (6, 1), (10, 2), (480, 640)],
                         ids=lambda v: str(v))
def test_encode_png_decodes_bit_exact_in_cv2(h, w):
    rgb, depth = _images(np.random.default_rng(1), h, w)
    for img in (rgb, depth):
        data = encode_png(img)
        got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        if img.ndim == 3:
            got = got[:, :, ::-1]  # cv2 reads BGR
        assert got.dtype == img.dtype and np.array_equal(got, img)
        assert np.array_equal(decode_png(data), img)


def test_port_decodes_cv2_pngs(tmp_path):
    rgb, depth = _images(np.random.default_rng(2))
    cv2.imwrite(str(tmp_path / "rgb.png"), rgb[:, :, ::-1])
    cv2.imwrite(str(tmp_path / "depth.png"), depth)
    assert np.array_equal(read_png(str(tmp_path / "rgb.png")), rgb)
    assert np.array_equal(read_png(str(tmp_path / "depth.png")), depth)
    write_png(str(tmp_path / "mine.png"), rgb)
    assert np.array_equal(cv2.imread(str(tmp_path / "mine.png"))[:, :, ::-1], rgb)
    with pytest.raises(ValueError):
        encode_png(rgb.astype(np.float32))


def _poses(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
                  rng.uniform(0.5, 1.2, n)], -1).astype(np.float32)
    return q, t


def test_project_points_matches_jax():
    rng = np.random.default_rng(3)
    q, t = _poses(rng, 5)
    pts = rng.uniform(-0.1, 0.1, (5, 40, 3)).astype(np.float32)
    K = np.repeat(jpin.DEFAULT_K[None], 5, 0)
    T = torch.from_numpy
    got = ppin.project_points(T(pts), T(q), T(t), T(K)).numpy()
    want = np.asarray(jpin.project_points(jnp.asarray(pts), jnp.asarray(q), jnp.asarray(t),
                                          jnp.asarray(K)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    mats = np.array(jquat.quat_to_mat(jnp.asarray(q)))
    got_m = ppin.project_points(T(pts), T(mats), T(t), T(K)).numpy()
    want_m = np.asarray(jpin.project_points(jnp.asarray(pts), jnp.asarray(mats), jnp.asarray(t),
                                            jnp.asarray(K)))
    np.testing.assert_allclose(got_m, want_m, atol=1e-4)
    assert np.array_equal(ppin.DEFAULT_K, jpin.DEFAULT_K)
    # the host form: integer pixels, one pose (quaternion or matrix)
    for rot in (q[0], mats[0]):
        a = pviz.project_points(pts[0], rot, t[0], jpin.DEFAULT_K)
        b = jviz.project_points(pts[0], rot, t[0], jpin.DEFAULT_K)
        assert a.dtype.kind == "i" and np.abs(a - b).max() <= 1


def test_quat_functions_match_jax():
    rng = np.random.default_rng(4)
    q1, _ = _poses(rng, 16)
    q2, _ = _poses(rng, 16)
    v = rng.standard_normal((16, 3)).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy
    cases = [(pquat.quat_canonical(T(q1)), jquat.quat_canonical(J(q1))),
             (pquat.quat_conj(T(q1)), jquat.quat_conj(J(q1))),
             (pquat.quat_mul(T(q1), T(q2)), jquat.quat_mul(J(q1), J(q2))),
             (pquat.quat_rotate(T(q1), T(v)), jquat.quat_rotate(J(q1), J(v))),
             (pquat.quat_rotate(T(q1[:1]), T(v)), jquat.quat_rotate(J(q1[:1]), J(v)))]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert (pquat.quat_canonical(T(q1))[:, 3] >= 0).all()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return generate_synthetic_linemod(str(tmp_path_factory.mktemp("tree")), obj_ids=(1, 10),
                                      frames_per_obj=4, img_w=160, img_h=120, seed=6)


def test_camera_and_mesh_equal_jax(tree):
    for folder in ("01", "10"):
        for frame in (0, 3, 99):  # 99: not annotated, K from the file's first entry
            got, want = pcam.get_gt_and_K(tree["data"], folder, frame), \
                jcam.get_gt_and_K(tree["data"], folder, frame)
            for g, w in zip(got, want):
                assert (g is None and w is None) or np.array_equal(g, w)
        assert np.array_equal(pmesh.load_mesh_corners(tree["models"], folder),
                              jmesh.load_mesh_corners(tree["models"], folder))
    assert pcam.get_gt_and_K(tree["data"], "05", 0)[2].tolist() == jpin.DEFAULT_K.tolist()
    assert pmesh.load_mesh_corners(tree["models"], "05") is None


def test_overlays_equal_cv2(tree):
    rng = np.random.default_rng(7)
    frame = read_png(os.path.join(tree["data"], "01", "rgb", "0000.png"))[:, :, ::-1]
    corners = pmesh.load_mesh_corners(tree["models"], "01")
    for _ in range(6):
        q, t = _poses(rng, 1)
        t[0, :2] *= 3  # some boxes and axes leave the frame
        a, b = frame.copy(), frame.copy()
        pts = pviz.project_points(corners, q[0], t[0], jpin.DEFAULT_K)
        pviz.draw_3d_box(a, pts)
        pviz.draw_axes(a, q[0], t[0], jpin.DEFAULT_K)
        pviz.draw_rectangle(a, tuple(pts.min(0)), tuple(pts.max(0)), (255, 0, 0), 2)
        jviz.draw_3d_box(b, jviz.project_points(corners, q[0], t[0], jpin.DEFAULT_K))
        jviz.draw_axes(b, q[0], t[0], jpin.DEFAULT_K)
        cv2.rectangle(b, tuple(int(x) for x in pts.min(0)), tuple(int(x) for x in pts.max(0)),
                      (255, 0, 0), 2)
        differ = (a != b).any(axis=-1)
        assert not differ.any(), int(differ.sum())
