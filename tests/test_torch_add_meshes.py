"""ADD from meshes (pose6d_tpu_torch/losses/add.py) against the JAX
package's losses/add.py on the CPU: load_object_models bit-equal (PLY
parsing, the outlier filter, models_info.yml diameters or the sampled
ones, the 500-point downsample and the padding, drawn in the same rng
order); ADDEvaluator.eval_metrics within 1e-5 relative; add_loss and its
gradient with respect to the predicted rotation and translation within
1e-4 relative of jax.grad. The deliberate difference on exact ties (JAX's
min splits the GT side's gradient among tied points, the port gives it
to the lowest index) leaves the prediction side's gradient equal, since
tied points repeat one another (padding)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial.transform import Rotation

from pose6d_tpu.data.synthetic import generate_synthetic_linemod
from pose6d_tpu.losses import add as jadd
from pose6d_tpu_torch.losses import add as tadd

FIELDS = ("points", "diameters", "symmetric", "present", "num_valid")


def _write_ply(path, pts):
    with open(path, "w") as f:
        f.write(f"ply\nformat ascii 1.0\ncomment test\nelement vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\nelement face 0\n"
                "property list uchar int vertex_indices\nend_header\n")
        f.writelines(f"{a} {b} {c}\n" for a, b, c in pts)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """The generator's models (800-point meshes, models_info.yml for both),
    and a directory of odd meshes: 300 points (padded), 40 points with no
    official diameter (sampled), one with far outliers, one empty, names
    that do not parse, ids out of range, and more fields in models_info.yml."""
    root = tmp_path_factory.mktemp("meshes")
    gen = generate_synthetic_linemod(str(root / "gen"), obj_ids=(1, 10), frames_per_obj=1,
                                     img_w=64, img_h=48, seed=2)
    odd = root / "odd"
    odd.mkdir()
    rng = np.random.default_rng(8)
    _write_ply(odd / "obj_02.ply", rng.uniform(-50, 50, (300, 3)))
    _write_ply(odd / "obj_05.ply", rng.uniform(-30, 30, (40, 3)))
    _write_ply(odd / "obj_11.ply", np.concatenate([rng.uniform(-40, 40, (700, 3)),
                                                   [[900.0, 0, 0], [0, -800.0, 0]]]))
    _write_ply(odd / "obj_07.ply", np.zeros((0, 3)))
    _write_ply(odd / "obj_xx.ply", rng.uniform(-1, 1, (5, 3)))
    _write_ply(odd / "obj_16.ply", rng.uniform(-1, 1, (5, 3)))
    (odd / "models_info.yml").write_text(
        "# ids 1-based\n2: {diameter: 150.5, min_x: -50.0}\n\n11: {diameter: 98.25, size_x: 80.0}\n")
    return {"gen": gen["models"], "odd": str(odd)}


@pytest.mark.parametrize("which", ["gen", "odd"])
def test_models_info_parser(model_dirs, which, tmp_path):
    path = os.path.join(model_dirs[which], "models_info.yml")
    with open(path) as f:
        assert tadd.parse_models_info(path) == yaml.safe_load(f)
    bad = tmp_path / "models_info.yml"
    bad.write_text("1:\n  diameter: 100.0\n")  # block form: not what LineMOD writes
    with pytest.raises(ValueError, match="models_info.yml:1"):
        tadd.parse_models_info(str(bad))


@pytest.mark.parametrize("which", ["gen", "odd"])
def test_load_object_models_bit_equal(model_dirs, which):
    want = jadd.load_object_models(model_dirs[which])
    got = tadd.load_object_models(model_dirs[which])
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    if which == "odd":
        assert got.num_valid[1] == 300 and got.num_valid[4] == 40 and not got.present[6]


def _poses(rng, B):
    gq = Rotation.random(B, random_state=int(rng.integers(1 << 30))).as_quat().astype(np.float32)
    noise = Rotation.from_rotvec(rng.normal(0, 0.15, (B, 3)))
    pq = (noise * Rotation.from_quat(gq)).as_quat().astype(np.float32)
    gt = (rng.normal(0, 0.05, (B, 3)) + [0, 0, 0.8]).astype(np.float32)
    pt = (gt + rng.normal(0, 0.01, (B, 3))).astype(np.float32)
    return pq, pt, gq, gt


def test_evaluator_matches_jax(model_dirs):
    rng = np.random.default_rng(0)
    pq, pt, gq, gt = _poses(rng, 8)
    ids = np.array([0, 9, 0, 9, 3, -1, 0, 9], np.int32)  # 3 absent, -1 padding
    want = jadd.ADDEvaluator(model_dirs["gen"]).eval_metrics(pq, pt, gq, gt, ids)
    got = tadd.ADDEvaluator(model_dirs["gen"], device="cpu").eval_metrics(pq, pt, gq, gt, ids)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-3), (k, got[k], want[k])


@pytest.mark.parametrize("which", ["gen", "odd"])
def test_add_loss_and_gradient_match_jax(model_dirs, which):
    """add_loss and d loss / d (pred rotation matrix, pred translation)
    against jax.grad of JAX's add_loss, over symmetric (ADD-S) and plain
    objects, padded meshes and invalid ids."""
    models = jadd.load_object_models(model_dirs[which])
    rng = np.random.default_rng(1)
    B = 6
    pq, pt, gq, gt = _poses(rng, B)
    ids = (np.array([0, 9, 0, 9, 3, 0], np.int32) if which == "gen"
           else np.array([1, 4, 10, 6, 1, 10], np.int32))  # 10 symmetric, 6 absent
    prm = Rotation.from_quat(pq).as_matrix().astype(np.float32)
    grm = Rotation.from_quat(gq).as_matrix().astype(np.float32)
    jm = {f: jnp.asarray(getattr(models, f)) for f in FIELDS}

    def jloss(rot, trans):
        return jadd.add_loss(jm["points"], jm["symmetric"], jm["present"], rot, trans,
                             jnp.asarray(grm), jnp.asarray(gt), jnp.asarray(ids),
                             num_valid=jm["num_valid"])

    want, (want_gr, want_gt) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(prm), jnp.asarray(pt))
    tm = tadd.load_object_models(model_dirs[which])
    rot = torch.from_numpy(prm).requires_grad_(True)
    trans = torch.from_numpy(pt).requires_grad_(True)
    got = tadd.add_loss(tm.points, tm.symmetric, tm.present, rot, trans, torch.from_numpy(grm),
                        torch.from_numpy(gt), torch.from_numpy(ids), num_valid=tm.num_valid)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-4 * abs(float(want))
    for g, w in ((rot.grad, want_gr), (trans.grad, want_gt)):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) <= 1e-4 * np.linalg.norm(w)


def test_add_s_tie_rule():
    """Exact ties: a GT cloud whose points repeat (load_object_models pads
    so). JAX's min splits the gradient among tied GT points, the port gives
    it all to the lowest index: the prediction side's gradient and each
    tied group's GT-side sum are equal, and the port's share sits on the
    group's first point."""
    rng = np.random.default_rng(3)
    base = rng.normal(0, 0.05, (40, 3))
    dup = rng.choice(40, 24, replace=True)
    gt = np.concatenate([base, base[dup]])[None].astype(np.float32)  # [1, 64, 3]
    pred = (gt[:, rng.permutation(64)] + rng.normal(0, 0.01, (1, 64, 3))).astype(np.float32)
    w = np.linspace(0.5, 1.5, 64).astype(np.float32)

    def jfn(p, g):
        return jnp.sum(jadd.pairwise_min_dist(p, g) * w)

    jgp, jgg = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(pred), jnp.asarray(gt))
    p = torch.from_numpy(pred).requires_grad_(True)
    g = torch.from_numpy(gt).requires_grad_(True)
    (tadd._nearest_distance(p, g) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp), rtol=1e-4, atol=1e-6)
    group = np.array([j if j < 40 else dup[j - 40] for j in range(64)])  # first index of each
    got_sum = np.zeros((40, 3))
    want_sum = np.zeros((40, 3))
    np.add.at(got_sum, group, g.grad.numpy()[0])
    np.add.at(want_sum, group, np.asarray(jgg)[0])
    # within 1e-4 of the largest: a group's sum cancels contributions of
    # opposite signs
    np.testing.assert_allclose(got_sum, want_sum, rtol=0, atol=1e-4 * np.abs(want_sum).max())
    # the port's GT-side share sits on each group's first index (the
    # centring's share cancels: the distances depend on p - g only)
    assert np.abs(g.grad.numpy()[0, 40:]).max() <= 1e-6
