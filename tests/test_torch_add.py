"""pose6d_tpu_torch.losses.add (ADD / ADD-S / ADD-0.1d) and the nearest-point
wrapper of ops/addmin against pose6d_tpu.losses.add.

P = 500 points per object, 15 objects with the LineMOD symmetric ids and
one object padded by repetition (num_valid < P); per-point distances agree
within 1e-6 m and the batch means within 1e-3 mm."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.geometry.quat import quat_to_mat as jq2m
from pose6d_tpu.losses import add as jadd
from pose6d_tpu_torch.geometry.quat import quat_to_mat as tq2m
from pose6d_tpu_torch.losses import add as tadd
from pose6d_tpu_torch.ops import addmin

P, N_OBJ, B = 500, 15, 12


def _models(rng):
    pts = rng.normal(size=(N_OBJ, P, 3)) * rng.uniform(0.02, 0.06, (N_OBJ, 1, 3))
    num_valid = np.full(N_OBJ, P, np.int32)
    num_valid[4] = 320
    pts[4, 320:] = pts[4, rng.integers(0, 320, P - 320)]  # padded by repetition
    diam = rng.uniform(0.08, 0.2, N_OBJ).astype(np.float32)
    sym = np.zeros(N_OBJ, bool)
    sym[list(tadd.SYMMETRIC_OBJECT_IDS)] = True
    present = np.ones(N_OBJ, bool)
    present[14] = False
    return pts.astype(np.float32), diam, sym, present, num_valid


def _poses(rng, n, jitter=None, base=None):
    if base is None:
        q = rng.normal(size=(n, 4))
        t = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
                      rng.uniform(0.5, 1.0, n)], -1)
    else:
        q = base[0] + rng.normal(0, jitter, (n, 4))
        t = base[1] + rng.normal(0, jitter / 10, (n, 3))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return q.astype(np.float32), t.astype(np.float32)


def test_pairwise_min_dist_matches_jax(rng):
    a = (rng.normal(size=(4, P, 3)) * 0.05 + [0.1, -0.05, 0.8]).astype(np.float32)
    b = (rng.normal(size=(4, P, 3)) * 0.05 + [0.1, -0.05, 0.8]).astype(np.float32)
    got = tadd.pairwise_min_dist(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jadd.pairwise_min_dist(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    exact = np.sqrt(((a[:, :, None] - b[:, None]).astype(np.float64) ** 2).sum(-1)).min(-1)
    np.testing.assert_allclose(got, exact, atol=1e-6)


@pytest.mark.parametrize("jitter", [None, 0.02])  # random poses, and near-correct ones
def test_add_metrics_match_jax(rng, jitter):
    pts, diam, sym, present, nv = _models(rng)
    gt_q, gt_t = _poses(rng, B)
    pred_q, pred_t = _poses(rng, B, jitter, (gt_q, gt_t)) if jitter else _poses(rng, B)
    ids = rng.integers(0, N_OBJ - 1, B)  # 14 is the absent object, set below
    ids[:4] = [9, 10, 4, 14]  # both symmetric objects, a padded one, an absent one
    ids[4] = -1  # invalid id
    jargs = (jnp.asarray(pts), jnp.asarray(diam), jnp.asarray(sym), jnp.asarray(present),
             jq2m(jnp.asarray(pred_q)), jnp.asarray(pred_t), jq2m(jnp.asarray(gt_q)),
             jnp.asarray(gt_t), jnp.asarray(ids))
    targs = (torch.from_numpy(pts), torch.from_numpy(diam), torch.from_numpy(sym),
             torch.from_numpy(present), tq2m(torch.from_numpy(pred_q)), torch.from_numpy(pred_t),
             tq2m(torch.from_numpy(gt_q)), torch.from_numpy(gt_t), torch.from_numpy(ids))
    want_per = jadd.add_per_sample(*jargs, num_valid=jnp.asarray(nv))
    got_per = tadd.add_per_sample(*targs, num_valid=torch.from_numpy(nv))
    for k in ("add", "add_s", "effective"):
        np.testing.assert_allclose(got_per[k].numpy(), np.asarray(want_per[k]), atol=1e-6)
    for k in ("correct", "valid"):
        np.testing.assert_array_equal(got_per[k].numpy(), np.asarray(want_per[k]))
    want = jadd.add_metrics(*jargs, num_valid=jnp.asarray(nv))
    got = tadd.add_metrics(*targs, num_valid=torch.from_numpy(nv))
    for k in ("add_mean", "add_s_mean", "add_01d_acc"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), atol=1e-3)
    assert got["count"].item() == int(want["count"]) == B - 2


def test_object_models_to_device(rng):
    pts, diam, sym, present, nv = _models(rng)
    m = tadd.ObjectModels(*(torch.from_numpy(a) for a in (pts, diam, sym, present, nv)))
    assert m.to("cpu").points.shape == (N_OBJ, P, 3)


@pytest.mark.parametrize("bad", ["dtype", "shape", "mismatch"])
def test_addmin_wrapper_refuses_bad_inputs(bad):
    a = torch.zeros(2, P, 3)
    if bad == "dtype":
        args, err = (a.double(), a.double()), TypeError
    elif bad == "shape":
        args, err = (torch.zeros(2, P, 4), torch.zeros(2, P, 4)), ValueError
    else:
        args, err = (a, torch.zeros(2, P - 1, 3)), ValueError
    with pytest.raises(err):
        addmin.pairwise_min_dist_kernel(*args)
    with pytest.raises(ValueError):  # neither CPU nor CUDA
        addmin.pairwise_min_dist_kernel(a.to("meta"), a.to("meta"))
