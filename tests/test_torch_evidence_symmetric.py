"""The symmetric-object evidence (cli/parity_symmetric.py) against the JAX
package:

  - planted poses on an object flagged symmetric, each turned 180 degrees
    about the object's symmetry axis from its ground truth: ADD-S ~ 0 and
    the sample correct, where plain ADD is large; the port's per-object rows
    (parity_symmetric.accumulate / object_rows on the port's add_per_sample)
    equal JAX's add_per_sample on the same arrays, grouped as
    scripts/parity_symmetric.per_object_breakdown groups them, within 1e-6 m;
  - (slow) the whole per_object_breakdown against the JAX script's on a tiny
    symmetric fixture (objects 1, 10 and 11 at img 64) with the same
    converted weights, held to assert_eval_parity's tolerances.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pose6d_tpu_torch.cli import parity_symmetric
from pose6d_tpu_torch.ops.addmin import expansion_d2_atol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OBJ, P = 11, 500
SYM = (9, 10)  # losses/add.py SYMMETRIC_OBJECT_IDS


def _planted(seed: int = 0):
    """Object models (ids 0-10; 9 and 10 symmetric under a 180-degree turn
    about their z axis: each cloud is a point set and its turned copy) and
    16 samples: ids 9 and 10 predicted at their GT pose turned 180 degrees
    about z (the twin), id 0 and 3 at a GT pose perturbed by a few mm and
    degrees."""
    rng = np.random.default_rng(seed)
    turn = Rotation.from_euler("z", 180, degrees=True).as_matrix()
    points = np.zeros((N_OBJ, P, 3), np.float32)
    for i in range(N_OBJ):
        half = rng.uniform(-0.04, 0.04, (P // 2, 3))
        points[i] = np.concatenate([half, half @ turn.T]) if i in SYM else \
            rng.uniform(-0.04, 0.04, (P, 3))
    diam = np.full(N_OBJ, 0.14, np.float32)
    symmetric = np.isin(np.arange(N_OBJ), SYM)
    ids = np.array([9, 10, 0, 3] * 4, np.int32)
    gt_r = Rotation.random(len(ids), random_state=seed).as_matrix()
    gt_t = np.stack([rng.uniform(-0.1, 0.1, len(ids)), rng.uniform(-0.1, 0.1, len(ids)),
                     rng.uniform(0.6, 1.0, len(ids))], -1)
    small = Rotation.from_rotvec(rng.normal(0, 0.02, (len(ids), 3))).as_matrix()
    pred_r = np.where(np.isin(ids, SYM)[:, None, None], gt_r @ turn, gt_r @ small)
    pred_t = gt_t + np.where(np.isin(ids, SYM)[:, None], 0.0, rng.normal(0, 0.003, gt_t.shape))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"points": points, "diameters": diam, "symmetric": symmetric,
            "present": np.ones(N_OBJ, bool), "pred_r": f32(pred_r), "pred_t": f32(pred_t),
            "gt_r": f32(gt_r), "gt_t": f32(gt_t), "ids": ids}


def test_planted_twin_poses_per_object_rows_match_jax():
    import jax.numpy as jnp

    from pose6d_tpu.losses.add import add_per_sample as jadd_per_sample
    from pose6d_tpu_torch.losses.add import add_per_sample

    d = _planted()
    keys = ("points", "diameters", "symmetric", "present", "pred_r", "pred_t", "gt_r", "gt_t",
            "ids")
    got = add_per_sample(*(torch.from_numpy(d[k]) for k in keys))
    want = jadd_per_sample(*(jnp.asarray(d[k]) for k in keys))
    want = {k: np.asarray(v) for k, v in want.items()}

    acc = {}
    parity_symmetric.accumulate(acc, got, d["ids"])
    rows = parity_symmetric.object_rows(acc, np.nonzero(d["symmetric"])[0])
    # JAX's grouping (scripts/parity_symmetric.per_object_breakdown) on JAX's arrays
    for oid in np.unique(d["ids"]):
        sel = d["ids"] == oid
        r = rows[int(oid)]
        assert r["symmetric"] == (oid in SYM)
        assert abs(r["add_mm"] - 1000 * float(np.mean(want["add"][sel]))) <= 1e-3
        assert abs(r["add_s_mm"] - 1000 * float(np.mean(want["add_s"][sel]))) <= 1e-3
        assert r["add01d_pct"] == 100 * float(np.mean(want["correct"][sel]))

    # the twin: ADD-S ~ 0 (within the expansion form's envelope in d^2,
    # ~1e-4 m on these clouds), correct; plain ADD far above 0.1 d
    atol = float(np.sqrt(expansion_d2_atol(torch.from_numpy(d["points"]),
                                           torch.from_numpy(d["points"]))))
    for oid in SYM:
        r = rows[oid]
        assert r["add_s_mm"] <= 1000 * atol and r["add01d_pct"] == 100.0, r
        assert r["add_mm"] > 1000 * 0.1 * 0.14, r
    for oid in (0, 3):
        assert rows[oid]["add_s_mm"] <= rows[oid]["add_mm"] + 1e-3


# ------------------------------------------------------------------ slow

@pytest.mark.slow
def test_per_object_breakdown_matches_jax(tmp_path, monkeypatch):
    """The whole breakdown of both packages on one tiny symmetric fixture
    (objects 1, 10, 11 x 40 frames at img 64, batch 4: 3 val batches) with
    the same weights: the JAX script's snapshot_restore stubbed to return
    the flax state, the port reading the converted weights (restore
    stubbed). The per-object ADD / ADD-S means within 1e-2 mm and the 0.1d
    accuracies equal (assert_eval_parity's tolerances)."""
    import importlib.util

    import jax

    from pose6d_tpu.configs.presets import get_preset as jget_preset
    from pose6d_tpu.ops.augment import AugmentConfig as JAugmentConfig
    from pose6d_tpu.train.loop import create_train_state
    from pose6d_tpu_torch.convert import posenet_from_jax
    from pose6d_tpu_torch.data.synthetic import generate_synthetic_linemod

    sym = tmp_path / "sym"
    generate_synthetic_linemod(str(sym / "synth"), obj_ids=(1, 10, 11), frames_per_obj=40,
                               seed=0, max_angle_deg=75.0)
    cfg = jget_preset("rgbd_geometric", rot_head_wide=True, img_size=64,
                      augment=JAugmentConfig(grayscale_p=0.0))
    _, _, state = create_train_state(cfg, jax.random.key(3))
    variables = {"params": state.params, "batch_stats": state.batch_stats}

    monkeypatch.setitem(sys.modules, "probe_components", types.SimpleNamespace(
        snapshot_restore=lambda path, st, name: {"state": state}))
    spec = importlib.util.spec_from_file_location(
        "jax_parity_symmetric", os.path.join(REPO, "scripts", "parity_symmetric.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    monkeypatch.setattr("pose6d_tpu.configs.presets.get_preset",
                        lambda v, **kw: jget_preset(v, **{**kw, "img_size": 64}))
    want = jmod.per_object_breakdown(str(sym), batch_size=4)

    sd = posenet_from_jax(jax.tree.map(np.asarray, variables))
    monkeypatch.setattr(parity_symmetric, "restore",
                        lambda model, save_dir, ckpt: model.load_state_dict(sd, strict=True))
    got = parity_symmetric.per_object_breakdown(str(sym), batch_size=4, img_size=64,
                                                num_workers=0, device="cpu")
    assert sorted(got) == sorted(want) == [0, 9, 10]
    for oid, w in want.items():
        g = got[oid]
        assert g["symmetric"] == w["symmetric"] == (oid in SYM)
        assert abs(g["add_mm"] - w["add_mm"]) <= 1e-2 and abs(g["add_s_mm"] - w["add_s_mm"]) <= 1e-2
        assert g["add01d_pct"] == w["add01d_pct"]
