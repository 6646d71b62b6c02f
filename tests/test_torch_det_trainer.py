"""The port's detector training (pose6d_tpu_torch/models/yolo/train.py) on
the CPU against the JAX package's (pose6d_tpu/models/yolo/train.py):

  - one guarded train step of YOLOv8n widths at img 64, batch 4, nc 2
    against make_det_train_step run in float64 (jax.enable_x64), from the
    same variables, moments and count, on JAX's augmentation draws: the
    losses within 1e-9 relative and num_fg equal for the port in float64
    (5e-5 in f32); Adam's moments, the parameter update and the BatchNorm
    statistics per leaf within torch_port_utils.LEAF_BOUNDS of the port's
    dtype. A poisoned batch (one inf pixel): parameters and BatchNorm
    statistics bitwise unchanged on both sides, the moments equal to
    optax's;
  - the flax init rules of the detector;
  - evaluate_map50 exactly equal to JAX's;
  - DetectionTrainer.fit for 2 epochs at img 64: a run resumed after epoch
    1 ends in the state of an uninterrupted one, bit for bit, and `best`
    is written only when mAP@50 rises; the trained EMA detector loads into
    PosePipeline;
  - convert.det_trainer_state_from_jax resumes a JAX trainer's state."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pose6d_tpu.data.synthetic import generate_synthetic_linemod
from pose6d_tpu.models.yolo import train as jtrain
from pose6d_tpu.models.yolo.model import YoloConfig as JYoloConfig, YoloV8 as JYoloV8
from pose6d_tpu_torch.convert import _flax_to_state_dict, det_trainer_state_from_jax, yolo_from_jax
from pose6d_tpu_torch.models.yolo import train as ttrain
from pose6d_tpu_torch.models.yolo.model import YoloConfig, YoloV8, flax_init_
from torch_port_utils import (LEAF_BOUNDS, few_torch_threads, jax_draws,  # noqa: F401
                              random_flax_variables)

S, B, NC, M = 64, 4, 2, 8
WARMUP, TOTAL, COUNT = 7, 8, 3  # a 2-epoch run of 4 steps, 3 steps in


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("det_train_tree")
    return generate_synthetic_linemod(str(root), obj_ids=(1, 2), frames_per_obj=20,
                                      img_w=200, img_h=150, seed=11)


def _batch(seed: int, poison: bool = False, dtype=np.float32) -> dict:
    """[0, 1] images of 8-bit values in `dtype` (float, so that the JAX step
    computes its HSV in float64 too, and one compile serves both calls),
    1-3 boxes per image."""
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 256, (B, S, S, 3)).astype(np.float32) / np.float32(255.0))
    boxes = np.zeros((B, M, 4), np.float32)
    mask = np.zeros((B, M), bool)
    for b in range(B):
        for m in range(1 + b % 3):
            x1, y1 = rng.uniform(0, 34, 2)
            w, h = rng.uniform(12, 28, 2)
            boxes[b, m] = (x1, y1, x1 + w, y1 + h)
            mask[b, m] = True
            img[b, int(y1):int(y1 + h), int(x1):int(x1 + w)] = rng.uniform(0.5, 1.0, 3)
    if poison:
        img[1, 10, 20, 1] = np.inf
    return {"image": img.astype(dtype), "gt_boxes": boxes, "gt_labels": rng.integers(0, NC, (B, M)).astype(np.int32),
            "gt_mask": mask}


def _f64_state(tree) -> dict:
    """A flax tree in the port's state_dict layout, in float64."""
    return _flax_to_state_dict(jax.tree.map(np.asarray, tree), dtype=np.float64)


def _jax_tx():
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, WARMUP, TOTAL, 1e-5)
    return optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(sched, weight_decay=5e-4))


@pytest.fixture(scope="module")
def step_runs():
    """JAX's float64 step on a clean and a poisoned batch, from seeded
    variables, moments and count; returns the inputs and JAX's outputs
    in the port's state_dict layout."""
    variables = random_flax_variables(JYoloV8(JYoloConfig(num_classes=NC)),
                                      jnp.zeros((1, S, S, 3)), seed=0, trainable=True)
    # box-branch biases that put the DFL mass on the first bins (boxes of a
    # few strides, so that anchors overlap the gts and many are foreground)
    # and negative class biases, as a trained detector's
    head = variables["params"]["head"]
    for i in range(3):
        head[f"box{i}_out"]["bias"] = np.tile(-0.5 * np.arange(16), 4).astype(np.float32)
        head[f"cls{i}_out"]["bias"] = np.full(NC, -3.0, np.float32)
    rng = np.random.default_rng(1)
    mu = jax.tree.map(lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32),
                      variables["params"])
    nu = jax.tree.map(lambda a: rng.uniform(1e-8, 1e-6, a.shape).astype(np.float32),
                      variables["params"])
    cfg = jtrain.DetTrainConfig(img_size=S, batch_size=B)
    key = jax.random.key(3)
    out = {"variables": variables, "mu": mu, "nu": nu}
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        ycfg = JYoloConfig(num_classes=NC, dtype=jnp.float64)
        tx = _jax_tx()
        step = jtrain.make_det_train_step(JYoloV8(ycfg), tx, cfg, ycfg)
        out["draws"] = jax_draws(key, B, cfg)
        for name, poison in (("clean", False), ("poisoned", True)):
            params = f64(variables["params"])
            state = tx.init(params)
            adam = state[1][0]._replace(count=jnp.int32(COUNT), mu=f64(mu), nu=f64(nu))
            state = (state[0], (adam, state[1][1], state[1][2]._replace(count=jnp.int32(COUNT))))
            batch = {k: jnp.asarray(v) for k, v in _batch(5, poison, jnp.float64).items()}
            p, bs, st, losses = step(params, f64(variables["batch_stats"]), state, batch, key)
            out[name] = {
                "losses": {k: float(v) for k, v in losses.items()},
                "state": _f64_state({"params": p, "batch_stats": bs}),
                "mu": _f64_state({"params": st[1][0].mu}),
                "nu": _f64_state({"params": st[1][0].nu}),
            }
    return out


def _port_step(runs, dtype, poison: bool):
    cfg = ttrain.DetTrainConfig(img_size=S, batch_size=B)
    ycfg = YoloConfig(num_classes=NC, dtype=dtype)
    model = YoloV8(ycfg)
    model.load_state_dict(yolo_from_jax(runs["variables"]), strict=True)
    model = model.to(dtype)
    tx = ttrain.DetOptimizer(model.parameters(), cfg, WARMUP, TOTAL)
    names = [n for n, _ in model.named_parameters()]
    mu, nu = (_flax_to_state_dict({"params": runs[k]}) for k in ("mu", "nu"))
    tx.load_state_dict({"mu": [mu[n] for n in names], "nu": [nu[n] for n in names],
                        "count": COUNT})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(5, poison, np.float64 if dtype == torch.float64 else np.float32).items()}
    draws = {k: v.to(dtype) if v.is_floating_point() else v for k, v in runs["draws"].items()}
    with torch.backends.mkldnn.flags(enabled=False):
        losses = ttrain.make_det_train_step(cfg, ycfg, "cpu")(model, tx, batch, draws)
    return model, tx, before, losses, names


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_train_step_matches_jax_float64(step_runs, dtype):
    want = step_runs["clean"]
    model, tx, before, losses, names = _port_step(step_runs, dtype, False)
    # f32: train-mode BatchNorm over 4 images carries the f32 rounding of a
    # YOLOv8n into the losses at up to 8.8e-6 relative (the cls loss)
    loss_tol = 1e-9 if dtype == torch.float64 else 5e-5
    assert int(losses["num_fg"]) == int(want["losses"]["num_fg"]) > 0
    for k in ("total", "box", "cls", "dfl"):
        w = want["losses"][k]
        assert abs(float(losses[k]) - w) <= loss_tol * abs(w), (k, float(losses[k]), w)
    assert tx.count == COUNT + 1
    rel_bound, _ = LEAF_BOUNDS[str(dtype).removeprefix("torch.")]
    after = model.state_dict()

    def check(got, ref, what):
        err, scale = float((got.double() - ref).norm()), float(ref.norm())
        assert err <= rel_bound * scale, f"{what}: rel L2 err {err / scale:.3g}"

    v0 = _f64_state(step_runs["variables"])
    for i, n in enumerate(names):
        check(tx.mu[i], want["mu"][n], f"mu {n}")
        check(tx.nu[i], want["nu"][n], f"nu {n}")
        check(after[n].double() - v0[n], want["state"][n] - v0[n], f"update {n}")
    stats = [k for k in after if "running_" in k]
    assert len(stats) == 2 * sum(1 for k in after if k.endswith("running_mean"))
    for k in stats:
        check(after[k], want["state"][k], k)
        assert not torch.equal(after[k], before[k]), k


def test_poisoned_step_leaves_params_and_stats(step_runs):
    """One inf pixel: the step is skipped as JAX skips it. Parameters and
    BatchNorm statistics bitwise as they were (JAX's too), Adam's moments
    advanced as zero gradients advance them, equal to optax's."""
    want = step_runs["poisoned"]
    model, tx, before, losses, names = _port_step(step_runs, torch.float64, True)
    assert not np.isfinite(float(losses["total"]))
    assert not np.isfinite(want["losses"]["total"])
    after = model.state_dict()
    v0 = _f64_state(step_runs["variables"])
    for k in after:
        assert torch.equal(after[k], before[k]), k
        if "num_batches" not in k:
            assert torch.equal(want["state"][k], v0[k]), f"JAX moved {k}"
    for i, n in enumerate(names):
        assert torch.equal(tx.mu[i], want["mu"][n]), n
        assert torch.equal(tx.nu[i], want["nu"][n]), n
    assert tx.count == COUNT + 1


def test_flax_init_rules_match_jax():
    """flax_init_ against YoloV8.init: the same tree; BatchNorm and biases
    equal (the cls{i}_out prior included); conv kernels truncated normals
    of std sqrt(1 / fan_in) (lecun_normal) on both sides."""
    jvars = jax.jit(JYoloV8(JYoloConfig(num_classes=NC)).init)(jax.random.key(0),
                                                                jnp.zeros((1, S, S, 3)))
    want = yolo_from_jax(jax.tree.map(np.asarray, jvars))
    got = flax_init_(YoloV8(YoloConfig(num_classes=NC)), 0).state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if g.ndim == 4:
            std = float(np.sqrt(1.0 / w[0].numel()))
            for t in (g, w):
                assert abs(float(t.std()) / std - 1.0) < 0.1 or t.numel() < 2000, k
                assert float(t.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6, k
        else:
            assert torch.equal(g, w), k
    assert float(got["head.cls0_out.bias"][0]) == pytest.approx(np.log(5.0 / NC / 80.0**2))


def test_evaluate_map50_equals_jax():
    rng = np.random.default_rng(0)
    preds, gts = [], []
    for _ in range(12):
        d, m = 10, 3
        gb = np.concatenate([rng.uniform(0, 40, (m, 2)), rng.uniform(45, 90, (m, 2))], 1)
        pb = gb[rng.integers(0, m, d)] + rng.normal(0, 6, (d, 4))
        scores = rng.choice([0.9, 0.5, 0.3, 0.1], d)  # ties in the score order
        preds.append({"boxes": pb, "scores": scores, "classes": rng.integers(0, 3, d),
                      "valid": rng.random(d) < 0.8})
        gts.append({"boxes": gb, "labels": rng.integers(0, 3, m), "mask": rng.random(m) < 0.9})
    for thresh in (0.5, 0.3):
        assert (ttrain.evaluate_map50(preds, gts, 4, thresh)
                == jtrain.evaluate_map50(preds, gts, 4, thresh))
    assert ttrain.evaluate_map50(preds, gts, 4) > 0


def _fit(data, save_dir, epochs, maps):
    cfg = ttrain.DetTrainConfig(img_size=S, batch_size=8, epochs=2, seed=0)
    tr = ttrain.DetectionTrainer(data, save_dir, cfg, device="cpu")
    seq = iter(maps)
    tr.validate_map50 = lambda rng: next(seq)
    tr.fit(epochs=epochs)
    tr.close()
    return tr


def test_fit_resume_is_exact_and_best_is_gated(synth, tmp_path):
    data = synth["data"]
    full = _fit(data, str(tmp_path / "full"), 2, [0.5, 0.3])
    part = str(tmp_path / "part")
    first = _fit(data, part, 1, [0.5])
    assert first.global_step == 4 and first.completed_epochs == 1 and first.best_map == 0.5
    with open(os.path.join(part, "best.pt"), "rb") as f:
        best_bytes = f.read()
    resumed = _fit(data, part, 2, [0.3])
    assert resumed.global_step == full.global_step == 8
    a, b = full._ckpt_tree(), resumed._ckpt_tree()
    for part_name in ("params", "batch_stats", "ema_params"):
        for k in a[part_name]:
            assert torch.equal(a[part_name][k], b[part_name][k]), (part_name, k)
    for k in ("mu", "nu"):
        for n in a["opt_state"][k]:
            assert torch.equal(a["opt_state"][k][n], b["opt_state"][k][n]), (k, n)
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 8
    assert a["meta"] == b["meta"] == {"global_step": 8, "epoch": 2, "best_map": 0.5}
    # `best` only when mAP rose: epoch 1's, untouched by epoch 2
    with open(os.path.join(part, "best.pt"), "rb") as f:
        assert f.read() == best_bytes
    best = torch.load(os.path.join(part, "best.pt"), weights_only=True)
    assert best["meta"]["epoch"] == 1 and best["meta"]["best_map"] == 0.5
    rows = open(os.path.join(part, "metrics.csv")).read().splitlines()
    assert rows[0] == ttrain.LOG_HEADER.strip() and len(rows) == 3
    assert rows[1].split(",")[:5] == open(os.path.join(tmp_path / "full", "metrics.csv")
                                          ).read().splitlines()[1].split(",")[:5]
    assert float(rows[2].split(",")[4]) == pytest.approx(resumed.tx.lr(8))

    # the trained detector serves: EMA parameters with the live statistics
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.models.posenet import PoseNetConfig
    from torch_port_utils import pipeline_weights

    sd = ttrain.load_yolo_variables(part, resumed.ycfg)
    assert torch.equal(sd["head.cls0_out.bias"], best["ema_params"]["head.cls0_out.bias"])
    assert torch.equal(ttrain.load_yolo_variables(part, resumed.ycfg, prefer="last")[
        "backbone.stem.bn.running_mean"], b["batch_stats"]["backbone.stem.bn.running_mean"])
    pose_state = pipeline_weights("rgb")[3]
    pipe = PosePipeline(PipelineConfig(variant="rgb", img_size=S, conf_thresh=0.0,
                                       compute_dtype=torch.float32), resumed.ycfg, sd, pose_state,
                        PoseNetConfig(variant="rgb", img_size=S), device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (2, 128, 160, 3), dtype=np.uint8)
    K = np.array([[150.0, 0, 80], [0, 150.0, 64], [0, 0, 1]], np.float32)
    out = pipe(frames, K)
    assert np.isfinite(out["rotation"].numpy()).all() and out["rotation"].shape[0] == 2


def test_state_from_jax_resumes_in_the_port(synth, tmp_path):
    """A JAX DetectionTrainer's state (moments, count, EMA, meta made
    non-trivial), saved by orbax and restored without its structure, and
    also taken as namedtuples: the port's trainer resumes it exactly and
    trains on from it."""
    import orbax.checkpoint as ocp

    data = synth["data"]
    jcfg = jtrain.DetTrainConfig(img_size=S, batch_size=8, epochs=2, seed=0)
    jt = jtrain.DetectionTrainer(data, str(tmp_path / "jax"), jcfg)
    rng = np.random.default_rng(2)
    noisy = lambda t, s: jax.tree.map(lambda a: jnp.asarray(  # noqa: E731
        rng.normal(0, s, a.shape), jnp.float32), t)
    adam = jt.opt_state[1][0]._replace(count=jnp.int32(4), mu=noisy(jt.params, 1e-3),
                                       nu=jax.tree.map(jnp.abs, noisy(jt.params, 1e-6)))
    jt.opt_state = (jt.opt_state[0], (adam, jt.opt_state[1][1],
                                      jt.opt_state[1][2]._replace(count=jnp.int32(4))))
    jt.ema_params = noisy(jt.params, 0.05)
    jt.global_step, jt.completed_epochs, jt.best_map = jnp.int32(4), 1, 0.25
    jt.save_checkpoint("last")
    restored = ocp.StandardCheckpointer().restore(str(tmp_path / "jax" / "last"))
    trees = {"orbax": jax.tree.map(np.asarray, restored),
             "namedtuple": jax.tree.map(np.asarray, jt._ckpt_tree())}
    cfg = ttrain.DetTrainConfig(img_size=S, batch_size=8, epochs=2, seed=0)
    for name, tree in trees.items():
        payload = det_trainer_state_from_jax(tree)
        save = tmp_path / f"port_{name}"
        os.makedirs(save)
        torch.save(payload, save / "last.pt")
        tr = ttrain.DetectionTrainer(data, str(save), cfg, device="cpu")
        assert tr.try_resume(), name
        want = yolo_from_jax({"params": tree["params"], "batch_stats": tree["batch_stats"]})
        for k, v in tr.model.state_dict().items():
            assert torch.equal(v, want[k]), (name, k)
        ema = _flax_to_state_dict({"params": tree["ema_params"]})
        mu = _flax_to_state_dict({"params": jax.tree.map(np.asarray, adam.mu)})
        for i, (n, p) in enumerate(tr.ema_model.named_parameters()):
            assert torch.equal(p, ema[n]) and torch.equal(tr.tx.mu[i], mu[n]), (name, n)
        assert (tr.tx.count, tr.global_step, tr.completed_epochs, tr.best_map) == (4, 4, 1, 0.25)
        tr.validate_map50 = lambda rng: 0.1
        tr.fit()
        tr.close()
        assert tr.global_step == 8 and tr.tx.count == 8 and tr.best_map == 0.25
