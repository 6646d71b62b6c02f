"""Several epochs of the port's Trainer.fit (pose6d_tpu_torch/train/
trainer.py) against the JAX package's Trainer.fit
(pose6d_tpu/train/trainer.py), side by side on one LineMOD tree from the
JAX generator (objects 1 and 10, 10 frames each: 16 train frames, two
steps of 8 an epoch, 2 val), in float64 on both sides: the configuration
of the reference-head rgbd_geometric parity run
(get_preset("rgbd_geometric"), rot_head_wide off) at img 64 and batch 8,
from the same starting weights (random_flax_variables, carried across by
convert.posenet_from_jax).

What differs by design is taken out in both tests:
  - the augmentation: the config's AugmentConfig has every strength at 0,
    and train_augment is the eval path's normalization on both sides,
    computed by the port's eval_preprocess for both (JAX's jitted step
    calls it on the host through jax.pure_callback). At strength 0 the
    colour jitter still rounds each crop through HSV in f32, differently
    in each package; and XLA's jitted step fuses the normalization's /255,
    -mean and /std and rounds up to 4.8e-7 away from an eager evaluation
    (torch's or JAX's own). Training turns such rounding into visible
    differences: on the first step's batch one of layer3_3.bn1's outputs
    sits 7.6e-8 from the ReLU's kink, and the jitted rounding flipped its
    mask, moving the gradient leaves below it by 2.3e-3; over three steps
    on the one-object batch it grew 1.2e-6 step differences into 5.5 % of
    the AdamW moments. With the same crops every number below agrees
    within ~1e-5 or far better;
  - the box jitter is drawn by numpy in both;
  - dropout is identity in both (flax's nn.Dropout through an interceptor,
    the port's Dropout at rate 0);
  - precision: the JAX train step casts the predictions to f32 before the
    loss; here jax.numpy's float32 reads as float64 inside
    pose6d_tpu/train/loop.py alone (_Float64Numpy), so its loss, its host
    batch's depth and its eval step run in float64, as the port's float64
    Trainer does. Nothing in the JAX package's files changes.

test_first_step_on_the_fixture: the first train step on the first batch,
at the one-step tests' tolerances (assert_train_step_parity); read 1.5e-8
at worst per gradient leaf.

test_fit_epochs_match_jax: fit(epochs=2), then a second Trainer of each
package resumes from the first one's checkpoints and runs fit(epochs=3).
The val ADD-0.1d stays at 100 % (a 1 km diameter) and plateau_patience is
0, so the plateau scheduler halves the rate after epoch 1 (before the
checkpoint the resume reads) and again after epoch 2: the resumed Trainer
must restore the halved rate into AdamW, and its epoch trains at it.
(With patience 1 the first halving comes after epoch 2, torch's rule being
num_bad_epochs > patience: after the last of three epochs, where no step
would take it.) So the epochs' shuffles (JAX restarts its generator at
the resume; so does the port), the plateau rate reaching AdamW, AdamW's
moments and step counter (its bias correction) and the BatchNorm
statistics carried from epoch to epoch and across the resume are all on
the path. Compared after each epoch: every metrics.csv column but the two
timing columns, and the scheduler's state; after the last epoch: every
parameter's change over the run, BatchNorm statistic and AdamW moment,
and the step counters; each step's loss. The tolerances are the float64
one-step tests' (torch_port_utils.assert_train_step_parity), not
loosened: a loss within 1e-5 max(1, |loss|), each parameter's change and
each AdamW moment within 1e-3 relative L2, each BatchNorm statistic
within 1e-4 of its largest magnitude; a leaf whose reference never moves
(a dense bias ahead of train-mode BatchNorm: its gradient is rounding)
within 1e-6 of the largest change, its moments of rounding skipped;
validation at the eval parity tolerances (assert_eval_parity: ADD means
within 1e-2 mm, the accuracies equal); the rate and the scheduler's
state equal. Read on the CPU: the step losses 6.5e-9 apart at most, a
parameter's change 3.0e-6, a BN statistic 2.4e-8, the moments 1.3e-7
(mu) and 1.0e-7 (nu).

The float64 JAX train steps' compiles and the JAX Trainer's init make
these tests slow (~2.2 min together on the CPU); they are marked so, as
the JAX package's heavy tests are.
"""

import csv
import os
import shutil

import numpy as np
import pytest
import torch

from torch_port_utils import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.slow

S, B = 64, 8
EPOCHS, RESUME_AT = 3, 2
LRS = [1e-4, 5e-5, 2.5e-5]  # the plateau's halvings after epochs 1 and 2
TIMING = ("steps_per_sec", "imgs_per_sec")
LOSS_RTOL = 1e-5     # the one-step tests' loss tolerance
LEAF_RTOL = 1e-3     # the one-step tests' gradient leaf tolerance (float64)
ZERO_ATOL = 1e-6     # of the run's largest change, for a leaf that should not move
BN_RTOL = 1e-4       # the one-step tests' BN statistics tolerance
ADD_ATOL_MM = 1e-2   # assert_eval_parity's


def _zero_augment():
    from pose6d_tpu_torch.ops.augment import AugmentConfig

    return AugmentConfig(brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0,
                         grayscale_p=0.0, erase_p=0.0)


def _host_crops(rgb):
    """The port's eval_preprocess of a uint8 batch, for JAX's jitted step
    (through jax.pure_callback): both packages then train on the same
    crops."""
    from pose6d_tpu_torch.ops.augment import eval_preprocess

    return eval_preprocess(torch.from_numpy(np.asarray(rgb))).numpy()


def _jax_crops(key, rgb, cfg):
    import jax
    import jax.numpy as jnp

    return jax.pure_callback(_host_crops, jax.ShapeDtypeStruct(rgb.shape, jnp.float32), rgb)


def _tree(root, obj_ids):
    """10 frames of each object (8 train, 1 val), every pose within 0.1 of
    a 1 km diameter: val ADD-0.1d stays at 100 %, so the plateau scheduler
    sees no improvement after epoch 0."""
    from pose6d_tpu.data.synthetic import generate_synthetic_linemod

    paths = generate_synthetic_linemod(str(root), obj_ids=obj_ids, frames_per_obj=10,
                                       img_w=320, img_h=240, seed=11)
    with open(os.path.join(paths["models"], "models_info.yml"), "w") as f:
        f.writelines(f"{o}: {{diameter: 1000000.0}}\n" for o in obj_ids)
    return paths


def _record(trainer, states, losses):
    """Append the scheduler's state after each of trainer's epochs, and each
    train step's loss."""
    sched, step = trainer.scheduler.step, trainer.train_step

    def scheduled(metric):
        lr = sched(metric)
        states.append(dict(trainer.scheduler.state_dict()))
        return lr

    def stepped(state, batch, key):
        state, metrics = step(state, batch, key)
        losses.append(float(np.asarray(metrics["loss"])))
        return state, metrics

    trainer.scheduler.step = scheduled
    trainer.train_step = stepped


def _rows(save_dir):
    with open(os.path.join(save_dir, "metrics.csv"), newline="") as f:
        return list(csv.DictReader(f))


class _Float64Numpy:
    """jax.numpy with float32 read as float64, for pose6d_tpu/train/loop.py
    alone: its train step then computes the pose loss in float64 (it casts
    the predictions to float32 first), its eval step keeps the float64
    model, and the host batch's depth is float64."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(self._jnp, name)


def _run_jax(paths, save, variables):
    """fit(epochs=RESUME_AT), then a resumed Trainer's fit(epochs=EPOCHS),
    in float64 with dropout intercepted and the eval path's normalization
    for augmentation. Returns (the scheduler states, the step losses, the
    final TrainState as numpy)."""
    import dataclasses
    from unittest import mock

    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from pose6d_tpu.configs.presets import get_preset as jget_preset
    from pose6d_tpu.ops.augment import AugmentConfig as JAugmentConfig
    from pose6d_tpu.train import loop as jloop
    from pose6d_tpu.train.trainer import Trainer as JTrainer
    from torch_port_utils import no_dropout_interceptor

    aug = JAugmentConfig(**dataclasses.asdict(_zero_augment()))
    cfg = jget_preset("rgbd_geometric", img_size=S, batch_size=B, epochs=EPOCHS,
                      plateau_patience=0, augment=aug, compute_dtype="float64")
    f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731

    def float64_state(tr):
        params = f64(variables["params"])
        return jloop.TrainState(params=params, batch_stats=f64(variables["batch_stats"]),
                                opt_state=tr.tx.init(params), step=jnp.zeros((), jnp.int32))

    states, losses = [], []
    with jax.enable_x64(True), nn.intercept_methods(no_dropout_interceptor), \
            mock.patch.object(jloop, "jnp", _Float64Numpy(jnp)), \
            mock.patch.object(jloop, "train_augment", _jax_crops):
        tr = JTrainer(cfg, paths["data"], paths["models"], save, num_workers=0)
        tr.state = float64_state(tr)
        compiled = tr.train_step, tr.eval_step
        _record(tr, states, losses)
        tr.fit(epochs=RESUME_AT)
        tr2 = JTrainer(cfg, paths["data"], paths["models"], save, num_workers=0)
        # the float64 template that orbax restores into (it casts to the
        # template's dtypes), and the first Trainer's compiled steps (the
        # same model, optimizer and config)
        tr2.state = float64_state(tr2)
        tr2.tx, (tr2.train_step, tr2.eval_step) = tr.tx, compiled
        _record(tr2, states, losses)
        tr2.fit(epochs=EPOCHS)
        final = jax.tree.map(np.asarray, tr2.state)
    return states, losses, final


def _run_port(paths, save, variables):
    from unittest import mock

    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.convert import posenet_from_jax
    from pose6d_tpu_torch.ops.augment import eval_preprocess
    from pose6d_tpu_torch.train import loop as tloop
    from pose6d_tpu_torch.train.trainer import Trainer
    from torch_port_utils import disable_dropout

    cfg = get_preset("rgbd_geometric", img_size=S, batch_size=B, epochs=EPOCHS,
                     plateau_patience=0, augment=_zero_augment())
    states, losses = [], []
    with mock.patch.object(tloop, "train_augment", lambda g, rgb, c: eval_preprocess(rgb)):
        tr = Trainer(cfg, paths["data"], paths["models"], save, num_workers=0, device="cpu")
        tr.state.model.load_state_dict(posenet_from_jax(variables), strict=True)
        disable_dropout(tr.state.model).to(torch.float64)
        _record(tr, states, losses)
        tr.fit(epochs=RESUME_AT)
        tr2 = Trainer(cfg, paths["data"], paths["models"], save, num_workers=0, device="cpu")
        # float64 before the resume: load_state_dict copies into the
        # parameters' dtype
        disable_dropout(tr2.state.model).to(torch.float64)
        _record(tr2, states, losses)
        tr2.fit(epochs=EPOCHS)
    tr.close()
    tr2.close()
    return states, losses, tr2.state


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside inject_hyperparams(chain(clip,
    adamw)), and the injected learning rate."""
    found = []

    def walk(node):
        if all(hasattr(node, a) for a in ("count", "mu", "nu")):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for n in node:
                walk(n)

    walk(opt_state.inner_state)
    assert len(found) == 1, found
    return found[0], float(opt_state.hyperparams["learning_rate"])


def _state_f64(tree) -> dict:
    """A flax tree in the port's state_dict layout, float64 (posenet_from_jax
    rounds to f32)."""
    from pose6d_tpu_torch.convert import _flax_to_state_dict

    return _flax_to_state_dict(tree, dtype=np.float64)


def _rel(got, want):
    return float((got - want).norm()) / float(want.norm())


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The tree and the starting weights; the tree is removed at the end."""
    import jax.numpy as jnp

    from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
    from pose6d_tpu.train import loop as jloop
    from torch_port_utils import random_flax_variables

    root = tmp_path_factory.mktemp("fit_epochs")
    dummy = {"rgb": jnp.zeros((1, S, S, 3)), "depth": jnp.zeros((1, S, S, 1)),
             "depth_raw": jnp.zeros((1, S, S)), "center_orig": jnp.zeros((1, 2)),
             "center_crop": jnp.zeros((1, 2)), "cam_K": jnp.eye(3)[None],
             "cam_K_crop": jnp.eye(3)[None]}
    variables = random_flax_variables(
        JPoseNet(JPoseNetConfig(variant="rgbd_geometric", img_size=S)),
        **jloop.model_inputs("rgbd_geometric", dummy, dummy["rgb"]), seed=0, trainable=True)
    yield _tree(root / "tree", (1, 10)), variables
    shutil.rmtree(root, ignore_errors=True)


def test_first_step_on_the_fixture(fixture):
    """The first train step on the tree's first batch, the JAX step float64
    throughout against the port's float64 step, at the one-step tests'
    tolerances (assert_train_step_parity), both on the port's crops."""
    from unittest import mock

    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
    from pose6d_tpu.train import loop as jloop
    from pose6d_tpu_torch.convert import posenet_from_jax
    from pose6d_tpu_torch.data.pipeline import LineMODPoseLoader
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig
    from pose6d_tpu_torch.ops.augment import eval_preprocess
    from pose6d_tpu_torch.train import loop as tloop
    from torch_port_utils import (assert_train_step_parity, disable_dropout, grad_capture_tx,
                                  no_dropout_interceptor)

    paths, variables = fixture
    loader = LineMODPoseLoader(paths["data"], mode="train", flavor="rgbd", img_size=S,
                               num_workers=0, compact_arrays=True)
    batch = {k: np.asarray(v) for k, v in
             next(iter(loader.batches(B, np.random.default_rng(0), shuffle=True))).items()}
    loader.close()
    crops = eval_preprocess(torch.from_numpy(batch["rgb"])).numpy()
    f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
    with jax.enable_x64(True), nn.intercept_methods(no_dropout_interceptor), \
            mock.patch.object(jloop, "jnp", _Float64Numpy(jnp)), \
            mock.patch.object(jloop, "train_augment", lambda k, rgb, c: jnp.asarray(crops)):
        model = JPoseNet(JPoseNetConfig(variant="rgbd_geometric", img_size=S, dtype=jnp.float64))
        tx = grad_capture_tx()
        params = f64(variables["params"])
        state = jloop.TrainState(params=params, batch_stats=f64(variables["batch_stats"]),
                                 opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
        new, metrics = jloop.make_train_step(
            model, tx, jloop.TrainConfig(variant="rgbd_geometric", img_size=S, batch_size=B))(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
        jax_out = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                   "grads": _state_f64({"params": new.opt_state["g"]}),
                   "batch_stats": _state_f64({"params": {}, "batch_stats": new.batch_stats})}
    cfg = tloop.TrainConfig(variant="rgbd_geometric", img_size=S, batch_size=B, grad_clip=1e9)
    port = PoseNet(PoseNetConfig(variant="rgbd_geometric", img_size=S))
    port.load_state_dict(posenet_from_jax(variables), strict=True)
    tstate = tloop.create_train_state(cfg, model=disable_dropout(port).to(torch.float64),
                                      device="cpu")
    with mock.patch.object(tloop, "train_augment", lambda g, rgb, c: eval_preprocess(rgb)), \
            torch.backends.mkldnn.flags(enabled=False):
        run = tloop.make_train_step(cfg)(tstate, batch, torch.Generator().manual_seed(0))
    worst = assert_train_step_parity(jax_out, {torch.float64: run})
    print(f"first step: worst relative gradient leaf {worst[torch.float64]:.3g}")


def test_fit_epochs_match_jax(fixture, tmp_path):
    from pose6d_tpu_torch.convert import posenet_from_jax

    paths, variables = fixture
    try:
        jstates, jlosses, jfinal = _run_jax(paths, str(tmp_path / "jax"), variables)
        tstates, tlosses, tfinal = _run_port(paths, str(tmp_path / "port"), variables)

        # per step and per epoch: the losses, metrics.csv, the scheduler
        assert len(jlosses) == len(tlosses) == 2 * EPOCHS
        for i, (got, want) in enumerate(zip(tlosses, jlosses)):
            assert abs(got - want) <= LOSS_RTOL * max(1.0, abs(want)), (i, got, want)
        jrows, trows = _rows(str(tmp_path / "jax")), _rows(str(tmp_path / "port"))
        assert len(jrows) == len(trows) == EPOCHS
        assert set(jrows[0]) - set(TIMING) == {"epoch", "train_loss", "val_add", "val_add_s",
                                               "val_acc", "val_acc_deploy", "lr"}
        for e, (jr, tr) in enumerate(zip(jrows, trows)):
            assert set(jr) == set(tr)
            assert int(tr["epoch"]) == int(jr["epoch"]) == e
            assert float(tr["lr"]) == float(jr["lr"]) == LRS[e], (e, tr["lr"], jr["lr"])
            want = float(jr["train_loss"])
            assert abs(float(tr["train_loss"]) - want) <= LOSS_RTOL * max(1.0, abs(want)), \
                (e, tr["train_loss"], want)
            for k in ("val_add", "val_add_s"):
                assert abs(float(tr[k]) - float(jr[k])) <= ADD_ATOL_MM, (e, k, tr[k], jr[k])
            for k in ("val_acc", "val_acc_deploy"):
                assert float(tr[k]) == float(jr[k]) == 100.0, (e, k, tr[k], jr[k])
        assert tstates == jstates and len(tstates) == EPOCHS
        assert [s["lr"] for s in tstates] == LRS

        # after the last epoch: parameters, BN statistics, AdamW
        model = tfinal.model
        start = posenet_from_jax(variables)
        want_params = _state_f64({"params": jfinal.params})
        want_stats = _state_f64({"params": {}, "batch_stats": jfinal.batch_stats})
        params = dict(model.named_parameters())
        assert set(params) == set(want_params)
        change = {k: want_params[k] - start[k].double() for k in params}
        largest = max(float(d.norm()) for d in change.values())
        still = {k for k, d in change.items() if float(d.norm()) < 1e-9 * largest}
        worst = {"loss": max(abs(g - w) / max(1.0, abs(w)) for g, w in zip(tlosses, jlosses))}
        for k, p in params.items():
            assert p.dtype == torch.float64, k
            got = p.detach() - start[k].double()
            if k in still:
                assert float((got - change[k]).norm()) <= ZERO_ATOL * largest, k
            else:
                worst["change"] = max(worst.get("change", 0.0), _rel(got, change[k]))
                assert _rel(got, change[k]) <= LEAF_RTOL, (k, _rel(got, change[k]))
        buffers = dict(model.named_buffers())
        stats = {k: v for k, v in want_stats.items() if "running_" in k}
        assert stats
        for k, want in stats.items():
            err = float((buffers[k] - want).abs().max())
            worst["bn"] = max(worst.get("bn", 0.0), err / float(want.abs().max()))
            assert err <= BN_RTOL * float(want.abs().max()), (k, err)

        adam, lr = _adam_state(jfinal.opt_state)
        assert lr == tfinal.tx.learning_rate == LRS[-1]
        n_steps = int(adam.count)
        assert n_steps == int(jfinal.step) == tfinal.step == 2 * EPOCHS
        want_mu = _state_f64({"params": adam.mu})
        want_nu = _state_f64({"params": adam.nu})
        moments = tfinal.tx.adamw.state
        # a leaf whose gradient is rounding (a dense bias ahead of
        # train-mode BatchNorm) has moments of rounding
        top_mu = max(float(v.norm()) for v in want_mu.values())
        for k, p in params.items():
            st = moments[p]
            assert int(st["step"]) == n_steps, k
            if float(want_mu[k].norm()) < 1e-9 * top_mu:
                assert float(st["exp_avg"].norm()) < 1e-6 * top_mu, k
                continue
            for name, got, want in (("mu", st["exp_avg"], want_mu[k]),
                                    ("nu", st["exp_avg_sq"], want_nu[k])):
                worst[name] = max(worst.get(name, 0.0), _rel(got, want))
                assert _rel(got, want) <= LEAF_RTOL, (k, name)
        print(f"worst relative errors: {worst}")
    finally:
        for p in tmp_path.iterdir():
            shutil.rmtree(p, ignore_errors=True)
