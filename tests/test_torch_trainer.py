"""The port's Trainer (pose6d_tpu_torch/train/trainer.py) on a LineMOD tree
from the JAX package's generator, on the CPU at img 64: validate() on
weights carried from a JAX tree equal to JAX's eval step over JAX's val
loader (the mean of per-batch means; the eval-parity tolerances of
torch_port_utils.assert_eval_parity: ADD means within 1e-2 mm, the 0.1d
accuracies equal, the loss within 1e-5); a 1-epoch fit on both input
paths writes metrics.csv under the JAX header and the three checkpoints;
resume restores epoch, best values, scheduler, model and optimizer state
exactly, falls back to `best` when `last` is unreadable; early_stop_acc,
profile_dir, a mesh= whose data axis does not divide the batch and a
missing pretrained_backbone raise."""

import csv
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.data.pipeline import LineMODPoseLoader as JLoader
from pose6d_tpu.data.synthetic import generate_synthetic_linemod
from pose6d_tpu.losses.add import ADDEvaluator as JEvaluator
from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
from pose6d_tpu.train import loop as jloop
from pose6d_tpu.train.trainer import Trainer as JTrainer
from pose6d_tpu_torch.configs.presets import get_preset
from pose6d_tpu_torch.convert import posenet_from_jax
from pose6d_tpu_torch.train.trainer import LOG_FIELDS, Trainer
from torch_port_utils import few_torch_threads, random_flax_variables  # noqa: F401

S, B = 64, 8


def _tree(root, diameter_mm, frames_per_obj):
    paths = generate_synthetic_linemod(str(root), obj_ids=(1, 10), frames_per_obj=frames_per_obj,
                                       img_w=320, img_h=240, seed=11)
    # a diameter of the test's choosing: untrained poses land some within
    # 0.1 d and some not (validate), or all within it (fit: `best` saves)
    with open(os.path.join(paths["models"], "models_info.yml"), "w") as f:
        f.write(f"1: {{diameter: {diameter_mm}}}\n10: {{diameter: {diameter_mm}}}\n")
    return paths


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return {"val": _tree(tmp_path_factory.mktemp("val_tree"), 15000.0, 20),
            "fit": _tree(tmp_path_factory.mktemp("fit_tree"), 1e6, 10)}


@pytest.fixture
def workdir(tmp_path):
    """A directory for save dirs and traces, removed after the test (a
    PoseNet checkpoint is 0.3-0.8 GB)."""
    yield tmp_path
    for p in tmp_path.iterdir():
        shutil.rmtree(p, ignore_errors=True)


def test_trainer_header_is_jax():
    """metrics.csv's columns are the JAX Trainer's (read from its source:
    its log_fields list is local to fit)."""
    import inspect

    src = inspect.getsource(JTrainer.fit)
    want = src[src.index("log_fields = [") + len("log_fields = "):]
    assert LOG_FIELDS == eval(want[:want.index("]") + 1])


def test_validate_matches_jax_eval(trees, workdir):
    data, models = trees["val"]["data"], trees["val"]["models"]
    dummy = {"rgb": jnp.zeros((1, S, S, 3)), "depth": jnp.zeros((1, S, S, 1))}
    variables = random_flax_variables(JPoseNet(JPoseNetConfig(variant="rgbd", img_size=S)),
                                      **dummy, seed=5)
    bs = 3  # 4 val samples: a full batch and a padded one
    jcfg = jloop.TrainConfig(variant="rgbd", img_size=S, batch_size=bs)
    jstep = jloop.make_eval_step(JPoseNet(JPoseNetConfig(variant="rgbd", img_size=S)), jcfg,
                                 JEvaluator(models))
    jstate = jloop.TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                              opt_state=(), step=jnp.zeros((), jnp.int32))
    keys = ("add_mean", "add_s_mean", "add_01d_acc", "loss", "add_01d_acc_deploy")
    jl = JLoader(data, mode="val", flavor="rgbd", img_size=S, augment_bbox=False,
                 num_workers=0, compact_arrays=True)
    per_batch = [np.asarray([jstep(jstate, b)[k] for k in keys])
                 for b in jl.batches(bs, np.random.default_rng(0), shuffle=False,
                                     drop_remainder=False)]
    assert len(per_batch) == 2
    want = dict(zip(("val_add", "val_add_s", "val_acc", "val_loss", "val_acc_deploy"),
                    np.mean(np.stack(per_batch).astype(np.float32), axis=0)))

    tr = Trainer(get_preset("rgbd", img_size=S, batch_size=bs), data, models,
                 str(workdir / "save"), num_workers=0, device="cpu")
    tr.state.model.load_state_dict(posenet_from_jax(variables), strict=True)
    got = tr.validate(np.random.default_rng(0))
    assert set(got) == set(want)
    for k in ("val_add", "val_add_s"):
        assert abs(got[k] - float(want[k])) <= 1e-2, (k, got[k], want[k])
    for k in ("val_acc", "val_acc_deploy"):
        assert got[k] == float(want[k]), (k, got[k], want[k])
    assert 0.0 < got["val_acc"] < 100.0 or 0.0 < got["val_acc_deploy"] < 100.0
    assert abs(got["val_loss"] - float(want["val_loss"])) <= 1e-5 * max(1.0, abs(want["val_loss"]))
    tr.close()


def _rows(save_dir):
    with open(os.path.join(save_dir, "metrics.csv"), newline="") as f:
        reader = csv.reader(f)
        assert next(reader) == LOG_FIELDS
        return list(reader)


def _assert_resumed_equal(tr, tr2):
    assert tr2.best_acc == tr.best_acc and tr2.best_deploy_acc == tr.best_deploy_acc
    assert tr2.scheduler.state_dict() == tr.scheduler.state_dict()
    a, b = tr.state.model.state_dict(), tr2.state.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = tr.state.tx.state_dict(), tr2.state.tx.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert all(torch.equal(oa["state"][i][k], ob["state"][i][k])
               for i in oa["state"] for k in oa["state"][i])
    assert tr2.state.step == tr.state.step


@pytest.mark.parametrize("device_preprocess", [False, True])
def test_fit_checkpoints_and_resume(trees, workdir, device_preprocess):
    data, models = trees["fit"]["data"], trees["fit"]["models"]
    # rgbd_geometric: the depth flavour's loader and store with one tower,
    # so each checkpoint is 0.3 GB (rgbd's are 0.8 GB)
    cfg = get_preset("rgbd_geometric", img_size=S, batch_size=B, epochs=1)
    save = str(workdir / "save")
    # num_workers 0: the loader's threads are tested in test_torch_host_loader,
    # and next to torch's own threads they slow a busy test run many-fold
    tr = Trainer(cfg, data, models, save, num_workers=0, device="cpu",
                 device_preprocess=device_preprocess)
    assert tr.fit() == 100.0  # every untrained pose is within 0.1 of a 1 km diameter
    rows = _rows(save)
    assert len(rows) == 1 and np.isfinite(float(rows[0][1]))
    assert all(tr.ckpt.has_checkpoint(n) for n in ("last", "best", "best_deploy"))
    if device_preprocess:
        assert set(tr.epoch_timing) == {"meta_s", "dispatch_s", "exec_fetch_s"}

    tr2 = Trainer(cfg, data, models, save, num_workers=0, device="cpu",
                  device_preprocess=device_preprocess)
    assert tr2.try_resume() and tr2.start_epoch == 1
    _assert_resumed_equal(tr, tr2)
    assert tr2.fit() == 100.0 and len(_rows(save)) == 1  # nothing left to run
    # early stop: the first further epoch reaches the target
    tr2.fit(epochs=3, early_stop_acc=50.0)
    assert len(_rows(save)) == 2 and tr2.start_epoch == 1
    tr.close()
    tr2.close()


def test_resume_falls_back_to_best_and_profiles(trees, workdir):
    data, models = trees["fit"]["data"], trees["fit"]["models"]
    cfg = get_preset("rgbd_geometric", img_size=S, batch_size=B, epochs=2)
    save, prof = str(workdir / "save"), str(workdir / "prof")
    tr = Trainer(cfg, data, models, save, num_workers=0, device="cpu", profile_dir=prof)
    tr.fit()
    assert len(_rows(save)) == 2
    assert os.listdir(prof) == ["trace_epoch1.json"]  # the run's second epoch
    # `best` is epoch 0 (100 % then, not bettered); `last` epoch 1
    with open(tr.ckpt.path("last"), "wb") as f:
        f.write(b"a save killed before os.replace would not leave this; a damaged disk might")
    tr2 = Trainer(cfg, data, models, save, num_workers=0, device="cpu")
    assert tr2.try_resume() and tr2.start_epoch == 1 and tr2.best_acc == 100.0
    fresh = Trainer(cfg, data, models, str(workdir / "empty"), num_workers=0, device="cpu")
    assert not fresh.try_resume() and fresh.start_epoch == 0
    tr.close()
    tr2.close()
    fresh.close()


def _mesh_of_three():
    from pose6d_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh

    return Mesh({DATA_AXIS: 3, MODEL_AXIS: 1}, 0, 0, 0, None, None, None)


@pytest.mark.parametrize("kw", [{"mesh": "three"}, {"pretrained_backbone": "r50.pth"}])
def test_unported_options_raise(trees, workdir, kw):
    """mesh= is ported (tests/test_torch_parallel_trainer.py) and raises,
    as JAX's Trainer does, when its data axis (3) does not divide the batch
    (32); pretrained_backbone= is ported (tests/test_torch_pretrained.py)
    and raises only for a file that is not there."""
    if "mesh" in kw:
        kw = {"mesh": _mesh_of_three()}
    err = (ValueError, "not divisible") if "mesh" in kw else (FileNotFoundError, "r50.pth")
    with pytest.raises(err[0], match=err[1]):
        Trainer(get_preset("rgb", img_size=S), trees["fit"]["data"], trees["fit"]["models"],
                str(workdir / "save"), device="cpu", **kw)
