"""Checkpoints, presets and warm start of the port against the JAX
package's policy: save then restore is exact (model, BN statistics,
AdamW moments and step counts and their devices, learning rate, step
count, meta, scheduler); a mismatched model restores None and leaves the
state as it was; a save killed midway leaves the previous file whole;
load_model_variables falls back from `best` to `last`; PRESETS equal to
JAX's field by field; graft_towers grafts the same scopes as JAX's on
trees carried across by convert.posenet_from_jax, with the same values,
and raises in the same cases."""

import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.configs import presets as jpresets
from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
from pose6d_tpu.train import warmstart as jwarm
from pose6d_tpu_torch.configs import presets as tpresets
from pose6d_tpu_torch.convert import posenet_from_jax
from pose6d_tpu_torch.models.resnet import BatchNorm
from pose6d_tpu_torch.train import checkpoint as tckpt
from pose6d_tpu_torch.train import loop as tloop
from pose6d_tpu_torch.train import warmstart as twarm
from torch_port_utils import random_flax_variables

S = 32


@pytest.fixture
def save_dir(tmp_path):
    """A checkpoint directory, removed after the test."""
    path = tmp_path / "save"
    yield str(path)
    shutil.rmtree(path, ignore_errors=True)


class Tiny(torch.nn.Module):
    """A small module with parameters and BatchNorm buffers: the
    checkpoint logic does not depend on the model, and a PoseNet
    checkpoint is 0.3-0.8 GB."""

    def __init__(self, width=16, norm=True):
        super().__init__()
        self.dense = torch.nn.Linear(8, width)
        self.norm = BatchNorm(width) if norm else torch.nn.Identity()
        self.out = torch.nn.Linear(width, 3)

    def forward(self, x):
        return self.out(torch.relu(self.norm(self.dense(x))))


def _state(seed=0, **kw):
    torch.manual_seed(seed)
    model = Tiny(**kw)
    cfg = tloop.TrainConfig(learning_rate=1e-3)
    return tloop.TrainState(model=model, tx=tloop.make_optimizer(cfg, model.parameters()))


def _step(state, seed=0):
    """One train step of the tiny model: loss, backward, clip + AdamW."""
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=(4, 8)).astype(np.float32))
    state.model.train()
    state.tx.zero_grad()
    state.model(x).square().mean().backward()
    state.tx.step()
    state.step += 1
    return state


def _assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.tx.state_dict(), b.tx.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k in oa["state"][i]:
            assert torch.equal(oa["state"][i][k], ob["state"][i][k]), (i, k)
            assert oa["state"][i][k].device == ob["state"][i][k].device, (i, k)
    assert a.step == b.step and a.tx.learning_rate == b.tx.learning_rate


SCHED = {"lr": 1e-4, "best": 0.0, "num_bad_epochs": 0, "cooldown_counter": 0}


def test_save_restore_exact(save_dir):
    state = _step(_step(_state()), 1)
    state.tx.learning_rate = 2.5e-5
    mgr = tckpt.CheckpointManager(save_dir)
    sched = {"lr": 2.5e-5, "best": 12.5, "num_bad_epochs": 2, "cooldown_counter": 0}
    mgr.save(state, 4, 12.5, 10.0, 31.25, sched, is_best=True, best_deploy_acc=7.5,
             is_best_deploy=True)
    assert all(mgr.has_checkpoint(n) for n in ("last", "best", "best_deploy"))
    fresh = _state(seed=1)
    out = mgr.restore(fresh)
    assert out["state"] is fresh
    _assert_same_state(fresh, state)
    assert out["meta"] == {"epoch": 4, "best_acc": 12.5, "best_deploy_acc": 7.5,
                           "curr_acc": 10.0, "curr_add": 31.25}
    assert out["scheduler"] == sched
    assert mgr.restore(_state(seed=2), name="best")["meta"]["best_acc"] == 10.0
    # the restored state trains on exactly as the saved one does
    _assert_same_state(_step(fresh, 3), _step(state, 3))


@pytest.mark.parametrize("other", [{"width": 32}, {"norm": False}])  # shapes, keys
def test_mismatched_model_restores_none(save_dir, other):
    mgr = tckpt.CheckpointManager(save_dir)
    mgr.save(_step(_state()), 0, 0.0, 0.0, 1.0, SCHED, is_best=False)
    target = _state(seed=3, **other)
    before = {k: v.clone() for k, v in target.model.state_dict().items()}
    assert mgr.restore(target) is None and mgr.restore(target, name="best") is None
    after = target.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    with open(mgr.path("last"), "wb") as f:  # a damaged file
        f.write(b"not a checkpoint")
    assert mgr.restore(_state(seed=4)) is None


def test_killed_save_keeps_the_old_file(save_dir, monkeypatch):
    state = _state()
    mgr = tckpt.CheckpointManager(save_dir)
    mgr.save(state, 0, 0.0, 0.0, 1.0, SCHED, is_best=False)
    old = open(mgr.path("last"), "rb").read()

    def killed(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a file")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(_step(state), 1, 0.0, 0.0, 1.0, SCHED, is_best=False)
    assert open(mgr.path("last"), "rb").read() == old


def test_load_model_variables(save_dir):
    """A PoseNet's state_dict from a checkpoint directory: `best`, else
    `last`; None for a config whose model does not fit."""
    cfg = tloop.TrainConfig(variant="rgbd_geometric", img_size=S)
    state = tloop.create_train_state(cfg, device="cpu")
    mgr = tckpt.CheckpointManager(save_dir)
    mgr.save(state, 0, 0.0, 0.0, 1.0, SCHED, is_best=False)
    sd = tckpt.load_model_variables(save_dir, cfg)  # no best: falls back to last
    want = state.model.state_dict()
    assert set(sd) == set(want) and all(torch.equal(sd[k], want[k]) for k in want)
    assert tckpt.load_model_variables(save_dir, dataclasses.replace(
        cfg, rot_head_wide=True)) is None


def test_presets_match_jax():
    assert tpresets.VARIANTS == jpresets.VARIANTS
    for v in jpresets.VARIANTS:
        got, want = dataclasses.asdict(tpresets.PRESETS[v]), dataclasses.asdict(
            jpresets.PRESETS[v])
        assert got == want, v
    got = dataclasses.asdict(tpresets.get_preset("rgbd", epochs=2, compute_dtype="bfloat16"))
    want = dataclasses.asdict(jpresets.get_preset("rgbd", epochs=2, compute_dtype="bfloat16"))
    assert got == want and tpresets.get_preset("rgb") is tpresets.PRESETS["rgb"]


def _tree(variant):
    extra = {"depth": jnp.zeros((1, S, S, 1))} if variant == "rgbd" else {}
    return random_flax_variables(JPoseNet(JPoseNetConfig(variant=variant, img_size=S)),
                                 jnp.zeros((1, S, S, 3)), seed=len(variant), **extra)


@pytest.fixture(scope="module")
def trees():
    return {v: _tree(v) for v in ("rgb", "rgbd")}


@pytest.mark.parametrize("target,donor", [("rgbd", "rgb"), ("rgbd", "rgbd"), ("rgb", "rgb")])
def test_graft_towers_matches_jax(trees, target, donor):
    want, want_log = jwarm.graft_towers(trees[target], trees[donor])
    got, got_log = twarm.graft_towers(posenet_from_jax(trees[target]),
                                      posenet_from_jax(trees[donor]))
    assert got_log == want_log and got_log
    ref = posenet_from_jax(want)
    assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref)


def test_graft_towers_raises_as_jax(trees):
    # no tower of the target in the donor
    with pytest.raises(ValueError, match="no tower scope"):
        jwarm.graft_towers(trees["rgb"], trees["rgbd"])
    with pytest.raises(ValueError, match="no tower scope"):
        twarm.graft_towers(posenet_from_jax(trees["rgb"]), posenet_from_jax(trees["rgbd"]))
    # a donor with parameters but no BatchNorm statistics
    params_only = {"params": trees["rgb"]["params"]}
    with pytest.raises(ValueError, match="batch_stats"):
        jwarm.graft_towers(trees["rgbd"], params_only)
    with pytest.raises(ValueError, match="batch_stats"):
        twarm.graft_towers(posenet_from_jax(trees["rgbd"]), posenet_from_jax(params_only))
