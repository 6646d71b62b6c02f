"""pose6d_tpu_torch.train against pose6d_tpu.train, the parts that need no
ResNet50 compile: the pose loss, the optimizer on identical gradients
(clip_by_global_norm then AdamW, against optax, within 1e-6 abs), the
plateau scheduler, decompress_batch, dropout's rate and scaling, the flax
initialization rules, and the epoch function against the step function.
The one-step parity of each variant is in test_torch_train_step_rgb.py and
test_torch_train_step_rgbd.py."""

import copy
import math

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pose6d_tpu.losses.pose_loss import PoseLossConfig as JLossConfig, pose_loss as j_pose_loss
from pose6d_tpu.train import loop as jloop
from pose6d_tpu.train.schedule import ReduceLROnPlateau as JPlateau
from pose6d_tpu_torch.data.device_pipeline import DeviceFrameStore
from pose6d_tpu_torch.losses.pose_loss import PoseLossConfig, geodesic_distance, pose_loss
from pose6d_tpu_torch.models.posenet import Dropout, PoseNet, PoseNetConfig, flax_init_
from pose6d_tpu_torch.models.resnet import BatchNorm
from pose6d_tpu_torch.train import loop as tloop
from pose6d_tpu_torch.train.schedule import ReduceLROnPlateau

from torch_port_utils import train_split


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("rotation_loss", ["geodesic", "l1"])
def test_pose_loss_matches_jax(rotation_loss):
    rng = np.random.default_rng(0)
    q1, q2 = _quats(rng, 16), _quats(rng, 16)
    q2[:4] = -q1[:4]  # the double cover: zero distance
    q2[4:6] = q1[4:6]
    q1[6] *= 3.0  # unnormalized predictions
    t1, t2 = rng.normal(size=(16, 3)).astype(np.float32), rng.normal(size=(16, 3)).astype(np.float32)
    jc = JLossConfig(rotation_loss=rotation_loss)
    tc = PoseLossConfig(rotation_loss=rotation_loss)
    want = float(j_pose_loss(*(jnp.asarray(a) for a in (q1, t1, q2, t2)), jc))
    got = float(pose_loss(*(torch.from_numpy(a) for a in (q1, t1, q2, t2)), tc))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    d = geodesic_distance(torch.from_numpy(q1[:4]), torch.from_numpy(q2[:4]))
    assert float(d) <= 1e-3  # atan2 form: ~0 at the double cover, no NaN
    with pytest.raises(ValueError):
        pose_loss(*(torch.from_numpy(a) for a in (q1, t1, q2, t2)),
                  PoseLossConfig(rotation_loss="cosine"))


def test_optimizer_matches_optax_on_identical_gradients():
    """Three steps on the same parameters and gradients: the first clipped
    (global norm 3.7 > 1), the second not (0.5), the learning rate changed
    before the third as the plateau scheduler changes it. A large learning
    rate and weight decay make each term visible at 1e-6."""
    rng = np.random.default_rng(1)
    shapes = {"conv": (8, 4, 3, 3), "dense": (16, 8), "bias": (16,), "bn_scale": (16,)}
    params = {k: rng.normal(0, 0.1, s).astype(np.float32) for k, s in shapes.items()}
    jcfg = jloop.TrainConfig(learning_rate=0.05, weight_decay=0.1)
    tcfg = tloop.TrainConfig(learning_rate=0.05, weight_decay=0.1)
    jtx = jloop.make_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    ttx = tloop.make_optimizer(tcfg, tparams.values())
    for i, norm in enumerate((3.7, 0.5, 2.0)):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        scale = norm / math.sqrt(sum(float((a.astype(np.float64) ** 2).sum()) for a in g.values()))
        g = {k: (a * scale).astype(np.float32) for k, a in g.items()}
        if i == 2:
            jstate.hyperparams["learning_rate"] = jnp.asarray(0.02)
            ttx.learning_rate = 0.02
        updates, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        ttx.zero_grad()
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        got_norm = float(ttx.step())
        assert abs(got_norm - float(optax.global_norm(g))) <= 1e-6 * norm
        for k in shapes:
            err = np.abs(tparams[k].detach().numpy() - np.asarray(jparams[k])).max()
            assert err <= 1e-6, (i, k, err)
    assert ttx.learning_rate == 0.02


def test_clip_is_optax_form():
    rng = np.random.default_rng(2)
    g = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(3)]
    for factor in (0.01, 10.0):
        gs = [a * factor for a in g]
        want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(a) for a in gs], None)
        t = [torch.from_numpy(a.copy()) for a in gs]
        tloop.clip_by_global_norm_(t, 1.0, tloop.global_norm(t))
        for a, b in zip(t, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_plateau_scheduler_matches_jax():
    kw = dict(lr=1e-3, patience=2, cooldown=1, min_lr=1e-4, factor=0.5)
    t, j = ReduceLROnPlateau(**kw), JPlateau(**kw)
    metrics = [1.0, 1.0, 0.9, 0.95, 0.99, 1.2, 1.2, 1.2, 1.2, 1.2, 1.2, 1.2, 1.2, 1.3]
    assert [t.step(m) for m in metrics] == [j.step(m) for m in metrics]
    assert t.state_dict() == j.state_dict()
    t2 = ReduceLROnPlateau(lr=1.0)
    t2.load_state_dict(t.state_dict())
    assert t2.state_dict() == t.state_dict()


def test_decompress_batch_matches_jax():
    d = np.random.default_rng(3).integers(0, 65535, (2, 8, 8)).astype(np.uint16)
    d[0, :2] = 5  # below the invalid threshold
    want = jloop.decompress_batch({"depth_mm": jnp.asarray(d), "x": jnp.zeros(2)})
    got = tloop.decompress_batch({"depth_mm": torch.from_numpy(d), "x": torch.zeros(2)})
    assert set(got) == set(want) == {"depth_raw", "depth", "x"}
    for k in ("depth_raw", "depth"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_dropout_rate_and_scaling():
    x = torch.ones(200_000)
    d = Dropout(0.3).train()
    y = d(x, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(y, d(x, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, d(x, torch.Generator().manual_seed(1)))
    assert torch.equal(d.eval()(x), x)
    assert torch.equal(Dropout(0.0).train()(x), x)
    with pytest.raises(ValueError):
        Dropout(0.3).train()(x)


def _check_lecun(w, name):
    w = w.detach()
    std = math.sqrt(1.0 / w[0].numel())
    assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6, name
    if w.numel() >= 4096:
        assert abs(float(w.std()) / std - 1.0) < 0.1, (name, float(w.std()), std)


def _check_xavier(w, name):
    w = w.detach()
    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    assert float(w.abs().max()) <= limit, name
    assert abs(float(w.std()) / (limit / math.sqrt(3.0)) - 1.0) < 0.1, name


@pytest.mark.parametrize("variant,flags", [("rgbd", {"attn_zero_init": True}),
                                           ("rgb_geometric", {})])
def test_flax_init_rules(variant, flags):
    model = flax_init_(PoseNet(PoseNetConfig(variant=variant, **flags)), seed=0)
    xavier = ("fusion_dense", "rot_", "trans_") if variant == "rgbd" else ()
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            if name == "cross_attention.out_proj":
                assert not m.weight.any()
            elif name.startswith(xavier) and xavier:
                _check_xavier(m.weight, name)
            else:
                _check_lecun(m.weight, name)
            if m.bias is not None:
                want = torch.zeros_like(m.bias)
                if name == "trans_out":
                    want[2] = 0.5
                elif name == "z_out":
                    want[0] = 0.5
                assert torch.equal(m.bias, want), name
        elif isinstance(m, BatchNorm):
            gamma = 0.0 if (".layer" in name and name.endswith(".bn3")) else 1.0
            assert torch.equal(m.weight, torch.full_like(m.weight, gamma)), name
            assert not m.bias.any() and not m.running_mean.any(), name
            assert torch.equal(m.running_var, torch.ones_like(m.running_var)), name
        elif isinstance(m, torch.nn.LayerNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight)) and not m.bias.any()


def test_create_train_state_and_learning_rate():
    cfg = tloop.TrainConfig(variant="rgb", img_size=32, learning_rate=3e-4)
    state = tloop.create_train_state(cfg, model=PoseNet(PoseNetConfig(variant="rgb")),
                                     device="cpu")
    assert state.step == 0 and state.tx.learning_rate == 3e-4
    state.tx.learning_rate = 1e-5
    assert all(g["lr"] == 1e-5 for g in state.tx.adamw.param_groups)
    with pytest.raises(NotImplementedError):
        tloop.create_train_state(tloop.TrainConfig(compute_dtype="bfloat16"), device="cpu")


def test_epoch_equals_its_steps():
    """make_train_epoch over stacked metadata [2, B] gives the losses and
    the parameters and BN statistics of two make_train_step calls with the
    same generator, augmentation and dropout on (rgbd, the slice's
    variant, initialized from scratch), and every kind of state moves."""
    S, B = 32, 2
    cfg = tloop.TrainConfig(variant="rgbd", img_size=S, batch_size=B)
    store = DeviceFrameStore(*train_split(1), img_size=S, flavor="rgbd", device="cpu")
    meta, n = store.epoch_meta(B, np.random.default_rng(0))
    meta = {k: v[:2] for k, v in meta.items()}
    hw = (store.frame_h, store.frame_w)
    a = tloop.create_train_state(cfg, seed=3, device="cpu")
    fresh = {k: v.clone() for k, v in a.model.state_dict().items()}
    b = tloop.create_train_state(cfg, model=copy.deepcopy(a.model), device="cpu")
    a, losses = tloop.make_train_epoch(cfg, frame_hw=hw)(
        a, store.rgb_frames, store.depth_frames, meta, torch.Generator().manual_seed(4))
    step = tloop.make_train_step(cfg, device_preprocess=True, frame_hw=hw)
    g = torch.Generator().manual_seed(4)
    step_losses = []
    for i in range(2):
        b, m = step(b, store.rgb_frames, store.depth_frames, {k: v[i] for k, v in meta.items()}, g)
        step_losses.append(m["loss"])
    assert a.step == b.step == 2 and losses.shape == (2,)
    assert torch.equal(losses, torch.stack(step_losses)) and torch.isfinite(losses).all()
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    moved = [k for k in sa if not torch.equal(sa[k], fresh[k])]
    assert any("running_var" in k for k in moved) and any(k.endswith("conv1.weight") for k in moved)
