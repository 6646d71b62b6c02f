"""The rgbd gradient probe (cli/probe_rgbd_gradients.py) against
scripts/probe_rgbd_gradients.py:

  - group_of puts every parameter of the probe's four configurations (rgb,
    rgbd, rgbd without attention, rgbd with the wide head) in the group that
    the JAX script's group_of gives its flax path (the flax trees from
    jax.eval_shape: no weights are made);
  - the inputs equal the JAX script's draws;
  - (slow) the per-group gradient RMS at the first step and after 2 steps,
    and the losses, at img 32 and batch 2 in float64 with dropout off,
    against the JAX script's loss and optax.adamw from the same weights:
    the first step's within PROBE_RTOL, the values after an AdamW update
    within STEP_RTOL. The gap between them is AdamW's, not the probe's: a
    Dense bias feeding a train-mode BatchNorm (rot_dense0 / rot_dense1 in
    rgb) has a gradient that is 0 in exact arithmetic and rounding noise in
    both packages (1,343 and 661 of their elements differ in sign between
    them, float64), and AdamW turns each such element into a step of +-lr;
    after it the groups' RMS read up to 4.0e-4 apart (rgbd_widehead; rgb
    1.4e-4, whose wide heads have two such biases each) and the losses up
    to 2.7e-6, where the first step agrees within 1.7e-10.
"""

import importlib.util
import os

import numpy as np
import pytest

from pose6d_tpu_torch.cli import probe_rgbd_gradients as probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, B, STEPS = 32, 2, 2
PROBE_RTOL = 1e-6   # the first step: gradients of the same weights
STEP_RTOL = 1e-3    # after an AdamW update (see the module docstring)


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_rgbd_gradients", os.path.join(REPO, "scripts", "probe_rgbd_gradients.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_name(path: tuple) -> str:
    """A flax param path -> the port's state_dict name (convert.py's table)."""
    return ".".join(path[:-1]) + "." + {"kernel": "weight", "scale": "weight",
                                        "bias": "bias"}[path[-1]]


@pytest.mark.parametrize("config", list(probe.CONFIGS))
def test_group_of_matches_jax(config):
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig

    flags = probe.CONFIGS[config]
    jmodel = JPoseNet(JPoseNetConfig(img_size=S, **flags))
    kwargs = {"rgb": jnp.zeros((1, S, S, 3))}
    if flags["variant"] == "rgbd":
        kwargs["depth"] = jnp.zeros((1, S, S, 1))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), **kwargs)["params"]
    jgroup = _jax_probe().group_of
    want = {_port_name(path): jgroup("/".join(path)) for path in flatten_dict(shapes)}
    names = [n for n, _ in PoseNet(PoseNetConfig(img_size=S, **flags)).named_parameters()]
    assert sorted(names) == sorted(want)
    got = {n: probe.group_of(n) for n in names}
    assert got == want
    assert "other" not in got.values()
    assert {probe.group_of("/".join(p)) for p in flatten_dict(shapes)} == set(want.values())


def test_probe_inputs_are_the_jax_scripts():
    """The JAX script draws rgb, depth, the quaternions and translations in
    this order from default_rng(0) (scripts/probe_rgbd_gradients.py:68-76)."""
    rng = np.random.default_rng(0)
    rgb = rng.uniform(-2, 2, (B, S, S, 3))
    depth = rng.uniform(0, 1, (B, S, S, 1))
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    trans = rng.normal(0, 0.1, (B, 3)) + [0, 0, 0.8]
    got = probe.probe_inputs(S, B)
    for k, v in (("rgb", rgb), ("depth", depth), ("quat", q), ("trans", trans)):
        np.testing.assert_array_equal(got[k], v.astype(np.float32))


@pytest.mark.slow
@pytest.mark.parametrize("config", list(probe.CONFIGS))
def test_probe_matches_jax_float64(config):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import optax
    import torch
    from flax.traverse_util import flatten_dict

    from pose6d_tpu.losses.pose_loss import PoseLossConfig, pose_loss
    from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
    from pose6d_tpu_torch.convert import posenet_from_jax
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig
    from torch_port_utils import disable_dropout, no_dropout_interceptor

    flags = probe.CONFIGS[config]
    inputs = probe.probe_inputs(S, B)
    jgroup = _jax_probe().group_of
    f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
    with jax.enable_x64(True), nn.intercept_methods(no_dropout_interceptor):
        jmodel = JPoseNet(JPoseNetConfig(img_size=S, dtype=jnp.float64, **flags))
        kwargs = {"rgb": jnp.asarray(inputs["rgb"], jnp.float64)}
        if flags["variant"] == "rgbd":
            kwargs["depth"] = jnp.asarray(inputs["depth"], jnp.float64)
        variables = jmodel.init(jax.random.key(0), **{k: v[:1] for k, v in kwargs.items()})
        params, batch_stats = f64(variables["params"]), f64(variables["batch_stats"])
        quat = jnp.asarray(inputs["quat"], jnp.float64)
        trans = jnp.asarray(inputs["trans"], jnp.float64)

        def loss_fn(p, bs):  # the JAX script's, with its rotation-only loss
            (rot, tr), updates = jmodel.apply(
                {"params": p, "batch_stats": bs}, train=True,
                rngs={"dropout": jax.random.key(1)}, mutable=["batch_stats"], **kwargs)
            return pose_loss(rot, tr, quat, trans, PoseLossConfig(trans_weight=0.0)), \
                updates["batch_stats"]

        tx = optax.adamw(probe.LR, weight_decay=probe.WEIGHT_DECAY)
        opt_state = tx.init(params)

        @jax.jit
        def step(p, bs, os_):
            (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, bs)
            upd, new_os = tx.update(grads, os_, p)
            return optax.apply_updates(p, upd), new_bs, new_os, grads, loss

        def rms(grads):
            sq, n = {}, {}
            for path, g in flatten_dict(grads, sep="/").items():
                k = jgroup(path)
                sq[k] = sq.get(k, 0.0) + float(jnp.sum(g.astype(jnp.float64) ** 2))
                n[k] = n.get(k, 0) + int(np.prod(g.shape))
            return {k: float(np.sqrt(sq[k] / n[k])) for k in sq}

        want = {"grad_rms": {}}
        for i in range(STEPS):
            params, batch_stats, opt_state, grads, loss = step(params, batch_stats, opt_state)
            if i == 0:
                want["grad_rms"]["init"], want["loss_first"] = rms(grads), float(loss)
        want["grad_rms"]["final"], want["loss_last"] = rms(grads), float(loss)

    model = PoseNet(PoseNetConfig(img_size=S, **flags))
    model.load_state_dict(posenet_from_jax(jax.tree.map(np.asarray, variables)), strict=True)
    with torch.backends.mkldnn.flags(enabled=False):
        got = probe.probe_model(disable_dropout(model).double(), inputs, STEPS)

    worst = {}
    for k, phase, rtol in (("loss_first", "init", PROBE_RTOL), ("loss_last", "final", STEP_RTOL)):
        g, w = got["grad_rms"][phase], want["grad_rms"][phase]
        assert set(g) == set(w) and g["trans_head"] == w["trans_head"] == 0.0
        errs = {grp: abs(g[grp] - w[grp]) / w[grp] for grp in w if w[grp]}
        errs[k] = abs(got[k] - want[k]) / abs(want[k])
        worst[phase] = max(errs.values())
        assert all(e <= rtol for e in errs.values()), (phase, errs)
    print(f"{config}: worst relative error {worst}")
