"""The detector trainer's device augmentation, schedule and EMA
(pose6d_tpu_torch/models/yolo/train.py, train/schedule.py) against the JAX
package's (pose6d_tpu/models/yolo/train.py, optax) on the CPU.

The port draws its own random numbers (a torch.Generator); the apply half
of each augmentation takes JAX's draws here, recomputed from the JAX
step's keys (or planted through jax.random.uniform): HSV and flip within
1e-6, affine within 1e-5 on [0, 1] images with boxes within 1e-4 px and
the same surviving boxes, at s in {0.5, 0.75, 1.0, 1.3, 1.5} with centres
off the frame included. The learning-rate schedule against optax's on
every step of several runs, the EMA decay against JAX's float32, and the
EMA update itself."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pose6d_tpu.models.yolo import train as jtrain
from pose6d_tpu_torch.models.yolo import train as ttrain
from pose6d_tpu_torch.train.schedule import ema_decay, warmup_cosine_decay
from torch_port_utils import few_torch_threads, jax_draws  # noqa: F401

S, B, M = 64, 6, 3


def _images(seed: int, n: int = B):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (n, S, S, 3)).astype(np.float32)
    x1y1 = rng.uniform(-4, 40, (n, M, 2))
    wh = rng.uniform(1.0, 30.0, (n, M, 2))
    boxes = np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)
    mask = rng.random((n, M)) < 0.85
    return imgs, boxes, mask


def test_hsv_and_flip_match_jax_on_its_draws():
    cfg = jtrain.DetTrainConfig(img_size=S)
    imgs, boxes, _ = _images(0)
    key = jax.random.key(5)
    draws = jax_draws(key, B, cfg)
    k_hsv, k_flip, _ = jax.random.split(key, 3)
    want = jax.vmap(lambda k, im: jtrain.hsv_augment(k, im, cfg))(
        jax.random.split(k_hsv, B), jnp.asarray(imgs))
    got = ttrain.hsv_apply(torch.from_numpy(imgs), draws["hsv"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    w_img, w_box = jax.vmap(lambda k, im, bx: jtrain.flip_augment(k, im, bx, cfg.flip_p, S))(
        jax.random.split(k_flip, B), want, jnp.asarray(boxes))
    g_img, g_box = ttrain.flip_apply(got, torch.from_numpy(boxes), draws["flip"], S)
    assert 0 < int(draws["flip"].sum()) < B
    np.testing.assert_allclose(g_img.numpy(), np.asarray(w_img), rtol=0, atol=1e-6)
    np.testing.assert_allclose(g_box.numpy(), np.asarray(w_box), rtol=0, atol=1e-6)


PLANTED = [(s, cx, cy) for s in (0.5, 0.75, 1.0, 1.3, 1.5)
           for cx, cy in ((0.5, 0.5), (0.43, 0.58), (-0.3, 1.35), (1.2, 0.45))]


def _jax_affine_planted(img, boxes, mask, params):
    """JAX's own affine_augment with its three uniform draws planted."""
    values = iter(params)
    with mock.patch.object(jax.random, "uniform",
                           lambda *a, **k: jnp.float32(next(values))):
        return jtrain.affine_augment(jax.random.key(0), jnp.asarray(img), jnp.asarray(boxes),
                                     jnp.asarray(mask), jtrain.DetTrainConfig(img_size=S))


def test_affine_matches_jax_at_planted_scales():
    imgs, boxes, mask = _images(1, len(PLANTED))
    want = [_jax_affine_planted(imgs[i], boxes[i], mask[i], p) for i, p in enumerate(PLANTED)]
    got_img, got_box, got_keep = ttrain.affine_apply(
        torch.from_numpy(imgs), torch.from_numpy(boxes), torch.from_numpy(mask),
        torch.tensor(PLANTED, dtype=torch.float32))
    for i, (w_img, w_box, w_keep) in enumerate(want):
        np.testing.assert_allclose(got_img[i].numpy(), np.asarray(w_img), rtol=0, atol=1e-5,
                                   err_msg=str(PLANTED[i]))
        np.testing.assert_allclose(got_box[i].numpy(), np.asarray(w_box), rtol=0, atol=1e-4,
                                   err_msg=str(PLANTED[i]))
        np.testing.assert_array_equal(got_keep[i].numpy(), np.asarray(w_keep),
                                      err_msg=str(PLANTED[i]))
    keep = got_keep.numpy()
    assert keep.any() and (mask & ~keep).any()  # some boxes survive, some are filtered
    # off-frame centres leave pixels uncovered: those are the gray fill
    off = [i for i, p in enumerate(PLANTED) if p[1] < 0]
    np.testing.assert_allclose(got_img[off[0], 0, -1].numpy(), 114.0 / 255.0, atol=1e-6)


def test_augment_batch_matches_jax_step_order():
    """hsv -> flip -> affine on JAX's draws for a key, as make_det_train_step
    composes them, against the JAX functions composed the same way."""
    cfg = jtrain.DetTrainConfig(img_size=S)
    imgs, boxes, mask = _images(2)
    u8 = (imgs * 255).astype(np.uint8)
    key = jax.random.key(11)
    k_hsv, k_flip, k_aff = jax.random.split(key, 3)
    x = jax.vmap(lambda k, im: jtrain.hsv_augment(k, im, cfg))(
        jax.random.split(k_hsv, B), jnp.asarray(u8).astype(jnp.float32) / 255.0)
    x, bx = jax.vmap(lambda k, im, b: jtrain.flip_augment(k, im, b, cfg.flip_p, S))(
        jax.random.split(k_flip, B), x, jnp.asarray(boxes))
    x, bx, mk = jax.vmap(lambda k, im, b, m: jtrain.affine_augment(k, im, b, m, cfg))(
        jax.random.split(k_aff, B), x, bx, jnp.asarray(mask))
    g, gb, gm = ttrain.augment_batch(torch.from_numpy(u8), torch.from_numpy(boxes),
                                     torch.from_numpy(mask), jax_draws(key, B, cfg),
                                     ttrain.DetTrainConfig(img_size=S))
    np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gb.numpy(), np.asarray(bx), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(mk))


def test_draws_follow_jax_distributions():
    """The port's own draws: in JAX's ranges, flips at about flip_p."""
    cfg = ttrain.DetTrainConfig()
    d = ttrain.draw_det_augment(torch.Generator().manual_seed(0), 4096, cfg, "cpu")
    h = d["hsv"].numpy()
    assert np.abs(h[:, 0]).max() <= cfg.hsv_h and np.abs(h[:, 1] - 1).max() <= cfg.hsv_s
    assert np.abs(h[:, 2] - 1).max() <= cfg.hsv_v
    a = d["affine"].numpy()
    assert np.abs(a[:, 0] - 1).max() <= cfg.affine_scale
    assert np.abs(a[:, 1:] - 0.5).max() <= cfg.affine_translate
    assert abs(float(d["flip"].float().mean()) - cfg.flip_p) < 0.04


# The runs: the trainer's (warmup, total) = (min(max(int(3 n), 1), T - 1),
# T) for n steps per epoch and T = max(epochs n, 2): the CPU trainer test's
# 2 epochs of 4 steps, the chip run's 2 epochs of 26, DetTrainConfig's 5
# epochs of 26, 4 epochs of 10, 10 epochs of 100.
RUNS = [(7, 8), (51, 52), (78, 130), (30, 40), (300, 1000)]


@pytest.mark.parametrize("warmup,total", RUNS)
def test_schedule_matches_optax(warmup, total):
    """Every step of the run and past its end: equal to optax's float32 in
    the warmup; in the cosine phase within 2 float32 ulps (XLA rounds some
    of its multiply-adds otherwise), and equal at most steps."""
    lr = 1e-3
    sched = jax.jit(optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total, lr * 0.01))
    steps = np.arange(total + 5)
    want = np.asarray(jax.vmap(sched)(jnp.asarray(steps, jnp.int32)), np.float32)
    got = np.array([warmup_cosine_decay(int(s), 0.0, lr, warmup, total, lr * 0.01)
                    for s in steps], np.float32)
    np.testing.assert_array_equal(got[:warmup], want[:warmup])
    assert (np.abs(got - want) <= 2 * np.spacing(want)).all()
    assert (got == want).mean() >= 0.9, (got != want).sum()
    # and as the trainer's optimizer reads it
    tx = ttrain.DetOptimizer([torch.zeros(1)], ttrain.DetTrainConfig(), warmup, total)
    assert tx.lr(warmup) == float(want[warmup])


def test_ema_decay_and_update_match_jax():
    """The EMA decay: JAX's float32 within one float32 ulp of the
    exponential (6e-8) at every step of 0-30,000 and equal at nearly all
    (XLA's own exp rounds some results the other way, and 1 - e carries that
    ulp into the small decays of the first steps); the update
    e * d + p * (1 - d) on it."""
    steps = np.arange(30001)
    # the decay as the JAX trainer computes it: inside the jitted ema_update
    # (e * d + p * (1 - d) at e = 1, p = 0 is d)
    decay = jax.jit(jax.vmap(lambda s: jtrain.ema_update({"d": jnp.float32(1.0)},
                                                         {"d": jnp.float32(0.0)}, s)["d"]))
    want = np.asarray(decay(jnp.asarray(steps, jnp.int32)))
    got = np.array([ema_decay(int(s)) for s in steps], np.float32)
    assert np.abs(got - want).max() <= 2.0**-24
    assert (got == want).mean() >= 0.99
    rng = np.random.default_rng(0)
    e, p = rng.normal(size=(2, 500)).astype(np.float32)
    step = 1000
    w = np.asarray(jtrain.ema_update({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)},
                                     jnp.int32(step))["w"])
    te = [torch.from_numpy(e.copy())]
    ttrain.ema_update_(te, [torch.from_numpy(p)], step)
    np.testing.assert_allclose(te[0].numpy(), w, rtol=0, atol=1e-6)
