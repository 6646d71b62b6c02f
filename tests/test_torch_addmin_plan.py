"""The ADD-S nearest-point kernel's plan (ops/addmin.py addmin_plan) and its
split-and-merge argmin, on the CPU.

The kernel (csrc/addmin.cu) cannot run here, so these tests hold what
surrounds it: the plan fills the card at the serving shape and covers every
(predicted point, GT point) pair exactly once; a numpy emulation of the
kernel's split scans and (d^2, index) merge, on the kernel's own f32 d^2
(tests/torch_port_utils.kernel_d2), equals the single-pass first-index
argmin under every plan, with exact ties from padded clouds and planted
equidistant pairs; the wrapper hands its plan to the launch; and the port's
plain version agrees with the Pallas kernel run in interpret mode within
1e-6 m. The GPU tests hold the kernel itself to the same expected bits."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.ops.pallas_addmin import pairwise_min_dist_pallas
from pose6d_tpu_torch import _build
from pose6d_tpu_torch.ops import addmin
from pose6d_tpu_torch.ops.addmin import AddminPlan, addmin_plan
from torch_port_utils import addmin_expected, kernel_d2, padded_cloud, plant_ties

CHUNK = 512          # csrc/addmin.cu: GT points staged per pass
SMEM_LIMIT = 48 * 1024  # dynamic shared memory without an opt-in
FLT_MAX = np.float32(3.402823466e38)
FORCED = (AddminPlan(8, 1, 1), AddminPlan(8, 1, 4), AddminPlan(16, 2, 16),
          AddminPlan(64, 4, 3), AddminPlan(32, 2, 5), AddminPlan(12, 4, 7))


def pred_map(plan: AddminPlan, P: int):
    """The predicted point of each (block, thread, register) in one sample,
    as the kernel computes it; -1 where it is past P (masked)."""
    G = plan.tile // plan.r
    t = np.arange(plan.threads)
    local = (t % G)[:, None] + np.arange(plan.r)[None, :] * G
    pred = np.arange(math.ceil(P / plan.tile))[:, None, None] * plan.tile + local[None]
    return np.where(pred < P, pred, -1)


def split_scan(plan: AddminPlan, P: int, s: int) -> np.ndarray:
    """The GT points split s scans, in order, chunk by chunk, from the
    kernel's start formula (the least j >= c0 with j = s mod splits)."""
    out = []
    for c0 in range(0, P, CHUNK):
        n = min(CHUNK, P - c0)
        start = (s - c0 % plan.splits + plan.splits) % plan.splits
        out += [c0 + j for j in range(start, n, plan.splits)]
    return np.array(out, np.int64)


def emulate_argmin(d2: np.ndarray, plan: AddminPlan) -> np.ndarray:
    """The kernel's argmin on [P, P] f32 d^2: each split scans its GT points
    in order with a strict `<` from (FLT_MAX, 0), then the splits merge in
    the kernel's order (0, 1, ...) by (d^2, index)."""
    P = d2.shape[0]
    best = np.full((plan.splits, P), FLT_MAX, np.float32)
    arg = np.zeros((plan.splits, P), np.int64)
    for s in range(plan.splits):
        for j in split_scan(plan, d2.shape[1], s):
            lower = d2[:, j] < best[s]
            arg[s] = np.where(lower, j, arg[s])
            best[s] = np.minimum(best[s], d2[:, j])
    bb, aa = best[0].copy(), arg[0].copy()
    for s in range(1, plan.splits):
        take = (best[s] < bb) | ((best[s] == bb) & (arg[s] < aa))
        bb, aa = np.where(take, best[s], bb), np.where(take, arg[s], aa)
    return aa


def test_plan_fills_the_card_at_the_serving_shape():
    plan = addmin_plan(8, 500)
    assert plan.blocks(8, 500) >= addmin.SMS
    warps = plan.blocks(8, 500) * math.ceil(plan.threads / 32)
    assert warps >= 4 * addmin.SMS  # every scheduler holds a warp or more


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("P", [1, 129, 500, 2048, 5000])
def test_plan_covers_every_pair_once(B, P):
    plan = addmin_plan(B, P)
    assert plan.threads <= addmin.MAX_THREADS
    smem = min(P, CHUNK) * 16 + plan.splits * plan.tile * 8
    assert smem <= SMEM_LIMIT
    pred = pred_map(plan, P)
    assert pred.shape[0] * B == plan.blocks(B, P)
    # in each split, each predicted point held by exactly one (block,
    # thread, register)
    by_split = pred.reshape(pred.shape[0], plan.splits, -1, plan.r).swapaxes(0, 1)
    for held in by_split:
        assert np.array_equal(np.bincount(held[held >= 0], minlength=P), np.ones(P, np.int64))
    # the splits partition the GT points, each scanned in increasing order
    scans = [split_scan(plan, P, s) for s in range(plan.splits)]
    assert all(np.all(np.diff(js) > 0) for js in scans)
    assert np.array_equal(np.sort(np.concatenate(scans)), np.arange(P))
    # a thread scans its split for all its predicted points: each pair
    # (i, j) is covered once, by the thread of j's split that holds i


def _inputs(kind: str, rng, P: int = 200):
    """[P, 3] pred and gt, f32: random clouds, a cloud padded by repetition
    (exact d^2 ties between a point and its repeats), or planted pairs of
    GT points at equal f32 d^2 but different distances, the farther first."""
    if kind == "random":
        gt = rng.normal(0, 0.05, (P, 3)).astype(np.float32)
    else:
        gt = padded_cloud(rng, P, P * 2 // 3)
    pred = (gt[rng.permutation(P)] + rng.normal(0, 0.004, (P, 3))).astype(np.float32)
    if kind == "planted":
        for i in range(30):
            j1, j2 = sorted(rng.choice(P, 2, replace=False))
            assert plant_ties(rng, pred[i], gt, j1, j2)
    return pred, gt


@pytest.mark.parametrize("kind", ["random", "padded", "planted"])
@pytest.mark.parametrize("plan", FORCED + (addmin_plan(8, 500), addmin_plan(32, 500)),
                         ids=lambda p: f"t{p.tile}r{p.r}s{p.splits}")
def test_split_merge_equals_first_index_argmin(kind, plan):
    rng = np.random.default_rng(3)
    pred, gt = _inputs(kind, rng)
    d2 = kernel_d2(pred, gt)
    first = d2.argmin(-1)  # numpy's argmin: the first index at the minimum
    assert np.array_equal(emulate_argmin(d2, plan), first)
    if kind != "random":  # the ties are there, at the minimum
        at_min = (d2 == d2.min(-1, keepdims=True)).sum(-1)
        assert (at_min > 1).sum() >= 30


def test_planted_ties_change_the_distance():
    """A rule other than the first index (the last, or the smallest f64
    distance) gives other bits on the planted pairs."""
    rng = np.random.default_rng(3)
    pred, gt = _inputs("planted", rng)
    d2 = kernel_d2(pred, gt)
    first, last = d2.argmin(-1), d2.shape[1] - 1 - d2[:, ::-1].argmin(-1)
    want = addmin_expected(pred[None], gt[None])[0]
    other = addmin_expected(pred[None], gt[None, ::-1].copy())[0]
    assert (first != last).sum() >= 30
    assert not np.array_equal(want, other)


def _clouds(kind: str, P: int, seed: int):
    """Two samples of centred [P, 3] f32 clouds: "near", a padded model
    cloud and predicted points within millimetres of it (a trained
    network's); "apart", two independent clouds at 5 cm scale (the JAX
    package's own Pallas test inputs)."""
    rng = np.random.default_rng(seed)
    gt = np.stack([padded_cloud(rng, P, P - 20) for _ in range(2)]).astype(np.float64)
    gt -= gt.mean(1, keepdims=True)
    if kind == "near":
        pred = gt + rng.normal(0, 0.004, gt.shape)
    else:
        pred = rng.normal(0, 0.05, gt.shape)
    return pred.astype(np.float32), gt.astype(np.float32)


def _exact(pred, gt):
    return np.sqrt(((pred[:, :, None].astype(np.float64) - gt[:, None]) ** 2).sum(-1)).min(-1)


# The expansion |a|^2 + |b|^2 - 2 a.b is accurate in d^2 (addmin.
# expansion_d2_atol), not in d: where the nearest point is under a
# millimetre away, its sqrt is off by up to a few 1e-6 m. So the expansions
# (plain, Pallas) are held within 1e-6 m of each other and of the kernel on
# "apart" clouds, and in d^2 within that envelope on "near" ones; the
# kernel's difference form is within 1e-7 m of float64 on both.


@pytest.mark.parametrize("kind", ["near", "apart"])
@pytest.mark.parametrize("P", [129, 500])
def test_kernel_arithmetic_against_f64_and_plain(P, kind):
    """The kernel's expected output (first-index argmin of its f32 d^2, f64
    recompute) against float64 cdist and the plain version."""
    pred, gt = _clouds(kind, P, P)
    got = addmin_expected(pred, gt)
    assert np.abs(got - _exact(pred, gt)).max() <= 1e-7
    plain = addmin._pairwise_min_dist(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
    if kind == "apart":
        assert np.abs(got - plain).max() <= 1e-6
    else:
        sq = lambda d: d.astype(np.float64) ** 2  # noqa: E731
        tol = addmin.expansion_d2_atol(torch.from_numpy(pred), torch.from_numpy(gt))
        assert np.abs(sq(got) - sq(plain)).max() <= tol


@pytest.mark.parametrize("kind", ["near", "apart"])
@pytest.mark.parametrize("P", [129, 500])
def test_plain_matches_pallas_interpret(P, kind):
    """The port's plain version against pairwise_min_dist_pallas, which
    runs in interpret mode off the TPU, at B = 2: within 1e-6 m on "apart"
    clouds, within the expansion's envelope in d^2 on "near" ones."""
    pred, gt = _clouds(kind, P, 10 + P)
    want = np.asarray(pairwise_min_dist_pallas(jnp.asarray(pred), jnp.asarray(gt)))
    got = addmin._pairwise_min_dist(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
    assert want.shape == got.shape == (2, P)
    if kind == "apart":
        assert np.abs(got - want).max() <= 1e-6
    else:
        sq = lambda d: d.astype(np.float64) ** 2  # noqa: E731
        tol = addmin.expansion_d2_atol(torch.from_numpy(pred), torch.from_numpy(gt))
        assert np.abs(sq(got) - sq(want)).max() <= tol


@pytest.mark.parametrize("forced", [None, AddminPlan(32, 4, 8)], ids=["default", "forced"])
def test_wrapper_hands_the_plan_to_the_launch(monkeypatch, forced):
    """The wrapper launches with addmin_plan(B, P), or the plan it is given
    (tensors on the meta device stand in for a card's; the card check, the
    guard's stream and the launch are patched)."""
    calls = []
    monkeypatch.setattr(_build, "check_on_card", lambda x, tensors=(): None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: _NullGuard())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 77})())
    monkeypatch.setattr(addmin, "_launch_addmin", lambda *args: calls.append(args))
    pts = torch.empty(8, 500, 3, device="meta")
    before = _build.launch_counts["pairwise_min_dist"]
    out = addmin.pairwise_min_dist_kernel(pts, pts, plan=forced)
    assert tuple(out.shape) == (8, 500)
    (pred, gt, _, plan, stream), = calls
    assert plan == (forced or addmin_plan(8, 500)) and stream == 77
    assert _build.launch_counts["pairwise_min_dist"] == before + 1


class _NullGuard:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("bad", [(8, 3, 1), (8, 8, 1), (6, 4, 1), (2, 4, 1), (8, 2, 0),
                                 (64, 1, 17)])
def test_invalid_plans_are_refused(bad):
    """R outside {1, 2, 4}, a tile not a multiple of R or below it, no
    split, or more than 1024 threads."""
    with pytest.raises(ValueError):
        AddminPlan(*bad)
