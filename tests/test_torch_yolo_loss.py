"""The port's detection loss (pose6d_tpu_torch/models/yolo/loss.py) against
the JAX package's (pose6d_tpu/models/yolo/loss.py) on the CPU: ciou_xyxy,
tal_assign and detection_loss on seeded predictions. The port in float64
against JAX under jax.enable_x64: losses and the gradients with respect to
both logit tensors (and the predicted boxes) within 1e-9 relative, fg and
the assigned gt (through the target boxes, the gt boxes being distinct)
equal, with planted top-k, metric and IoU ties. f32 against f32 on inputs
without near-ties within 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.models.yolo import loss as jloss
from pose6d_tpu.models.yolo.decode import dfl_expectation as j_dfl
from pose6d_tpu_torch.models.yolo import loss as tloss
from pose6d_tpu_torch.models.yolo.decode import dfl_expectation, make_anchors
from torch_port_utils import few_torch_threads  # noqa: F401

IMG, NC, REG_MAX = 64, 3, 16
STRIDES = (8, 16, 32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-300)
    return float(np.abs(got - want).max()) / scale


def _anchors():
    anchors, strides = make_anchors((IMG, IMG), STRIDES)
    return anchors.numpy().astype(np.float64), strides.numpy().astype(np.float64)


def _scene(seed: int, ties: bool):
    """B=3 images of A anchors: class logits [B, A, NC], box logits
    [B, A, 4*REG_MAX], pred boxes [B, A, 4] (around each anchor), and
    M=4 padded gts (image 2 has none). With ties: 14 anchors inside image
    0's first gt predict one box with one score (equal metrics across the
    top-k boundary and at the per-gt max), and image 1's last two gts are
    one box with two labels (equal IoUs in the conflict rule)."""
    rng = np.random.default_rng(seed)
    anchors, strides = _anchors()
    A = anchors.shape[0]
    B, M = 3, 4
    px = anchors * strides[:, None]
    half = rng.uniform(4.0, 14.0, (B, A, 2))
    pred_boxes = np.concatenate([px - half + rng.normal(0, 1.5, (B, A, 2)),
                                 px + half + rng.normal(0, 1.5, (B, A, 2))], -1)
    cls_logits = rng.normal(-1.0, 1.0, (B, A, NC))
    box_logits = rng.normal(0.0, 1.0, (B, A, 4 * REG_MAX))
    gt = np.zeros((B, M, 4))
    for b in range(B):
        for m in range(M):
            x1, y1 = rng.uniform(0, 36, 2)
            w, h = rng.uniform(14, 28, 2)
            gt[b, m] = (x1, y1, min(x1 + w, IMG - 0.5), min(y1 + h, IMG - 0.5))
    labels = rng.integers(0, NC, (B, M))
    mask = np.array([[True, True, True, False], [True, True, True, True], [False] * M])
    if ties:
        gt[0, 0] = (4.25, 4.25, 44.75, 44.75)
        inside = np.flatnonzero((px[:, 0] > 4.25) & (px[:, 0] < 44.75)
                                & (px[:, 1] > 4.25) & (px[:, 1] < 44.75))[:14]
        pred_boxes[0, inside] = (10.0, 9.0, 40.0, 41.0)
        cls_logits[0, inside, labels[0, 0]] = 0.75
        gt[1, 3] = gt[1, 2]
        labels[1, 3] = (labels[1, 2] + 1) % NC
    return {"cls": cls_logits, "box": box_logits, "pred_boxes": pred_boxes, "gt": gt,
            "labels": labels.astype(np.int32), "mask": mask, "anchors": anchors,
            "strides": strides}


def _jax_assign(s, pred_scores, pred_boxes):
    anchor_px = jnp.asarray(s["anchors"] * s["strides"][:, None])
    return jax.vmap(lambda sc, bx, gb, gl, gm: jloss.tal_assign(sc, bx, anchor_px, gb, gl, gm))(
        pred_scores, pred_boxes, jnp.asarray(s["gt"]), jnp.asarray(s["labels"]),
        jnp.asarray(s["mask"]))


def _port_assign(s, pred_scores, pred_boxes):
    anchor_px = torch.from_numpy(s["anchors"] * s["strides"][:, None])
    return tloss.tal_assign(pred_scores, pred_boxes, anchor_px, torch.from_numpy(s["gt"]),
                            torch.from_numpy(s["labels"]), torch.from_numpy(s["mask"]))


def test_ciou_matches_jax_float64():
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.uniform(0, 50, (64, 2)), rng.uniform(51, 100, (64, 2))], -1)
    b = np.concatenate([rng.uniform(0, 50, (64, 2)), rng.uniform(51, 100, (64, 2))], -1)
    b[:8] = a[:8]  # identical pairs
    b[8:16, :2] = a[8:16, 2:] + 5.0  # disjoint pairs
    b[8:16, 2:] = b[8:16, :2] + 10.0
    b[16:24, 0] = a[16:24, 2]  # touching pairs: the overlap's width is 0, a
    b[16:24, 2] = a[16:24, 2] + 20.0  # tie of jnp.clip whose gradient JAX halves
    wa = rng.normal(size=64)
    with jax.enable_x64(True):
        f = lambda x, y: jnp.sum(jloss.ciou_xyxy(x, y) * wa)  # noqa: E731
        want = np.asarray(jloss.ciou_xyxy(jnp.asarray(a), jnp.asarray(b)))
        ga, gb = (np.asarray(g) for g in jax.grad(f, (0, 1))(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    got = tloss.ciou_xyxy(ta, tb)
    (got * torch.from_numpy(wa)).sum().backward()
    assert _rel(got.detach(), want) <= 1e-12
    assert _rel(ta.grad, ga) <= 1e-9 and _rel(tb.grad, gb) <= 1e-9


@pytest.mark.parametrize("ties", [False, True])
def test_tal_assign_matches_jax_float64(ties):
    s = _scene(1, ties)
    scores = 1.0 / (1.0 + np.exp(-s["cls"]))
    w_scores = np.random.default_rng(2).normal(size=(3, s["anchors"].shape[0], NC))
    with jax.enable_x64(True):
        want = _jax_assign(s, jnp.asarray(scores), jnp.asarray(s["pred_boxes"]))
        want = {k: np.asarray(v) for k, v in want.items()}

        def f(sc, bx):
            out = _jax_assign(s, sc, bx)
            return jnp.sum(out["scores"] * w_scores)

        g_sc, g_bx = (np.asarray(g) for g in jax.grad(f, (0, 1))(jnp.asarray(scores),
                                                                 jnp.asarray(s["pred_boxes"])))
    t_sc = torch.tensor(scores, requires_grad=True)
    t_bx = torch.tensor(s["pred_boxes"], requires_grad=True)
    got = _port_assign(s, t_sc, t_bx)
    (got["scores"] * torch.from_numpy(w_scores)).sum().backward()

    np.testing.assert_array_equal(got["fg"].numpy(), want["fg"])
    assert want["fg"].sum() > 10
    np.testing.assert_array_equal(got["boxes"].detach().numpy(), want["boxes"])
    # the gt boxes of a batch row are distinct but for the planted pair, so
    # equal target boxes pin best_gt; the pair is told apart by its label
    want_best = np.stack([[np.flatnonzero((s["gt"][b] == row).all(1))[0] for row in want["boxes"][b]]
                          for b in range(3)])
    np.testing.assert_array_equal(got["best_gt"].numpy(), want_best)
    assert _rel(got["scores"].detach(), want["scores"]) <= 1e-12
    assert _rel(t_sc.grad, g_sc) <= 1e-9 and _rel(t_bx.grad, g_bx) <= 1e-9
    if ties:
        # the planted pair: the first of equal IoUs takes the anchor
        assert not (got["best_gt"][1] == 3).any() and (got["best_gt"][1] == 2).any()
        # 14 tied candidates, 10 taken: the lowest anchor indices
        fg0 = np.flatnonzero(want["fg"][0] & (want_best[0] == 0))
        assert len(fg0) == 10


def _losses_jax(s, box, cls, pred_boxes, from_dfl: bool):
    anchors, strides = jnp.asarray(s["anchors"]), jnp.asarray(s["strides"])
    if from_dfl:
        ltrb = j_dfl(box, REG_MAX)
        pred_boxes = jnp.concatenate([(anchors[None] - ltrb[..., :2]) * strides[None, :, None],
                                      (anchors[None] + ltrb[..., 2:]) * strides[None, :, None]], -1)
    return jloss.detection_loss(box, cls, pred_boxes, anchors, strides, jnp.asarray(s["gt"]),
                                jnp.asarray(s["labels"]), jnp.asarray(s["mask"]), REG_MAX)


def _losses_port(s, box, cls, pred_boxes, from_dfl: bool):
    anchors, strides = torch.from_numpy(s["anchors"]), torch.from_numpy(s["strides"])
    anchors, strides = anchors.to(box.dtype), strides.to(box.dtype)
    if from_dfl:
        ltrb = dfl_expectation(box, REG_MAX)
        pred_boxes = torch.cat([(anchors[None] - ltrb[..., :2]) * strides[None, :, None],
                                (anchors[None] + ltrb[..., 2:]) * strides[None, :, None]], -1)
    return tloss.detection_loss(box, cls, pred_boxes, anchors, strides,
                                torch.from_numpy(s["gt"]).to(box.dtype),
                                torch.from_numpy(s["labels"]), torch.from_numpy(s["mask"]), REG_MAX)


@pytest.mark.parametrize("ties,from_dfl", [(False, True), (True, False), (False, False)])
def test_detection_loss_matches_jax_float64(ties, from_dfl):
    """Every component and the gradients of the total with respect to the
    box and class logits (and the boxes, when they are an input)."""
    s = _scene(3, ties)
    keys = ("total", "box", "cls", "dfl")
    with jax.enable_x64(True):
        args = [jnp.asarray(s[k]) for k in ("box", "cls", "pred_boxes")]
        want = {k: float(v) for k, v in _losses_jax(s, *args, from_dfl).items()}
        grads = jax.grad(lambda *a: _losses_jax(s, *a, from_dfl)["total"], (0, 1, 2))(*args)
        grads = [np.asarray(g) for g in grads]
    targs = [torch.tensor(s[k], requires_grad=True) for k in ("box", "cls", "pred_boxes")]
    got = _losses_port(s, *targs, from_dfl)
    got["total"].backward()
    assert int(got["num_fg"]) == int(want["num_fg"]) > 0
    for k in keys:
        assert abs(float(got[k].detach()) - want[k]) <= 1e-9 * abs(want[k]), k
    for t, g, name in zip(targs, grads, ("box", "cls", "pred_boxes")):
        if from_dfl and name == "pred_boxes":
            continue
        assert _rel(t.grad, g) <= 1e-9, name


def test_detection_loss_matches_jax_float32():
    s = _scene(4, False)
    for k in ("box", "cls", "pred_boxes", "gt", "anchors", "strides"):
        s[k] = s[k].astype(np.float32)
    args = [jnp.asarray(s[k]) for k in ("box", "cls", "pred_boxes")]
    want = {k: float(v) for k, v in _losses_jax(s, *args, True).items()}
    got = _losses_port(s, *(torch.from_numpy(s[k]) for k in ("box", "cls", "pred_boxes")), True)
    assert int(got["num_fg"]) == int(want["num_fg"])
    for k in ("total", "box", "cls", "dfl"):
        assert abs(float(got[k]) - want[k]) <= 1e-5 * abs(want[k]), k
    # and the assignment itself
    scores = (1.0 / (1.0 + np.exp(-s["cls"].astype(np.float64)))).astype(np.float32)
    want_a = _jax_assign(s, jnp.asarray(scores), jnp.asarray(s["pred_boxes"]))
    got_a = _port_assign(s, torch.from_numpy(scores), torch.from_numpy(s["pred_boxes"]))
    np.testing.assert_array_equal(got_a["fg"].numpy(), np.asarray(want_a["fg"]))
    np.testing.assert_array_equal(got_a["boxes"].numpy(), np.asarray(want_a["boxes"]))


def test_detection_loss_without_gt_is_background_only():
    """No gt anywhere: no foreground, box and dfl 0, cls the BCE against
    all-zero targets; as in JAX."""
    s = _scene(5, False)
    s["mask"][:] = False
    with jax.enable_x64(True):
        want = _losses_jax(s, *(jnp.asarray(s[k]) for k in ("box", "cls", "pred_boxes")), True)
        want = {k: float(v) for k, v in want.items()}
    got = _losses_port(s, *(torch.from_numpy(s[k]) for k in ("box", "cls", "pred_boxes")), True)
    assert int(got["num_fg"]) == 0 and float(got["box"]) == 0.0 and float(got["dfl"]) == 0.0
    assert abs(float(got["cls"]) - want["cls"]) <= 1e-12 * want["cls"]
