"""pose6d_tpu_torch.models.yolo.decode's general path against the JAX
package: decode_outputs, box_iou_xyxy, nms_fixed / batched_nms, the
max_det > 1 branch of decode_topk_nms, detect, and PosePipeline with
max_objects > 1 (narrow YOLOv8, img_size 64, compute f32, the JAX
pipeline with jit disabled).

The same seeded numpy inputs go through both. Tolerances: classes, valid
and the kept candidates (each output box's row in the input) equal; scores
within 1e-5 (the port's sigmoid is float64 rounded once, JAX's float32);
boxes within 1e-4 px where they are decoded (softmax expectations in two
frameworks), equal where NMS only selects them. Planted ties check every
slot, invalid ones too: equal bf16 class logits rank by anchor index, and
suppressed candidates (keep score -1) compact in index order, as
jax.lax.top_k orders them. The class offset (1e4 px per class, added in
f32) is mirrored: at class 12 the corners sit on a 2^-7 px grid, and a
pair whose plain IoU passes the threshold passes it no longer there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.models.yolo import decode as jdec
from pose6d_tpu.models.yolo.model import YoloConfig as JYoloConfig, YoloV8 as JYoloV8
from pose6d_tpu_torch.convert import yolo_from_jax
from pose6d_tpu_torch.models.yolo import decode as tdec
from pose6d_tpu_torch.models.yolo.model import YoloConfig, YoloV8

from torch_port_utils import (assert_pipeline_parity, make_pipeline_pair, pipeline_request,
                              random_flax_variables)

H, W = 64, 96


def _outputs(rng, nc, batch=2, cls_mean=-2.0, dtype=np.float32):
    """Random per-level raw maps [(box [B,h,w,64], cls [B,h,w,nc])] as numpy."""
    out = []
    for s in (8, 16, 32):
        shape = (batch, H // s, W // s)
        out.append((rng.normal(0, 1.5, shape + (64,)).astype(dtype),
                    rng.normal(cls_mean, 2, shape + (nc,)).astype(dtype)))
    return out


def _to_jax(outputs, dtype=jnp.float32):
    return [(jnp.asarray(b, dtype), jnp.asarray(c, dtype)) for b, c in outputs]


def _to_torch(outputs, dtype=torch.float32):
    return [(torch.from_numpy(np.asarray(b, np.float32)).to(dtype),
             torch.from_numpy(np.asarray(c, np.float32)).to(dtype)) for b, c in outputs]


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _rows(boxes, table):
    """Each output box's row in `table` (its candidate index), -1 if none."""
    hit = (boxes[..., :, None, :] == table[..., None, :, :]).all(-1)
    return np.where(hit.any(-1), hit.argmax(-1), -1)


def assert_dets_equal(got, want, box_atol=0.0, table=None):
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=box_atol)
    if table is not None:
        np.testing.assert_array_equal(_rows(got["boxes"], table), _rows(want["boxes"], table))


def _field(rng, n, clustered):
    """n xyxy boxes and [n, 3] scores: uniform, or 8 tight clusters of
    n/8 boxes each (heavy mutual overlap, long suppression chains)."""
    if clustered:
        centers = np.repeat(rng.uniform(0, 80, (8, 2)), n // 8, axis=0) + rng.uniform(-4, 4, (n, 2))
        sizes = rng.uniform(10, 20, (n, 2))
    else:
        centers, sizes = rng.uniform(0, 90, (n, 2)), rng.uniform(4, 40, (n, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
    return boxes, rng.uniform(0.05, 1.0, (n, 3)).astype(np.float32)


def test_decode_outputs_match_jax():
    rng = np.random.default_rng(0)
    outputs = _outputs(rng, nc=4)
    gb, gs = tdec.decode_outputs(_to_torch(outputs), YoloConfig(num_classes=4), (H, W))
    wb, ws = jdec.decode_outputs(_to_jax(outputs), JYoloConfig(num_classes=4), (H, W))
    assert gb.shape == (2, 126, 4) and gs.shape == (2, 126, 4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-5)


def test_box_iou_matches_jax():
    rng = np.random.default_rng(1)
    a, _ = _field(rng, 24, clustered=True)
    b = np.concatenate([a[:10] + rng.uniform(-2, 2, (10, 4)), _field(rng, 6, False)[0]])
    b = b.astype(np.float32)
    b[3] = [5, 5, 5, 9]  # empty box: IoU 0 through the 1e-9 union floor
    got = tdec.box_iou_xyxy(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jdec.box_iou_xyxy(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (24, 16) and (got > 0.5).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got[:, 3], 0.0)


@pytest.mark.parametrize("fixpoint_iters", [None, 16])
@pytest.mark.parametrize("clustered", [False, True])
def test_nms_fixed_matches_jax(clustered, fixpoint_iters):
    rng = np.random.default_rng(2 + clustered)
    kw = dict(max_det=48, pre_topk=48, iou_thresh=0.5, conf_thresh=0.2,
              fixpoint_iters=fixpoint_iters)
    for _ in range(3):
        boxes, scores = _field(rng, 64, clustered)
        got = tdec.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
        want = jdec.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), **kw)
        assert got["boxes"].shape == (48, 4)
        assert 0 < int(got["valid"].sum()) < 48  # some kept, some dropped
        assert_dets_equal(got, want, table=boxes)


@pytest.mark.parametrize("fixpoint_iters", [None, 16])
def test_batched_nms_matches_jax(fixpoint_iters):
    rng = np.random.default_rng(4)
    fields = [_field(rng, 64, clustered=c) for c in (True, False, True)]
    boxes = np.stack([f[0] for f in fields])
    scores = np.stack([f[1] for f in fields])
    kw = dict(max_det=16, pre_topk=64, iou_thresh=0.45, conf_thresh=0.1,
              fixpoint_iters=fixpoint_iters)
    got = tdec.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    want = jdec.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    assert got["boxes"].shape == (3, 16, 4)
    assert_dets_equal(got, want, table=boxes)


def test_nms_bounded_fixpoint_equals_exact_on_dense_fields():
    """16 fixpoint iterations (PipelineConfig's default) keep the exact
    greedy set on clustered fields, and a deep chain needs all k."""
    rng = np.random.default_rng(11)
    for _ in range(5):
        boxes, scores = (torch.from_numpy(a) for a in _field(rng, 64, clustered=True))
        kw = dict(max_det=64, pre_topk=64, iou_thresh=0.5, conf_thresh=0.0)
        exact = tdec.nms_fixed(boxes, scores, **kw)
        fast = tdec.nms_fixed(boxes, scores, fixpoint_iters=16, **kw)
        for k in exact:
            assert torch.equal(exact[k], fast[k]), k
    # a line of 16 boxes, each overlapping only its neighbours: greedy keeps
    # every other one, which 1 fixpoint iteration does not find
    n = 16
    line = torch.tensor([[i * 6.0, 0.0, i * 6.0 + 10.0, 10.0] for i in range(n)])
    sc = torch.linspace(1.0, 0.5, n)[:, None]
    kw = dict(max_det=n, pre_topk=n, iou_thresh=0.2, conf_thresh=0.0)
    assert int(tdec.nms_fixed(line, sc, **kw)["valid"].sum()) == n // 2
    assert int(tdec.nms_fixed(line, sc, fixpoint_iters=1, **kw)["valid"].sum()) != n // 2


def test_decode_topk_nms_matches_two_step():
    """Mirror of tests/test_yolo.py::test_decode_topk_nms_matches_two_step:
    the fused top-k-before-DFL decode equals decode_outputs + batched_nms
    (same ranking, per-anchor DFL, same suppression); and both equal the
    JAX package's fused decode."""
    cfg = YoloConfig(num_classes=5)
    outputs = _outputs(np.random.default_rng(3), nc=5)
    kw = dict(max_det=8, pre_topk=32, iou_thresh=0.5, conf_thresh=0.1, fixpoint_iters=16)
    boxes, scores = tdec.decode_outputs(_to_torch(outputs), cfg, (H, W))
    ref = tdec.batched_nms(boxes, scores, **kw)
    got = tdec.decode_topk_nms(_to_torch(outputs), cfg, (H, W), **kw)
    for k in ("scores", "classes", "valid"):
        assert torch.equal(ref[k], got[k]), k
    np.testing.assert_allclose(ref["boxes"].numpy(), got["boxes"].numpy(), rtol=0, atol=1e-4)
    want = jdec.decode_topk_nms(_to_jax(outputs), JYoloConfig(num_classes=5), (H, W), **kw)
    assert_dets_equal(got, want, box_atol=1e-4)


def test_nms_top1_fast():
    """Mirror of tests/test_yolo.py::test_nms_top1_fast: the max_det=1
    decode equals slot 0 of the general path, including the conf-threshold
    invalidation (trial 2's lower logits and threshold send frames
    invalid)."""
    cfg = YoloConfig(num_classes=5)
    rng = np.random.default_rng(11)
    invalid = 0
    for trial in range(4):
        outputs = _to_torch(_outputs(rng, nc=5, batch=3, cls_mean=-4.0 if trial == 2 else -2.0))
        kw = dict(pre_topk=32, iou_thresh=0.5, conf_thresh=0.95 if trial == 2 else 0.1,
                  fixpoint_iters=16)
        full = tdec.decode_topk_nms(outputs, cfg, (H, W), max_det=8, **kw)
        fast = tdec.decode_topk_nms(outputs, cfg, (H, W), max_det=1, **kw)
        for k in ("scores", "classes", "valid"):
            assert torch.equal(full[k][:, :1], fast[k]), k
        np.testing.assert_allclose(full["boxes"][:, :1].numpy(), fast["boxes"].numpy(),
                                   rtol=0, atol=1e-4)
        invalid += int((~fast["valid"]).sum())
    assert invalid > 0


def test_planted_ties_in_bf16_class_logits():
    """bf16 class logits on a coarse grid: many anchors share the best
    logit and many anchors tie between classes. Ranking happens in bf16,
    so the candidate order among equal logits is the anchor index and the
    class among equal logits the first; every slot (invalid ones too, at
    conf 0.5) matches the JAX package."""
    rng = np.random.default_rng(5)
    outputs = _outputs(rng, nc=4, batch=3)
    tied = []
    for box, cls in outputs:
        # steps of 0.5 capped at 1: ties everywhere, ~1 anchor in 3 at the top
        c = np.minimum(np.round(rng.normal(0, 1.0, cls.shape) * 2) / 2, 1.0)
        c[..., 2] = c[..., 1]  # class 1 and 2 tie at every anchor
        tied.append((box, c.astype(np.float32)))
    flat = np.concatenate([c.reshape(3, -1, 4) for _, c in tied], 1).max(-1)
    assert (np.sort(flat, 1)[:, ::-1][:, :25] == 1.0).all()  # the 24 candidates tie
    kw = dict(max_det=16, pre_topk=24, iou_thresh=0.5, conf_thresh=0.5, fixpoint_iters=None)
    got = tdec.decode_topk_nms(_to_torch(tied, torch.bfloat16), YoloConfig(num_classes=4),
                               (H, W), **kw)
    want = jdec.decode_topk_nms(_to_jax(tied, jnp.bfloat16), JYoloConfig(num_classes=4),
                                (H, W), **kw)
    assert got["boxes"].shape == (3, 16, 4)
    assert not got["valid"].all() and got["valid"].any()
    assert set(got["classes"][got["valid"]].tolist()) <= {0, 1, 3}  # class 2 never wins a tie
    assert_dets_equal(got, want, box_atol=1e-4)


def test_planted_ties_among_suppressed_candidates():
    """Every candidate in one place with equal scores: all but the first of
    each class are suppressed (keep score -1), and the compaction lists the
    suppressed ones in index order; every slot's box matches JAX."""
    rng = np.random.default_rng(6)
    n = 32
    base = np.array([10.0, 10.0, 40.0, 40.0], np.float32)
    boxes = (base + rng.uniform(-1, 1, (n, 4))).astype(np.float32)
    scores = np.zeros((n, 3), np.float32)
    scores[np.arange(n), rng.integers(0, 3, n)] = 0.75  # one tie level across all
    kw = dict(max_det=n, pre_topk=n, iou_thresh=0.5, conf_thresh=0.0)
    got = tdec.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    want = jdec.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    assert int(got["valid"].sum()) == len(np.unique(scores.argmax(1)))
    assert_dets_equal(got, want, table=boxes)
    rows = _rows(got["boxes"].numpy(), boxes)
    np.testing.assert_array_equal(np.sort(rows), np.arange(n))
    assert (np.diff(rows[~got["valid"].numpy()]) > 0).all()  # index order


def test_class_offset_at_class_12():
    """Two boxes of class 12 whose plain IoU is 0.50004 (suppressed at 0.5):
    offset by 1.2e5 px in f32, the second box's corners round to the 2^-7
    grid and the IoU drops to 0.49970, so both are kept, in the port as in
    the JAX package. At class 0 the same pair suppresses."""
    boxes = np.array([[0.0, 0.0, 10.0, 10.0], [3.333, 0.0, 13.333, 10.0]], np.float32)
    kw = dict(max_det=2, pre_topk=2, iou_thresh=0.5, conf_thresh=0.0)
    plain = tdec.box_iou_xyxy(torch.from_numpy(boxes), torch.from_numpy(boxes))[0, 1].item()
    assert plain >= 0.5
    for cls, n_kept in ((12, 2), (0, 1)):
        scores = np.zeros((2, 13), np.float32)
        scores[:, cls] = [0.9, 0.8]
        got = tdec.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
        want = jdec.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), **kw)
        assert int(got["valid"].sum()) == n_kept, cls
        assert_dets_equal(got, want, table=boxes)


def test_detect_matches_jax():
    """detect (forward -> decode_outputs -> batched_nms) of a narrow YOLOv8
    against the flax model's, on inputs whose candidate ranking no
    difference between the frameworks' logits can reorder."""
    jcfg, tcfg = JYoloConfig(num_classes=3, width=0.125), YoloConfig(num_classes=3, width=0.125)
    jmodel = JYoloV8(jcfg)
    variables = random_flax_variables(jmodel, jnp.zeros((1, 64, 64, 3)), seed=3)
    tmodel = YoloV8(tcfg)
    tmodel.load_state_dict(yolo_from_jax(variables), strict=True)
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    kw = dict(max_det=6, pre_topk=12, iou_thresh=0.5, conf_thresh=0.0)
    with torch.no_grad():
        t_out = tmodel.eval()(torch.from_numpy(x))
        got = tdec.detect(tmodel, torch.from_numpy(x), tcfg, **kw)
    j_out = jmodel.apply(variables, jnp.asarray(x))
    best = [np.concatenate([np.asarray(c).reshape(2, -1, 3) for _, c in o], 1).max(-1)
            for o in (j_out, [(b, c.numpy()) for b, c in t_out])]
    noise = np.abs(best[0] - best[1]).max()
    gaps = -np.diff(np.sort(best[0], 1)[:, ::-1][:, :13], axis=1)
    assert (gaps > 10 * noise).all()
    want = jdec.detect(jmodel, variables, jnp.asarray(x), jcfg, **kw)
    assert_dets_equal(got, want, box_atol=1e-3)


@pytest.mark.parametrize("folded", [False, True], ids=["float", "folded"])
@pytest.mark.parametrize("variant", ["rgbd", "rgb_geometric"])
def test_pipeline_max_objects_matches_jax(variant, folded):
    """PosePipeline with max_objects=3 (NMS with 8 slots, the top 3 of each
    frame as a [B*3] pose batch, outputs [B, 3, ...]) against the JAX
    pipeline on 64x64 frames, nc 3, float and folded towers. Boxes within
    1e-3 px, scores 1e-5, classes and validity equal, rotations 1e-4,
    translations 1e-4 m."""
    jpipe, tpipe = make_pipeline_pair(variant, nc=3, max_objects=3)
    if folded:
        jpipe.fold_backbones()
        tpipe.fold_backbones()
    frames, K, depth = pipeline_request(4, (64, 64))
    args = (frames, K, depth) if variant == "rgbd" else (frames, K)
    with jax.disable_jit():
        want = jpipe(*args)
    got = tpipe(*args)
    assert got["rotation"].shape == (2, 3, 4) and got["bbox_xywh"].shape == (2, 3, 4)
    assert got["detections"]["boxes"].shape == (2, 8, 4)
    assert_pipeline_parity(got, want)
    # three different boxes per frame, each its own crop and pose
    assert (got["bbox_xywh"][:, 0] != got["bbox_xywh"][:, 1]).any(-1).all()
    assert not torch.allclose(got["rotation"][:, 0], got["rotation"][:, 1])
