"""YOLOv8 output decoding (counterpart of pose6d_tpu/models/yolo/decode.py):
anchors, the DFL expectation, the full-field decode, class-aware greedy NMS
on static shapes, and the fused top-k decode `decode_topk_nms`.

Rankings follow jax.lax.top_k: among equal values the lower index comes
first. torch.topk promises no order for ties (on the card it can differ),
so every ranking here is a stable descending sort cut to its first k.
Scores are the sigmoid computed in float64 and rounded once to float32:
the card's and the CPU's float32 exp differ in the last bit, and the
float64 route gives the same float32 score on both (within a float32 ulp
of the JAX package's).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .model import YoloConfig


def make_anchors(img_size: Tuple[int, int], strides: Sequence[int], device=None):
    """Anchor cell centres (stride units) [A, 2] (x, y) and per-anchor
    stride [A], levels concatenated in order."""
    H, W = img_size
    pts, sts = [], []
    for s in strides:
        h, w = H // s, W // s
        xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
        ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        sts.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(pts, dim=0), torch.cat(sts, dim=0)


def dfl_expectation(box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Softmax over reg_max bins -> expected distance:
    [..., 4*reg_max] -> [..., 4] (l, t, r, b) in stride units."""
    x = box_logits.reshape(*box_logits.shape[:-1], 4, reg_max)
    p = torch.softmax(x, dim=-1)
    bins = torch.arange(reg_max, dtype=p.dtype, device=p.device)
    return (p * bins).sum(dim=-1)


def _sigmoid(logits: torch.Tensor) -> torch.Tensor:
    """float32 sigmoid that is the same bits on the card and the CPU."""
    return torch.sigmoid(logits.double()).float()


def _topk(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: the k largest values and their
    indices, the lower index first among equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _flatten_levels(outputs, cfg: YoloConfig):
    """Per-level (box, cls) maps -> box logits [B, A, 4*reg_max] and class
    logits [B, A, nc], levels concatenated in order."""
    B = outputs[0][0].shape[0]
    box = torch.cat([b.reshape(B, -1, 4 * cfg.reg_max) for b, _ in outputs], 1)
    cls = torch.cat([c.reshape(B, -1, cfg.num_classes) for _, c in outputs], 1)
    return box, cls


def _boxes_xyxy(ltrb, anchor, stride):
    x1y1 = (anchor - ltrb[..., :2]) * stride
    x2y2 = (anchor + ltrb[..., 2:]) * stride
    return torch.cat([x1y1, x2y2], dim=-1)


def decode_outputs(outputs, cfg: YoloConfig, img_size: Tuple[int, int]):
    """Per-level raw maps -> (boxes_xyxy [B, A, 4] pixels, scores [B, A, nc]
    sigmoid probabilities)."""
    box_logits, cls_logits = _flatten_levels(outputs, cfg)
    anchors, strides = make_anchors(img_size, cfg.strides, box_logits.device)
    ltrb = dfl_expectation(box_logits.float(), cfg.reg_max)
    return _boxes_xyxy(ltrb, anchors[None], strides[None, :, None]), _sigmoid(cls_logits.float())


def _at_least(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.maximum(x, c), gradient included: halved at x == c, as JAX's
    (torch.clamp_min would pass all of it)."""
    return torch.maximum(x, torch.full((), c, dtype=x.dtype, device=x.device))


def box_iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between [..., N, 4] and [..., M, 4] xyxy boxes ->
    [..., N, M], by the JAX package's operations (the training loss takes
    its gradient)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = _at_least(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = _at_least(a[..., 2] - a[..., 0], 0.0) * _at_least(a[..., 3] - a[..., 1], 0.0)
    area_b = _at_least(b[..., 2] - b[..., 0], 0.0) * _at_least(b[..., 3] - b[..., 1], 0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / _at_least(union, 1e-9)


def _greedy_suppress(top_boxes, top_score, top_cls, max_det: int, iou_thresh: float,
                     conf_thresh: float, fixpoint_iters: int | None) -> dict:
    """Greedy class-aware NMS over score-ordered candidates [B, k, ...]
    (the JAX package's, batched): {"boxes" [B, n, 4], "scores", "classes",
    "valid" [B, n]}, n = min(max_det, k).

    Greedy suppression is the fixpoint of F(S)_i = conf_i and no earlier j
    with iou[j, i] >= iou_thresh in S, iterated from keep_conf
    fixpoint_iters times (k when None: always exact); each step is one
    [k, k] masked reduction, with no wait for the device."""
    B, k = top_score.shape
    # class offset so that different classes never suppress each other; the
    # offset corners are f32 (at class 12 the spacing is 2^-7 px) and the
    # IoU is taken on them, as in the reference
    span = 1e4
    off_boxes = top_boxes + top_cls[..., None].float() * span
    iou = box_iou_xyxy(off_boxes, off_boxes)  # [B, k, k]

    keep_conf = top_score >= conf_thresh
    ar = torch.arange(k, device=top_score.device)
    suppresses = (iou >= iou_thresh) & (ar[:, None] < ar[None, :])  # [B, j, i], j < i

    kept = keep_conf
    for _ in range(k if fixpoint_iters is None else fixpoint_iters):
        kept = keep_conf & ~(suppresses & kept[..., :, None]).any(dim=-2)

    # compact the survivors to max_det slots (score order, ties by index)
    keep_score = torch.where(kept, top_score, torch.full_like(top_score, -1.0))
    sel_score, sel = _topk(keep_score, min(max_det, k))
    valid = sel_score > 0
    return {
        "boxes": torch.gather(top_boxes, 1, sel[..., None].expand(B, sel.shape[1], 4)),
        "scores": torch.where(valid, sel_score, torch.zeros_like(sel_score)),
        "classes": torch.where(valid, torch.gather(top_cls, 1, sel), torch.full_like(sel, -1)),
        "valid": valid,
    }


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, max_det: int = 100,
                pre_topk: int = 300, iou_thresh: float = 0.7, conf_thresh: float = 0.25,
                fixpoint_iters: int | None = None) -> dict:
    """Static-shape class-aware NMS per image: [B, A, 4] xyxy, [B, A, nc]
    -> dict of [B, min(max_det, k), ...], k = min(pre_topk, A). Candidates
    are the top k by best class score, then greedy suppression
    (_greedy_suppress)."""
    best_score, best_cls = scores.max(dim=-1)  # first class among equal scores
    k = min(pre_topk, boxes.shape[1])
    top_score, top_idx = _topk(best_score, k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(boxes.shape[0], k, 4))
    return _greedy_suppress(top_boxes, top_score, torch.gather(best_cls, 1, top_idx), max_det,
                            iou_thresh, conf_thresh, fixpoint_iters)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, **kw) -> dict:
    """batched_nms of one image: [A, 4], [A, nc] -> dict of [max_det, ...]."""
    return {k: v[0] for k, v in batched_nms(boxes[None], scores[None], **kw).items()}


def decode_topk_nms(outputs, cfg: YoloConfig, img_size: Tuple[int, int], max_det: int = 100,
                    pre_topk: int = 300, iou_thresh: float = 0.7, conf_thresh: float = 0.25,
                    fixpoint_iters: int | None = None) -> dict:
    """decode_outputs + batched_nms with the top-k BEFORE the DFL decode:
    the same results, but only the k candidates' box logits are decoded.
    Candidates are ranked in the network's dtype by their best class logit
    (sigmoid is monotone), and their box logits are gathered exactly.

    max_det=1: greedy NMS never suppresses the global best candidate, so
    slot 0 of the general path is the top-1 anchor decoded alone, with no
    IoU fixpoint: {"boxes" [B, 1, 4] xyxy pixels, "scores", "classes",
    "valid" [B, 1]}."""
    box_logits, cls_logits = _flatten_levels(outputs, cfg)
    B, A, _ = box_logits.shape
    anchors, strides = make_anchors(img_size, cfg.strides, box_logits.device)

    best_logit, best_cls = cls_logits.max(dim=-1)  # [B, A]
    if max_det == 1:
        top_logit, top_idx = best_logit.max(dim=-1, keepdim=True)  # [B, 1]
    else:
        top_logit, top_idx = _topk(best_logit, min(pre_topk, A))
    top_score = _sigmoid(top_logit.float())
    k = top_idx.shape[1]
    sel_logits = torch.gather(box_logits, 1,
                              top_idx[..., None].expand(B, k, box_logits.shape[-1])).float()
    sel_cls = torch.gather(best_cls, 1, top_idx)
    flat = top_idx.reshape(-1)
    top_boxes = _boxes_xyxy(dfl_expectation(sel_logits, cfg.reg_max),
                            anchors.index_select(0, flat).reshape(B, k, 2),
                            strides.index_select(0, flat).reshape(B, k, 1))
    if max_det != 1:
        return _greedy_suppress(top_boxes, top_score, sel_cls, max_det, iou_thresh,
                                conf_thresh, fixpoint_iters)
    valid = (top_score >= conf_thresh) & (top_score > 0)
    return {
        "boxes": top_boxes,
        "scores": torch.where(valid, top_score, torch.zeros_like(top_score)),
        "classes": torch.where(valid, sel_cls, torch.full_like(sel_cls, -1)),
        "valid": valid,
    }


def detect(model, images: torch.Tensor, cfg: YoloConfig, **nms_kw) -> dict:
    """Full inference: forward -> decode_outputs -> batched_nms, on
    [B, H, W, 3] images."""
    boxes, scores = decode_outputs(model(images), cfg, tuple(images.shape[1:3]))
    return batched_nms(boxes, scores, **nms_kw)
