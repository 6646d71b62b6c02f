"""YOLOv8 detection training loss (counterpart of
pose6d_tpu/models/yolo/loss.py): task-aligned assignment + CIoU + DFL + BCE.

  - Task-aligned assigner: align = score^0.5 * IoU^6, the top 10 anchors
    among those whose centres fall inside a gt box, conflicts resolved by
    the largest IoU, soft targets normalised per gt.
  - Losses: BCE on the soft class targets over every anchor, CIoU on the
    foreground, distribution-focal loss over the two bins around each
    target distance. Gains box 7.5, cls 0.5, dfl 1.5 (ultralytics').

Shapes are static (gt boxes padded to M with a mask) and the assigner runs
batched over [B, M, A] with selects, gathers and scatters only: no boolean
indexing and nothing that waits for the card.

Semantics kept from the JAX package, gradients included:
  - no stop_gradient in the assigner: the soft targets, the box weights
    sum(tgt_scores) and the normaliser tgt_sum carry gradients back into the
    class scores and the predicted boxes through the metric and the IoU
    (ultralytics detaches here; the JAX package does not);
  - rankings as lax.top_k (the lower index first among equal values) and
    argmax (the first maximum);
  - jnp.max reductions that carry gradients split them evenly among ties
    (torch.amax does the same), and jnp.maximum / jnp.clip against a
    constant split it in half at a tie (torch.maximum; torch.clamp would
    pass all of it).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .decode import _at_least, _topk, box_iou_xyxy

ALPHA = 0.5
BETA = 6.0
TOPK = 10
BOX_GAIN = 7.5
CLS_GAIN = 0.5
DFL_GAIN = 1.5
EPS = 1e-9


def ciou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complete IoU between matched box pairs [..., 4] -> [...]; the
    aspect-ratio weight alpha is held constant in the gradient."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    aw, ah = ax2 - ax1, ay2 - ay1
    bw, bh = bx2 - bx1, by2 - by1

    inter_w = _at_least(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), 0.0)
    inter_h = _at_least(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), 0.0)
    inter = inter_w * inter_h
    union = aw * ah + bw * bh - inter
    iou = inter / _at_least(union, EPS)

    # enclosing box diagonal, centre distance, aspect-ratio consistency
    cw = torch.maximum(ax2, bx2) - torch.minimum(ax1, bx1)
    ch = torch.maximum(ay2, by2) - torch.minimum(ay1, by1)
    c2 = cw * cw + ch * ch + EPS
    rho2 = ((ax1 + ax2 - bx1 - bx2) ** 2 + (ay1 + ay2 - by1 - by2) ** 2) / 4.0
    v = (4.0 / math.pi**2) * (torch.atan(bw / _at_least(bh, EPS))
                              - torch.atan(aw / _at_least(ah, EPS))) ** 2
    alpha = (v / _at_least(1.0 - iou + v, EPS)).detach()
    return iou - rho2 / c2 - alpha * v


def tal_assign(pred_scores: torch.Tensor, pred_boxes: torch.Tensor, anchor_pts: torch.Tensor,
               gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_mask: torch.Tensor) -> dict:
    """Task-aligned assignment of a batch: pred_scores [B, A, nc] sigmoid
    probabilities, pred_boxes [B, A, 4] xyxy pixels, anchor_pts [A, 2]
    anchor centres in pixels, gt_boxes [B, M, 4] xyxy pixels (padded),
    gt_labels [B, M] int, gt_mask [B, M] bool. Returns "boxes" [B, A, 4],
    "scores" [B, A, nc], "fg" [B, A] and "best_gt" [B, A] (the gt each
    anchor takes its target from; 0 where no gt claims it)."""
    B, A, nc = pred_scores.shape
    M = gt_boxes.shape[1]
    dev = pred_scores.device

    # candidates: anchor centre strictly inside the gt box
    x, y = anchor_pts[:, 0], anchor_pts[:, 1]
    inside = ((x > gt_boxes[..., 0:1]) & (x < gt_boxes[..., 2:3])
              & (y > gt_boxes[..., 1:2]) & (y < gt_boxes[..., 3:4]))  # [B, M, A]
    inside = inside & gt_mask[..., None]

    # alignment metric
    iou = _at_least(box_iou_xyxy(gt_boxes, pred_boxes), 0.0)  # [B, M, A]
    labels = gt_labels.long().clamp(0, nc - 1)
    cls_score = torch.gather(pred_scores.transpose(1, 2), 1,
                             labels[..., None].expand(B, M, A))  # [B, M, A]
    metric = cls_score**ALPHA * iou**BETA
    metric = torch.where(inside, metric, torch.zeros_like(metric))

    # top-k per gt (no gradient through the ranking, as in JAX)
    k = min(TOPK, A)
    topk_metric, topk_idx = _topk(metric.detach(), k)  # [B, M, k]
    is_topk = torch.zeros(B, M, A, dtype=torch.bool, device=dev).scatter(
        2, topk_idx, topk_metric > EPS)
    pos = is_topk & inside

    # conflict resolution: an anchor claimed by more than one gt goes to the
    # gt of the largest IoU, the first of equals
    iou_masked = torch.where(pos, iou.detach(), -1.0)
    m_idx = torch.arange(M, device=dev)[None, :, None]
    is_max = iou_masked == iou_masked.amax(dim=1, keepdim=True)
    best_gt = torch.where(is_max, m_idx, M).amin(dim=1)  # [B, A]
    fg = pos.any(dim=1)  # [B, A]

    tgt_boxes = torch.gather(gt_boxes, 1, best_gt[..., None].expand(B, A, 4))
    tgt_labels = torch.gather(labels, 1, best_gt)

    # normalised soft targets: metric * max_iou / max_metric per gt
    pos_after = (m_idx == best_gt[:, None, :]) & fg[:, None, :]  # [B, M, A]
    metric_pos = torch.where(pos_after, metric, torch.zeros_like(metric))
    iou_pos = torch.where(pos_after, iou, torch.zeros_like(iou))
    max_metric = metric_pos.amax(dim=2, keepdim=True)  # [B, M, 1]
    max_iou = iou_pos.amax(dim=2, keepdim=True)
    norm = metric_pos * max_iou / _at_least(max_metric, EPS)
    t = norm.amax(dim=1)  # [B, A]

    one_hot = tgt_labels[..., None] == torch.arange(nc, device=dev)
    tgt_scores = one_hot.to(t.dtype) * t[..., None]
    tgt_scores = torch.where(fg[..., None], tgt_scores, torch.zeros_like(tgt_scores))
    return {"boxes": tgt_boxes, "scores": tgt_scores, "fg": fg, "best_gt": best_gt}


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid binary cross-entropy with soft targets (no label
    smoothing); the gradient reaches the targets too."""
    return -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))


def detection_loss(box_logits: torch.Tensor, cls_logits: torch.Tensor, pred_boxes: torch.Tensor,
                   anchors: torch.Tensor, strides: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_mask: torch.Tensor, reg_max: int = 16) -> dict:
    """The detection loss of a batch: box_logits [B, A, 4*reg_max],
    cls_logits [B, A, nc], pred_boxes [B, A, 4] decoded xyxy pixels,
    anchors [A, 2] in stride units, strides [A], gt as tal_assign's.
    Returns {"total", "box", "cls", "dfl", "num_fg"} 0-dim tensors."""
    pred_scores = torch.sigmoid(cls_logits)
    anchor_px = anchors * strides[:, None]
    assign = tal_assign(pred_scores, pred_boxes, anchor_px, gt_boxes, gt_labels, gt_mask)
    fg, tgt_scores, tgt_boxes = assign["fg"], assign["scores"], assign["boxes"]

    tgt_sum = _at_least(tgt_scores.sum(), 1.0)
    zero = torch.zeros((), dtype=tgt_sum.dtype, device=tgt_sum.device)

    # classification: BCE with soft targets over all anchors
    cls_loss = sigmoid_bce(cls_logits, tgt_scores).sum() / tgt_sum

    # box: CIoU on foreground anchors, weighted by the target score
    weight = tgt_scores.sum(dim=-1)  # [B, A]
    ciou = ciou_xyxy(pred_boxes, tgt_boxes)
    box_loss = torch.where(fg, (1.0 - ciou) * weight, zero).sum() / tgt_sum

    # DFL: target ltrb = (anchor - x1y1 / stride, x2y2 / stride - anchor)
    s = strides[None, :, None]
    tgt_ltrb = torch.cat([anchors[None] - tgt_boxes[..., :2] / s,
                          tgt_boxes[..., 2:] / s - anchors[None]], dim=-1)
    tgt_ltrb = torch.clamp(tgt_ltrb, 0.0, reg_max - 1 - 0.01)  # [B, A, 4]
    tl = torch.floor(tgt_ltrb).long()
    tr = tl + 1
    wl = tr.to(tgt_ltrb.dtype) - tgt_ltrb
    wr = 1.0 - wl
    logp = F.log_softmax(box_logits.reshape(*box_logits.shape[:-1], 4, reg_max), dim=-1)
    ce_l = -torch.gather(logp, -1, tl[..., None])[..., 0]
    ce_r = -torch.gather(logp, -1, tr.clamp(0, reg_max - 1)[..., None])[..., 0]
    dfl = (ce_l * wl + ce_r * wr).mean(dim=-1)  # [B, A]
    dfl_loss = torch.where(fg, dfl * weight, zero).sum() / tgt_sum

    total = BOX_GAIN * box_loss + CLS_GAIN * cls_loss + DFL_GAIN * dfl_loss
    return {"total": total, "box": box_loss, "cls": cls_loss, "dfl": dfl_loss,
            "num_fg": fg.sum()}
