"""YOLOv8 output decoding (counterpart of pose6d_tpu/models/yolo/decode.py):
anchors, the DFL expectation and the top-1 decode of `decode_topk_nms`.

Only the max_det=1 path is ported: greedy NMS never suppresses the global
best candidate, so slot 0 of the general path is the top-1 anchor decoded
alone. The general class-aware NMS path raises until its slice lands.
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


def decode_topk_nms(outputs, cfg: YoloConfig, img_size: Tuple[int, int],
                    max_det: int, conf_thresh: float = 0.25) -> dict:
    """Per image, the best-scoring anchor's box, score and class:
    {"boxes" [B, 1, 4] xyxy pixels, "scores" [B, 1], "classes" [B, 1],
    "valid" [B, 1]}. Ranking uses the max class logit (sigmoid is
    monotone); only the winner's DFL logits are decoded."""
    if max_det != 1:
        raise NotImplementedError("decode_topk_nms: only the max_det=1 path "
                                  "is ported; general NMS is a later slice")
    B = outputs[0][0].shape[0]
    box_logits = torch.cat([b.reshape(B, -1, 4 * cfg.reg_max) for b, _ in outputs], 1)
    cls_logits = torch.cat([c.reshape(B, -1, cfg.num_classes) for _, c in outputs], 1)
    anchors, strides = make_anchors(img_size, cfg.strides, box_logits.device)

    best_logit, best_cls = cls_logits.max(dim=-1)  # [B, A]
    top_logit, top_idx = best_logit.max(dim=-1, keepdim=True)  # [B, 1]
    top_score = torch.sigmoid(top_logit.float())
    sel_logits = torch.gather(
        box_logits, 1, top_idx[..., None].expand(B, 1, box_logits.shape[-1])).float()
    sel_cls = torch.gather(best_cls, 1, top_idx)
    sel_anchor = anchors[top_idx]  # [B, 1, 2]
    sel_stride = strides[top_idx][..., None]  # [B, 1, 1]

    ltrb = dfl_expectation(sel_logits, cfg.reg_max)
    x1y1 = (sel_anchor - ltrb[..., :2]) * sel_stride
    x2y2 = (sel_anchor + ltrb[..., 2:]) * sel_stride
    valid = (top_score >= conf_thresh) & (top_score > 0)
    return {
        "boxes": torch.cat([x1y1, x2y2], dim=-1),
        "scores": torch.where(valid, top_score, torch.zeros_like(top_score)),
        "classes": torch.where(valid, sel_cls, torch.full_like(sel_cls, -1)),
        "valid": valid,
    }
