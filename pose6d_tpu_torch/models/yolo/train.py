"""YOLOv8 detector training (counterpart of pose6d_tpu/models/yolo/train.py):
the guarded train step, device augmentation, EMA, mAP@50 and the trainer.

    DetectionTrainer(source_root, save_dir).fit()   # DetTrainConfig()'s recipe

The recipe is the JAX trainer's: YOLOv8n from the flax init rules, 640,
batch 16, AdamW (lr 1e-3, 3-epoch linear warmup into cosine decay to 1e-5,
weight decay 5e-4) after a global-norm clip at 10, HSV + flip + affine
augmentation on the card, a ramped EMA of the parameters for validation and
export, `last` every epoch and `best` when mAP@50 rises, with full-state
resume. There is no mosaic (ultralytics' close_mosaic turns it off for
the whole of the reference's 5-epoch run).

Where the JAX package threads immutable trees through jitted functions,
the port updates the module and the optimizer in place. Random draws come
from a torch.Generator on the card (seeded with seed * 7919 + epoch, where
JAX derives its key); each augmentation is split into a draw half and an
apply half, so that the apply half can be held against JAX's on JAX's own
draws. The step takes a batch already on the card and never waits for it:
the non-finite guard is a flag on the card, and the learning rate and the
EMA decay are host numbers from the step count the host keeps.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import DEFAULT_DEVICE
from ...ops.augment import _hsv_to_rgb, _rgb_to_hsv, to_float01
from ...train.loop import clip_by_global_norm_, global_norm, to_device
from ...train.schedule import ema_decay, warmup_cosine_decay
from ..resnet import BatchNorm
from .decode import (_boxes_xyxy, _flatten_levels, batched_nms, decode_outputs,
                     dfl_expectation, make_anchors)
from .loss import detection_loss
from .model import YoloConfig, YoloV8, flax_init_

LOG_HEADER = "epoch,train_loss,map50,best_map50,lr,epoch_seconds\n"  # the JAX trainer's


@dataclasses.dataclass(frozen=True)
class DetTrainConfig:
    img_size: int = 640
    batch_size: int = 16
    epochs: int = 5
    learning_rate: float = 1e-3
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    flip_p: float = 0.5
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    # ultralytics random_perspective defaults (degrees/shear/perspective = 0):
    # scale ~ U(1-0.5, 1+0.5), centre moved by +-10% of the image size
    affine_scale: float = 0.5
    affine_translate: float = 0.1
    seed: int = 42


# -------------------------------------------------------------- augmentation


def draw_det_augment(generator: torch.Generator, batch: int, cfg: DetTrainConfig,
                     device) -> Dict[str, torch.Tensor]:
    """The per-image draws of one step, on `device` from `generator`:
    "hsv" [B, 3] gains (hue shift in [-h, h], saturation and value factors
    in 1 +- s, 1 +- v), "flip" [B] bool (probability flip_p), "affine"
    [B, 3] (scale s in 1 +- affine_scale, the centre (cx, cy) in 0.5 +-
    affine_translate of the frame). JAX's distributions, not its stream."""
    u = torch.rand((batch, 7), generator=generator, device=device)

    def between(col, lo, hi):
        return u[:, col] * (hi - lo) + lo

    hsv = torch.stack([between(0, -cfg.hsv_h, cfg.hsv_h), 1.0 + between(1, -cfg.hsv_s, cfg.hsv_s),
                       1.0 + between(2, -cfg.hsv_v, cfg.hsv_v)], dim=-1)
    t = cfg.affine_translate
    affine = torch.stack([between(4, 1.0 - cfg.affine_scale, 1.0 + cfg.affine_scale),
                          between(5, 0.5 - t, 0.5 + t), between(6, 0.5 - t, 0.5 + t)], dim=-1)
    return {"hsv": hsv, "flip": u[:, 3] < cfg.flip_p, "affine": affine}


def hsv_apply(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Per-image HSV gains [B, 3] (hue shift, saturation and value factors)
    on [B, H, W, 3] images in [0, 1] (ultralytics augment_hsv analogue)."""
    hsv = _rgb_to_hsv(img)
    gh, gs, gv = (gains[:, i, None, None] for i in range(3))
    h = torch.remainder(hsv[..., 0] + gh, 1.0)
    s = torch.clamp(hsv[..., 1] * gs, 0.0, 1.0)
    v = torch.clamp(hsv[..., 2] * gv, 0.0, 1.0)
    return _hsv_to_rgb(torch.stack([h, s, v], dim=-1))


def flip_apply(img: torch.Tensor, boxes: torch.Tensor, take: torch.Tensor, width: int):
    """Horizontal flip of the images [B, H, W, 3] where take [B] and of
    their xyxy boxes [B, M, 4]."""
    flipped = torch.stack([width - boxes[..., 2], boxes[..., 1], width - boxes[..., 0],
                           boxes[..., 3]], dim=-1)
    return (torch.where(take[:, None, None, None], img.flip(2), img),
            torch.where(take[:, None, None], flipped, boxes))


def scale_translate_weights(n: int, scale: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """jax.image.scale_and_translate's weight matrix along one axis of size
    n (jax/_src/image/scale.py compute_weight_mat) with the linear
    (triangle) kernel and antialias, per image: scale, translation [B] ->
    [B, n_in, n_out], in their dtype. Output pixel o samples the input at
    (o + 0.5) / s - t / s - 0.5; when shrinking, the triangle widens by 1/s;
    each column is normalised by its weight sum, and zero where the sum is
    (near) 0 or the sample lies outside [-0.5, n - 0.5]."""
    dtype, dev = scale.dtype, scale.device
    inv = 1.0 / scale
    kernel_scale = torch.maximum(inv, torch.ones((), dtype=dtype, device=dev))
    pos = torch.arange(n, dtype=dtype, device=dev)
    sample_f = (pos + 0.5)[None, :] * inv[:, None] - (translation * inv)[:, None] - 0.5
    x = (sample_f[:, None, :] - pos[None, :, None]).abs() / kernel_scale[:, None, None]
    w = torch.clamp_min(1.0 - x, 0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def affine_apply(img: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor,
                 params: torch.Tensor, fill: float = 114.0 / 255.0):
    """Scale + translate of each image [B, H, W, 3] in [0, 1] and its xyxy
    boxes [B, M, 4] by params [B, 3] = (s, cx, cy): out(x) = in((x - t) / s)
    with the scaled image's centre at (cx W, cy H), as JAX's
    scale_and_translate(method="linear", antialias=True) computes it (two
    batched matmuls with the weight matrices of scale_translate_weights);
    pixels from outside the frame take the gray `fill`. Boxes follow, are
    clipped to the frame, and survive (mask [B, M]) by ultralytics'
    box_candidates (w, h > 2 px, area ratio > 0.1, aspect < 100)."""
    B, H, W, C = img.shape
    s, cx, cy = params.unbind(-1)
    tx = cx * W - s * (W / 2.0)
    ty = cy * H - s * (H / 2.0)
    wh = scale_translate_weights(H, s, ty).to(img.dtype)  # [B, H, Ho]
    ww = scale_translate_weights(W, s, tx).to(img.dtype)  # [B, W, Wo]
    rows = torch.bmm(wh.transpose(1, 2), img.reshape(B, H, W * C)).reshape(B, H, W, C)
    scaled = torch.bmm(rows.permute(0, 1, 3, 2).reshape(B, H * C, W), ww)
    scaled = scaled.reshape(B, H, C, W).permute(0, 1, 3, 2)
    coverage = wh.sum(dim=1)[:, :, None] * ww.sum(dim=1)[:, None, :]
    out = scaled + (1.0 - coverage[..., None]) * fill

    s_, tx_, ty_ = s[:, None], tx[:, None], ty[:, None]
    nx1 = torch.clamp(boxes[..., 0] * s_ + tx_, 0.0, W)
    ny1 = torch.clamp(boxes[..., 1] * s_ + ty_, 0.0, H)
    nx2 = torch.clamp(boxes[..., 2] * s_ + tx_, 0.0, W)
    ny2 = torch.clamp(boxes[..., 3] * s_ + ty_, 0.0, H)
    new_boxes = torch.stack([nx1, ny1, nx2, ny2], dim=-1)
    w0 = (boxes[..., 2] - boxes[..., 0]) * s_
    h0 = (boxes[..., 3] - boxes[..., 1]) * s_
    w1, h1 = nx2 - nx1, ny2 - ny1
    eps = 1e-6
    ar = torch.maximum(w1 / (h1 + eps), h1 / (w1 + eps))
    keep = (w1 > 2.0) & (h1 > 2.0) & (w1 * h1 / (w0 * h0 + eps) > 0.1) & (ar < 100.0)
    return out, new_boxes, mask & keep


def augment_batch(images: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor,
                  draws: Dict[str, torch.Tensor], cfg: DetTrainConfig):
    """HSV, then flip, then (when configured) affine, on a batch: uint8 or
    [0, 1] float images [B, S, S, 3], boxes [B, M, 4], mask [B, M]."""
    imgs = hsv_apply(to_float01(images), draws["hsv"])
    imgs, boxes = flip_apply(imgs, boxes, draws["flip"], cfg.img_size)
    if cfg.affine_scale > 0.0 or cfg.affine_translate > 0.0:
        imgs, boxes, mask = affine_apply(imgs, boxes, mask, draws["affine"])
    return imgs, boxes, mask


# ----------------------------------------------------------------- optimizer


class DetOptimizer:
    """optax.chain(clip_by_global_norm(10), adamw(warmup_cosine_decay(0, lr,
    warmup, total, lr / 100), weight_decay)) written out, with the JAX
    step's non-finite guard: on a step whose flag `finite` (a 0-dim bool on
    the card) is false the gradients count as zeros, Adam's moments and
    count still advance with them, and the update is zero, so the
    parameters stay bitwise as they were. torch.optim.AdamW given zero
    gradients would still move them (momentum, decoupled decay).

    Adam as optax's: b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    bias corrections 1 - b^count; the weight decay is added to the update
    before the learning rate scales it, on every parameter. The count is
    the host's, so the learning rate and the corrections are host numbers
    and no step waits for the card."""

    B1, B2, EPS = 0.9, 0.999, 1e-8
    MAX_NORM = 10.0

    def __init__(self, params, cfg: DetTrainConfig, warmup_steps: int, total_steps: int):
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.peak_lr, self.weight_decay = cfg.learning_rate, cfg.weight_decay
        self.warmup_steps, self.total_steps = warmup_steps, total_steps

    def lr(self, count: int) -> float:
        return warmup_cosine_decay(count, 0.0, self.peak_lr, self.warmup_steps, self.total_steps,
                                   self.peak_lr * 0.01)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, finite: torch.Tensor) -> None:
        grads = [torch.where(finite, p.grad, 0.0) for p in self.params]
        clip_by_global_norm_(grads, self.MAX_NORM, global_norm(grads))
        b1, b2 = self.B1, self.B2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        count = self.count + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(b1) ** count)
        bc2 = float(f32(1.0) - f32(b2) ** count)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        update = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(update, -self.lr(self.count))
        # the update is finite whatever the batch (the moments only ever
        # saw finite gradients), so a multiply zeroes it exactly
        torch._foreach_mul_(update, finite.to(update[0].dtype))
        torch._foreach_add_(self.params, update)
        self.count = count

    def state_dict(self) -> dict:
        return {"mu": [m.detach().cpu().clone() for m in self.mu],
                "nu": [n.detach().cpu().clone() for n in self.nu], "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            if len(state[key]) != len(dst):
                raise ValueError(f"{key}: {len(state[key])} tensors for {len(dst)} parameters")
            for d, s in zip(dst, state[key]):
                d.copy_(s)
        self.count = int(state["count"])


def bn_buffers(model: torch.nn.Module) -> List[torch.Tensor]:
    """Every BatchNorm running mean and variance of `model`."""
    return [b for m in model.modules() if isinstance(m, BatchNorm)
            for b in (m.running_mean, m.running_var)]


def make_det_train_step(cfg: DetTrainConfig, ycfg: YoloConfig, device=DEFAULT_DEVICE):
    """The guarded train step: (model, tx, batch, draws) -> losses
    {"total", "box", "cls", "dfl", "num_fg"} (0-dim tensors on the card).
    batch holds "image" [B, S, S, 3] (uint8 or [0, 1] float), "gt_boxes"
    [B, M, 4] xyxy pixels, "gt_labels" [B, M], "gt_mask" [B, M], already
    on the model's device; draws are draw_det_augment's. Augment,
    train-mode forward (BatchNorm on batch statistics, running statistics
    updated as flax does), the DFL-decoded boxes, the loss, backward, and
    tx.step under the non-finite guard: a step whose loss or any gradient
    is not finite leaves the parameters and the BatchNorm statistics
    bitwise as they were."""
    anchors, strides = make_anchors((cfg.img_size, cfg.img_size), ycfg.strides, device)

    def step(model: YoloV8, tx: DetOptimizer, batch: Dict[str, torch.Tensor],
             draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        imgs, boxes, mask = augment_batch(batch["image"], batch["gt_boxes"], batch["gt_mask"],
                                          draws, cfg)
        model.train()
        tx.zero_grad()
        stats = bn_buffers(model)
        saved = [b.clone() for b in stats]
        box_l, cls_l = _flatten_levels(model(imgs), ycfg)
        pred_boxes = _boxes_xyxy(dfl_expectation(box_l, ycfg.reg_max), anchors[None],
                                 strides[None, :, None])
        losses = detection_loss(box_l, cls_l, pred_boxes, anchors, strides, boxes,
                                batch["gt_labels"], mask, ycfg.reg_max)
        losses["total"].backward()
        grads = torch.cat([p.grad.reshape(-1) for p in tx.params])
        finite = torch.isfinite(losses["total"]) & torch.isfinite(grads).all()
        del grads
        tx.step(finite)
        with torch.no_grad():
            for b, old in zip(stats, saved):
                torch.where(finite, b, old, out=b)
        return {k: v.detach() for k, v in losses.items()}

    return step


@torch.no_grad()
def ema_update_(ema_params: List[torch.Tensor], params: List[torch.Tensor], step: int,
                decay: float = 0.9999) -> None:
    """Ramped EMA (ultralytics ModelEMA) in place after `step` steps:
    e = e * d + p * (1 - d), d = schedule.ema_decay(step, decay)."""
    d = ema_decay(step, decay)
    torch._foreach_mul_(ema_params, d)
    torch._foreach_add_(ema_params, torch._foreach_mul(params, 1.0 - d))


# ------------------------------------------------------------------------ mAP


def average_precision(tp: np.ndarray, conf: np.ndarray, n_gt: int) -> float:
    """All-point-interpolation AP from per-prediction TP flags + scores."""
    if n_gt == 0 or len(tp) == 0:
        return 0.0
    order = np.argsort(-conf)
    tp = tp[order]
    fp = ~tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    # envelope + integrate
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou_matrix_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between xyxy box sets [N, 4] x [M, 4] -> [N, M]."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0.0, None), axis=1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0.0, None), axis=1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def evaluate_map50(predictions: List[dict], ground_truths: List[dict], num_classes: int,
                   iou_thresh: float = 0.5) -> float:
    """mAP@50 over per-image predictions ({'boxes' [D, 4], 'scores' [D],
    'classes' [D], 'valid' [D]}) and ground truths ({'boxes' [M, 4],
    'labels' [M], 'mask' [M]}), numpy: greedy matching in score order per
    image and class, all-point AP per class, the mean over the classes that
    have a gt."""
    aps = []
    for c in range(num_classes):
        tps, confs = [], []
        n_gt = 0
        for pred, gt in zip(predictions, ground_truths):
            gt_sel = (gt["labels"] == c) & gt["mask"]
            gt_boxes = np.asarray(gt["boxes"])[gt_sel]
            n_gt += len(gt_boxes)
            p_sel = (pred["classes"] == c) & pred["valid"]
            p_boxes = np.asarray(pred["boxes"])[p_sel]
            p_scores = np.asarray(pred["scores"])[p_sel]
            if len(p_boxes) == 0:
                continue
            order = np.argsort(-p_scores)
            if len(gt_boxes) == 0:
                tps.extend([False] * len(order))
                confs.extend(p_scores[order].tolist())
                continue
            ious = _iou_matrix_np(p_boxes[order], gt_boxes)  # [D, M]
            matched = np.zeros(len(gt_boxes), bool)
            for row, score in zip(ious, p_scores[order]):
                j = int(np.argmax(row))
                if row[j] >= iou_thresh and not matched[j]:
                    matched[j] = True
                    tps.append(True)
                else:
                    tps.append(False)
                confs.append(float(score))
        if n_gt == 0:
            continue
        aps.append(average_precision(np.asarray(tps), np.asarray(confs), n_gt))
    return float(np.mean(aps)) if aps else 0.0


# -------------------------------------------------------------- checkpoints


def _checkpoint_path(save_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(save_dir), f"{name}.pt")


def load_yolo_variables(save_dir: str, ycfg: YoloConfig, prefer: str = "best") -> Optional[dict]:
    """A trained detector's state_dict (CPU tensors) from a
    DetectionTrainer's save_dir: the EMA parameters (what validation and
    export use) with the live BatchNorm statistics, from `prefer` or else
    the other of `best` / `last`; None when neither loads into a YoloV8 of
    ycfg. It loads into PosePipeline's detector as it is."""
    want = YoloV8(ycfg).state_dict()
    for name in (prefer, "last" if prefer != "last" else "best"):
        path = _checkpoint_path(save_dir, name)
        if not os.path.exists(path):
            continue
        try:
            payload = torch.load(path, map_location="cpu", weights_only=True)
            sd = {**payload["ema_params"], **payload["batch_stats"]}
            if set(sd) != set(want) or any(sd[k].shape != want[k].shape for k in want):
                raise ValueError("the checkpoint does not fit a YoloV8 of this config")
        except Exception as e:  # a damaged file or another model: try the other
            print(f"[yolo] restore of {path} failed: {e}")
            continue
        return sd
    return None


# -------------------------------------------------------------------- trainer


class DetectionTrainer:
    """The JAX DetectionTrainer's recipe on a LineMOD tree (train_yolo.py's
    5-epoch finetune), on `device` (the card by default)."""

    def __init__(self, source_root: str, save_dir: str, cfg: DetTrainConfig = DetTrainConfig(),
                 ycfg: Optional[YoloConfig] = None, scene_roots: Tuple[str, ...] = (),
                 device=DEFAULT_DEVICE):
        from ...data.detection import DetectionLoader

        self.cfg = cfg
        self.device = torch.device(device)
        # scene_roots: multi-object scene trees mixed into both splits
        self.train_loader = DetectionLoader(source_root, "train", cfg.img_size,
                                            scene_roots=scene_roots)
        self.val_loader = DetectionLoader(source_root, "val", cfg.img_size,
                                          scene_roots=scene_roots)
        self.ycfg = ycfg or YoloConfig(num_classes=self.train_loader.num_classes)
        self.model = flax_init_(YoloV8(self.ycfg), cfg.seed).to(self.device)

        steps_per_epoch = max(len(self.train_loader) // cfg.batch_size, 1)
        total = max(cfg.epochs * steps_per_epoch, 2)
        # short runs: the warmup must leave room for the decay phase
        warmup = min(max(int(cfg.warmup_epochs * steps_per_epoch), 1), total - 1)
        self.tx = DetOptimizer(self.model.parameters(), cfg, warmup, total)
        # the EMA's parameters; its module evaluates with the live model's
        # BatchNorm statistics, copied in before each use
        self.ema_model = copy.deepcopy(self.model).requires_grad_(False)
        self.global_step = 0
        self.completed_epochs = 0
        self.best_map = -1.0
        self.step_fn = make_det_train_step(cfg, self.ycfg, self.device)
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)

    def close(self) -> None:
        """Stop the loaders' prefetch threads."""
        self.train_loader.close()
        self.val_loader.close()

    # ------------------------------------------------------------- checkpoint
    #
    # The full trainer state (ultralytics' resume-from-last): parameters,
    # BatchNorm statistics, EMA parameters, Adam's moments and count, the
    # global step (the schedule and the EMA ramp), the completed epochs and
    # the best mAP for the gating of `best`.

    def _ckpt_tree(self) -> dict:
        names = [n for n, _ in self.model.named_parameters()]
        params = {n: p.detach().cpu().clone() for n, p in self.model.named_parameters()}
        opt = self.tx.state_dict()
        return {
            "params": params,
            "batch_stats": {n: b.detach().cpu().clone() for n, b in self.model.named_buffers()},
            "ema_params": {n: p.detach().cpu().clone() for n, p in self.ema_model.named_parameters()},
            "opt_state": {"mu": dict(zip(names, opt["mu"])), "nu": dict(zip(names, opt["nu"])),
                          "count": opt["count"]},
            "meta": {"global_step": self.global_step, "epoch": self.completed_epochs,
                     "best_map": self.best_map},
        }

    def save_checkpoint(self, name: str = "last") -> None:
        """Write the full state to <save_dir>/<name>.pt (under a temporary
        name first, so that a kill mid-save leaves the previous file whole)."""
        path = _checkpoint_path(self.save_dir, name)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(self._ckpt_tree(), tmp)
        os.replace(tmp, path)

    def load_tree(self, tree: dict) -> None:
        """Set the full state from a checkpoint tree (_ckpt_tree's layout,
        or convert.det_trainer_state_from_jax's); raises, leaving the state
        as it was, when the tree does not fit."""
        names = [n for n, _ in self.model.named_parameters()]
        state = {**tree["params"], **tree["batch_stats"]}
        want = self.model.state_dict()
        ema = tree["ema_params"]
        opt = tree["opt_state"]
        for part, keys in ((state, want), (ema, names), (opt["mu"], names), (opt["nu"], names)):
            if set(part) != set(keys) or any(part[k].shape != want[k].shape for k in keys):
                raise ValueError("the checkpoint does not fit this detector")
        self.model.load_state_dict(state, strict=True)
        with torch.no_grad():
            for n, p in self.ema_model.named_parameters():
                p.copy_(ema[n])
        self.tx.load_state_dict({"mu": [opt["mu"][n] for n in names],
                                 "nu": [opt["nu"][n] for n in names], "count": opt["count"]})
        meta = tree["meta"]
        self.global_step = int(meta["global_step"])
        self.completed_epochs = int(meta["epoch"])
        self.best_map = float(meta["best_map"])

    def try_resume(self, name: str = "last") -> bool:
        path = _checkpoint_path(self.save_dir, name)
        if not os.path.exists(path):
            return False
        try:
            self.load_tree(torch.load(path, map_location="cpu", weights_only=True))
        except Exception as e:  # a damaged file or another model: a fresh start
            print(f"[yolo] checkpoint restore failed ({e}); starting fresh")
            return False
        return True

    # ------------------------------------------------------------------ steps

    def _generator(self, epoch: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.cfg.seed * 7919 + epoch)

    @torch.no_grad()
    def _sync_ema_buffers(self) -> None:
        for e, b in zip(self.ema_model.buffers(), self.model.buffers()):
            e.copy_(b)

    @torch.no_grad()
    def _infer(self, images: torch.Tensor) -> dict:
        self.ema_model.eval()
        images = to_float01(images)
        boxes, scores = decode_outputs(self.ema_model(images), self.ycfg,
                                       tuple(images.shape[1:3]))
        return batched_nms(boxes, scores, max_det=10, pre_topk=100)

    def train_epoch(self, epoch: int, rng: np.random.Generator) -> float:
        """One epoch over the shuffled train split; the mean loss over its
        finite steps (the guard skipped the others), fetched once."""
        gen = self._generator(epoch)
        params = list(self.model.parameters())
        ema = list(self.ema_model.parameters())
        losses = []
        for batch in self.train_loader.batches(self.cfg.batch_size, rng, shuffle=True):
            batch = to_device({k: batch[k] for k in ("image", "gt_boxes", "gt_labels", "gt_mask")},
                              self.device)
            draws = draw_det_augment(gen, self.cfg.batch_size, self.cfg, self.device)
            out = self.step_fn(self.model, self.tx, batch, draws)
            self.global_step += 1
            ema_update_(ema, params, self.global_step)
            losses.append(out["total"])
        if not losses:
            return 0.0
        arr = torch.stack(losses).cpu().numpy()  # the epoch's one wait for the card
        n_bad = int(np.count_nonzero(~np.isfinite(arr)))
        if n_bad:
            print(f"[yolo] epoch {epoch + 1}: skipped {n_bad}/{arr.size} nonfinite step(s)")
            if n_bad == arr.size:
                return float("nan")
        return float(np.nanmean(arr))

    def validate_map50(self, rng: np.random.Generator) -> float:
        """mAP@50 of the EMA parameters with the live BatchNorm statistics
        over the val split; detections stay on the card until one fetch."""
        self._sync_ema_buffers()
        outs, host_gts = [], []
        for batch in self.val_loader.batches(self.cfg.batch_size, rng, shuffle=False,
                                             drop_remainder=False):
            image = to_device({"image": batch["image"]}, self.device)["image"]
            outs.append(self._infer(image))
            host_gts.append(batch)
        if not outs:
            return 0.0
        out = {k: torch.cat([o[k] for o in outs]).cpu().numpy() for k in outs[0]}
        preds, gts = [], []
        row = 0
        for batch in host_gts:
            for i in range(len(batch["valid"])):
                if batch["valid"][i]:
                    preds.append({k: out[k][row + i] for k in out})
                    gts.append({"boxes": batch["gt_boxes"][i], "labels": batch["gt_labels"][i],
                                "mask": batch["gt_mask"][i]})
            row += len(batch["valid"])
        return evaluate_map50(preds, gts, self.ycfg.num_classes)

    def fit(self, epochs: Optional[int] = None, validate_every: int = 1) -> float:
        """Train with per-epoch validation, best-mAP gating and resume:
        after an interruption the schedule, the EMA ramp, Adam's moments and
        the shuffle continue from the saved step, and completed epochs are
        skipped: a resumed run ends in the state of an uninterrupted one.
        validate_every > 1 skips intermediate validations (the last epoch
        always validates). Returns the last mAP@50."""
        epochs = epochs or self.cfg.epochs
        rng = np.random.default_rng(self.cfg.seed)
        if self.try_resume():
            print(f"[yolo] resumed from last checkpoint: epoch {self.completed_epochs}, "
                  f"step {self.global_step}, best mAP {self.best_map:.4f}")
            # the completed epochs' shuffles, replayed: the resumed epochs
            # draw the orders an uninterrupted run draws (JAX restarts the
            # generator, so its resumed run shuffles otherwise)
            for _ in range(self.completed_epochs):
                rng.shuffle(np.arange(len(self.train_loader)))
        map50 = self.best_map
        metrics_path = os.path.join(self.save_dir, "metrics.csv")
        # a header if the file is absent or empty (a kill before the first
        # flush can leave it empty)
        write_header = not os.path.exists(metrics_path) or os.path.getsize(metrics_path) == 0
        for epoch in range(self.completed_epochs, epochs):
            t0 = time.monotonic()
            loss = self.train_epoch(epoch, rng)
            self.completed_epochs = epoch + 1
            validated = (epoch + 1) % validate_every == 0 or epoch + 1 == epochs
            if validated:
                map50 = self.validate_map50(rng)
                if map50 > self.best_map:
                    self.best_map = map50
                    self.save_checkpoint("best")
                print(f"[yolo] epoch {epoch + 1}/{epochs} loss {loss:.4f} mAP@50 {map50:.4f} "
                      f"(best {self.best_map:.4f}, {time.monotonic() - t0:.1f}s)")
            else:
                print(f"[yolo] epoch {epoch + 1}/{epochs} loss {loss:.4f} "
                      f"({time.monotonic() - t0:.1f}s)")
            self.save_checkpoint("last")
            with open(metrics_path, "a", newline="") as f:
                if write_header:
                    f.write(LOG_HEADER)
                    write_header = False
                lr = self.tx.lr(self.global_step)
                f.write(f"{epoch + 1},{loss:.6f},{map50 if validated else ''},"
                        f"{self.best_map:.6f},{lr:.8f},{time.monotonic() - t0:.2f}\n")
        print(f"mAP@50: {map50:.4f}")
        return map50
