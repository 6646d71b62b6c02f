"""Train and eval steps for the pose networks (counterpart of
pose6d_tpu/train/loop.py).

One train step: on-device augmentation -> train-mode forward (BatchNorm on
batch statistics, dropout) -> f32 pose loss -> backward -> global-norm
clip -> AdamW -> the BatchNorm running statistics, updated in the forward
as flax updates them. With the split resident on the card
(data/device_pipeline.DeviceFrameStore) each step first gathers its frames
by index through the gather kernel and crops them as two matmuls
(`expand_device_batch`). The epoch function walks a whole epoch's stacked
metadata on the card and returns the losses as one tensor: nothing in it
waits for the card.

Where the JAX package threads an immutable TrainState through jitted
functions, the port updates the module and the optimizer in place: the
state holds them (TrainState.model, TrainState.tx), and the factories take
the config alone where the JAX ones also take the flax module and the
optax transformation. Random draws (augmentation, dropout) come from an
explicit torch.Generator on the card, where the JAX package splits keys.

Optimizer: clip_by_global_norm(1.0) then AdamW(lr 1e-4, weight decay 1e-4)
as optax chains them (reference train_rgb.py:70,110); the learning rate is
settable between steps (PoseOptimizer.learning_rate), where the JAX package
injects it as a hyperparameter for the host-side plateau scheduler.

Not ported: bfloat16 training (compute_dtype "bfloat16" raises), the
Trainer, checkpoints, warm-start from pretrained towers, and the host
loader's compact batches beyond `decompress_batch`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..data.crop import normalize_depth
from ..geometry.pinhole import pinhole_xy_from_z
from ..geometry.quat import quat_to_mat
from ..losses.add import ObjectModels, add_metrics
from ..losses.pose_loss import PoseLossConfig, pose_loss
from ..models.posenet import PoseNet, PoseNetConfig, flax_init_
from ..ops.augment import AugmentConfig, eval_preprocess, train_augment
from ..ops.crop_resize import crop_resize_matmul
from ..ops.gather_frames import gather_frames, gather_frames_packed


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    variant: str = "rgb"
    img_size: int = 224
    batch_size: int = 32
    epochs: int = 75
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    loss: PoseLossConfig = PoseLossConfig()
    # plateau scheduler (train_rgb adds min_lr=1e-7; others use 0)
    plateau_factor: float = 0.5
    plateau_patience: int = 5
    min_lr: float = 0.0
    # augmentation; grayscale_p > 0 only for the rgb variant (train_rgb.py:46)
    augment: AugmentConfig = AugmentConfig()
    # PoseNetConfig's ablation and init flags
    rot_head_wide: bool = False
    fusion_attention: bool = True
    z_from_backbone: bool = False
    z_backbone_wide: bool = False
    attn_zero_init: bool = False
    # only "float32" is ported; the JAX package's "bfloat16" mixed precision
    # raises here
    compute_dtype: str = "float32"


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: every g scaled by max_norm / norm
    when norm >= max_norm, else unchanged (torch's clip_grad_norm_ would
    scale by max_norm / (norm + 1e-6)). No host sync: the choice is a
    select on the card, and the scale one fused multiply over all g."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(grads), scale)


class PoseOptimizer:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(lr, weight_decay)):
    AdamW with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root), decaying every parameter, BatchNorm and LayerNorm scales
    and biases included, as optax's adamw does without a mask."""

    def __init__(self, params, cfg: TrainConfig):
        self.params = list(params)
        self.grad_clip = cfg.grad_clip
        self.adamw = torch.optim.AdamW(self.params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=cfg.weight_decay)

    @property
    def learning_rate(self) -> float:
        return self.adamw.param_groups[0]["lr"]

    @learning_rate.setter
    def learning_rate(self, lr: float) -> None:
        for group in self.adamw.param_groups:
            group["lr"] = float(lr)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip the gradients, take the AdamW step; returns the global
        gradient norm before clipping (a tensor on the card)."""
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        clip_by_global_norm_(grads, self.grad_clip, norm)
        self.adamw.step()
        return norm


@dataclasses.dataclass
class TrainState:
    """The module (its parameters and BatchNorm statistics), the optimizer
    (its moments and learning rate) and the count of steps taken."""

    model: PoseNet
    tx: PoseOptimizer
    step: int = 0


def make_optimizer(cfg: TrainConfig, params) -> PoseOptimizer:
    return PoseOptimizer(params, cfg)


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on `device`. Host
    arrays go to a card from pinned memory without blocking: a copy from
    pageable memory would wait for the card."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def _u16_to_f32(d: torch.Tensor) -> torch.Tensor:
    """uint16 values held as int16 or uint16 -> float32 (through int32:
    torch's uint16 has few kernels)."""
    return (d.view(torch.int16).to(torch.int32) & 0xFFFF).float()


def decompress_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A compact batch's uint16 'depth_mm' [B, H, W] -> 'depth_raw'
    (metres) and the normalized 'depth' channel; other batches pass."""
    if "depth_mm" not in batch:
        return batch
    batch = dict(batch)
    raw = _u16_to_f32(batch.pop("depth_mm")) / 1000.0
    batch["depth_raw"] = raw
    batch["depth"] = normalize_depth(raw)[..., None]
    return batch


def expand_device_batch(frames: torch.Tensor, depth: Optional[torch.Tensor],
                        batch: Dict[str, torch.Tensor], img_size: int,
                        frame_hw: Optional[tuple] = None) -> Dict[str, torch.Tensor]:
    """The device half of the preprocessing contract: gather the batch's
    frames from the resident split (the gather kernel) and crop+resize them
    as two matmuls. frames is packed words [N, R] (needs frame_hw = (H, W))
    or raw uint8 [N, H, W, 3]; depth packed words, raw uint16 millimetres
    held as int16 [N, H, W], or None; batch a metadata batch on the card.
    Adds 'rgb' [B, S, S, 3] in [0, 1] f32 and, with depth, 'depth_raw'
    [B, S, S] metres and the normalized 'depth' [B, S, S, 1]."""
    idx = batch["idx"]
    x1, y1, size = batch["x1"], batch["y1"], batch["size"]
    out = dict(batch)
    if frames.ndim == 2:
        src = gather_frames_packed(frames, idx, (*frame_hw, 3), torch.uint8)
    else:
        src = gather_frames(frames, idx)
    out["rgb"] = crop_resize_matmul(src.float(), x1, y1, size, img_size) / 255.0
    if depth is not None:
        if depth.ndim == 2:
            dsrc = gather_frames_packed(depth, idx, frame_hw, torch.int16)
        else:
            dsrc = gather_frames(depth, idx)
        raw = crop_resize_matmul(_u16_to_f32(dsrc)[..., None], x1, y1, size, img_size)[..., 0]
        raw = raw / 1000.0
        out["depth_raw"] = raw
        out["depth"] = normalize_depth(raw)[..., None]
    return out


def model_inputs(variant: str, batch: Dict[str, torch.Tensor], rgb: torch.Tensor) -> dict:
    """The variant's PoseNet keyword arguments from the superset batch:
    rgb_geometric takes the original-frame centre and intrinsics,
    rgbd_geometric the crop-frame centre and the crop's intrinsics
    (reference train_rgb_geometric.py:105, train_rgbd_geometric.py:107)."""
    kwargs: dict = {"rgb": rgb}
    if variant == "rgb_geometric":
        kwargs["bbox_center"] = batch["center_orig"]
        kwargs["camera_matrix"] = batch["cam_K"]
    elif variant == "rgbd":
        kwargs["depth"] = batch["depth"]
    elif variant == "rgbd_geometric":
        kwargs["depth_raw"] = batch["depth_raw"]
        kwargs["bbox_center"] = batch["center_crop"]
        kwargs["camera_matrix"] = batch["cam_K_crop"]
    return kwargs


def create_train_state(cfg: TrainConfig, seed: int = 0, model: Optional[PoseNet] = None,
                       device=DEFAULT_DEVICE) -> TrainState:
    """The module, initialized from scratch by the flax rules from `seed`
    (posenet.flax_init_), or `model` as given (e.g. weights carried from a
    flax tree by convert.posenet_from_jax), moved to `device`, with a fresh
    optimizer."""
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(f"compute_dtype {cfg.compute_dtype!r}: only float32 "
                                  f"training is ported")
    if model is None:
        model = flax_init_(PoseNet(PoseNetConfig(
            variant=cfg.variant, img_size=cfg.img_size, rot_head_wide=cfg.rot_head_wide,
            fusion_attention=cfg.fusion_attention, z_from_backbone=cfg.z_from_backbone,
            z_backbone_wide=cfg.z_backbone_wide, attn_zero_init=cfg.attn_zero_init)), seed)
    model = model.to(device)
    return TrainState(model=model, tx=make_optimizer(cfg, model.parameters()))


def _make_core(cfg: TrainConfig) -> Callable:
    """The step body shared by the per-step and whole-epoch functions:
    augment, forward, loss, backward, clip, AdamW; the BatchNorm statistics
    update in the forward."""

    def core(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        model, tx = state.model, state.tx
        rgb = train_augment(generator, batch["rgb"], cfg.augment)
        model.train()
        tx.zero_grad()
        pred_rot, pred_trans = model(**model_inputs(cfg.variant, batch, rgb), generator=generator)
        loss = pose_loss(pred_rot.float(), pred_trans.float(), batch["quat"], batch["trans"],
                         cfg.loss)
        loss.backward()
        grad_norm = tx.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return core


def make_train_step(cfg: TrainConfig, device_preprocess: bool = False,
                    frame_hw: Optional[tuple] = None) -> Callable:
    """The train step: (state, batch, generator) -> (state, metrics), with
    metrics {"loss", "grad_norm"} tensors on the card. With
    device_preprocess the signature is (state, frames, depth, batch,
    generator): batch is a metadata batch (DeviceFrameStore) and the step
    gathers and crops the frames on the card (packed words when frame_hw is
    given)."""
    core = _make_core(cfg)
    if device_preprocess:

        def step_dev(state, frames, depth, batch, generator):
            batch = to_device(batch, frames.device)
            return core(state, expand_device_batch(frames, depth, batch, cfg.img_size, frame_hw),
                        generator)

        return step_dev

    def step(state, batch, generator):
        device = next(state.model.parameters()).device
        return core(state, decompress_batch(to_device(batch, device)), generator)

    return step


def make_train_epoch(cfg: TrainConfig, frame_hw: Optional[tuple] = None) -> Callable:
    """The whole-epoch train function: (state, frames, depth, meta_scan,
    generator) -> (state, losses [n_steps]). meta_scan's arrays are stacked
    [n_steps, B, ...] (DeviceFrameStore.epoch_meta); they go to the card in
    one copy, and no step waits for the card."""
    core = _make_core(cfg)

    def epoch_fn(state, frames, depth, meta_scan, generator):
        meta = to_device(meta_scan, frames.device)
        n_steps = meta["idx"].shape[0]
        losses = torch.empty(n_steps, dtype=torch.float32, device=frames.device)
        for i in range(n_steps):
            batch = expand_device_batch(frames, depth, {k: v[i] for k, v in meta.items()},
                                        cfg.img_size, frame_hw)
            state, metrics = core(state, batch, generator)
            losses[i] = metrics["loss"]
        return state, losses

    return epoch_fn


def make_eval_step(cfg: TrainConfig, evaluator: ObjectModels) -> Callable:
    """The eval step: (state, batch) -> metrics. Eval-mode forward in f32,
    batched ADD metrics through the addmin kernel over the batch's valid
    rows, and for rgb / rgbd also 'add_01d_acc_deploy', the accuracy with
    X/Y re-derived from the predicted Z, the box centre and the original
    intrinsics as deployment does (a second add_metrics call); the loss and
    the predictions. batch holds 'rgb' (uint8 or [0, 1] float), the
    variant's inputs, 'quat', 'trans', 'obj_id', 'center_orig', 'cam_K' and
    'valid'."""
    points, diameters = evaluator.points, evaluator.diameters
    symmetric, present, num_valid = evaluator.symmetric, evaluator.present, evaluator.num_valid

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model = state.model
        model.eval()
        batch = decompress_batch(to_device(batch, points.device))
        rgb = eval_preprocess(batch["rgb"])
        pred_rot, pred_trans = model(**model_inputs(cfg.variant, batch, rgb))
        obj_ids = torch.where(batch["valid"], batch["obj_id"].long(),
                              torch.full_like(batch["obj_id"].long(), -1))
        gt_mat = quat_to_mat(batch["quat"])
        metrics = add_metrics(points, diameters, symmetric, present, quat_to_mat(pred_rot),
                              pred_trans, gt_mat, batch["trans"], obj_ids, num_valid=num_valid)
        if cfg.variant in ("rgb", "rgbd"):
            trans_deploy = pinhole_xy_from_z(pred_trans[:, 2], batch["center_orig"],
                                             batch["cam_K"])
            deploy = add_metrics(points, diameters, symmetric, present, quat_to_mat(pred_rot),
                                 trans_deploy, gt_mat, batch["trans"], obj_ids,
                                 num_valid=num_valid)
            metrics["add_01d_acc_deploy"] = deploy["add_01d_acc"]
        else:
            metrics["add_01d_acc_deploy"] = metrics["add_01d_acc"]
        metrics["loss"] = pose_loss(pred_rot, pred_trans, batch["quat"], batch["trans"], cfg.loss)
        metrics["pred_rot"] = pred_rot
        metrics["pred_trans"] = pred_trans
        return metrics

    return step
