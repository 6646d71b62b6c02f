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

Mixed precision (compute_dtype "bfloat16"): the towers' forward and
backward run in bf16 under torch.autocast, as flax's ResNet50(dtype=bf16)
does; parameters, optimizer state, BatchNorm running statistics, the heads
and the loss stay f32. The eval step runs f32 whatever the compute dtype.
The Trainer (train/trainer.py) drives these steps over a LineMOD split.

Under a mesh (parallel/mesh.py; the state from parallel.shard_state) the
resident steps (make_train_epoch, and make_train_step with
device_preprocess) are given the global metadata batch and take the rank's
rows: the gather kernel expands only those. The host-path train step and
the eval step are given the rank's rows alone (parallel.local_rows of the
global batch; the host loader decodes only those, LineMODPoseLoader.batches'
rows=). The augmentation and dropout draws are made at the global batch
and each rank keeps its block;
BatchNorm reduces its statistics over the data group; the optimizer
all-reduces the gradients as a mean (PoseOptimizer says over which ranks)
and sums the squares of the head shards over the model group for the
clipping norm. So
the step is the one-process step on the global batch, as the JAX package's
GSPMD step is. The metrics (the loss, the eval sums) are reduced over the
data group and every rank returns the global ones.
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
    # "bfloat16": mixed-precision training (see the module docstring);
    # validation always runs f32
    compute_dtype: str = "float32"


COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def sharded_global_norm(tensors, sharded, group) -> torch.Tensor:
    """global_norm of tensors of which those marked `sharded` are this
    rank's slices over `group` (a model group): their squares are summed
    over the group, the replicated ones counted once."""
    tensors = list(tensors)
    rep = [t for t, s in zip(tensors, sharded) if not s]
    split = [t for t, s in zip(tensors, sharded) if s]
    if not split:
        return global_norm(rep)
    from ..parallel.collectives import all_reduce_

    sq = global_norm(split) ** 2
    return torch.sqrt(global_norm(rep) ** 2 + all_reduce_(sq, group))


ALL_REDUCE_BUCKET = 1 << 24  # elements a flat all-reduce of gradients holds at most


def all_reduce_mean_(tensors, group) -> None:
    """Each tensor replaced by its mean over `group`, in flat buckets of
    up to ALL_REDUCE_BUCKET elements: every rank divides the same sum by
    the same count, so the replicas stay equal bit for bit."""
    from ..parallel.collectives import all_reduce_

    tensors = list(tensors)
    i = 0
    while i < len(tensors):
        j, n = i + 1, tensors[i].numel()
        while (j < len(tensors) and tensors[j].dtype == tensors[i].dtype
               and n + tensors[j].numel() <= ALL_REDUCE_BUCKET):
            n += tensors[j].numel()
            j += 1
        flat = all_reduce_(torch.cat([t.reshape(-1) for t in tensors[i:j]]), group)
        flat.div_(group.size)
        offset = 0
        for t in tensors[i:j]:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        i = j


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
    and biases included, as optax's adamw does without a mask.

    mesh (parallel.shard_state builds it so): the gradients are first
    all-reduced as a mean, those of the parameters marked `sharded` (this
    rank's head slices) over the data group, the replicated ones over every
    rank: the ranks of a model group compute those alike, but kernels that
    accumulate with atomics (cuDNN's) round them differently, and the mean
    keeps the replicas equal bit for bit. The clipping norm sums the squares
    of the sharded ones over the model group."""

    def __init__(self, params, cfg: TrainConfig, mesh=None, sharded=None):
        self.params = list(params)
        self.cfg = cfg
        self.mesh = mesh
        self.sharded = list(sharded) if sharded is not None else [False] * len(self.params)
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

    def state_dict(self) -> dict:
        """AdamW's state: its moments, step counts and learning rate."""
        return self.adamw.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state)

    def step(self) -> torch.Tensor:
        """Clip the gradients, take the AdamW step; returns the global
        gradient norm before clipping (a tensor on the card)."""
        grads = [p.grad for p in self.params]
        if self.mesh is None:
            norm = global_norm(grads)
        else:
            all_reduce_mean_([g for g, s in zip(grads, self.sharded) if not s], self.mesh.world)
            all_reduce_mean_([g for g, s in zip(grads, self.sharded) if s], self.mesh.data_group)
            norm = sharded_global_norm(grads, self.sharded, self.mesh.model_group)
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


def pose_config(cfg: TrainConfig) -> PoseNetConfig:
    """The PoseNetConfig of a TrainConfig's variant and flags. Its dtype
    stays f32: the train step passes compute_dtype as the towers' dtype,
    and validation and the tools run f32 towers, as the JAX package's
    eval step replaces its model's dtype with f32."""
    return PoseNetConfig(
        variant=cfg.variant, img_size=cfg.img_size, rot_head_wide=cfg.rot_head_wide,
        fusion_attention=cfg.fusion_attention, z_from_backbone=cfg.z_from_backbone,
        z_backbone_wide=cfg.z_backbone_wide, attn_zero_init=cfg.attn_zero_init)


def create_train_state(cfg: TrainConfig, seed: int = 0, model: Optional[PoseNet] = None,
                       device=DEFAULT_DEVICE, pretrained_backbone=None) -> TrainState:
    """The module, initialized from scratch by the flax rules from `seed`
    (posenet.flax_init_), or `model` as given (e.g. weights carried from a
    flax tree by convert.posenet_from_jax), moved to `device`, with a fresh
    optimizer. pretrained_backbone (a torchvision resnet50 .pth path or
    state_dict) loads the towers of the from-scratch model
    (models/pretrained.py)."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of {sorted(COMPUTE_DTYPES)}")
    if model is None and pretrained_backbone is not None:
        from ..models.pretrained import init_posenet_with_pretrained

        model = init_posenet_with_pretrained(pose_config(cfg), seed, pretrained_backbone)
    elif model is None:
        model = flax_init_(PoseNet(pose_config(cfg)), seed)
    model = model.to(device)
    return TrainState(model=model, tx=make_optimizer(cfg, model.parameters()))


def _make_core(cfg: TrainConfig, mesh=None) -> Callable:
    """The step body shared by the per-step and whole-epoch functions:
    augment, forward (the towers in cfg.compute_dtype), f32 loss, backward,
    clip, AdamW; the BatchNorm statistics update in the forward. Under a
    mesh the batch is this rank's rows and the loss returned is this
    rank's (_mean_over_data reduces it)."""
    tower_dtype = COMPUTE_DTYPES[cfg.compute_dtype]
    rows = {} if mesh is None else {"rows": mesh.rows}

    def core(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        model, tx = state.model, state.tx
        rgb = train_augment(generator, batch["rgb"], cfg.augment, **rows)
        model.train()
        tx.zero_grad()
        pred_rot, pred_trans = model(**model_inputs(cfg.variant, batch, rgb), generator=generator,
                                     tower_dtype=tower_dtype)
        # f32, or the parameters' dtype where wider (a float64 module)
        ld = torch.promote_types(pred_rot.dtype, torch.float32)
        loss = pose_loss(pred_rot.to(ld), pred_trans.to(ld), batch["quat"], batch["trans"],
                         cfg.loss)
        loss.backward()
        grad_norm = tx.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return core


def _rows(batch, mesh, dim: int = 0):
    if mesh is None:
        return batch
    from ..parallel.mesh import shard_batch

    return shard_batch(batch, mesh, dim)


def _mean_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """A per-rank mean (the loss of its rows) -> the global batch's."""
    if mesh is None:
        return x
    from ..parallel.collectives import all_reduce_

    return all_reduce_(x.detach().clone(), mesh.data_group) / mesh.dp


def make_train_step(cfg: TrainConfig, device_preprocess: bool = False,
                    frame_hw: Optional[tuple] = None, mesh=None) -> Callable:
    """The train step: (state, batch, generator) -> (state, metrics), with
    metrics {"loss", "grad_norm"} tensors on the card. With
    device_preprocess the signature is (state, frames, depth, batch,
    generator): batch is a metadata batch (DeviceFrameStore) and the step
    gathers and crops the frames on the card (packed words when frame_hw is
    given). mesh: the state is sharded on it; the metadata batch of
    device_preprocess is the global batch, the host path's batch this
    rank's rows of it (see the module docstring)."""
    core = _make_core(cfg, mesh)

    def reduced(out):
        state, metrics = out
        return state, {**metrics, "loss": _mean_over_data(metrics["loss"], mesh)}

    if device_preprocess:

        def step_dev(state, frames, depth, batch, generator):
            batch = _rows(to_device(batch, frames.device), mesh)  # global -> local
            return reduced(core(state, expand_device_batch(frames, depth, batch, cfg.img_size,
                                                           frame_hw), generator))

        return step_dev

    def step(state, batch, generator):
        device = next(state.model.parameters()).device
        return reduced(core(state, decompress_batch(to_device(batch, device)), generator))

    return step


def make_train_epoch(cfg: TrainConfig, frame_hw: Optional[tuple] = None, mesh=None) -> Callable:
    """The whole-epoch train function: (state, frames, depth, meta_scan,
    generator) -> (state, losses [n_steps]). meta_scan's arrays are stacked
    [n_steps, B, ...] (DeviceFrameStore.epoch_meta); they go to the card in
    one copy, and no step waits for the card. Under a mesh meta_scan is
    the global batches' and the losses are reduced once, at the end."""
    core = _make_core(cfg, mesh)

    def epoch_fn(state, frames, depth, meta_scan, generator):
        meta = _rows(to_device(meta_scan, frames.device), mesh, dim=1)
        n_steps = meta["idx"].shape[0]
        losses = torch.empty(n_steps, dtype=torch.float32, device=frames.device)
        for i in range(n_steps):
            batch = expand_device_batch(frames, depth, {k: v[i] for k, v in meta.items()},
                                        cfg.img_size, frame_hw)
            state, metrics = core(state, batch, generator)
            losses[i] = metrics["loss"]
        return state, _mean_over_data(losses, mesh)

    return epoch_fn


def make_eval_step(cfg: TrainConfig, evaluator: ObjectModels, mesh=None) -> Callable:
    """The eval step: (state, batch) -> metrics. Eval-mode forward in f32
    (whatever cfg.compute_dtype),
    batched ADD metrics through the addmin kernel over the batch's valid
    rows, and for rgb / rgbd also 'add_01d_acc_deploy', the accuracy with
    X/Y re-derived from the predicted Z, the box centre and the original
    intrinsics as deployment does (a second add_metrics call); the loss and
    the predictions. batch holds 'rgb' (uint8 or [0, 1] float), the
    variant's inputs, 'quat', 'trans', 'obj_id', 'center_orig', 'cam_K' and
    'valid'. Under a mesh batch is this rank's rows of the global batch
    (parallel.local_rows): the metrics' sums and counts and the loss are
    reduced over the data group and the predictions gathered, so every rank
    returns what the one-process step returns on the global batch."""
    points, diameters = evaluator.points, evaluator.diameters
    group = None if mesh is None else mesh.data_group
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
        # f32, or a float64 module's float64 (no copy in f32)
        ld = torch.promote_types(pred_rot.dtype, torch.float32)
        pts, diam, gt_trans = points.to(ld), diameters.to(ld), batch["trans"].to(ld)
        gt_mat = quat_to_mat(batch["quat"].to(ld))
        metrics = add_metrics(pts, diam, symmetric, present, quat_to_mat(pred_rot), pred_trans,
                              gt_mat, gt_trans, obj_ids, num_valid=num_valid, group=group)
        if cfg.variant in ("rgb", "rgbd"):
            trans_deploy = pinhole_xy_from_z(pred_trans[:, 2], batch["center_orig"],
                                             batch["cam_K"])
            deploy = add_metrics(pts, diam, symmetric, present, quat_to_mat(pred_rot),
                                 trans_deploy, gt_mat, gt_trans, obj_ids,
                                 num_valid=num_valid, group=group)
            metrics["add_01d_acc_deploy"] = deploy["add_01d_acc"]
        else:
            metrics["add_01d_acc_deploy"] = metrics["add_01d_acc"]
        metrics["loss"] = _mean_over_data(
            pose_loss(pred_rot, pred_trans, batch["quat"], batch["trans"], cfg.loss), mesh)
        if mesh is not None:
            from ..parallel.collectives import gather_rows

            pred_rot, pred_trans = gather_rows(pred_rot, group), gather_rows(pred_trans, group)
        metrics["pred_rot"] = pred_rot
        metrics["pred_trans"] = pred_trans
        return metrics

    return step
