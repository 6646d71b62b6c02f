"""Detect -> crop -> pose serving pipeline (counterpart of
pose6d_tpu/infer/pipeline.py), all four PoseNet variants, one pose per
frame.

uint8 frames /255 in compute_dtype -> YOLOv8 at native resolution ->
top-1 decode -> square crop at 1.2x the box -> crop+resize as two matmuls
-> ImageNet normalization -> PoseNet (float towers, or BN-folded serving
towers after fold_backbones, whose stem, layer1 and stages may run as CUDA
kernels). Per variant, as in the reference's deployment scripts:
  - rgb, rgbd: X/Y re-derived from the predicted Z, the box centre and the
    original intrinsics (the JAX package's geometric_correction, always on);
  - rgb_geometric: the network takes the original-frame centre and K;
  - rgbd: the depth map is cropped in compute_dtype and normalized;
  - rgbd_geometric: the depth map is cropped in f32 (its depth is metric)
    and the network takes the crop-frame centre, clipped to the crop, and
    the crop's intrinsics.

Not ported yet: the letterbox branch (frame sides not divisible by the
detector's coarsest stride, raises), more than one pose per frame with
general NMS, the crop window and the int8 mode; see ROADMAP.md.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..data.crop import normalize_depth
from ..geometry.pinhole import adjust_intrinsics_for_crop, pinhole_xy_from_z
from ..models.posenet import VARIANTS, PoseNet, PoseNetConfig
from ..models.posenet_serving import serving_forward
from ..models.yolo.decode import decode_topk_nms
from ..models.yolo.model import YoloConfig, YoloV8
from ..ops.augment import eval_preprocess
from ..ops.crop_resize import crop_params_from_bbox, crop_resize_matmul
from ..ops.fused_block import pack_layer1_weights, pack_stage_weights, pack_stem_weights
from ..ops.quant import fold_bn_resnet


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    variant: str = "rgb"  # rgb | rgb_geometric | rgbd | rgbd_geometric
    img_size: int = 224
    conf_thresh: float = 0.25
    # towers, crops and frames; the rgbd net sees only the normalized depth,
    # so its depth map is cropped in this dtype too (rgbd_geometric: f32)
    compute_dtype: torch.dtype = torch.bfloat16


class PosePipeline:
    """Holds both models on `device` and serves __call__(frames, K, depth).

    yolo_state / pose_state are the port's state_dicts (convert.py makes
    them from flax trees or from a seed)."""

    def __init__(self, pipe_cfg: PipelineConfig, yolo_cfg: YoloConfig,
                 yolo_state: dict, pose_state: dict,
                 pose_cfg: PoseNetConfig | None = None,
                 device: str | torch.device = DEFAULT_DEVICE):
        if pipe_cfg.variant not in VARIANTS:
            raise ValueError(f"PosePipeline: unknown variant {pipe_cfg.variant!r}")
        self.cfg = pipe_cfg
        self.device = torch.device(device)
        self.yolo_cfg = yolo_cfg
        self.pose_cfg = pose_cfg or PoseNetConfig(variant=pipe_cfg.variant,
                                                  img_size=pipe_cfg.img_size)
        self.yolo = self._load(YoloV8(yolo_cfg), yolo_state)
        self.posenet = self._load(PoseNet(self.pose_cfg), pose_state)
        self._folded: dict = {}

    def _load(self, module, state):
        module.load_state_dict(state, strict=True)
        return module.to(self.device, memory_format=torch.channels_last).eval()

    def fold_backbones(self, pallas_layer1: bool = False, pallas_stem: bool = False,
                       pallas_stages: tuple = ()):
        """Enable the folded serving mode: BN folds into every tower conv,
        the towers run in compute_dtype with f32 accumulation, and with
        pallas_stem / pallas_layer1 / pallas_stages (stage numbers 1-4;
        img_size 224 only) the stem, layer1 and those stages run as the
        fused CUDA kernels (ops/fused_block.py). Returns self."""
        if (pallas_layer1 or pallas_stem or pallas_stages) and self.cfg.img_size != 224:
            raise ValueError(f"pallas_layer1/pallas_stem/pallas_stages require img_size "
                             f"224 (56x56 layer1 maps), got {self.cfg.img_size}")
        cd = self.cfg.compute_dtype
        folded = {}
        for name in self.posenet.towers:
            tree = fold_bn_resnet(getattr(self.posenet, name))
            entry = {"tree": {k: {"w": v["w"].to(cd).contiguous(memory_format=torch.channels_last),
                                  "b": v["b"].to(cd)} for k, v in tree.items()}}
            if pallas_layer1:
                entry["pallas_l1"] = pack_layer1_weights(tree, cd)
            if pallas_stem:
                entry["pallas_stem"] = pack_stem_weights(tree, cd)
            if pallas_stages:
                entry["pallas_stages"] = {n: pack_stage_weights(tree, n, cd)
                                          for n in pallas_stages}
            folded[name] = entry
        self._folded = folded
        return self

    # ------------------------------------------------------------------ core

    def _detect_best(self, frames_norm: torch.Tensor):
        """YOLO at native resolution -> top-1 box per frame, as xywh in
        original-frame pixels [B, 1, 4], plus the raw decode dict."""
        _, H, W, _ = frames_norm.shape
        stride = max(self.yolo_cfg.strides)
        if H % stride or W % stride:
            raise NotImplementedError(
                f"frames {H}x{W} need the letterbox path (sides must divide "
                f"{stride}); it is not ported yet")
        outputs = self.yolo(frames_norm.to(self.yolo_cfg.dtype))
        dets = decode_topk_nms(outputs, self.yolo_cfg, (H, W), max_det=1,
                               conf_thresh=self.cfg.conf_thresh)
        x1, y1, x2, y2 = dets["boxes"].unbind(-1)
        return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1), dets

    def crop_stage(self, frames: torch.Tensor, camera_K: torch.Tensor,
                   depth_raw_full: torch.Tensor | None = None) -> dict:
        """Everything before the pose net: detection, crop parameters and
        {"inputs": the PoseNet keyword arguments of the variant ("rgb"
        [B,S,S,3] in compute_dtype, and "depth", "depth_raw", "bbox_center",
        "camera_matrix" as the variant takes them), "bbox_xywh", "center"
        (the box centre in the frame), "dets"}."""
        cfg = self.cfg
        S = cfg.img_size
        cd = cfg.compute_dtype
        frames_norm = frames.to(cd) / 255.0
        bbox_xywh, dets = self._detect_best(frames_norm)
        bbox = bbox_xywh[:, 0]
        cx1, cy1, csize = crop_params_from_bbox(bbox)

        def crop(src, dtype):
            return crop_resize_matmul(src.to(dtype), cx1, cy1, csize, S, compute_dtype=dtype)

        crops = eval_preprocess(crop(frames_norm, cd)).to(cd)
        center = torch.stack([bbox[:, 0] + bbox[:, 2] / 2.0, bbox[:, 1] + bbox[:, 3] / 2.0], -1)
        inputs = {"rgb": crops}
        if cfg.variant == "rgb_geometric":
            inputs.update(bbox_center=center, camera_matrix=camera_K)
        elif cfg.variant == "rgbd":
            depth_crop = crop(depth_raw_full[..., None], cd)[..., 0]
            inputs["depth"] = normalize_depth(depth_crop)[..., None].to(cd)
        elif cfg.variant == "rgbd_geometric":
            # crop-frame bookkeeping; the device crop never materializes
            # padding, so the pad terms are zero and x1 may be negative
            scale = S / torch.clamp_min(csize, 1.0)
            zeros = torch.zeros_like(cx1)
            center_crop = torch.stack([((center[:, 0] - cx1) * scale).clamp(0, S - 1),
                                       ((center[:, 1] - cy1) * scale).clamp(0, S - 1)], -1)
            inputs.update(
                depth_raw=crop(depth_raw_full[..., None], torch.float32)[..., 0],
                bbox_center=center_crop,
                camera_matrix=adjust_intrinsics_for_crop(camera_K, cx1, cy1, zeros, zeros, scale))
        return {"inputs": inputs, "bbox_xywh": bbox, "center": center, "dets": dets}

    def _run(self, frames, camera_K, depth_raw_full) -> dict:
        cfg = self.cfg
        st = self.crop_stage(frames, camera_K, depth_raw_full)
        if self._folded:
            rot, trans = serving_forward(self.posenet, self.pose_cfg, **st["inputs"],
                                         compute_dtype=cfg.compute_dtype, folded=self._folded)
        else:
            rot, trans = self.posenet(**st["inputs"])
        trans = trans.float()
        if cfg.variant in ("rgb", "rgbd"):
            # deployment-time X/Y re-derivation from the predicted Z, the box
            # centre and the original intrinsics
            trans = pinhole_xy_from_z(trans[:, 2], st["center"], camera_K)
        dets = st["dets"]
        return {
            "rotation": rot.float(),
            "translation": trans,
            "bbox_xywh": st["bbox_xywh"],
            "class_id": dets["classes"][:, 0],
            "det_score": dets["scores"][:, 0],
            "det_valid": dets["valid"][:, 0],
            "detections": dets,
        }

    # ------------------------------------------------------------------- API

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return t.to(self.device, dtype=dtype)

    @torch.inference_mode()
    def __call__(self, frames, camera_K, depth_raw_full=None) -> dict:
        """frames [B, H, W, 3] uint8; camera_K [B, 3, 3] or [3, 3];
        depth_raw_full [B, H, W] metres (rgbd variants). Numpy arrays or
        tensors; returns a dict of tensors on the pipeline's device."""
        frames = self._tensor(frames)
        camera_K = self._tensor(camera_K, torch.float32)
        if camera_K.ndim == 2:
            camera_K = camera_K.expand(frames.shape[0], 3, 3)
        if self.cfg.variant in ("rgbd", "rgbd_geometric"):
            if depth_raw_full is None:
                raise ValueError(f"variant {self.cfg.variant!r} needs depth_raw_full")
            depth_raw_full = self._tensor(depth_raw_full, torch.float32)
        return self._run(frames, camera_K, depth_raw_full)
