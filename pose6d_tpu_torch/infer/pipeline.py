"""Detect -> crop -> pose serving pipeline (counterpart of
pose6d_tpu/infer/pipeline.py), all four PoseNet variants, any frame size,
one or more poses per frame.

uint8 frames /255 in compute_dtype -> YOLOv8 at native resolution (or on
a centred det_size letterbox where the frame's sides do not divide the
detector's coarsest stride) -> top-1 decode, or top-k + class-aware NMS
for max_objects > 1 -> boxes mapped back to the frame -> square crop at
1.2x each box -> crop+resize as two matmuls (optionally on a per-sample
window) -> ImageNet normalization -> PoseNet over the [B*M] crops (float
towers in PoseNetConfig.dtype, by default compute_dtype as in the JAX
pipeline; BN-folded serving towers after fold_backbones, whose stem,
layer1 and stages may run as CUDA kernels; or int8 towers and an int8
detector after quantize_backbones). Per variant, as in the reference's
deployment scripts:
  - rgb, rgbd: with geometric_correction, X/Y re-derived from the
    predicted Z, the box centre and the original intrinsics;
  - rgb_geometric: the network takes the original-frame centre and K;
  - rgbd: the depth map is cropped in compute_dtype (depth_crop_bf16) or
    f32, and normalized;
  - rgbd_geometric: the depth map is cropped in f32 (its depth is metric)
    and the network takes the crop-frame centre, clipped to the crop, and
    the crop's intrinsics.
A depth variant called without a depth map serves an all-zero one, as the
JAX pipeline does: zero depth is invalid everywhere, so rgbd's depth tower
sees 0 and rgbd_geometric's translation falls back to depth_fallback.

shard(mesh) serves over a parallel.Mesh, one process per rank: every rank
is called with the same full batch (as JAX's caller is), runs detect ->
crop -> towers on its rows of the frames and the heads split over the
model group (parallel/heads.py), and all-gathers the outputs, so that every
rank returns what the unsharded pipeline returns. fold_backbones and
quantize_backbones compose with shard in either order; under a mesh the
calibration's abs-max statistics are reduced with MAX over the data group,
and its percentile statistics are taken over |x| gathered from the data
group, so that every rank calibrates on the whole batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import DEFAULT_DEVICE
from ..data.crop import normalize_depth
from ..geometry.pinhole import adjust_intrinsics_for_crop, pinhole_xy_from_z
from ..models.posenet import VARIANTS, PoseNet, PoseNetConfig
from ..models.posenet_serving import serving_forward
from ..models.yolo.decode import decode_topk_nms
from ..models.yolo.model import YoloConfig, YoloV8
from ..models.yolo.quant import quantize_yolo_from_variables, yolo_int8_model
from ..ops.augment import eval_preprocess
from ..ops.crop_resize import (crop_params_from_bbox, crop_resize_matmul,
                               crop_resize_matmul_windowed)
from ..ops.fused_block import pack_layer1_weights, pack_stage_weights, pack_stem_weights
from ..ops.quant import fold_bn_resnet, quantize_resnet_from_variables


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    variant: str = "rgb"  # rgb | rgb_geometric | rgbd | rgbd_geometric
    img_size: int = 224
    det_size: int = 640  # letterbox side for frames whose sides do not divide the stride
    conf_thresh: float = 0.25
    iou_thresh: float = 0.7
    nms_pre_topk: int = 64
    # greedy-NMS fixpoint iterations: exact for suppression chains up to
    # this depth; None = nms_pre_topk iterations (always exact)
    nms_fixpoint_iters: int | None = 16
    # poses per frame: the top-M detections by score
    max_objects: int = 1
    # max_objects = 1 decodes the best anchor alone (slot 0 of the general
    # NMS path, which never suppresses the global best); False runs the
    # general NMS with max(8, M) detections there too
    nms_top1_fast: bool = True
    # crop from a per-sample window of this side instead of the whole frame
    # (must exceed the largest crop side), for frames much larger than the
    # crops, e.g. 1280x720 with LineMOD objects (crops < 300 px) at 320;
    # None = the whole frame
    crop_window: int | None = None
    geometric_correction: bool = True  # rgb, rgbd: re-derive X/Y at deployment
    # frames, crops and serving towers; the float towers' default dtype
    compute_dtype: torch.dtype = torch.bfloat16
    # rgbd: crop the depth map in compute_dtype (the net sees only the
    # normalized depth); else f32. rgbd_geometric always crops it in f32
    depth_crop_bf16: bool = True


class PosePipeline:
    """Holds both models on `device` and serves __call__(frames, K, depth).

    yolo_state / pose_state are the port's state_dicts (convert.py makes
    them from flax trees or from a seed). Without pose_cfg the pose net is
    PoseNetConfig(variant, img_size, dtype=compute_dtype), as the JAX
    pipeline builds it: its float towers serve in the compute dtype. A
    pose_cfg given keeps its own dtype."""

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
                                                  img_size=pipe_cfg.img_size,
                                                  dtype=pipe_cfg.compute_dtype)
        self.yolo = self._load(YoloV8(yolo_cfg), yolo_state)
        self.posenet = self._load(PoseNet(self.pose_cfg), pose_state)
        self._folded: dict = {}
        # int8 serving mode: {tower name: int8 tree, "__yolo__": the detector's}
        self._quantized: dict = {}
        self._yolo_int8 = None  # the int8 detector over _quantized["__yolo__"]
        self._zero_depth = None  # cached all-zero depth map [B, H, W]
        self.mesh = None

    def _load(self, module, state):
        module.load_state_dict(state, strict=True)
        return module.to(self.device, memory_format=torch.channels_last).eval()

    def shard(self, mesh) -> "PosePipeline":
        """Serve over `mesh` (a parallel.Mesh: this process is one of its
        ranks): frames split over the data axis, the detector and the towers
        replicated, the pose heads Megatron-split over the model axis. Frame
        batches must divide the data axis. Returns self."""
        from ..parallel import shard_posenet

        shard_posenet(self.posenet, mesh)
        self.mesh = mesh
        return self

    def _rows(self, t):
        """This rank's rows of a frame batch (all of it without a mesh)."""
        if self.mesh is None or t is None:
            return t
        from ..parallel.mesh import local_rows

        return t[local_rows(t.shape[0], self.mesh)]

    def _data_group(self):
        """The mesh's data group (the calibration's statistics are taken
        over it), else None."""
        return None if self.mesh is None else self.mesh.data_group

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

    @torch.no_grad()
    def quantize_backbones(self, calib_frames, calib_K, calib_depth=None,
                           percentile: float | None = None,
                           include_detector: bool = False):
        """Enable the int8 serving mode: the float pipeline's crops of
        representative frames (top-1 box, f32; calib_depth [B, H, W] metres,
        or all-zero when None, normalized for every variant) calibrate each
        tower's static activation scales (abs max, or the `percentile` of
        |x|), and every ResNet50 tower goes to per-channel int8
        (ops/quant.py); with include_detector the detector too (abs max),
        calibrated on the canvas it takes (frames / 255 at native
        resolution, or the letterbox). calib_K is taken as the JAX pipeline
        takes it, unused. A tower also folded by fold_backbones runs int8.
        Under a mesh each rank calibrates on its rows of the frames, the abs
        maxes reduced with MAX over the data group and the percentiles taken
        over the inputs gathered from it: every rank holds the scales of the
        whole batch. Returns self."""
        frames = self._rows(self._tensor(calib_frames))
        depth = (torch.zeros(frames.shape[:3], device=self.device) if calib_depth is None
                 else self._rows(self._tensor(calib_depth, torch.float32)))
        crops, depth_norm = self._calib_crops(frames, depth)
        group = self._data_group()
        q = {name: quantize_resnet_from_variables(getattr(self.posenet, name), [x], percentile,
                                                  group)
             for name, x in self.posenet.tower_inputs(crops, depth_norm).items()}
        if include_detector:
            canvas = self._letterbox(frames.float() / 255.0)[0]
            q["__yolo__"] = quantize_yolo_from_variables(self.yolo, [canvas], group)
        return self.load_quantized(q)

    def load_quantized(self, quantized: dict):
        """Serve int8 trees: {tower name: ops.quant.quantize_folded tree,
        optionally "__yolo__": the detector's}, from quantize_backbones or
        carried across from the JAX package's (convert.quantized_from_jax).
        Moves them to the pipeline's device and
        builds the int8 detector once. Returns self."""
        self._quantized = {
            name: {conv: {k: v.to(self.device) if torch.is_tensor(v) else v
                          for k, v in e.items()} for conv, e in tree.items()}
            for name, tree in quantized.items()}
        yolo_q = self._quantized.get("__yolo__")
        self._yolo_int8 = (None if yolo_q is None else
                           yolo_int8_model(yolo_q, self.yolo_cfg, self.cfg.compute_dtype))
        return self

    def _calib_crops(self, frames: torch.Tensor, depth_raw_full: torch.Tensor):
        """The pipeline's crop stage for calibration, in f32: the RGB crops
        after eval_preprocess and the normalized depth crops [B, S, S, 1] of
        each frame's top-1 box, from the float detector."""
        S = self.cfg.img_size
        frames_norm = frames.float() / 255.0
        bbox = self._detect_best(frames_norm)[0][:, 0]
        cx1, cy1, csize = crop_params_from_bbox(bbox)
        crops = eval_preprocess(crop_resize_matmul(frames_norm, cx1, cy1, csize, S,
                                                   compute_dtype=torch.float32))
        dcrop = crop_resize_matmul(depth_raw_full[..., None], cx1, cy1, csize, S,
                                   compute_dtype=torch.float32)
        return crops, normalize_depth(dcrop)

    # ------------------------------------------------------------------ core

    def _letterbox(self, frames_norm: torch.Tensor):
        """Detector input: the frames themselves when their sides divide the
        coarsest stride, else a centred det_size x det_size canvas of
        114/255 with the frames resized into it (bilinear, antialiased when
        it shrinks, as jax.image.resize; computed in f32 and cast once).
        Returns (canvas, scale, pad_l, pad_t, det_hw)."""
        B, H, W, C = frames_norm.shape
        stride = max(self.yolo_cfg.strides)
        if H % stride == 0 and W % stride == 0:
            return frames_norm, 1.0, 0, 0, (H, W)
        D = self.cfg.det_size
        scale = min(D / W, D / H)
        nh, nw = int(round(H * scale)), int(round(W * scale))
        pad_t, pad_l = (D - nh) // 2, (D - nw) // 2
        resized = F.interpolate(frames_norm.permute(0, 3, 1, 2).float(), size=(nh, nw),
                                mode="bilinear", align_corners=False, antialias=True)
        canvas = frames_norm.new_full((B, D, D, C), 114.0 / 255.0)
        canvas[:, pad_t:pad_t + nh, pad_l:pad_l + nw] = resized.permute(0, 2, 3, 1)
        return canvas, scale, pad_l, pad_t, (D, D)

    def _decode(self, outputs, det_hw) -> dict:
        """The detector's raw maps -> detections [B, D, ...] in canvas
        pixels: the top-1 decode (D = 1) when max_objects == 1 and
        nms_top1_fast, else NMS with D = max(8, max_objects)."""
        cfg = self.cfg
        top1 = cfg.max_objects == 1 and cfg.nms_top1_fast
        return decode_topk_nms(outputs, self.yolo_cfg, det_hw,
                               max_det=1 if top1 else max(8, cfg.max_objects),
                               pre_topk=cfg.nms_pre_topk, iou_thresh=cfg.iou_thresh,
                               conf_thresh=cfg.conf_thresh,
                               fixpoint_iters=cfg.nms_fixpoint_iters)

    def _detector(self, canvas: torch.Tensor, yolo_int8=None):
        """The detector's raw maps on its canvas: the float detector in its
        dtype, or the int8 one given."""
        return (self.yolo(canvas.to(self.yolo_cfg.dtype)) if yolo_int8 is None
                else yolo_int8(canvas))

    @staticmethod
    def _frame_boxes(boxes: torch.Tensor, scale, pad_l, pad_t) -> torch.Tensor:
        """Canvas xyxy boxes [B, D, 4] -> xywh in the original frame."""
        x1 = (boxes[..., 0] - pad_l) / scale
        y1 = (boxes[..., 1] - pad_t) / scale
        x2 = (boxes[..., 2] - pad_l) / scale
        y2 = (boxes[..., 3] - pad_t) / scale
        return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)

    def _detect_best(self, frames_norm: torch.Tensor, yolo_int8=None):
        """YOLO (the float detector, or the int8 one given) -> decode ->
        every detection mapped back to the original frame, score-ordered,
        as xywh [B, D, 4], plus the decode dict."""
        canvas, scale, pad_l, pad_t, det_hw = self._letterbox(frames_norm)
        dets = self._decode(self._detector(canvas, yolo_int8), det_hw)
        return self._frame_boxes(dets["boxes"], scale, pad_l, pad_t), dets

    def _per_object(self, t: torch.Tensor) -> torch.Tensor:
        """A per-frame tensor [B, ...] repeated for each of the M objects:
        [B*M, ...], frame-major."""
        M = self.cfg.max_objects
        return t.repeat_interleave(M, dim=0) if M > 1 else t

    def _to_compute(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 frames -> compute_dtype / 255."""
        return frames.to(self.cfg.compute_dtype) / 255.0

    def _pose_boxes(self, all_bbox: torch.Tensor):
        """The top-M boxes of each frame, [B*M, 4] frame-major, and their
        square crop parameters (cx1, cy1, csize) at 1.2x each box."""
        B, M = all_bbox.shape[0], self.cfg.max_objects
        bbox = all_bbox[:, :M].reshape(B * M, 4)
        return bbox, crop_params_from_bbox(bbox)

    def _crop(self, src: torch.Tensor, params, dtype) -> torch.Tensor:
        """[B, H, W, C] -> the [B*M, S, S, C] crops of params (cx1, cy1,
        csize, each [B*M]) in dtype: each of the M crops of a frame reads
        the same source frame, from the whole frame or its crop_window."""
        cfg = self.cfg
        S, M, B = cfg.img_size, cfg.max_objects, src.shape[0]
        src = src.to(dtype)
        params = [p.reshape(B, M) for p in params]
        windowed = cfg.crop_window is not None and cfg.crop_window < min(src.shape[1],
                                                                         src.shape[2])
        outs = []
        for m in range(M):
            xs, ys, ss = (p[:, m] for p in params)
            outs.append(crop_resize_matmul_windowed(src, xs, ys, ss, S, cfg.crop_window,
                                                    compute_dtype=dtype) if windowed
                        else crop_resize_matmul(src, xs, ys, ss, S, compute_dtype=dtype))
        return torch.stack(outs, 1).reshape(B * M, S, S, src.shape[-1])

    def crop_stage(self, frames: torch.Tensor, camera_K: torch.Tensor,
                   depth_raw_full: torch.Tensor | None = None) -> dict:
        """Everything before the pose net, over the [B*M] pose batch (the
        top-M detections of each frame, frame-major): {"inputs": the
        PoseNet keyword arguments of the variant ("rgb" [B*M,S,S,3] in
        compute_dtype, and "depth", "depth_raw", "bbox_center",
        "camera_matrix" as the variant takes them), "bbox_xywh" [B*M, 4],
        "center" (the box centre in the frame), "dets" (the decode dict,
        [B, D, ...])}."""
        cd = self.cfg.compute_dtype
        frames_norm = self._to_compute(frames)
        all_bbox, dets = self._detect_best(frames_norm, self._yolo_int8)
        bbox, params = self._pose_boxes(all_bbox)
        rgb = eval_preprocess(self._crop(frames_norm, params, cd)).to(cd)
        inputs, center = self._pose_inputs(rgb, bbox, params, camera_K, depth_raw_full)
        return {"inputs": inputs, "bbox_xywh": bbox, "center": center, "dets": dets}

    def _pose_inputs(self, rgb: torch.Tensor, bbox: torch.Tensor, params,
                     camera_K: torch.Tensor, depth_raw_full: torch.Tensor | None):
        """The PoseNet keyword arguments of the variant over the [B*M] pose
        batch, from its normalized crops `rgb`, boxes and crop parameters
        (_pose_boxes), and the box centres in the frame: (inputs, center).
        The depth variants crop the depth map here."""
        cfg = self.cfg
        S, cd = cfg.img_size, cfg.compute_dtype
        cx1, cy1, csize = params
        K = self._per_object(camera_K)
        center = torch.stack([bbox[:, 0] + bbox[:, 2] / 2.0, bbox[:, 1] + bbox[:, 3] / 2.0], -1)
        inputs = {"rgb": rgb}
        if cfg.variant == "rgb_geometric":
            inputs.update(bbox_center=center, camera_matrix=K)
        elif cfg.variant == "rgbd":
            depth_crop = self._crop(depth_raw_full[..., None], params,
                                    cd if cfg.depth_crop_bf16 else torch.float32)[..., 0]
            inputs["depth"] = normalize_depth(depth_crop)[..., None].to(cd)
        elif cfg.variant == "rgbd_geometric":
            # crop-frame bookkeeping; the device crop never materializes
            # padding, so the pad terms are zero and x1 may be negative
            scale = S / torch.clamp_min(csize, 1.0)
            zeros = torch.zeros_like(cx1)
            center_crop = torch.stack([((center[:, 0] - cx1) * scale).clamp(0, S - 1),
                                       ((center[:, 1] - cy1) * scale).clamp(0, S - 1)], -1)
            inputs.update(
                depth_raw=self._crop(depth_raw_full[..., None], params, torch.float32)[..., 0],
                bbox_center=center_crop,
                camera_matrix=adjust_intrinsics_for_crop(K, cx1, cy1, zeros, zeros, scale))
        return inputs, center

    def pose_forward(self, inputs: dict):
        """The pose net over crop_stage's inputs: the serving towers (folded
        or int8) when the pipeline has them, else the float module, its
        towers in pose_cfg.dtype. Returns (rotation, translation)."""
        cfg = self.cfg
        if self._folded or self._quantized:
            return serving_forward(self.posenet, self.pose_cfg, **inputs,
                                   compute_dtype=cfg.compute_dtype, folded=self._folded,
                                   quantized=self._quantized)
        return self.posenet(**inputs)

    def _run(self, frames, camera_K, depth_raw_full) -> dict:
        st = self.crop_stage(frames, camera_K, depth_raw_full)
        rot, trans = self.pose_forward(st["inputs"])
        return self._outputs(rot, trans, st, camera_K)

    def _outputs(self, rot, trans, st: dict, camera_K: torch.Tensor) -> dict:
        """The request's outputs from the pose net's (rot, trans) and
        crop_stage's dict: with geometric_correction (rgb, rgbd) X/Y
        re-derived from the predicted Z, the box centre and the original
        intrinsics; [B, M, ...] when max_objects > 1."""
        cfg = self.cfg
        dets = st["dets"]
        B, M = dets["boxes"].shape[0], cfg.max_objects
        trans = trans.float()
        if cfg.geometric_correction and cfg.variant in ("rgb", "rgbd"):
            # deployment-time X/Y re-derivation from the predicted Z, the box
            # centre and the original intrinsics
            trans = pinhole_xy_from_z(trans[:, 2], st["center"], self._per_object(camera_K))

        def shape_out(x):
            return x.reshape(B, M, *x.shape[1:]) if M > 1 else x

        return {
            "rotation": shape_out(rot.float()),
            "translation": shape_out(trans),
            "bbox_xywh": shape_out(st["bbox_xywh"]),
            "class_id": shape_out(dets["classes"][:, :M].reshape(B * M)),
            "det_score": shape_out(dets["scores"][:, :M].reshape(B * M)),
            "det_valid": shape_out(dets["valid"][:, :M].reshape(B * M)),
            "detections": dets,
        }

    # ------------------------------------------------------------------- API

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return t.to(self.device, dtype=dtype)

    @torch.inference_mode()
    def __call__(self, frames, camera_K, depth_raw_full=None) -> dict:
        """frames [B, H, W, 3] uint8; camera_K [B, 3, 3] or [3, 3];
        depth_raw_full [B, H, W] metres (rgbd variants; None serves an
        all-zero map). Numpy arrays or tensors; returns a dict of tensors on
        the pipeline's device. After shard(), every rank passes the same
        full batch and gets the full outputs."""
        frames = self._tensor(frames)
        camera_K = self._tensor(camera_K, torch.float32)
        if camera_K.ndim == 2:
            camera_K = camera_K.expand(frames.shape[0], 3, 3)
        if self.cfg.variant in ("rgbd", "rgbd_geometric"):
            depth_raw_full = (self._zero_depth_map(frames.shape[:3]) if depth_raw_full is None
                              else self._tensor(depth_raw_full, torch.float32))
        if self.mesh is None:
            return self._run(frames, camera_K, depth_raw_full)
        from ..parallel.collectives import all_gather_rows

        out = self._run(*(self._rows(t) for t in (frames, camera_K, depth_raw_full)))
        group = self.mesh.data_group

        def gather(v):
            return ({k: gather(x) for k, x in v.items()} if isinstance(v, dict)
                    else all_gather_rows(v, group))

        return gather(out)

    def _zero_depth_map(self, shape) -> torch.Tensor:
        """The all-zero f32 depth map of `shape` [B, H, W], cached per shape."""
        if self._zero_depth is None or self._zero_depth.shape != shape:
            self._zero_depth = torch.zeros(shape, device=self.device)
        return self._zero_depth
