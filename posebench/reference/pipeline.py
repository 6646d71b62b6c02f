"""The serving request, float32, in plain PyTorch: what the benchmark holds
the program's outputs against.

detections(): frames -> YOLOv8 -> for every anchor of every level its box
(the DFL expectation: a softmax over reg_max bins per side, in stride
units, about the anchor's cell centre), its best class logit and that
class. The benchmark judges the program's detections against these
(judge.py); it does not run a decode of its own, so that it can say how
far each detection the program returned lies from the best one.

poses(): for boxes given in the frame (the program's own, the way a served
model's tokens are fed to its reference), the square crop at 1.2x the
box's larger side with the host's int() truncation, a bilinear resize by
gathering the four neighbours (pixel centres at half-integers, samples
clamped into the crop, pixels outside the frame 0), ImageNet
normalisation, the towers and heads, and the translation:
  rgbd            the head's Z, X/Y from Z, the box centre and K;
  rgbd_geometric  the depth crop at the box centre (clipped into the crop;
                  readings <= 0.01 m become 0.5 m, then clamped to
                  [0.1, 2.0] m) back-projected through the crop's K.
"""

from __future__ import annotations

import contextlib

import torch

from . import nets

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CROP_EXPANSION = 1.2
DEPTH_MIN_M, DEPTH_MAX_M, DEPTH_INVALID_M = 0.1, 1.6, 0.01
DEPTH_FALLBACK_M, DEPTH_GUARD_MAX_M = 0.5, 2.0
STRIDES = (8, 16, 32)


def detections(sd_yolo: dict, frames_u8: torch.Tensor, reg_max: int = 16) -> dict:
    """frames [B, H, W, 3] uint8 -> {"boxes" [B, A, 4] xyxy pixels, "logit"
    [B, A] the best class logit, "cls" [B, A] its class, "stride" [A]}."""
    x = frames_u8.permute(0, 3, 1, 2).float() / 255.0
    B, _, H, W = x.shape
    boxes, logits, classes, strides = [], [], [], []
    for (box, cls), s in zip(nets.yolo_levels(sd_yolo, x), STRIDES):
        h, w = box.shape[2:]
        dist = torch.softmax(box.reshape(B, 4, reg_max, h, w), dim=2)
        ltrb = (dist * torch.arange(reg_max, device=x.device, dtype=x.dtype)[:, None, None]
                ).sum(2)  # [B, 4, h, w]
        gy, gx = torch.meshgrid(torch.arange(h, device=x.device, dtype=x.dtype) + 0.5,
                                torch.arange(w, device=x.device, dtype=x.dtype) + 0.5,
                                indexing="ij")
        xyxy = torch.stack([gx - ltrb[:, 0], gy - ltrb[:, 1], gx + ltrb[:, 2], gy + ltrb[:, 3]],
                           dim=-1) * s  # [B, h, w, 4]
        best, arg = cls.max(dim=1)
        boxes.append(xyxy.reshape(B, h * w, 4))
        logits.append(best.reshape(B, h * w))
        classes.append(arg.reshape(B, h * w))
        strides.append(torch.full((h * w,), float(s), device=x.device))
    return {"boxes": torch.cat(boxes, 1), "logit": torch.cat(logits, 1),
            "cls": torch.cat(classes, 1), "stride": torch.cat(strides)}


def crop_params(bbox_xywh: torch.Tensor):
    """(x1, y1, size) of the square crop: CROP_EXPANSION x max(w, h) about
    the box centre, each truncated as the host's int() does, a value within
    1e-3 of an integer taken as that integer."""
    x, y, w, h = bbox_xywh.unbind(-1)
    side = torch.maximum(w, h) * CROP_EXPANSION

    def trunc(v):
        r = torch.round(v)
        return torch.trunc(torch.where(torch.abs(v - r) < 1e-3, r, v))

    return trunc(x + w / 2.0 - side / 2.0), trunc(y + h / 2.0 - side / 2.0), trunc(side)


def crop(images: torch.Tensor, frame: torch.Tensor, x1: torch.Tensor, y1: torch.Tensor,
         size: torch.Tensor, out: int) -> torch.Tensor:
    """Square crops of images [B, H, W, C] f32: crop n of frame[n] at (x1,
    y1) of side size[n], resized bilinearly to [N, out, out, C]."""
    H, W = images.shape[1:3]
    side = size.clamp_min(1.0)[:, None]
    rel = ((torch.arange(out, dtype=torch.float32, device=images.device) + 0.5) / out)[None, :] \
        * size[:, None] - 0.5
    r0 = torch.floor(rel)
    wt = rel - r0

    def index(i, origin, n):
        a = torch.minimum(i.clamp_min(0.0), side - 1.0) + origin[:, None]
        return a.clamp(0, n - 1).long(), (a >= 0) & (a <= n - 1)

    f = frame[:, None, None]

    def sample(yi, xi):
        (ya, vy), (xa, vx) = index(yi, y1, H), index(xi, x1, W)
        vals = images[f, ya[:, :, None], xa[:, None, :]]
        return vals * (vy[:, :, None] & vx[:, None, :])[..., None]

    wx, wy = wt[:, None, :, None], wt[:, :, None, None]
    top = sample(r0, r0) * (1 - wx) + sample(r0, r0 + 1) * wx
    bottom = sample(r0 + 1, r0) * (1 - wx) + sample(r0 + 1, r0 + 1) * wx
    return top * (1 - wy) + bottom * wy


def pinhole(z: torch.Tensor, u: torch.Tensor, v: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    return torch.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], dim=-1)


def normalize_depth(raw: torch.Tensor) -> torch.Tensor:
    d = ((raw - DEPTH_MIN_M) / (DEPTH_MAX_M - DEPTH_MIN_M)).clamp(0.0, 1.0)
    return torch.where(raw < DEPTH_INVALID_M, torch.zeros_like(d), d)


def poses(variant: str, sd: dict, frames_u8: torch.Tensor, depth: torch.Tensor,
          K: torch.Tensor, bbox_xywh: torch.Tensor, frame: torch.Tensor, img: int,
          towers=None):
    """The pose of each box: bbox_xywh [N, 4] in the frames frames_u8[frame]
    ([B, H, W, 3] uint8, depth [B, H, W] metres, K [3, 3]). Returns
    (rotation [N, 4] unit xyzw, translation [N, 3] metres). towers: None,
    or the dtype in which the ResNet-50 towers run BatchNorm-folded, their
    input crops cast to it (the rest stays float32)."""

    def resnet50(prefix, x):
        return nets.resnet50(sd, prefix, x, towers)

    x1, y1, size = crop_params(bbox_xywh)
    mean = torch.tensor(IMAGENET_MEAN, device=frames_u8.device)
    std = torch.tensor(IMAGENET_STD, device=frames_u8.device)
    rgb = (crop(frames_u8.float() / 255.0, frame, x1, y1, size, img) - mean) / std
    depth_crop = crop(depth[..., None], frame, x1, y1, size, img)[..., 0]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = bbox_xywh[:, 0] + bbox_xywh[:, 2] / 2.0
    v = bbox_xywh[:, 1] + bbox_xywh[:, 3] / 2.0
    if variant == "rgbd":
        rgb_feat = resnet50("rgb_backbone", rgb.permute(0, 3, 1, 2))
        depth_feat = resnet50("depth_backbone", normalize_depth(depth_crop)[:, None])
        rot, trans = nets.rgbd_heads(sd, rgb_feat, depth_feat)
        return rot, pinhole(trans[:, 2], u, v, fx, fy, cx, cy)
    if variant == "rgbd_geometric":
        rot = nets.rotation_head_bn(sd, resnet50("backbone", rgb.permute(0, 3, 1, 2)))
        scale = img / size.clamp_min(1.0)
        uc = ((u - x1) * scale).clamp(0, img - 1)
        vc = ((v - y1) * scale).clamp(0, img - 1)
        z = depth_crop[torch.arange(len(uc), device=uc.device), vc.long(), uc.long()]
        z = torch.where(z > DEPTH_INVALID_M, z, torch.full_like(z, DEPTH_FALLBACK_M))
        z = z.clamp(DEPTH_MIN_M, DEPTH_GUARD_MAX_M)
        return rot, pinhole(z, uc, vc, fx * scale, fy * scale, (cx - x1) * scale,
                            (cy - y1) * scale)
    raise ValueError(f"reference: no pose pipeline for variant {variant!r}")


@contextlib.contextmanager
def tf32_off():
    """float32 convolutions and matrix products on the card in float32,
    not TF32, inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
