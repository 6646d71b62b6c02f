"""The square-crop and depth contract (counterpart of
pose6d_tpu/data/crop.py and data/pipeline.py's constants; reference
data/dataset_rgb.py:83-147, data/dataset_rgbd.py:85-206): its constants,
the rgbd network's depth normalization (torch, and numpy for the host
loader), and the host half of the crop: bbox jitter, the scalar crop
bookkeeping with the reference's int() truncations, the crop's intrinsics,
and crop + resize in numpy. rgbd_geometric's depth guards reuse the depth
constants.

`crop_resize_image` is cv2.copyMakeBorder + cv2.resize(INTER_LINEAR) without
cv2 (the card's machine has none): zero padding, the crop, then cv2's
bilinear. uint8 follows cv2's fixed-point arithmetic (11-bit coefficients,
the horizontal pass in int, the vertical pass as its SIMD code rounds it)
and equals cv2 bit for bit; uint16 follows its float path and is within 1
of cv2 (the order of cv2's float operations is not reproduced).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

DEPTH_MIN_M = 0.1
DEPTH_MAX_M = 1.6
DEPTH_INVALID_M = 0.01

# square crop side: CROP_EXPANSION * max(w, h) of the (jittered) box
CROP_EXPANSION = 1.2
# train-time bbox jitter per data flavour: (position, scale) fractions of
# the box (data/dataset_rgb.py:101-110, dataset_rgbd.py:110-118)
JITTER = {"rgb": (0.15, 0.20), "rgbd": (0.05, 0.10)}


def normalize_depth(raw: torch.Tensor) -> torch.Tensor:
    """Metric depth -> the rgbd network's depth channel, same shape:
    clip((raw - 0.1) / 1.5, 0, 1), and 0 where raw < 0.01 m (invalid)."""
    d = torch.clamp((raw - DEPTH_MIN_M) / (DEPTH_MAX_M - DEPTH_MIN_M), 0.0, 1.0)
    return torch.where(raw < DEPTH_INVALID_M, torch.zeros_like(d), d)


def normalize_depth_np(depth_raw_m: np.ndarray) -> np.ndarray:
    """normalize_depth for the host loader's numpy arrays, float32 out."""
    d = np.clip((depth_raw_m - DEPTH_MIN_M) / (DEPTH_MAX_M - DEPTH_MIN_M), 0.0, 1.0)
    return np.where(depth_raw_m < DEPTH_INVALID_M, 0.0, d).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class CropParams:
    """One square crop: its origin (x1, y1) in the PADDED frame and integer
    side `size`; the zero padding of the original frame; the resize scale
    img_size / size; the original box centre (the label) and that centre in
    resized-crop pixels, clipped to [0, img_size - 1]."""

    x1: int
    y1: int
    size: int
    pad_l: int
    pad_t: int
    pad_r: int
    pad_b: int
    scale: float
    center_orig: Tuple[float, float]
    center_crop: Tuple[float, float]
    img_size: int


def jitter_bbox(bbox: np.ndarray, rng: np.random.Generator, pos_frac: float,
                scale_frac: float) -> np.ndarray:
    """Train-time bbox jitter (JITTER's fractions per flavour): four
    uniform draws in rng's order, each offset truncated to an int as the
    reference does."""
    x, y, w, h = bbox
    jx = int(rng.uniform(-pos_frac, pos_frac) * w)
    jy = int(rng.uniform(-pos_frac, pos_frac) * h)
    sw = int(rng.uniform(-scale_frac, scale_frac) * w)
    sh = int(rng.uniform(-scale_frac, scale_frac) * h)
    return np.asarray([x + jx, y + jy, w + sw, h + sh], dtype=np.float64)


def compute_crop_params(bbox_jittered: np.ndarray, bbox_orig: np.ndarray, img_w: int,
                        img_h: int, img_size: int = 224) -> CropParams:
    """The crop around the jittered box: side int(1.2 max(w, h)), origin
    int() of the centre minus half of it, padding where it leaves the frame;
    the original box's centre mapped into the resized crop."""
    x, y, w, h = bbox_jittered
    xo, yo, wo, ho = bbox_orig
    c_x, c_y = x + w / 2.0, y + h / 2.0
    size_f = max(w, h) * CROP_EXPANSION
    x1 = int(c_x - size_f / 2.0)
    y1 = int(c_y - size_f / 2.0)
    size = int(size_f)
    pad_l = max(0, -x1)
    pad_t = max(0, -y1)
    pad_r = max(0, (x1 + size) - img_w)
    pad_b = max(0, (y1 + size) - img_h)
    x1p, y1p = x1 + pad_l, y1 + pad_t
    scale = img_size / size if size > 0 else 0.0
    center_orig = (xo + wo / 2.0, yo + ho / 2.0)
    ccx = float(np.clip((center_orig[0] + pad_l - x1p) * scale, 0, img_size - 1))
    ccy = float(np.clip((center_orig[1] + pad_t - y1p) * scale, 0, img_size - 1))
    return CropParams(x1=x1p, y1=y1p, size=size, pad_l=pad_l, pad_t=pad_t, pad_r=pad_r,
                      pad_b=pad_b, scale=scale, center_orig=center_orig,
                      center_crop=(ccx, ccy), img_size=img_size)


def adjust_K_for_crop(cam_K: np.ndarray, p: CropParams) -> np.ndarray:
    """The crop's intrinsics [3, 3] float32: fx' = fx s and
    cx' = (cx + pad_l - x1) s with the padded-frame x1."""
    fx, fy = cam_K[0, 0], cam_K[1, 1]
    cx, cy = cam_K[0, 2], cam_K[1, 2]
    return np.asarray([[fx * p.scale, 0.0, (cx + p.pad_l - p.x1) * p.scale],
                       [0.0, fy * p.scale, (cy + p.pad_t - p.y1) * p.scale],
                       [0.0, 0.0, 1.0]], dtype=np.float32)


def _linear_taps(src: int, dst: int, clamp_weight: bool):
    """cv2's INTER_LINEAR taps along one axis: for each output index, the
    two source indices and the float32 weight of the second. The source
    coordinate is (d + 0.5) / (dst / src) - 0.5 in double, rounded to
    float32. Along x (clamp_weight) a coordinate outside [0, src - 1] takes
    the edge pixel with weight 0; along y cv2 keeps the weight and clamps
    the two row indices, which its fixed-point rounding can tell apart."""
    f = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weight:
        out = (s < 0) | (s >= src - 1)
        f[out] = 0.0
        s = np.where(s < 0, 0, np.where(s >= src - 1, src - 1, s))
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f


def resize_linear(image: np.ndarray, size: int) -> np.ndarray:
    """cv2.resize(image, (size, size), interpolation=INTER_LINEAR) for an
    [H, W] or [H, W, C] uint8 or uint16 image."""
    h, w = image.shape[:2]
    xi0, xi1, fx = _linear_taps(w, size, True)
    yi0, yi1, fy = _linear_taps(h, size, False)
    col = (1, -1) + (1,) * (image.ndim - 2)
    row = (-1,) + (1,) * (image.ndim - 1)
    one = np.float32(1.0)
    if image.dtype == np.uint8:
        # 11-bit fixed point: the horizontal pass exact in int32, the
        # vertical pass as ((h0 >> 4) b0 >> 16) + ((h1 >> 4) b1 >> 16), + 2, >> 2
        cx1 = np.rint(fx * 2048).astype(np.int32).reshape(col)
        cx0 = np.rint((one - fx) * 2048).astype(np.int32).reshape(col)
        cy1 = np.rint(fy * 2048).astype(np.int32).reshape(row)
        cy0 = np.rint((one - fy) * 2048).astype(np.int32).reshape(row)
        a = image.astype(np.int32)
        hz = a[:, xi0] * cx0 + a[:, xi1] * cx1
        v = ((((hz[yi0] >> 4) * cy0) >> 16) + (((hz[yi1] >> 4) * cy1) >> 16) + 2) >> 2
        return np.clip(v, 0, 255).astype(np.uint8)
    if image.dtype == np.uint16:
        a = image.astype(np.float32)
        hz = a[:, xi0] * (one - fx).reshape(col) + a[:, xi1] * fx.reshape(col)
        v = hz[yi0] * (one - fy).reshape(row) + hz[yi1] * fy.reshape(row)
        return np.clip(np.rint(v), 0, 65535).astype(np.uint16)
    raise TypeError(f"resize_linear takes uint8 or uint16 images, got {image.dtype}")


def crop_resize_image(image: np.ndarray, p: CropParams) -> np.ndarray:
    """Zero-pad the frame by p's padding, take the [size, size] crop at
    (x1, y1) of the padded frame and resize it to img_size (cv2's
    copyMakeBorder + resize, see the module docstring). [H, W(, C)] uint8
    or uint16 -> [img_size, img_size(, C)]."""
    h, w = image.shape[:2]
    if p.size <= 0:
        raise ValueError(f"empty crop: {p}")
    crop = np.zeros((p.size, p.size) + image.shape[2:], dtype=image.dtype)
    # the crop in original-frame coordinates, and its part inside the frame
    x0, y0 = p.x1 - p.pad_l, p.y1 - p.pad_t
    sx0, sy0 = max(x0, 0), max(y0, 0)
    sx1, sy1 = min(x0 + p.size, w), min(y0 + p.size, h)
    if sx1 > sx0 and sy1 > sy0:
        crop[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = image[sy0:sy1, sx0:sx1]
    return resize_linear(crop, p.img_size)
