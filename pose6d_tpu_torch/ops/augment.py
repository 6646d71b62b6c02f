"""Photometric augmentation and eval preprocessing on the device
(counterpart of pose6d_tpu/ops/augment.py). Images are [B, H, W, 3]
(NHWC), float32 in [0, 1] before normalization.

The train half replaces the reference's torchvision stack
(scripts/training/train_rgb.py:43-50):
    ColorJitter(brightness=0.3, contrast=0.3, saturation=0.3, hue=0.05)
    RandomGrayscale(p=0.1)                   # the rgb variant only
    Normalize(ImageNet mean/std)
    RandomErasing(p=0.2, scale=(0.02, 0.1))  # after normalize
as batched, branch-free tensor math: per-image factors, a per-image order
of the four jitter ops, and selects instead of control flow. Randomness
comes from an explicit torch.Generator on the images' device; the factor
distributions and the order permutation are the JAX package's, its random
streams are not.

Under a data-parallel mesh each rank holds its rows of the global batch:
`rows` = (this rank's block, blocks). Every draw is made at the global
batch, as every rank's generator makes it alike, and the rank applies its
block of the draws to its images; the one-process stack on the global batch
draws the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GRAY_WEIGHTS = (0.299, 0.587, 0.114)  # ITU-R 601, torchvision's weights


def to_float01(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]; float images pass through."""
    if rgb.dtype == torch.uint8:
        return rgb.float() / 255.0
    return rgb


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    brightness: float = 0.3
    contrast: float = 0.3
    saturation: float = 0.3
    hue: float = 0.05
    grayscale_p: float = 0.1  # 0.0 disables (only the rgb variant uses it)
    erase_p: float = 0.2
    erase_scale: Tuple[float, float] = (0.02, 0.1)
    erase_ratio: Tuple[float, float] = (0.3, 3.3)


def _channels(values, like: torch.Tensor) -> torch.Tensor:
    """Per-channel constants [C] on like's device, made there by fill
    kernels: a tensor copied from the host would wait for the card, and
    the train epoch never waits."""
    return torch.stack([torch.full((), v, dtype=like.dtype, device=like.device)
                        for v in values])


def rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 1] luminance."""
    return (img * _channels(GRAY_WEIGHTS, img)).sum(-1, keepdim=True)


def _blend(img, other, factor):
    return torch.clamp(factor * img + (1.0 - factor) * other, 0.0, 1.0)


def adjust_brightness(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return _blend(img, torch.zeros_like(img), factor)


def adjust_contrast(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    # torchvision blends toward the mean of the grayscale image
    mean = rgb_to_grayscale(img).mean(dim=(-3, -2, -1), keepdim=True)
    return _blend(img, mean, factor)


def adjust_saturation(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return _blend(img, rgb_to_grayscale(img), factor)


def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img.unbind(-1)
    maxc = img.amax(-1)
    minc = img.amin(-1)
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12), zero)
    safe_delta = torch.where(delta > 0, delta, torch.ones_like(delta))
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, h, zero)
    h = torch.remainder(h / 6.0, 1.0)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    # branch-free sextant select: an elementwise where-chain (a gather over
    # the stacked candidates was the JAX package's catastrophe on the TPU)
    def pick(c0, c1, c2, c3, c4, c5):
        return torch.where(i == 0, c0, torch.where(i == 1, c1, torch.where(
            i == 2, c2, torch.where(i == 3, c3, torch.where(i == 4, c4, c5)))))

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def adjust_hue(img: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """delta broadcasts against [B, H, W] (e.g. [B, 1, 1])."""
    hsv = _rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def _uniform(generator, shape, lo, hi, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return u * (hi - lo) + lo


def _global_batch(b: int, rows) -> int:
    return b if rows is None else b * rows[1]


def _block(t: torch.Tensor, b: int, rows) -> torch.Tensor:
    """This rank's b rows of a draw made at the global batch."""
    return t if rows is None else t.narrow(0, rows[0] * b, b)


def color_jitter_batch(generator: torch.Generator, img: torch.Tensor,
                       cfg: AugmentConfig, rows=None) -> torch.Tensor:
    """torchvision ColorJitter on a batch [B, H, W, 3]: per-image factors
    and a per-image order of the four ops. At each of the 4 positions all
    four ops are computed and a per-image select keeps one."""
    B, dev = img.shape[0], img.device
    G = _global_batch(B, rows)
    shp = (G, 1, 1, 1)
    fb = _uniform(generator, shp, max(0.0, 1 - cfg.brightness), 1 + cfg.brightness, dev)
    fc = _uniform(generator, shp, max(0.0, 1 - cfg.contrast), 1 + cfg.contrast, dev)
    fs = _uniform(generator, shp, max(0.0, 1 - cfg.saturation), 1 + cfg.saturation, dev)
    fh = _uniform(generator, (G, 1, 1), -cfg.hue, cfg.hue, dev)
    # a uniform per-image permutation: the argsort of iid uniforms
    order = torch.argsort(torch.rand((G, 4), generator=generator, device=dev), dim=-1)
    fb, fc, fs, fh, order = (_block(t, B, rows) for t in (fb, fc, fs, fh, order))
    x = img
    for pos in range(4):
        o = order[:, pos].view(B, 1, 1, 1)
        x = torch.where(o == 0, adjust_brightness(x, fb), torch.where(
            o == 1, adjust_contrast(x, fc),
            torch.where(o == 2, adjust_saturation(x, fs), adjust_hue(x, fh))))
    return x


def random_grayscale_batch(generator: torch.Generator, img: torch.Tensor,
                           p: float, rows=None) -> torch.Tensor:
    """Per-image RandomGrayscale on a batch [B, H, W, 3]."""
    B = img.shape[0]
    gray = rgb_to_grayscale(img).expand(img.shape)
    take = torch.rand((_global_batch(B, rows), 1, 1, 1), generator=generator,
                      device=img.device) < p
    return torch.where(_block(take, B, rows), gray, img)


def normalize(img: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    return (img - _channels(mean, img)) / _channels(std, img)


def erase_boxes(img: torch.Tensor, take: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Zero the box [y0, y0 + h) x [x0, x0 + w) of image b where take[b]:
    img [B, H, W, C], the rest [B]."""
    _, H, W, _ = img.shape
    rows = torch.arange(H, device=img.device).view(1, H, 1)
    cols = torch.arange(W, device=img.device).view(1, 1, W)
    yb, xb, hb, wb = (t.view(-1, 1, 1) for t in (y0, x0, h, w))
    inside = (rows >= yb) & (rows < yb + hb) & (cols >= xb) & (cols < xb + wb)
    mask = take.view(-1, 1, 1) & inside
    return torch.where(mask[..., None], torch.zeros_like(img), img)


def random_erasing_batch(generator: torch.Generator, img: torch.Tensor,
                         cfg: AugmentConfig, rows=None) -> torch.Tensor:
    """torchvision RandomErasing (value 0) on a batch [B, H, W, C] of
    normalized images: one draw of area and aspect per image (torchvision
    retries up to 10 times), skipped when the box does not fit; the origin
    is floor(u * range), uniform over the valid origins."""
    B, H, W, _ = img.shape
    dev = img.device
    G = _global_batch(B, rows)
    target = _uniform(generator, (G,), cfg.erase_scale[0], cfg.erase_scale[1], dev) * (H * W)
    log_ratio = _uniform(generator, (G,), math.log(cfg.erase_ratio[0]),
                         math.log(cfg.erase_ratio[1]), dev)
    ratio = torch.exp(log_ratio)
    h = torch.round(torch.sqrt(target * ratio)).to(torch.int32)
    w = torch.round(torch.sqrt(target / ratio)).to(torch.int32)
    fits = (h < H) & (w < W)
    take = (torch.rand((G,), generator=generator, device=dev) < cfg.erase_p) & fits
    h = h.clamp(1, H - 1)
    w = w.clamp(1, W - 1)
    y0 = torch.floor(torch.rand((G,), generator=generator, device=dev)
                     * (H - h + 1).float()).to(torch.int32)
    x0 = torch.floor(torch.rand((G,), generator=generator, device=dev)
                     * (W - w + 1).float()).to(torch.int32)
    return erase_boxes(img, *(_block(t, B, rows) for t in (take, y0, x0, h, w)))


def color_jitter(generator: torch.Generator, img: torch.Tensor,
                 cfg: AugmentConfig) -> torch.Tensor:
    """ColorJitter on one image [H, W, 3]: color_jitter_batch on a batch of
    one (the train path calls the batch form)."""
    return color_jitter_batch(generator, img[None], cfg)[0]


def random_grayscale(generator: torch.Generator, img: torch.Tensor, p: float) -> torch.Tensor:
    """RandomGrayscale on one image [H, W, 3], with probability p."""
    return random_grayscale_batch(generator, img[None], p)[0]


def random_erasing(generator: torch.Generator, img: torch.Tensor,
                   cfg: AugmentConfig) -> torch.Tensor:
    """RandomErasing (value 0) on one normalized image [H, W, C]."""
    return random_erasing_batch(generator, img[None], cfg)[0]


def train_augment(generator: torch.Generator, rgb: torch.Tensor,
                  cfg: AugmentConfig = AugmentConfig(), rows=None) -> torch.Tensor:
    """The train-time stack on a batch [B, H, W, 3] (uint8, or float in
    [0, 1]): jitter -> (grayscale) -> normalize -> erase; `rows` under a
    mesh (see the module docstring)."""
    img = color_jitter_batch(generator, to_float01(rgb), cfg, rows)
    if cfg.grayscale_p > 0:
        img = random_grayscale_batch(generator, img, cfg.grayscale_p, rows)
    return random_erasing_batch(generator, normalize(img), cfg, rows)


def eval_preprocess(rgb: torch.Tensor) -> torch.Tensor:
    """Eval path: normalize only (reference train_rgb.py:52-56)."""
    return normalize(to_float01(rgb))
