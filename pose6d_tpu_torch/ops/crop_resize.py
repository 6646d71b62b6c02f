"""Batched square crop + bilinear resize on the device (counterpart of
pose6d_tpu/ops/crop_resize.py).

Sampling follows cv2.INTER_LINEAR: pixel centres at half-integers,
src = (dst + 0.5) * (size / out) - 0.5; samples clamp to the crop window
(edge replication inside the crop) and crop pixels outside the image read 0
(the reference's zero padding). Crop parameters (x1, y1, size) are
per-sample floats in the original frame; padding never materialises.
"""

from __future__ import annotations

import torch


def crop_resize_bilinear(images: torch.Tensor, x1: torch.Tensor,
                         y1: torch.Tensor, size: torch.Tensor,
                         out_size: int) -> torch.Tensor:
    """Gather formulation (the oracle): [B, H, W, C] -> [B, S, S, C] f32."""
    images = images.float()
    B, H, W, C = images.shape
    S = out_size
    d = (torch.arange(S, dtype=torch.float32, device=images.device) + 0.5) / S
    rel = d[None, :] * size[:, None] - 0.5  # [B, S], same for x and y
    r0 = torch.floor(rel)
    w = rel - r0
    r0i = r0.to(torch.int64)
    szi = size.to(torch.int64)[:, None]

    def axis_index(i, origin, n):
        # clamp into the crop window, then shift to absolute image pixels
        i = torch.minimum(torch.clamp_min(i, 0), szi - 1)
        a = i + origin.to(torch.int64)[:, None]
        return a.clamp(0, n - 1), (a >= 0) & (a < n)

    bidx = torch.arange(B, device=images.device)[:, None, None]

    def gather(yi, xi):
        ya, vy = axis_index(yi, y1, H)
        xa, vx = axis_index(xi, x1, W)
        vals = images[bidx, ya[:, :, None], xa[:, None, :]]  # [B, S, S, C]
        valid = (vy[:, :, None] & vx[:, None, :])[..., None]
        return torch.where(valid, vals, torch.zeros_like(vals))

    wx = w[:, None, :, None]
    wy = w[:, :, None, None]
    top = gather(r0i, r0i) * (1 - wx) + gather(r0i, r0i + 1) * wx
    bot = gather(r0i + 1, r0i) * (1 - wx) + gather(r0i + 1, r0i + 1) * wx
    return top * (1 - wy) + bot * wy


def _interp_matrix(start: torch.Tensor, size: torch.Tensor, in_dim: int,
                   out_size: int) -> torch.Tensor:
    """Per-sample bilinear interpolation matrix [B, out_size, in_dim]: row i
    carries the two weights of output pixel i; out-of-image columns never
    match, which is the zero padding."""
    dev = start.device
    d = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) / out_size
    rel = d[None, :] * size[:, None] - 0.5
    r0 = torch.floor(rel)
    w1 = rel - r0
    hi = torch.clamp_min(size, 1.0)[:, None] - 1.0
    i0 = torch.minimum(torch.clamp_min(r0, 0.0), hi)
    i1 = torch.minimum(torch.clamp_min(r0 + 1.0, 0.0), hi)
    a0 = i0 + start[:, None]
    a1 = i1 + start[:, None]
    cols = torch.arange(in_dim, dtype=torch.float32, device=dev)[None, None, :]
    m0 = (cols == a0[..., None]).float() * (1.0 - w1)[..., None]
    m1 = (cols == a1[..., None]).float() * w1[..., None]
    return m0 + m1


def crop_resize_matmul(images: torch.Tensor, x1: torch.Tensor,
                       y1: torch.Tensor, size: torch.Tensor, out_size: int,
                       compute_dtype=torch.float32, src_scale: float = 1.0) -> torch.Tensor:
    """Crop+resize as two batched matmuls, V_y @ img @ V_x^T, in
    compute_dtype (bf16 for image data feeding a bf16 network, f32 for
    metric depth). [B, H, W, C] -> [B, S, S, C] float32. src_scale is
    folded into V_y (in compute_dtype, the scale rounded to it first), so
    e.g. uint8-valued frames crop straight to [0, 1] with 1/255."""
    B, H, W, C = images.shape
    vy = _interp_matrix(y1, size, H, out_size).to(compute_dtype)
    vx = _interp_matrix(x1, size, W, out_size).to(compute_dtype)
    if src_scale != 1.0:
        vy = vy * torch.tensor(src_scale, dtype=compute_dtype, device=vy.device)
    images = images.to(compute_dtype)
    tmp = torch.einsum("btw,bhwc->bhtc", vx, images)
    out = torch.einsum("bsh,bhtc->bstc", vy, tmp)
    return out.float()


def crop_resize_matmul_windowed(images: torch.Tensor, x1: torch.Tensor,
                                y1: torch.Tensor, size: torch.Tensor, out_size: int,
                                window: int, compute_dtype=torch.float32,
                                src_scale: float = 1.0) -> torch.Tensor:
    """crop_resize_matmul on a per-sample [window, window] slice of each
    frame: the interpolation matrices and the matmuls' K shrink from H, W
    to window. The slice starts at trunc(x1), trunc(y1) clipped into the
    frame, and sizes are clamped to window - 2, so a crop larger than that
    loses its outer border (pick window above the largest crop side).
    The slices are one index gather over the batch."""
    B, H, W, C = images.shape
    window = min(window, H, W)
    size = torch.clamp_max(size, window - 2)
    wx0 = torch.trunc(x1).clamp(0, W - window).to(torch.int64)
    wy0 = torch.trunc(y1).clamp(0, H - window).to(torch.int64)
    off = torch.arange(window, device=images.device)
    rows = (wy0[:, None] + off)[:, :, None]  # [B, window, 1]
    cols = (wx0[:, None] + off)[:, None, :]  # [B, 1, window]
    sub = images[torch.arange(B, device=images.device)[:, None, None], rows, cols]
    return crop_resize_matmul(sub, x1 - wx0.to(x1.dtype), y1 - wy0.to(y1.dtype), size,
                              out_size, compute_dtype, src_scale)


def crop_params_from_bbox(bbox_xywh: torch.Tensor, expansion: float = 1.2):
    """Square crop at expansion * max(w, h) around the box centre with the
    host contract's int() truncation: x1 = int(cx - size/2),
    size = int(size_f). Returns (x1, y1, size) as floats."""
    x, y, w, h = bbox_xywh.unbind(-1)
    cx = x + w / 2.0
    cy = y + h / 2.0
    size_f = torch.maximum(w, h) * expansion

    def trunc_like_int(v):
        # the host computes in float64; a float32 value within 1e-3 of an
        # integer snaps to it before truncating (19.999998 -> 20, not 19)
        r = torch.round(v)
        return torch.trunc(torch.where(torch.abs(v - r) < 1e-3, r, v))

    return (trunc_like_int(cx - size_f / 2.0), trunc_like_int(cy - size_f / 2.0),
            trunc_like_int(size_f))
