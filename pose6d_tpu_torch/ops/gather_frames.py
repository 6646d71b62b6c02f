"""Resident-frame gather for the device-side training pipeline (counterpart
of pose6d_tpu/ops/gather_frames.py).

The device-resident train step keeps a split's decoded frames on the card
as host-packed 32-bit words, [N, R] with one frame per row (uint8 RGB
[H, W, 3] or uint16 depth [H, W] viewed as words), and gathers each step's
batch by index (train/loop.expand_device_batch).

`gather_rows_u32` launches the CUDA kernel (csrc/gather.cu, a persistent
copy: the output's 16 KB chunks dealt round-robin to a grid sized to the
card, `gather_shares`) for a CUDA tensor and runs the plain version
`_gather_rows_plain` for a CPU tensor; any other device raises. Words are
int32 or uint32 (torch's uint32 has few kernels, so the plain version
gathers an int32 view). Both are pure word
moves, bit-exact with `src[idx]`. Indices outside [0, N) clamp into it, in
the kernel and in the plain version alike, as JAX's indexing gather
clamps: no index reads outside the buffer, and checking them would cost a
host sync per step.

`gather_frames` takes a raw [N, ...] buffer of 1-, 2- or 4-byte elements
and views it as words on the device, which torch does for free (XLA would
materialise a copy, hence the JAX package's host pack). A frame that is
not whole 128-word rows takes `index_select` instead, as the JAX package
falls back to `jnp.take`. A non-contiguous `src` raises on every device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _build

LANES = 128  # a row is a whole number of 128-word lines, as on the TPU
# The kernel's grid: blocks per SM, all that fit at once (8 x 256 threads at
# 32 registers; ops/gather_sweep.py times the others)
BLOCKS_PER_SM = 8
CHUNK_VECS = 1024  # 16-byte vectors of a chunk, the unit of the shares (16 KB)

_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def _gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: index_select on the int32 view, clamped indices."""
    rows = idx.to(torch.int64).clamp(0, src.shape[0] - 1)
    return src.view(torch.int32).index_select(0, rows).view(src.dtype)


def gather_blocks(n_vecs: int, slots: int) -> int:
    """The kernel's grid for a copy of n_vecs 16-byte vectors on a card
    that holds `slots` of its blocks at once (SMs x blocks per SM): every
    slot, or one block per chunk if that is fewer."""
    return min(slots, -(-n_vecs // CHUNK_VECS))


def gather_shares(batch: int, row_words: int, blocks: int) -> list:
    """How the kernel cuts out [batch, row_words] among `blocks` blocks:
    the output's V = batch * row_words / 4 16-byte vectors in chunks of
    CHUNK_VECS (the last may be short), block i taking chunks i, i + G,
    i + 2G, ... (G = blocks) in that order, each chunk as its pieces inside
    one row: (b, first vector in row b, vectors), read from source row
    clamp(idx[b])."""
    vpr = row_words // 4
    total = batch * vpr
    shares = []
    for i in range(blocks):
        pieces = []
        for start in range(i * CHUNK_VECS, total, blocks * CHUNK_VECS):
            v, end = start, min(total, start + CHUNK_VECS)
            while v < end:
                b = v // vpr
                n = min(end, (b + 1) * vpr) - v
                pieces.append((b, v - b * vpr, n))
                v += n
        shares.append(pieces)
    return shares


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_gather(src, idx, out, stream: int, blocks_per_sm: int = BLOCKS_PER_SM) -> None:
    blocks = gather_blocks(out.numel() // 4, _sm_count(src.device) * blocks_per_sm)
    code = _build.lib().pose6d_gather_rows_u32(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), src.shape[0], idx.shape[0],
        src.shape[1], blocks, stream)
    _build.check(code, "gather_rows_u32")


def gather_rows_u32(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src [N, R] int32/uint32 words (R % 128 == 0), idx [B] integer ->
    src[idx] [B, R] in src's dtype, bit-exact; indices clamp to [0, N)."""
    if src.ndim != 2 or src.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"src must be [N, R] int32/uint32 words, got "
                        f"{tuple(src.shape)} {src.dtype}")
    n, r = src.shape
    if n == 0 or r % LANES:
        raise ValueError(f"src must have N > 0 rows of R % {LANES} == 0 words, got [{n}, {r}]")
    if idx.ndim != 1 or idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise TypeError(f"idx must be [B] integer, got {tuple(idx.shape)} {idx.dtype}")
    if src.device.type == "cpu":
        return _gather_rows_plain(src, idx.to(src.device))
    _build.check_on_card(src)
    if src.data_ptr() % 16:
        raise ValueError("the kernel takes a 16-byte aligned src")
    if idx.shape[0] > 65535:
        raise ValueError(f"the kernel takes at most 65535 rows per call, got {idx.shape[0]}")
    idx32 = idx.to(device=src.device, dtype=torch.int32).contiguous()
    out = torch.empty((idx.shape[0], r), dtype=src.dtype, device=src.device)
    with _build.on_device(src.device) as stream:
        _launch_gather(src, idx32, out, stream)
    _build.launch_counts["gather_rows_u32"] += 1
    return out


def gather_frames(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx] for a raw frame buffer: src [N, ...] with 1-, 2- or 4-byte
    elements, contiguous; idx [B] integer. Returns [B, ...] in src's dtype,
    bit-exact with `src[idx]`."""
    if not src.is_contiguous():
        # the word view needs the buffer as laid out; a silent copy of a
        # resident split per batch would cost more than the gather
        raise ValueError("gather_frames takes a contiguous src")
    n, frame_shape = src.shape[0], tuple(src.shape[1:])
    size = src.element_size()
    words, rem = divmod(math.prod(frame_shape) * size, 4)
    signed = _SIGNED[size]
    if rem or words % LANES:
        # odd geometry (small fixtures): a plain index_select on a signed view
        rows = idx.to(device=src.device, dtype=torch.int64).clamp(0, n - 1)
        return src.view(signed).index_select(0, rows).view(src.dtype)
    out = gather_rows_u32(src.view(signed).reshape(n, -1).view(torch.int32), idx)
    return out.view(signed).view(src.dtype).reshape((idx.shape[0],) + frame_shape)


def pack_frames_host(a: np.ndarray) -> np.ndarray | None:
    """Host-side pack of a frame buffer [N, ...] (uint8/uint16) into 32-bit
    words [N, R] (a numpy `.view(np.uint32)`, no copy of a contiguous
    array), or None when a frame's bytes are not whole 128-word rows."""
    n = a.shape[0]
    flat = np.ascontiguousarray(a).reshape(n, -1)
    words, rem = divmod(flat.shape[1] * flat.dtype.itemsize, 4)
    if rem != 0 or words % LANES != 0:
        return None
    return flat.view(np.uint32)


def gather_frames_packed(words: torch.Tensor, idx: torch.Tensor, frame_shape: tuple,
                         dtype: torch.dtype) -> torch.Tensor:
    """Gather from a host-packed word buffer: words [N, R] int32/uint32
    (pack_frames_host, as a tensor), returns [B, *frame_shape] in `dtype`,
    bit-exact with `src[idx]` on the original array (little-endian packing
    both sides)."""
    out = gather_rows_u32(words, idx)
    if dtype != out.dtype:
        out = out.view(dtype)
    return out.reshape((idx.shape[0],) + tuple(frame_shape))
