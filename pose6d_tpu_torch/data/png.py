"""PNG reader and writer for LineMOD's two image formats (in place of the JAX loader's
cv2.imread, pose6d_tpu/data/pipeline.py:87-106; the card's machine has
neither cv2 nor PIL).

  - 8-bit RGB (colour type 2) -> [H, W, 3] uint8 in RGB order (cv2 reads
    BGR, and the JAX loader converts it to RGB);
  - 16-bit grey (colour type 0) -> [H, W] uint16 (stored big-endian).

The IDAT stream is inflated with zlib and its row filters undone in C++
(data/_native.py). Interlaced, palette, alpha or other bit-depth images
raise ValueError naming the file, as do a bad chunk CRC and a truncated
stream. Ancillary chunks are skipped.

encode_png / write_png write the same two formats (in place of the JAX
package's cv2.imwrite): each row takes one of the five PNG filters, by
default filter y % 5 on row y, so that every reader path is exercised.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

from . import _native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> (channels, numpy dtype of a sample)
FORMATS = {(8, 2): (3, np.dtype(np.uint8)), (16, 0): (1, np.dtype(">u2"))}


def decode_png(data: bytes, what: str = "<bytes>") -> np.ndarray:
    """The image of a PNG file's bytes; `what` names it in errors."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{what}: not a PNG file")
    pos, header, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{what}: truncated before IEND")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"{what}: truncated {ctype!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(body, zlib.crc32(ctype)) != crc:
            raise ValueError(f"{what}: bad CRC in the {ctype.decode('latin-1')} chunk")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        elif not ctype[0] & 0x20:  # a critical chunk this reader does not know (PLTE, ...)
            raise ValueError(f"{what}: unsupported critical chunk {ctype.decode('latin-1')}")
    if header is None or not idat:
        raise ValueError(f"{what}: no IHDR or no IDAT chunk")
    width, height, depth, color, compression, filt, interlace = header
    if (depth, color) not in FORMATS:
        raise ValueError(f"{what}: bit depth {depth}, colour type {color}: only 8-bit RGB and "
                         f"16-bit grey PNGs are read")
    if interlace or compression or filt:
        raise ValueError(f"{what}: interlaced or non-standard PNG (interlace {interlace}, "
                         f"compression {compression}, filter method {filt})")
    channels, dtype = FORMATS[(depth, color)]
    bpp = channels * dtype.itemsize
    stride = width * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{what}: corrupt image data ({e})") from e
    rows = _native.png_unfilter(raw, height, stride, bpp, what)
    img = rows.view(dtype).reshape(height, width, channels)
    if channels == 1:
        img = img[..., 0]
    return img.astype(dtype.newbyteorder("="))


def png_size(path: str) -> tuple:
    """(width, height) of the PNG file at `path`, from its IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def read_png(path: str) -> np.ndarray:
    """The image of the PNG file at `path` (see the module docstring)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def read_depth(path: Optional[str], shape) -> np.ndarray:
    """A uint16 depth map: the PNG at `path`, or zeros of `shape` (H, W)
    when there is no depth file, as the JAX loader does where cv2.imread
    returns None (pose6d_tpu/data/pipeline.py:103-109)."""
    if path is None or not os.path.exists(path):
        return np.zeros(shape, dtype=np.uint16)
    return read_png(path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (len(body).to_bytes(4, "big") + kind + body
            + zlib.crc32(body, zlib.crc32(kind)).to_bytes(4, "big"))


def encode_png(img: np.ndarray) -> bytes:
    """A PNG of an [H, W, 3] uint8 image (8-bit RGB, stored in that channel
    order) or an [H, W] uint16 one (16-bit grey, big-endian), zlib level 1.
    Row y uses filter type y % 5, so every one of the five filters occurs;
    each filter is computed on its own rows only, in uint8 arithmetic
    (PNG's filters are modulo 256)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        color, depth, bpp = 2, 8, 3
        rows = img.reshape(h, w * 3)
    elif img.dtype == np.uint16 and img.ndim == 2:
        color, depth, bpp = 0, 16, 2
        rows = img.astype(">u2").view(np.uint8).reshape(h, w * 2)
    else:
        raise ValueError(f"encode_png: an [H, W, 3] uint8 or [H, W] uint16 image, got "
                         f"{img.shape} {img.dtype}")
    up_all = np.zeros_like(rows)
    up_all[1:] = rows[:-1]
    data = np.empty((h, rows.shape[1] + 1), np.uint8)
    data[:, 0] = np.arange(h) % 5
    for ftype in range(5):
        x, up = rows[ftype::5], up_all[ftype::5]
        left = np.zeros_like(x)
        left[:, bpp:] = x[:, :-bpp]
        if ftype == 0:
            f = x
        elif ftype == 1:
            f = x - left
        elif ftype == 2:
            f = x - up
        elif ftype == 3:
            f = x - ((left.astype(np.uint16) + up) >> 1).astype(np.uint8)
        else:
            a, b = left.astype(np.int16), up.astype(np.int16)
            c = np.zeros_like(b)
            c[:, bpp:] = b[:, :-bpp]
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            f = x - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)).astype(np.uint8)
        data[ftype::5, 1:] = f
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(data.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """encode_png(img) written to `path`."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
