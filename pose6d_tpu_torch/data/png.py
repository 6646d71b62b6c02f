"""PNG reader for LineMOD's two image formats (in place of the JAX loader's
cv2.imread, pose6d_tpu/data/pipeline.py:87-106; the card's machine has
neither cv2 nor PIL).

  - 8-bit RGB (colour type 2) -> [H, W, 3] uint8 in RGB order (cv2 reads
    BGR, and the JAX loader converts it to RGB);
  - 16-bit grey (colour type 0) -> [H, W] uint16 (stored big-endian).

The IDAT stream is inflated with zlib and its row filters undone in C++
(data/_native.py). Interlaced, palette, alpha or other bit-depth images
raise ValueError naming the file, as do a bad chunk CRC and a truncated
stream. Ancillary chunks are skipped.
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
