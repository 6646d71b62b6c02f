"""ctypes bridge to the port's host C++ library (native/linemod_host.cpp):
the LineMOD gt.yml / info.yml parser (counterpart of
pose6d_tpu/data/_native.py) and the PNG row unfilter of data/png.py.

One `g++ -O3 -shared -fPIC` call builds the library into the gitignored
`_build/liblinemod_host.so` at its first use, never at import; it is rebuilt
when older than its source. There is no PyYAML fallback (the card's machine
has no yaml): a failed build raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, List

import numpy as np

from .. import _build

SRC = os.path.join(os.path.dirname(_build.CSRC_DIR), "native", "linemod_host.cpp")
LIB_PATH = os.path.join(_build.BUILD_DIR, "liblinemod_host.so")

_lock = threading.Lock()
_lib = None
_DOUBLE_PP = ctypes.POINTER(ctypes.POINTER(ctypes.c_double))


def build() -> None:
    """Compile the library if it is missing or older than its source.
    Raises RuntimeError with g++'s output on failure."""
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SRC):
        return
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    try:
        run = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SRC],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"g++ could not build {SRC}: {e}") from e
    if run.returncode != 0:
        raise RuntimeError(f"g++ failed ({run.returncode}) on {SRC}:\n{run.stdout}{run.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader never sees half


def lib() -> ctypes.CDLL:
    """The loaded library, building it first when needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            handle = ctypes.CDLL(LIB_PATH)
            for name in ("parse_gt_yml", "parse_info_yml"):
                fn = getattr(handle, name)
                fn.restype = ctypes.c_long
                fn.argtypes = [ctypes.c_char_p, _DOUBLE_PP]
            handle.linemod_free.restype = None
            handle.linemod_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
            handle.png_unfilter.restype = ctypes.c_long
            handle.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                                            ctypes.c_long, ctypes.c_int]
            _lib = handle
    return _lib


def _rows(fn_name: str, path: str, row_len: int) -> np.ndarray:
    handle = lib()
    ptr = ctypes.POINTER(ctypes.c_double)()
    n = getattr(handle, fn_name)(os.fsencode(path), ctypes.byref(ptr))
    if n < 0:
        raise ValueError(f"{path}: not a LineMOD {os.path.basename(path)} the parser reads")
    try:
        if n == 0:
            return np.zeros((0, row_len))
        return np.ctypeslib.as_array(ptr, shape=(int(n) * row_len,)).reshape(-1, row_len).copy()
    finally:
        handle.linemod_free(ptr)


def parse_gt(path: str) -> Dict[int, List[dict]]:
    """gt.yml -> {frame_id: [{'obj_id', 'obj_bb', 'cam_R_m2c', 'cam_t_m2c'}]},
    the values as yaml.safe_load gives them (lists of floats, an int id)."""
    out: Dict[int, List[dict]] = {}
    for row in _rows("parse_gt_yml", path, 18):
        out.setdefault(int(row[0]), []).append({
            "obj_id": int(row[1]),
            "obj_bb": row[2:6].tolist(),
            "cam_R_m2c": row[6:15].tolist(),
            "cam_t_m2c": row[15:18].tolist(),
        })
    return out


def parse_info(path: str) -> Dict[int, dict]:
    """info.yml -> {frame_id: {'cam_K', 'depth_scale'}}."""
    return {int(row[0]): {"cam_K": row[1:10].tolist(), "depth_scale": float(row[10])}
            for row in _rows("parse_info_yml", path, 11)}


def png_unfilter(raw: bytes, height: int, stride: int, bpp: int, what: str) -> np.ndarray:
    """Undo the PNG row filters of `raw`, the inflated stream of `height`
    rows of one filter byte and `stride` bytes each; returns the
    reconstructed bytes [height, stride] uint8. `what` names the file in
    the error raised for a short stream or an unknown filter type."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{what}: image data holds {len(raw)} bytes, "
                         f"expected {height * (stride + 1)}")
    src = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty((height, stride), dtype=np.uint8)
    bad = lib().png_unfilter(src.ctypes.data, out.ctypes.data, height, stride, bpp)
    if bad:
        raise ValueError(f"{what}: row {bad - 1} has filter type {src[(bad - 1) * (stride + 1)]}, "
                         f"not 0-4")
    return out
