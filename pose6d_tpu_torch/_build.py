"""Build and load the hand-written CUDA kernels (csrc/*.cu).

One nvcc process per source, all started together, compiles the sources
to objects, and one more links them into a shared library with a plain C
interface, `_build/libpose6d_kernels.so`, loaded with ctypes. No source
includes PyTorch's headers, so the build takes seconds rather than minutes.
The library is rebuilt when it is missing or older than any source or
header, which happens at the first kernel launch of a process (never at
import time). nvcc runs with `-Xptxas -v`: its output (each kernel's
registers, shared memory and spills) goes to `_build/nvcc.log`.

Every C entry point takes device pointers and the CUDA stream as `void*`,
launches on that stream without synchronising, allocates nothing, and returns
`cudaGetLastError()` as an int; `check()` raises on a non-zero code.

`launch_counts` counts kernel launches by name: each wrapper adds one where
it launches its kernel, and nowhere else. Each wrapper launches inside
`on_device(x.device)`: the C entry points launch on the current device, so
the guard makes x's device current and passes that device's stream.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libpose6d_kernels.so")
LOG_PATH = os.path.join(BUILD_DIR, "nvcc.log")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

launch_counts: collections.Counter = collections.Counter()

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: (name, argtypes); every function returns int (cudaError_t)
_SIGNATURES = {
    # x, w (HWIO), b, out, B, C, stream: the f32 stem (stem.cu)
    "pose6d_stem_f32": [_P, _P, _P, _P, _I, _I, _P],
    # x, w_s2d ([64C, 64]), b, out, B, C, stream: the bf16 stem (stem_tc.cu)
    "pose6d_stem_bf16": [_P, _P, _P, _P, _I, _I, _P],
    # x, weights (array of n_weights pointers), n_weights, n_blocks, t1, t2,
    # ya, yb, out, B, h, w, stride, cin, cmid, cout, is_bf16, plan (array of
    # (tile N, splits) per GEMM), n_plan, ws, tickets, stream
    "pose6d_stage_forward": [_P, ctypes.POINTER(_P), _I, _I, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I), _I,
                             _P, _P, _P],
    # a1, w1, a2, w2, bias, bias2, res, out, ws, tickets, M, N, K1, K2, h, w,
    # ho, wo, stride, conv3x3, tile N, splits, stream
    "pose6d_gemm_bf16": [_P] * 10 + [_I] * 12 + [_P],
    # pred, gt, out, idx (argmin output or null), B, P, tile, R, splits (the
    # plan), stream
    "pose6d_addmin_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # src, idx, out, N, B, R (32-bit words per row), blocks (grid), stream
    "pose6d_gather_rows_u32": [_P, _P, _P, _I, _I, _I, _I, _P],
}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources() + headers())


def _run(procs) -> str:
    """Wait for (command, Popen) pairs; their output, raising if one failed."""
    out = ""
    for cmd, proc in procs:
        text = proc.communicate()[0]
        out += text
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
    return out


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build() -> float:
    """Compile csrc/*.cu if the library is missing or stale (one nvcc per
    source, in parallel, then the link); returns the seconds spent (0.0
    when up to date)."""
    if not _stale():
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{os.getpid()}.o")
            for src in sources()]
    t0 = time.perf_counter()
    log = ""
    try:
        log = _run([_start([_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
                            "-Xcompiler", "-fPIC", "-c", "-o", obj, src])
                    for src, obj in zip(sources(), objs)])
        log += _run([_start([_nvcc(), *ARCH_FLAGS, "-shared", "-o", tmp, *objs])])
    finally:
        with open(LOG_PATH, "w") as f:
            f.write(log)
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, LIB_PATH)  # atomic: concurrent builders never see half
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library, building it first when needed."""
    global _lib
    if _lib is None:
        build()
        handle = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def check_on_card(x: torch.Tensor, tensors=()) -> None:
    """The kernels take contiguous tensors, all on x's CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}: CPU runs the plain "
                         f"version, CUDA the kernel")
    for t in (x, *tensors):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


@contextlib.contextmanager
def on_device(device: torch.device):
    """Make `device` current for a launch and yield its current stream's
    handle (an int, for the C entry points)."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream
