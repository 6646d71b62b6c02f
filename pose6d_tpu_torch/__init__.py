"""PyTorch + CUDA port of pose6d_tpu for NVIDIA Hopper (H100).

The JAX package `pose6d_tpu` is the reference; this package mirrors its
layout (geometry/, ops/, models/, models/yolo/, infer/, losses/, data/,
train/, configs/) and public conventions (NHWC images, xyzw quaternions) so
that each function can be held against its counterpart. It imports torch,
numpy and the standard library only: LineMOD's yaml files and PNGs are read
by a small C++ library (native/linemod_host.cpp, built with one g++ call
into `_build/` at first use; data/_native.py).

The TPU's Pallas kernels on the serving path are hand-written CUDA C++ under
csrc/, built at first use into `_build/`, one nvcc per source in parallel
(see _build.py).
Every kernel wrapper runs its plain PyTorch version for CPU tensors only; a
CUDA tensor launches the kernel or raises.

Entry points take an explicit `device`; the default is "cuda".
"""

DEFAULT_DEVICE = "cuda"
