"""Fused ResNet50 stem and bottleneck stages for the folded serving towers
(counterpart of pose6d_tpu/ops/pallas_block.py fused_stem / fused_layer1 /
fused_stage).

Each wrapper launches its hand-written CUDA kernel for a CUDA tensor: the
stem in f32 on CUDA-core FMAs (csrc/stem.cu), in bf16 on the tensor cores
(csrc/stem_tc.cu, a wgmma implicit GEMM over the space-to-depth taps of
`stem_s2d_weights`); fused_stage, and fused_layer1 (fused_stage at stage 1
behind its own launch count), in f32 on CUDA-core FMAs (csrc/stage.cu), in
bf16 on the tensor cores (csrc/stage_wgmma.cu, tiled and split as
`stage_plan` says). For a CPU tensor it runs its plain PyTorch version,
`reference_stem` / `reference_layer1` / `reference_stage`; any other device
raises. Kernels and plain versions take the same packed weights and keep
the TPU kernels' numeric contract: f32 accumulation, bias and residual
added in f32, activations rounded to the compute type (the dtype of x) at
every conv output that the TPU kernel rounded.

Layouts are NHWC like the JAX package: stem [B,224,224,C] -> [B,56,56,64]
(C = 3 for rgb towers, 1 for the rgbd depth tower); stage n [B,h,w,cin] ->
[B,h/s,w/s,cout] per STAGE_CFGS (layer1 is stage 1, [B,56,56,64] ->
[B,56,56,256]).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from .. import _build

H = W = 56
CIN = 64
STEM_IN = 224

# (name, n_blocks, stride, cin, cmid, cout, h_in, w_in) at 224x224 input
STAGE_CFGS = {
    1: ("layer1", 3, 1, 64, 64, 256, 56, 56),
    2: ("layer2", 4, 2, 256, 128, 512, 56, 56),
    3: ("layer3", 6, 2, 512, 256, 1024, 28, 28),
    4: ("layer4", 3, 2, 1024, 512, 2048, 14, 14),
}


# The bf16 stage kernel (csrc/stage_wgmma.cu): output rows per tile, K per
# step, and the H100's SM count, which a GEMM's blocks should fill
TILE_M = 128
STEP_K = 64
NUM_SMS = 132
MIN_SPLIT_STEPS = 8  # K steps a split should keep before K is cut finer


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """One GEMM of a stage on the bf16 kernel: out [m, n] from A1 [m, k1]
    W1 [k1, n] plus, for block 0's conv3, the shortcut A2 [m, k2] W2 [k2, n]
    in the same accumulator; conv3x3: A1 is the 3x3 patch matrix of a
    [.., k1 / 9]-channel map. Tiles of TILE_M x bn outputs; the k1 + k2 K
    steps of STEP_K (A1's first) split into `splits` contiguous ranges, one
    block each, reduced in split order through an f32 workspace."""

    name: str
    m: int
    n: int
    k1: int
    k2: int
    conv3x3: bool
    bn: int
    splits: int

    @property
    def tiles(self) -> int:
        return -(-self.m // TILE_M) * (self.n // self.bn)

    @property
    def k_steps(self) -> int:
        return (self.k1 + self.k2) // STEP_K

    def split_steps(self, split: int) -> range:
        """The K steps of one split: the kernel's partition (blockIdx.z)."""
        nk = self.k_steps
        return range(split * nk // self.splits, (split + 1) * nk // self.splits)

    @property
    def workspace_bytes(self) -> int:
        """The f32 partial sums [splits, m, n]; none without a split."""
        return 4 * self.splits * self.m * self.n if self.splits > 1 else 0


def _plan_gemm(name: str, m: int, n: int, k1: int, k2: int = 0, conv3x3: bool = False):
    m_tiles = -(-m // TILE_M)
    bn = 128 if n % 128 == 0 and m_tiles * (n // 128) >= NUM_SMS else 64
    tiles = m_tiles * (n // bn)
    steps = (k1 + k2) // STEP_K
    splits = 1
    if tiles < NUM_SMS:
        splits = min(steps, max(2, min(NUM_SMS // tiles, steps // MIN_SPLIT_STEPS)))
    return GemmPlan(name, m, n, k1, k2, conv3x3, bn, splits)


@functools.lru_cache(maxsize=64)
def stage_plan(stage: int, batch: int) -> tuple:
    """The bf16 kernel's GEMMs of `stage` at `batch`, in launch order (per
    block conv1, conv2, conv3 with its shortcut), each with its tile N and
    K splits. Two blocks share an SM at either tile width, so the wide tile
    (128) is taken where its tiles still give every SM one, else 64. A
    GEMM with fewer tiles than SMs splits K: as many splits as give each
    block an SM of its own, at least 2, and no finer than MIN_SPLIT_STEPS
    steps a split unless 2 are needed (python -m
    pose6d_tpu_torch.ops.stage_sweep times the alternatives)."""
    _, n_blocks, stride, cin, cmid, cout, h, w = STAGE_CFGS[stage]
    m_in, m_out = batch * h * w, batch * (h // stride) * (w // stride)
    plan = []
    for j in range(n_blocks):
        plan += [_plan_gemm(f"b{j}.conv1", m_in if j == 0 else m_out, cmid, cin if j == 0 else cout),
                 _plan_gemm(f"b{j}.conv2", m_out, cmid, 9 * cmid, conv3x3=True),
                 _plan_gemm(f"b{j}.conv3", m_out, cout, cmid, cin if j == 0 else 0)]
    return tuple(plan)


def stage_workspace(plan) -> tuple[int, int]:
    """What the wrapper allocates for a plan: the f32 workspace's bytes (the
    largest split GEMM's) and the number of int32 tickets (its most tiles);
    the stage's GEMMs run one after another and share both."""
    split = [g for g in plan if g.splits > 1]
    return (max((g.workspace_bytes for g in split), default=0),
            max((g.tiles for g in split), default=0))


def stem_s2d_weights(w: torch.Tensor) -> torch.Tensor:
    """conv1 [7,7,C,64] HWIO -> [16*4C, 64] in w's dtype: conv1 7x7/s2 as a
    4x4/s1 conv over the 2x2 space-to-depth input, the JAX package's w2cat
    (pallas_block.pack_stem_weights): row (tap (u, v), u and v in -2..1 with
    v fastest; s2d channel (py, px, c)) holds w[2u+py+3, 2v+px+3, c], zero
    where the 7x7 kernel has no tap (ky or kx = -1)."""
    C = w.shape[2]
    w8 = w.new_zeros((8, 8, C, CIN))
    w8[1:, 1:] = w  # index ky + 1 = 2 (u + 2) + py
    return w8.reshape(4, 2, 4, 2, C, CIN).permute(0, 2, 1, 3, 4, 5).reshape(64 * C, CIN).contiguous()


def pack_stem_weights(folded: dict, dtype=torch.bfloat16):
    """The folded conv1 entry (OIHW [64,C,7,7]) as the kernel's tuple:
    (w [7,7,C,64] HWIO in dtype, b [64] f32), and in bf16 also the tensor-
    core kernel's [16*4C, 64] matrix, stem_s2d_weights(w)."""
    w = folded["conv1"]["w"].permute(2, 3, 1, 0).contiguous().to(dtype)
    b = folded["conv1"]["b"].float().contiguous()
    return (w, b, stem_s2d_weights(w)) if dtype == torch.bfloat16 else (w, b)


def pack_stage_weights(folded: dict, stage: int, dtype=torch.bfloat16):
    """One stage's entries of a folded tree as the kernel's tuple of
    6 * n_blocks + 2 tensors, in the JAX package's order: per block w1
    [ci,cm], b1, w2 [9*cm,cm] in (ky, kx, cin) row order, b2, w3 [cm,co], b3,
    and for block 0 also wd [ci,co], bd. Weights are in dtype, biases f32
    [co]."""
    name, n_blocks = STAGE_CFGS[stage][:2]

    def w11(n):
        w = folded[n]["w"]  # [co, ci, 1, 1]
        return w[:, :, 0, 0].t().contiguous().to(dtype)

    def w33(n):
        w = folded[n]["w"]  # [co, ci, 3, 3] -> [(ky, kx, ci), co]
        return w.permute(2, 3, 1, 0).reshape(9 * w.shape[1], w.shape[0]).contiguous().to(dtype)

    def b(n):
        return folded[n]["b"].float().contiguous()

    args = []
    for j in range(n_blocks):
        blk = f"{name}_{j}"
        args += [w11(f"{blk}/conv1"), b(f"{blk}/conv1"), w33(f"{blk}/conv2"),
                 b(f"{blk}/conv2"), w11(f"{blk}/conv3"), b(f"{blk}/conv3")]
        if j == 0:
            args += [w11(f"{blk}/downsample"), b(f"{blk}/downsample")]
    return tuple(args)


def pack_layer1_weights(folded: dict, dtype=torch.bfloat16):
    """The layer1 entries as the kernel's 20-tuple: pack_stage_weights of
    stage 1."""
    return pack_stage_weights(folded, 1, dtype)


def _stage_shapes(stage: int) -> list:
    """The shapes of pack_stage_weights(., stage), in its order."""
    _, n_blocks, _, cin, cmid, cout, _, _ = STAGE_CFGS[stage]
    shapes = []
    for j in range(n_blocks):
        ci = cin if j == 0 else cout
        shapes += [(ci, cmid), (cmid,), (9 * cmid, cmid), (cmid,), (cmid, cout), (cout,)]
        if j == 0:
            shapes += [(cin, cout), (cout,)]
    return shapes


# ------------------------------------------------------------ plain versions


def reference_stem(x: torch.Tensor, weights) -> torch.Tensor:
    """conv1 7x7/s2/pad3 + bias in f32, ReLU, round to x.dtype, maxpool
    3x3/s2/pad1 (torch's -inf padding) -> [B,56,56,64] in x.dtype.
    weights: (w, b, ...) of pack_stem_weights."""
    w, b = weights[:2]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float().permute(3, 2, 0, 1),
                 b.float(), stride=2, padding=3)
    y = F.relu(y).to(x.dtype)
    return F.max_pool2d(y, 3, 2, padding=1).permute(0, 2, 3, 1).contiguous()


def reference_stage(x: torch.Tensor, weights, stage: int) -> torch.Tensor:
    """One stage's folded bottlenecks in f32 with the kernel's roundings:
    conv1/conv2 outputs and each block output round to x.dtype; block 0's
    projection shortcut stays f32 until the block's sum. Block 0's 3x3 conv
    pads 1 on every side at its stride; its 1x1 shortcut reads the even rows
    and columns when the stride is 2."""
    _, n_blocks, stride, *_ = STAGE_CFGS[stage]
    dt = x.dtype

    def mm(a, w, b):  # 1x1 conv on the NHWC map, f32
        return a.float() @ w.float() + b

    def conv3x3(a, w, b, s):
        cm = a.shape[-1]
        w = w.float().reshape(3, 3, cm, -1).permute(3, 2, 0, 1)
        y = F.conv2d(a.permute(0, 3, 1, 2).float(), w, b, stride=s, padding=1)
        return y.permute(0, 2, 3, 1)

    h = x
    it = iter(weights)
    for j in range(n_blocks):
        w1, b1, w2, b2, w3, b3 = (next(it) for _ in range(6))
        s = stride if j == 0 else 1
        if j == 0:
            shortcut = mm(h[:, ::s, ::s], *(next(it) for _ in range(2)))
        else:
            shortcut = h.float()
        t = F.relu(mm(h, w1, b1)).to(dt)
        t = F.relu(conv3x3(t, w2, b2, s)).to(dt)
        h = F.relu(mm(t, w3, b3) + shortcut).to(dt)
    return h.contiguous()


def reference_layer1(x: torch.Tensor, weights) -> torch.Tensor:
    """reference_stage of stage 1."""
    return reference_stage(x, weights, 1)


# ------------------------------------------------------------------ kernels


def _dtype_flag(x: torch.Tensor) -> int:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected float32 or bfloat16, got {x.dtype}")
    return int(x.dtype == torch.bfloat16)


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    """What the kernel takes, checked for every device so that the plain
    path refuses the same inputs."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _launch_stem(x, weights, out, stream: int) -> None:
    B, _, _, C = x.shape
    if x.dtype == torch.bfloat16:  # the tensor cores, on the s2d weight matrix
        launch, w = _build.lib().pose6d_stem_bf16, weights[2]
    else:
        launch, w = _build.lib().pose6d_stem_f32, weights[0]
    code = launch(x.data_ptr(), w.data_ptr(), weights[1].data_ptr(), out.data_ptr(), B, C, stream)
    _build.check(code, "fused_stem")


def _launch_stage(x, weights, stage: int, scratch, out, stream: int) -> None:
    _, n_blocks, stride, cin, cmid, cout, h, w = STAGE_CFGS[stage]
    ptrs = (ctypes.c_void_p * len(weights))(*(t.data_ptr() for t in weights))
    t1, t2, ya, yb, ws, tickets = scratch
    bf16 = _dtype_flag(x)
    plan = stage_plan(stage, x.shape[0]) if bf16 else ()
    flat = (ctypes.c_int * (2 * len(plan)))(*(v for g in plan for v in (g.bn, g.splits)))
    code = _build.lib().pose6d_stage_forward(
        x.data_ptr(), ptrs, len(weights), n_blocks, t1.data_ptr(), t2.data_ptr(),
        ya.data_ptr(), yb.data_ptr(), out.data_ptr(), x.shape[0], h, w, stride,
        cin, cmid, cout, bf16, flat, len(plan), ws.data_ptr(), tickets.data_ptr(), stream)
    _build.check(code, f"fused_stage(stage={stage})")


def fused_stem(x: torch.Tensor, weights) -> torch.Tensor:
    """conv1 + ReLU + maxpool as one kernel. x [B,224,224,C] (C 3 or 1) in
    f32 or bf16; weights from pack_stem_weights in x's dtype ((w, b) in
    f32, (w, b, w_s2d) in bf16). Returns [B,56,56,64] in x.dtype."""
    bf16 = _dtype_flag(x)
    if x.ndim != 4 or x.shape[1:3] != (STEM_IN, STEM_IN) or x.shape[3] not in (1, 3):
        raise ValueError(f"fused_stem: x must be [B,224,224,1|3], got {tuple(x.shape)}")
    C = x.shape[3]
    _check("w", weights[0], x.dtype, (7, 7, C, CIN))
    _check("b", weights[1], torch.float32, (CIN,))
    if len(weights) != 2 + bf16:
        raise ValueError(f"fused_stem: expected {2 + bf16} weights from pack_stem_weights "
                         f"in {x.dtype}, got {len(weights)}")
    if bf16:
        _check("w_s2d", weights[2], x.dtype, (64 * C, CIN))
    if x.device.type == "cpu":
        return reference_stem(x, weights)
    _build.check_on_card(x, weights)
    out = torch.empty((x.shape[0], H, W, CIN), dtype=x.dtype, device=x.device)
    with _build.on_device(x.device) as stream:
        _launch_stem(x, weights, out, stream)
    _build.launch_counts[f"fused_stem_c{C}"] += 1
    return out


def _check_stage(fn: str, x: torch.Tensor, weights, stage: int) -> None:
    """What the stage kernels take: x [B,h,w,cin] of STAGE_CFGS[stage] in f32
    or bf16 and the pack_stage_weights tuple in x's dtype (biases f32)."""
    if stage not in STAGE_CFGS:
        raise ValueError(f"{fn}: stage must be one of {sorted(STAGE_CFGS)}, got {stage}")
    _dtype_flag(x)
    _, _, _, cin, _, _, h, w = STAGE_CFGS[stage]
    if x.ndim != 4 or tuple(x.shape[1:]) != (h, w, cin):
        raise ValueError(f"{fn}: x must be [B,{h},{w},{cin}], got {tuple(x.shape)}")
    shapes = _stage_shapes(stage)
    if len(weights) != len(shapes):
        raise ValueError(f"{fn}: expected {len(shapes)} weights, got {len(weights)}")
    for i, (t, shape) in enumerate(zip(weights, shapes)):
        _check(f"weights[{i}]", t, torch.float32 if len(shape) == 1 else x.dtype, shape)


def _stage_buffers(x: torch.Tensor, stage: int):
    """The kernel's scratch (t1 [B*h*w, cmid] for block 0's conv1 at the
    input resolution, t2 [B*ho*wo, cmid], two [B*ho*wo, cout] ping-pong
    maps; in bf16 also the plan's f32 split-K workspace and its zeroed
    int32 tickets, one per output tile, made for this call so that no two
    calls in flight share them) and its output [B,ho,wo,cout]."""
    _, _, stride, _, cmid, cout, h, w = STAGE_CFGS[stage]
    B, ho, wo = x.shape[0], h // stride, w // stride

    def empty(*shape):
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    ws_bytes, n_tickets = (stage_workspace(stage_plan(stage, B)) if x.dtype == torch.bfloat16
                           else (0, 0))
    scratch = (empty(B * h * w, cmid), empty(B * ho * wo, cmid),
               empty(B * ho * wo, cout), empty(B * ho * wo, cout),
               torch.empty(ws_bytes // 4, dtype=torch.float32, device=x.device),
               torch.zeros(n_tickets, dtype=torch.int32, device=x.device))
    return scratch, empty(B, ho, wo, cout)


def fused_layer1(x: torch.Tensor, weights) -> torch.Tensor:
    """ResNet50 layer1 (three folded bottlenecks). x [B,56,56,64] in f32 or
    bf16; weights from pack_layer1_weights in x's dtype. Returns
    [B,56,56,256] in x.dtype. The stage kernel at stage 1 (csrc/stage.cu),
    counted as fused_layer1: the rgbd path's name for its layer1."""
    _check_stage("fused_layer1", x, weights, 1)
    if x.device.type == "cpu":
        return reference_layer1(x, weights)
    _build.check_on_card(x, weights)
    scratch, out = _stage_buffers(x, 1)
    with _build.on_device(x.device) as stream:
        _launch_stage(x, weights, 1, scratch, out, stream)
    _build.launch_counts["fused_layer1"] += 1
    return out


def fused_stage(x: torch.Tensor, weights, stage: int) -> torch.Tensor:
    """ResNet50 stage `stage` (1-4, STAGE_CFGS) as one call. x [B,h,w,cin]
    in f32 or bf16; weights from pack_stage_weights(., stage) in x's dtype.
    Returns [B,h/s,w/s,cout] in x.dtype. On the card this is one logical
    launch of three GEMM kernels per block (csrc/stage.cu)."""
    _check_stage("fused_stage", x, weights, stage)
    if x.device.type == "cpu":
        return reference_stage(x, weights, stage)
    _build.check_on_card(x, weights)
    scratch, out = _stage_buffers(x, stage)
    with _build.on_device(x.device) as stream:
        _launch_stage(x, weights, stage, scratch, out, stream)
    _build.launch_counts[f"fused_stage_s{stage}"] += 1
    return out
