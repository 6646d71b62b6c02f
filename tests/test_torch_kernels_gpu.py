"""The CUDA kernels against their plain versions on the card (skipped
without one). Run on a machine with a CUDA card and nvcc:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu

Kernels: the fused stem (the bf16 tensor-core kernel also at batches 1,
2, 3, 8 and 32, and two bf16 launches bit for bit equal), layer1, the
parametric stage (stages 1-4 at
batches 1, 2, 3, 8 and 32, stage 1 bit for bit equal to layer1, and two
bf16 launches bit for bit equal under split-K), the bf16 wgmma GEMM alone
in each geometry a stage gives it (dense 1x1, 3x3 at stride 1 and 2, the
conv3 + shortcut pair, the identity residual; with and without split-K),
the ADD-S nearest-point search (also at B 1/8/32 x P 1 to 5000, bit-equal under
every forced plan and across launches, and bit for bit the first index at
the smallest d^2 on ties planted in a padded cloud, with its argmin output the
same distances and the first index at the smallest d^2, and the ADD-S
backward equal to the CPU's) and the frame-row gather (bit for bit
equal to its plain version at batches 1, 3, 32 and 33 of 128- to
230,400-word rows, with repeated and clamped indices). Beside
them: each kernel launches on its input's card when another card is
current (skipped below two cards), one device-preprocess train step of
each PoseNet variant is finite on the card, and the rgbd train epoch
never waits for the card (torch.cuda.set_sync_debug_mode("error")); the
serving path's plain tensor code on the card against the CPU: the
decode + NMS with ties planted in bf16 class logits (bit-equal classes,
validity and scores, with no wait for the card), the windowed crop
against the full-frame crop, the 1280x720 letterbox, and the int8
convolution (conv_s8s32, torch._int_mm) bit-equal at the ResNet50 and
YOLOv8n geometries at batches 8 and 32.
Tolerances: f32 kernel vs plain max error <= 1e-4 * max(1, |plain|max)
(different f32 summation order); bf16 kernel vs the f32 plain version
within the bf16 envelope (mean error < 0.02 std, max < 0.25 std);
nearest-point distances within 1e-7 m of float64 cdist and, on the first
test's inputs, within 1e-6 m of the plain expansion (elsewhere within the
expansion's own envelope in d^2, addmin.expansion_d2_atol)."""

import numpy as np
import pytest
import torch

from pose6d_tpu_torch import _build
from pose6d_tpu_torch.data.device_pipeline import DeviceFrameStore
from pose6d_tpu_torch.ops import addmin
from pose6d_tpu_torch.ops import fused_block as fb
from pose6d_tpu_torch.ops import gather_frames as gf
from pose6d_tpu_torch.train import loop as tloop
from torch_port_utils import addmin_expected, kernel_d2, padded_cloud, plant_ties

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _folded(specs, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {name: {"w": torch.randn(co, ci, k, k, generator=g) * (2.0 / (ci * k * k)) ** 0.5,
                   "b": torch.randn(co, generator=g) * 0.1}
            for name, (k, ci, co) in specs.items()}


def _to(weights, device):
    return tuple(t.to(device) for t in weights)


def _check(got, want_f32, dtype):
    err = (got.float() - want_f32).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * max(1.0, want_f32.abs().max().item())
    else:
        std = want_f32.std().item()
        assert err.mean().item() < 0.02 * std and err.max().item() < 0.25 * std


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [3, 1])
def test_stem_kernel(cuda, C, dtype):
    w = fb.pack_stem_weights(_folded({"conv1": (7, C, 64)}), dtype)
    x = torch.randn(3, 224, 224, C, generator=torch.Generator().manual_seed(1)).to(dtype)
    before = _build.launch_counts[f"fused_stem_c{C}"]
    got = fb.fused_stem(x.to(cuda), _to(w, cuda))
    torch.cuda.synchronize()
    assert _build.launch_counts[f"fused_stem_c{C}"] == before + 1
    want = fb.reference_stem(x.float().to(cuda), (w[0].float().to(cuda), w[1].to(cuda)))
    _check(got, want, dtype)


@pytest.mark.parametrize("batch", [1, 2, 3, 8, 32, 128])
@pytest.mark.parametrize("C", [3, 1])
def test_stem_tensor_core_kernel(cuda, C, batch):
    """The bf16 stem (csrc/stem_tc.cu) at the serving batch and around it,
    and at 128 (the request trace's rgbd batch), every tile of every image
    against the f32 plain version; two launches on the same input are
    equal bit for bit."""
    w = _to(fb.pack_stem_weights(_folded({"conv1": (7, C, 64)}, seed=batch), torch.bfloat16),
            cuda)
    x = torch.randn(batch, 224, 224, C, generator=torch.Generator().manual_seed(10 + batch))
    x = x.to(torch.bfloat16).to(cuda)
    got = fb.fused_stem(x, w)
    again = fb.fused_stem(x, w)
    torch.cuda.synchronize()
    want = fb.reference_stem(x.float(), (w[0].float(), w[1]))
    for i in range(batch):  # per image, so that a wrong image offset shows
        _check(got[i:i + 1], want[i:i + 1], torch.bfloat16)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer1_kernel(cuda, dtype):
    specs = {"layer1_0/downsample": (1, 64, 256)}
    for j in range(3):
        specs.update({f"layer1_{j}/conv1": (1, 64 if j == 0 else 256, 64),
                      f"layer1_{j}/conv2": (3, 64, 64), f"layer1_{j}/conv3": (1, 64, 256)})
    w = fb.pack_layer1_weights(_folded(specs), dtype)
    x = torch.randn(2, 56, 56, 64, generator=torch.Generator().manual_seed(2)).to(dtype)
    got = fb.fused_layer1(x.to(cuda), _to(w, cuda))
    torch.cuda.synchronize()
    want = fb.reference_layer1(x.float().to(cuda), tuple(t.float().to(cuda) for t in w))
    _check(got, want, dtype)


def _stage_weights(stage, dtype, seed=0):
    name, n_blocks, _, cin, cmid, cout, _, _ = fb.STAGE_CFGS[stage]
    specs = {f"{name}_0/downsample": (1, cin, cout)}
    for j in range(n_blocks):
        specs.update({f"{name}_{j}/conv1": (1, cin if j == 0 else cout, cmid),
                      f"{name}_{j}/conv2": (3, cmid, cmid), f"{name}_{j}/conv3": (1, cmid, cout)})
    return fb.pack_stage_weights(_folded(specs, seed), stage, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 2, 3, 8, 32, 128])
@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_stage_kernel(cuda, stage, batch, dtype):
    """Every stage, including M = B*ho*wo not a multiple of the 64- or
    128-row tile (stage 2 at B=1: 784 rows; stage 4: 49 rows per image;
    batch 3), the batches whose plans split K (stage_plan), and 128 (the
    request trace's rgbd batch)."""
    _, _, _, cin, _, _, h, w = fb.STAGE_CFGS[stage]
    wts = _stage_weights(stage, dtype)
    x = torch.randn(batch, h, w, cin, generator=torch.Generator().manual_seed(stage)).to(dtype)
    key = f"fused_stage_s{stage}"
    before = _build.launch_counts[key]
    got = fb.fused_stage(x.to(cuda), _to(wts, cuda), stage)
    torch.cuda.synchronize()
    assert _build.launch_counts[key] == before + 1
    want = fb.reference_stage(x.float().to(cuda), tuple(t.float().to(cuda) for t in wts), stage)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage1_equals_layer1_bit_for_bit(cuda, dtype):
    wts = _to(_stage_weights(1, dtype, seed=3), cuda)
    x = torch.randn(2, 56, 56, 64, generator=torch.Generator().manual_seed(4)).to(dtype).to(cuda)
    a = fb.fused_stage(x, wts, 1)
    b = fb.fused_layer1(x, wts)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_stage_kernel_is_deterministic(cuda, stage):
    """Split-K sums its partials in split order: two bf16 launches on the
    same input are equal bit for bit (batch 8, where stages 2-4 split)."""
    _, _, _, cin, _, _, h, w = fb.STAGE_CFGS[stage]
    wts = _to(_stage_weights(stage, torch.bfloat16, seed=5), cuda)
    x = torch.randn(8, h, w, cin, generator=torch.Generator().manual_seed(6))
    x = x.to(torch.bfloat16).to(cuda)
    a = fb.fused_stage(x, wts, stage)
    b = fb.fused_stage(x, wts, stage)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _patches(x, stride):
    """The 3x3 patch matrix of an NHWC map, padding 1, in (ky, kx, c) column
    order: [B*ho*wo, 9*C]."""
    B, h, w, C = x.shape
    cols = torch.nn.functional.unfold(x.permute(0, 3, 1, 2), 3, padding=1, stride=stride)
    return cols.reshape(B, C, 9, -1).permute(0, 3, 2, 1).reshape(-1, 9 * C)


# name: (B, h, w, C of A1's map or K1, stride, N, K2, residual, tile N): one
# GEMM of each geometry a stage launches, with ragged M against 128-row
# tiles and more than one tile along N
GEMM_CASES = {
    "dense_1x1": (3, 10, 10, 256, 1, 128, 0, False, 128),
    "dense_1x1_bn64": (3, 10, 10, 256, 1, 128, 0, False, 64),
    "dense_1x1_n64": (2, 9, 9, 64, 1, 64, 0, False, 64),
    "dense_1x1_residual": (2, 12, 12, 128, 1, 256, 0, True, 128),
    "conv3x3_s1": (2, 14, 14, 64, 1, 128, 0, False, 64),
    "conv3x3_s2": (3, 14, 14, 128, 2, 128, 0, False, 128),
    "conv3_shortcut_s2": (2, 14, 14, 128, 2, 256, 64, False, 128),
    "conv3_shortcut_s1": (2, 10, 10, 64, 1, 256, 64, False, 64),
}


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_wgmma_gemm_geometry(cuda, case, splits):
    """The bf16 GEMM kernel alone (pose6d_gemm_bf16) against the same GEMM
    in f32 on bf16 inputs, within the bf16 envelope: the 3x3 taps and
    padding, the stride-2 gather, the shortcut's second (A, W) pair at its
    own K offset, ragged M, tile N 64 and 128, and split-K."""
    B, h, w, C, stride, N, K2, residual, bn = GEMM_CASES[case]
    g = torch.Generator().manual_seed(11)
    conv3x3 = case.startswith("conv3x3")
    ho, wo = h // stride, w // stride
    bf = torch.bfloat16

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(bf).to(cuda)

    if conv3x3:
        a1 = rand(B, h, w, C)
        K1, M = 9 * C, B * ho * wo
        a1_mat = _patches(a1.float(), stride)
    elif K2:
        M, K1 = B * ho * wo, C
        a1 = rand(M, K1)
        a1_mat = a1.float()
    else:
        M, K1 = B * h * w, C
        a1 = rand(M, K1)
        a1_mat = a1.float()
    w1 = rand(K1, N, scale=K1 ** -0.5)
    bias = torch.randn(N, generator=g).to(cuda)
    want = a1_mat @ w1.float() + bias
    a2 = w2 = bias2 = res = None
    if K2:
        a2 = rand(B, h, w, K2)
        w2 = rand(K2, N, scale=K2 ** -0.5)
        bias2 = torch.randn(N, generator=g).to(cuda)
        want = want + a2.float()[:, ::stride, ::stride].reshape(M, K2) @ w2.float() + bias2
    if residual:
        res = rand(M, N)
        want = want + res.float()
    want = want.relu()
    k_steps = (K1 + K2) // 64
    splits = min(splits, k_steps)
    tiles = -(-M // 128) * (N // bn)
    out = torch.empty(M, N, dtype=bf, device=cuda)
    ws = torch.empty(splits * M * N, dtype=torch.float32, device=cuda)
    tickets = torch.zeros(tiles, dtype=torch.int32, device=cuda)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    code = _build.lib().pose6d_gemm_bf16(
        ptr(a1), ptr(w1), ptr(a2), ptr(w2), ptr(bias), ptr(bias2), ptr(res), ptr(out),
        ptr(ws), ptr(tickets), M, N, K1, K2, h, w, ho, wo, stride, int(conv3x3), bn, splits,
        torch.cuda.current_stream().cuda_stream)
    _build.check(code, "pose6d_gemm_bf16")
    torch.cuda.synchronize()
    err = (out.float() - want).abs()
    worst = int(err.argmax())
    assert err.max().item() < 0.02 * max(1.0, want.abs().max().item()), (
        f"max err {err.max().item():.4g} at row {worst // N} col {worst % N}; "
        f"{(err > 0.05).float().mean().item():.3f} of outputs off")
    assert torch.equal(tickets, torch.zeros_like(tickets))  # reset by each tile's last block


@pytest.mark.parametrize("P", [500, 129, 1])
def test_addmin_kernel(cuda, P):
    rng = np.random.default_rng(P)
    pred = torch.from_numpy(rng.normal(0, 0.05, (4, P, 3)).astype(np.float32)).to(cuda)
    gt = torch.from_numpy(rng.normal(0, 0.05, (4, P, 3)).astype(np.float32)).to(cuda)
    got = addmin.pairwise_min_dist_kernel(pred, gt)
    torch.cuda.synchronize()
    assert (got - addmin._pairwise_min_dist(pred, gt)).abs().max().item() <= 1e-6
    exact = torch.cdist(pred.double(), gt.double()).amin(-1)
    assert (got.double() - exact).abs().max().item() <= 1e-7


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("P", [1, 129, 500, 2048, 5000])
def test_addmin_kernel_shapes(cuda, P, B):
    """Within 1e-7 m of float64 cdist, and of the plain version within the
    expansion's own envelope in d^2 (addmin.expansion_d2_atol): at these
    sizes the plain version itself strays past 1e-6 m from float64 where a
    point's nearest is close (1.1e-6 m at B 32, P 2048 on an H100)."""
    rng = np.random.default_rng(P + B)
    pred = torch.from_numpy(rng.normal(0, 0.05, (B, P, 3)).astype(np.float32)).to(cuda)
    gt = torch.from_numpy(rng.normal(0, 0.05, (B, P, 3)).astype(np.float32)).to(cuda)
    got = addmin.pairwise_min_dist_kernel(pred, gt)
    torch.cuda.synchronize()
    exact = torch.cdist(pred.double(), gt.double()).amin(-1)
    assert (got.double() - exact).abs().max().item() <= 1e-7
    plain = addmin._pairwise_min_dist(pred, gt).double()
    assert (got.double() ** 2 - plain ** 2).abs().max().item() <= addmin.expansion_d2_atol(pred, gt)


ADDMIN_PLANS = (addmin.AddminPlan(8, 1, 1), addmin.AddminPlan(8, 1, 4),
                addmin.AddminPlan(16, 2, 16), addmin.AddminPlan(64, 4, 3),
                addmin.AddminPlan(32, 2, 5), addmin.AddminPlan(12, 4, 7),
                addmin.AddminPlan(128, 4, 32), addmin.AddminPlan(256, 1, 4))


@pytest.mark.parametrize("B,P", [(8, 500), (32, 500), (8, 2048), (3, 1100)])
def test_addmin_plans_bit_equal(cuda, B, P):
    """Every forced plan, and two launches of the default one, give the same
    bits: the splits merge by (d^2, index)."""
    rng = np.random.default_rng(B * P)
    gt = torch.from_numpy(np.stack([padded_cloud(rng, P, P * 3 // 4) for _ in range(B)])).to(cuda)
    pred = (gt + torch.from_numpy(rng.normal(0, 0.004, (B, P, 3)).astype(np.float32))
            .to(cuda)).contiguous()
    want = addmin.pairwise_min_dist_kernel(pred, gt)
    assert torch.equal(addmin.pairwise_min_dist_kernel(pred, gt), want)
    for plan in ADDMIN_PLANS:
        assert torch.equal(addmin.pairwise_min_dist_kernel(pred, gt, plan=plan), want), plan
    torch.cuda.synchronize()
    assert (want.double() - torch.cdist(pred.double(), gt.double()).amin(-1)).abs().max() <= 1e-7


def test_addmin_ties_on_a_padded_cloud(cuda):
    """A cloud padded by repetition, as load_object_models pads it, with
    pairs of GT points planted at equal f32 d^2 but different distances
    (the farther first): under every plan the kernel returns the bits of
    the first index at the smallest d^2 (tests/torch_port_utils
    addmin_expected, an exact emulation of its arithmetic)."""
    rng = np.random.default_rng(5)
    B, P = 2, 300
    gt = np.stack([padded_cloud(rng, P, 200) for _ in range(B)])
    pred = (gt[:, rng.permutation(P)] + rng.normal(0, 0.004, (B, P, 3))).astype(np.float32)
    for b in range(B):
        for i in range(40):
            j1, j2 = sorted(rng.choice(P, 2, replace=False))
            assert plant_ties(rng, pred[b, i], gt[b], j1, j2)
    want = torch.from_numpy(addmin_expected(pred, gt)).to(cuda)
    pred_t, gt_t = torch.from_numpy(pred).to(cuda), torch.from_numpy(gt).to(cuda)
    for plan in (None,) + ADDMIN_PLANS:
        assert torch.equal(addmin.pairwise_min_dist_kernel(pred_t, gt_t, plan=plan), want), plan


def test_addmin_index_output(cuda):
    """The argmin output of the ADD-S loss (return_index) on a padded cloud
    with planted ties: under every plan the distances are the bits of the
    call without it, and the index is the first GT point at the smallest
    f32 d^2 (kernel_d2, an exact emulation of the kernel's arithmetic).
    The differentiable ADD-S (losses/add.py NearestDistance) built on it
    gives the CPU's gradient, where the plain version picks the same
    nearest points."""
    from pose6d_tpu_torch.losses.add import NearestDistance

    rng = np.random.default_rng(6)
    B, P = 2, 300
    gt = np.stack([padded_cloud(rng, P, 200) for _ in range(B)])
    pred = (gt[:, rng.permutation(P)] + rng.normal(0, 0.004, (B, P, 3))).astype(np.float32)
    for b in range(B):
        for i in range(40):
            j1, j2 = sorted(rng.choice(P, 2, replace=False))
            assert plant_ties(rng, pred[b, i], gt[b], j1, j2)
    want_idx = torch.from_numpy(kernel_d2(pred, gt).argmin(-1)).to(cuda)
    pred_t, gt_t = torch.from_numpy(pred).to(cuda), torch.from_numpy(gt).to(cuda)
    want = addmin.pairwise_min_dist_kernel(pred_t, gt_t)
    for plan in (None,) + ADDMIN_PLANS:
        before = _build.launch_counts["pairwise_min_dist"]
        dist, idx = addmin.pairwise_min_dist_kernel(pred_t, gt_t, plan=plan, return_index=True)
        assert _build.launch_counts["pairwise_min_dist"] == before + 1
        assert torch.equal(dist, want), plan
        assert idx.dtype == torch.int64 and torch.equal(idx, want_idx), plan

    far = rng.normal(0, 0.05, (B, P, 3)).astype(np.float32)  # no near-ties: one argmin
    grads = {}
    for dev in ("cpu", cuda):
        p = torch.from_numpy(far).to(dev).requires_grad_(True)
        g = torch.from_numpy(gt).to(dev).requires_grad_(True)
        (NearestDistance.apply(p, g) * torch.linspace(0.5, 1.5, P, device=dev)).sum().backward()
        grads[str(dev)] = (p.grad.cpu(), g.grad.cpu())
    for got, ref in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-6)


def test_kernels_refuse_non_contiguous(cuda):
    x = torch.zeros(1, 224, 224, 6, device=cuda)[..., :3]
    w = _to(fb.pack_stem_weights(_folded({"conv1": (7, 3, 64)}), torch.float32), cuda)
    with pytest.raises(ValueError):
        fb.fused_stem(x, w)
    words = torch.zeros(4, 512, dtype=torch.int32, device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        gf.gather_rows_u32(words, torch.tensor([0], device=cuda))
    frames = torch.zeros(8, 48, 64, 3, dtype=torch.uint8, device=cuda)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        gf.gather_frames(frames, torch.tensor([0], device=cuda))


@pytest.mark.parametrize("frame", [(480, 640, 3), (480, 640)])  # RGB words, depth words
def test_gather_kernel_bit_equal(cuda, frame):
    rng = np.random.default_rng(7)
    dtype = np.uint8 if len(frame) == 3 else np.uint16
    src = rng.integers(0, np.iinfo(dtype).max, (40, *frame), dtype=dtype)
    words = torch.from_numpy(gf.pack_frames_host(src).view(np.int32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 40, 32)).to(cuda)
    idx[:3] = torch.tensor([0, 39, 39])
    before = _build.launch_counts["gather_rows_u32"]
    got = gf.gather_rows_u32(words, idx)
    torch.cuda.synchronize()
    assert _build.launch_counts["gather_rows_u32"] == before + 1
    assert torch.equal(got, gf._gather_rows_plain(words, idx))
    unpacked = gf.gather_frames_packed(words, idx, frame, torch.uint8 if len(frame) == 3
                                       else torch.int16)
    want = src[idx.cpu().numpy()]
    np.testing.assert_array_equal(unpacked.cpu().numpy().view(dtype), want)
    # indices outside [0, N) clamp, as the plain version does
    wild = torch.tensor([-5, 40, 1000, 3], device=cuda)
    assert torch.equal(gf.gather_rows_u32(words, wild), gf._gather_rows_plain(words, wild))


@pytest.mark.parametrize("rows,r", [(3, 128), (5, 128 * 9), (2, 4096 + 128)])
def test_gather_kernel_row_lengths(cuda, rows, r):
    """Rows shorter than a 1024-vector chunk, and chunks that end inside a
    row."""
    words = torch.randint(-2**31, 2**31 - 1, (rows, r), dtype=torch.int32, device=cuda)
    idx = torch.arange(rows - 1, -1, -1, device=cuda)
    assert torch.equal(gf.gather_rows_u32(words, idx), words.flip(0))
    assert torch.equal(gf.gather_rows_u32(words.view(torch.uint32), idx).view(torch.int32),
                       words.flip(0))


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    return torch.device("cuda:1")


def test_kernels_launch_on_the_inputs_card(two_cards):
    """With card 0 current, every wrapper given tensors on card 1 launches
    there (its device guard) and matches its plain version there."""
    dev = two_cards
    g = torch.Generator().manual_seed(0)
    w = _to(fb.pack_stem_weights(_folded({"conv1": (7, 3, 64)}), torch.float32), dev)
    x = torch.randn(1, 224, 224, 3, generator=g).to(dev)
    _check(fb.fused_stem(x, w), fb.reference_stem(x, w), torch.float32)
    wts = _to(_stage_weights(1, torch.float32), dev)
    h = torch.randn(1, 56, 56, 64, generator=g).to(dev)
    _check(fb.fused_layer1(h, wts), fb.reference_layer1(h, wts), torch.float32)
    _check(fb.fused_stage(h, wts, 1), fb.reference_stage(h, wts, 1), torch.float32)
    pts = torch.randn(2, 100, 3, generator=g).to(dev)
    assert (addmin.pairwise_min_dist_kernel(pts, pts.flip(1))
            - addmin._pairwise_min_dist(pts, pts.flip(1))).abs().max().item() <= 1e-6
    words = torch.randint(0, 1000, (4, 256), dtype=torch.int32).to(dev)
    idx = torch.tensor([3, 1], device=dev)
    assert torch.equal(gf.gather_rows_u32(words, idx), gf._gather_rows_plain(words, idx))
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0


def _store(cuda, variant, n=12):
    from torch_port_utils import train_split

    rgb, depth, bbox, rot, trans_mm, obj_id, K = train_split(0)
    rng = np.random.default_rng(1)
    # LineMOD-sized frames: the store packs them into words, the gather
    # kernel moves them
    rgb = rng.integers(0, 256, (n, 480, 640, 3), dtype=np.uint8)
    depth = rng.integers(300, 1500, (n, 480, 640)).astype(np.uint16)
    bbox = bbox[:n] * 4 + np.array([100, 100, 0, 0])
    return DeviceFrameStore(rgb, depth, bbox, rot[:n], trans_mm[:n], obj_id[:n], K[:n],
                            flavor="rgbd" if variant.startswith("rgbd") else "rgb", device=cuda)


@pytest.mark.parametrize("variant", ["rgb", "rgb_geometric", "rgbd", "rgbd_geometric"])
def test_train_step_finite_on_the_card(cuda, variant):
    store = _store(cuda, variant)
    cfg = tloop.TrainConfig(variant=variant, batch_size=4)
    state = tloop.create_train_state(cfg, seed=0, device=cuda)
    step = tloop.make_train_step(cfg, device_preprocess=True,
                                 frame_hw=(store.frame_h, store.frame_w))
    meta = store.meta_batch(np.array([0, 3, 7, 11]), np.random.default_rng(2))
    with_depth = variant.startswith("rgbd")
    before = _build.launch_counts["gather_rows_u32"]
    state, metrics = step(state, store.rgb_frames, store.depth_frames if with_depth else None,
                          meta, torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert _build.launch_counts["gather_rows_u32"] == before + (2 if with_depth else 1)
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert state.step == 1


def test_train_epoch_never_waits_for_the_card(cuda):
    """rgbd, two steps: set_sync_debug_mode("error") raises at any
    operation that would wait for the card."""
    store = _store(cuda, "rgbd", n=8)
    cfg = tloop.TrainConfig(variant="rgbd", batch_size=4)
    state = tloop.create_train_state(cfg, seed=0, device=cuda)
    epoch = tloop.make_train_epoch(cfg, frame_hw=(store.frame_h, store.frame_w))
    meta, n = store.epoch_meta(4, np.random.default_rng(3))
    g = torch.Generator(device=cuda).manual_seed(0)
    state, _ = epoch(state, store.rgb_frames, store.depth_frames,
                     {k: v[:1] for k, v in meta.items()}, g)  # warm-up: cuDNN plans
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, losses = epoch(state, store.rgb_frames, store.depth_frames, meta, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert n == 2 and torch.isfinite(losses).all()


@pytest.mark.parametrize("blocks_per_sm", [8, 1])
@pytest.mark.parametrize("r", [128, 384, 153_600, 230_400])
@pytest.mark.parametrize("batch", [1, 3, 32, 33])
def test_gather_kernel_shares(cuda, batch, r, blocks_per_sm):
    """The persistent gather at the batches and row lengths of the CPU
    share-plan test (LineMOD's depth and RGB rows among them), with the
    wrapper's grid and with one block per SM (many chunks per block): bit
    for bit equal to the plain version, with repeated indices and indices
    outside [0, N) that clamp."""
    n = 40
    words = torch.randint(-2**31, 2**31 - 1, (n, r), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(r)).to(cuda)
    rng = np.random.default_rng(batch)
    idx = rng.integers(0, n, batch)
    idx[::3] = idx[0]  # repeats
    idx[1::4] = np.resize([-7, n, 10**6, -1], len(idx[1::4]))  # clamp to 0 or n - 1
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    out = torch.empty(batch, r, dtype=torch.int32, device=cuda)
    gf._launch_gather(words, idx, out, torch.cuda.current_stream().cuda_stream,
                      blocks_per_sm=blocks_per_sm)
    torch.cuda.synchronize()
    assert torch.equal(out, gf._gather_rows_plain(words, idx))



def _tied_detector_outputs(seed, batch=8, hw=(480, 640), nc=13):
    """Seeded raw YOLOv8 maps at a full frame as bf16 tensors, the class
    logits on a 0.5 grid capped at 1.0 (a third of the anchors tie for the
    best logit) and classes 1 and 2 equal at every anchor."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for s in (8, 16, 32):
        shape = (batch, hw[0] // s, hw[1] // s)
        cls = torch.clamp_max(torch.round(torch.randn(*shape, nc, generator=g) * 2) / 2, 1.0)
        cls[..., 2] = cls[..., 1]
        out.append(((torch.randn(*shape, 64, generator=g) * 1.5).to(torch.bfloat16),
                    cls.to(torch.bfloat16)))
    return out


@pytest.mark.parametrize("max_det", [1, 64])
def test_decode_on_the_card_equals_cpu(cuda, max_det):
    """decode_topk_nms on the card, under set_sync_debug_mode("error"),
    against the same call on the CPU, with ties planted in the bf16 class
    logits: classes, validity and scores equal bit for bit (the ranking is
    a stable sort on both), boxes within 1e-4 px (the DFL softmax's exp
    differs in the last bit between the two)."""
    from pose6d_tpu_torch.models.yolo.decode import decode_topk_nms
    from pose6d_tpu_torch.models.yolo.model import YoloConfig

    cfg = YoloConfig()
    outputs = _tied_detector_outputs(0)
    kw = dict(max_det=max_det, pre_topk=64, iou_thresh=0.7, conf_thresh=0.0, fixpoint_iters=16)
    on_card = [(b.to(cuda), c.to(cuda)) for b, c in outputs]
    decode_topk_nms(on_card, cfg, (480, 640), **kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = decode_topk_nms(on_card, cfg, (480, 640), **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = decode_topk_nms(outputs, cfg, (480, 640), **kw)
    for k in ("classes", "valid", "scores"):
        assert torch.equal(got[k].cpu(), want[k]), k
    assert (got["boxes"].cpu() - want["boxes"]).abs().max().item() <= 1e-4
    if max_det > 1:
        assert not want["valid"].all()  # suppressed slots compared too


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_crop_on_the_card_equals_full_crop(cuda, dtype):
    """crop_resize_matmul_windowed at window 320 against crop_resize_matmul
    on the card, on 1280x720 frames and square crops of side 40-300 px
    (some past the frame's edges): f32 within 1e-4 * max(1, |full|), bf16
    within the bf16 envelope of the f32 full crop."""
    from pose6d_tpu_torch.ops.crop_resize import (crop_params_from_bbox, crop_resize_matmul,
                                                  crop_resize_matmul_windowed)

    g = torch.Generator().manual_seed(0)
    frames = (torch.randint(0, 256, (8, 720, 1280, 3), generator=g) / 255.0).to(cuda)
    side = (40 + 260 * torch.rand(8, 1, generator=g)).expand(8, 2) / 1.2  # crop = 1.2 x box
    xy = torch.rand(8, 2, generator=g) * torch.tensor([1280.0, 720.0]) - side / 2
    x1, y1, size = (p.to(cuda) for p in crop_params_from_bbox(torch.cat([xy, side], -1)))
    assert 40 <= float(size.min()) and float(size.max()) <= 300
    full = crop_resize_matmul(frames, x1, y1, size, 224)
    got = crop_resize_matmul_windowed(frames.to(dtype), x1, y1, size, 224, 320, compute_dtype=dtype)
    _check(got, full, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_letterbox_on_the_card_equals_cpu(cuda, dtype):
    """The 1280x720 letterbox onto the 640x640 canvas (antialiased bilinear
    shrink, f32, cast once) on the card against the CPU: within 1e-6 in
    f32, one bf16 ulp in bf16."""
    import types

    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.models.yolo.model import YoloConfig

    owner = types.SimpleNamespace(cfg=PipelineConfig(), yolo_cfg=YoloConfig())
    frames = (torch.randint(0, 256, (2, 720, 1280, 3),
                            generator=torch.Generator().manual_seed(1)) / 255.0).to(dtype)
    want = PosePipeline._letterbox(owner, frames)
    got = PosePipeline._letterbox(owner, frames.to(cuda))
    assert got[1:] == want[1:] == (0.5, 0, 140, (640, 640))
    err = (got[0].cpu().float() - want[0].float()).abs()
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8  # bf16 ulp of values in [0.5, 1)
    assert err.max().item() <= tol


# (kernel, stride, padding, cin, cout, input H, W) of the int8 convolutions:
# ResNet50's at 224 (conv1 of the RGB and depth towers, K 147 -> 152 and
# 49 -> 56) and YOLOv8n's at 640x480 (the stem, K 27 -> 32)
INT8_CONV_GEOMETRIES = {
    "resnet_conv1_rgb": (7, 2, 3, 3, 64, 224, 224),
    "resnet_conv1_depth": (7, 2, 3, 1, 64, 224, 224),
    "resnet_layer1_conv2": (3, 1, 1, 64, 64, 56, 56),
    "resnet_layer2_conv2_s2": (3, 2, 1, 128, 128, 56, 56),
    "resnet_layer2_downsample": (1, 2, 0, 256, 512, 56, 56),
    "resnet_layer4_conv1": (1, 1, 0, 1024, 512, 14, 14),
    "resnet_layer4_conv3": (1, 1, 0, 512, 2048, 7, 7),
    "yolo_stem": (3, 2, 1, 3, 16, 480, 640),
    "yolo_down1": (3, 2, 1, 16, 32, 240, 320),
    "yolo_c2f_1_bottleneck": (3, 1, 1, 16, 16, 120, 160),
    "yolo_c2f_1_cv2": (1, 1, 0, 48, 32, 120, 160),
    "yolo_sppf_cv2": (1, 1, 0, 512, 256, 15, 20),
    "yolo_head_cls": (3, 1, 1, 64, 64, 60, 80),
}


@pytest.mark.parametrize("batch", [8, 32])
@pytest.mark.parametrize("geometry", sorted(INT8_CONV_GEOMETRIES))
def test_conv_s8s32_on_the_card_equals_cpu(cuda, geometry, batch):
    """conv_s8s32 (im2col + torch._int_mm) on the card against the same
    call on the CPU: the int32 outputs equal bit for bit at the towers' and
    the detector's conv geometries, the zero-padded K included."""
    from pose6d_tpu_torch.ops.quant import conv_s8s32

    k, stride, pad, ci, co, h, w = INT8_CONV_GEOMETRIES[geometry]
    g = torch.Generator().manual_seed(k * 1000 + ci)
    x = torch.randint(-127, 128, (batch, h, w, ci), generator=g, dtype=torch.int8)
    wt = torch.randint(-127, 128, (co, k, k, ci), generator=g, dtype=torch.int8)
    got = conv_s8s32(x.to(cuda), wt.to(cuda), stride, pad)
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), conv_s8s32(x, wt, stride, pad))
