"""The CUDA kernels against their plain versions on the card (skipped
without one). Run on a machine with a CUDA card and nvcc:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu

Kernels: the fused stem, layer1, the parametric stage (stages 1-4, and
stage 1 bit for bit equal to layer1), the ADD-S nearest-point search and
the frame-row gather (bit for bit equal to its plain version). Beside
them: each kernel launches on its input's card when another card is
current (skipped below two cards), one device-preprocess train step of
each PoseNet variant is finite on the card, and the rgbd train epoch
never waits for the card (torch.cuda.set_sync_debug_mode("error")).
Tolerances: f32 kernel vs plain max error <= 1e-4 * max(1, |plain|max)
(different f32 summation order); bf16 kernel vs the f32 plain version
within the bf16 envelope (mean error < 0.02 std, max < 0.25 std);
nearest-point distances within 1e-6 m of the plain expansion."""

import numpy as np
import pytest
import torch

from pose6d_tpu_torch import _build
from pose6d_tpu_torch.data.device_pipeline import DeviceFrameStore
from pose6d_tpu_torch.ops import addmin
from pose6d_tpu_torch.ops import fused_block as fb
from pose6d_tpu_torch.ops import gather_frames as gf
from pose6d_tpu_torch.train import loop as tloop

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
@pytest.mark.parametrize("stage,batch", [(1, 2), (2, 2), (3, 2), (4, 2), (2, 1), (4, 1)])
def test_stage_kernel(cuda, stage, batch, dtype):
    """Every stage, including M = B*ho*wo not a multiple of the 64-row tile
    (stage 2 at B=1: 784 rows; stage 4: 49 rows per image)."""
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
    """Rows shorter than one block's 1024 vectors, and ragged last chunks."""
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
