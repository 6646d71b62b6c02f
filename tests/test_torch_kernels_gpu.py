"""The CUDA kernels against their plain versions on the card (skipped
without one). Run on a machine with a CUDA card and nvcc:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu

Kernels: the fused stem, layer1, the parametric stage (stages 1-4, and
stage 1 bit for bit equal to layer1) and the ADD-S nearest-point search.
Tolerances: f32 kernel vs plain max error <= 1e-4 * max(1, |plain|max)
(different f32 summation order); bf16 kernel vs the f32 plain version
within the bf16 envelope (mean error < 0.02 std, max < 0.25 std);
nearest-point distances within 1e-6 m of the plain expansion."""

import numpy as np
import pytest
import torch

from pose6d_tpu_torch import _build
from pose6d_tpu_torch.ops import addmin
from pose6d_tpu_torch.ops import fused_block as fb

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
