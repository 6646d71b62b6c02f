"""The plan of the bf16 stem kernel (csrc/stem_tc.cu), checked on the CPU,
where the CUDA kernel cannot run.

- The port's [16*4C, 64] space-to-depth weight matrix (stem_s2d_weights,
  the third entry of pack_stem_weights in bf16) equals the JAX package's
  w2cat (pallas_block.pack_stem_weights) exactly, at C=3 and C=1.
- A plain torch emulation of the kernel's per-block computation (below:
  the 40x40xC NHWC patch under an 8x8 pooled tile staged into a 20x20x4C
  space-to-depth tile with conv1's zero pad, the 289 x 16*4C A matrix in the
  weight's tap order, the GEMM with f32 accumulation, bias and ReLU, the
  conv outputs outside the 112x112 map set to 0, rounding to x's dtype
  before the 3x3/s2 pool over the 17x17 tile with its halo) matches
  reference_stem and the JAX fused_stem in interpret mode over every tile
  of each image, border tiles included: in f32 within 1e-5 rtol/atol; in
  bf16 within one bf16 rounding (2^-7 relative, 1e-4 absolute: the two
  sides sum in other orders, so a conv output may round to the
  neighbouring bf16 value), and within the bf16 envelope of the f32
  oracle (mean error < 0.02 std, max < 0.25 std).
- The source note's occupancy: 3 blocks of the C=3 kernel (4 at C=1) fit
  an H100 SM, so batch 8's 392 blocks run in one wave on 132 SMs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pose6d_tpu.ops import pallas_block as jpb
from pose6d_tpu_torch.ops import fused_block as tfb

# csrc/stem_tc.cu's geometry
TILE, CT, SP = 8, 17, 20  # pooled tile side, conv outputs under it, s2d pixels under those
M_TILES = 5  # wgmma m64 tiles over the 289 GEMM rows
SMEM_PER_SM, SMEM_RESERVED = 233_472, 1024  # H100: 228 KB a block's share; 1 KB per block
NUM_SMS = 132
TAPS = [(u, v) for u in range(-2, 2) for v in range(-2, 2)]  # the K order: JAX's _STEM_TAPS


def _trees(rng, C):
    """A random folded conv1: {"conv1": {"w", "b"}} in the JAX layout (HWIO)
    and the port's (OIHW)."""
    w = rng.standard_normal((7, 7, C, 64)).astype(np.float32) * 0.05
    b = rng.standard_normal((64,)).astype(np.float32) * 0.05
    return ({"conv1": {"w": w, "b": b}},
            {"conv1": {"w": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                       "b": torch.from_numpy(b)}})


def emulate_stem_kernel(x: torch.Tensor, wk: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The bf16 stem kernel's arithmetic, block by block, in plain torch:
    x [B,224,224,C] NHWC, wk [16*4C, 64] (stem_s2d_weights), bias [64] f32
    -> [B,56,56,64] in x.dtype."""
    B, _, _, C = x.shape
    CH = 4 * C
    dt = x.dtype
    out = torch.empty(B, 56, 56, 64, dtype=dt)
    for b in range(B):
        for by in range(56 // TILE):
            for bx in range(56 // TILE):
                py0, px0 = by * TILE, bx * TILE  # pooled origin
                cy0, cx0 = 2 * py0 - 1, 2 * px0 - 1  # conv origin
                iy0, ix0 = 2 * cy0 - 4, 2 * cx0 - 4  # input pixel of s2d pixel (0, 0)
                # staging: the 40x40 NHWC patch, zero where conv1 pads, in s2d order
                patch = torch.zeros(2 * SP, 2 * SP, C, dtype=dt)
                y0, y1 = max(iy0, 0), min(iy0 + 2 * SP, 224)
                x0, x1 = max(ix0, 0), min(ix0 + 2 * SP, 224)
                patch[y0 - iy0:y1 - iy0, x0 - ix0:x1 - ix0] = x[b, y0:y1, x0:x1]
                s2d = patch.reshape(SP, 2, SP, 2, C).permute(0, 2, 1, 3, 4).reshape(SP, SP, CH)
                # A [289, 16*CH]: conv output (r, q), tap (u, v) -> s2d pixel (r+u+2, q+v+2)
                a = torch.stack([s2d[u + 2:u + 2 + CT, v + 2:v + 2 + CT] for u, v in TAPS],
                                dim=2).reshape(CT * CT, 16 * CH)
                conv = torch.relu(a.float() @ wk.float() + bias).reshape(CT, CT, 64)
                cy = torch.arange(cy0, cy0 + CT)
                cx = torch.arange(cx0, cx0 + CT)
                inside = ((cy >= 0) & (cy < 112))[:, None] & ((cx >= 0) & (cx < 112))[None, :]
                conv = torch.where(inside[..., None], conv, 0.0).to(dt)
                pooled = F.max_pool2d(conv.float().permute(2, 0, 1)[None], 3, 2)[0]
                out[b, py0:py0 + TILE, px0:px0 + TILE] = pooled.permute(1, 2, 0).to(dt)
    return out


@pytest.mark.parametrize("C", [3, 1])
def test_s2d_weights_equal_jax_w2cat(rng, C):
    jtree, ttree = _trees(rng, C)
    w32 = tfb.pack_stem_weights(ttree, torch.float32)
    assert len(w32) == 2  # the f32 kernel reads the HWIO weight
    got = tfb.stem_s2d_weights(w32[0])
    assert got.shape == (64 * C, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpb.pack_stem_weights(jtree, jnp.float32)[0]))
    wbf = tfb.pack_stem_weights(ttree, torch.bfloat16)
    want = np.asarray(jpb.pack_stem_weights(jtree, jnp.bfloat16)[0]).view(np.uint16)
    np.testing.assert_array_equal(wbf[2].view(torch.int16).numpy().view(np.uint16), want)
    assert torch.equal(wbf[2], tfb.stem_s2d_weights(wbf[0]))


@pytest.mark.parametrize("batch,C", [(1, 3), (2, 1)])
def test_emulation_matches_reference_and_pallas_f32(rng, batch, C):
    jtree, ttree = _trees(rng, C)
    x = rng.standard_normal((batch, 224, 224, C)).astype(np.float32)
    w, b = tfb.pack_stem_weights(ttree, torch.float32)
    got = emulate_stem_kernel(torch.from_numpy(x), tfb.stem_s2d_weights(w), b).numpy()
    want = tfb.reference_stem(torch.from_numpy(x), (w, b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(jpb.fused_stem(jnp.asarray(x), jpb.pack_stem_weights(jtree, jnp.float32),
                                       dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def _within_one_rounding(a: np.ndarray, b: np.ndarray) -> None:
    assert (np.abs(a - b) <= 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b)) + 1e-4).all()


@pytest.mark.parametrize("C", [3, 1])
def test_emulation_matches_reference_and_pallas_bf16(rng, C):
    jtree, ttree = _trees(rng, C)
    x = torch.from_numpy(rng.standard_normal((1, 224, 224, C)).astype(np.float32)).bfloat16()
    w, b, wk = tfb.pack_stem_weights(ttree, torch.bfloat16)
    got = emulate_stem_kernel(x, wk, b)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    _within_one_rounding(got, tfb.reference_stem(x, (w, b)).float().numpy())
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    pallas = jpb.fused_stem(xj, jpb.pack_stem_weights(jtree, jnp.bfloat16), dtype=jnp.bfloat16,
                            interpret=True)
    _within_one_rounding(got, np.asarray(pallas.astype(jnp.float32)))
    oracle = tfb.reference_stem(x.float(), (w.float(), b)).numpy()
    err = np.abs(got - oracle)
    assert err.mean() < 0.02 * oracle.std() and err.max() < 0.25 * oracle.std()


@pytest.mark.parametrize("C", [3, 1])
def test_one_wave_at_batch_8(C):
    """The shared memory stem_tc.cu asks for (the 1024-aligned weight tile,
    the 17x17x64 bf16 conv tile, the 20x20x4C s2d patch) fits 3 blocks on an
    SM at C=3 and 4 at C=1, so batch 8's 7 x 7 x 8 blocks fit the 132 SMs at
    once; the GEMM's K is whole k16 steps and its M fits the m64 tiles."""
    K = 16 * 4 * C
    assert K % 16 == 0 and M_TILES * 64 >= CT * CT > (M_TILES - 1) * 64
    smem = 1024 + K * 128 + CT * CT * 128 + SP * SP * 4 * C * 2
    per_sm = SMEM_PER_SM // (smem + SMEM_RESERVED)
    assert per_sm == {3: 3, 1: 4}[C]
    assert (56 // TILE) ** 2 * 8 <= NUM_SMS * per_sm


def test_wrapper_takes_the_s2d_matrix_in_bf16(rng):
    """fused_stem in bf16 needs pack_stem_weights' third entry (the kernel's
    matrix) and refuses a pair or a matrix of the wrong shape; in f32 it
    takes the pair."""
    _, ttree = _trees(rng, 3)
    x = torch.zeros(1, 224, 224, 3, dtype=torch.bfloat16)
    w, b, wk = tfb.pack_stem_weights(ttree, torch.bfloat16)
    assert tfb.fused_stem(x, (w, b, wk)).shape == (1, 56, 56, 64)
    with pytest.raises(ValueError):
        tfb.fused_stem(x, (w, b))
    with pytest.raises(ValueError):
        tfb.fused_stem(x, (w, b, wk[:64]))
    with pytest.raises(ValueError):
        tfb.fused_stem(x.float(), tfb.pack_stem_weights(ttree, torch.float32) + (wk.float(),))
