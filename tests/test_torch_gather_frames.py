"""pose6d_tpu_torch.ops.gather_frames against the JAX gather_frames /
gather_frames_packed (its Pallas row gather in interpret mode on the CPU)
and jnp.take: bit-exact for uint8 RGB, uint16 depth and uint32 frames, the
odd-geometry fallback, and the host pack. The port's wrapper runs its
plain version here (CPU tensors); the kernel is held to it on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.ops import gather_frames as jgf
from pose6d_tpu_torch import _build
from pose6d_tpu_torch.ops import gather_frames as tgf

TORCH_DTYPES = {np.uint8: torch.uint8, np.uint16: torch.uint16, np.uint32: torch.uint32}
CASES = [
    ((7, 48, 64, 3), np.uint8),   # RGB frames: 48*64*3 bytes = 72 rows of 128 words
    ((7, 48, 64), np.uint16),     # depth in mm: 48 rows of 128 words
    ((5, 32, 128), np.uint32),    # one word per element
]
IDX = [0, 6, 3, 3, 4, 1]  # repeats and both ends


def _src(shape, dtype, seed=0):
    return np.random.default_rng(seed).integers(0, np.iinfo(dtype).max, shape, dtype)


@pytest.mark.parametrize("shape,dtype", CASES)
def test_gather_frames_bit_exact_with_jax(shape, dtype):
    src = _src(shape, dtype)
    idx = np.array([i % shape[0] for i in IDX], np.int32)
    want = np.asarray(jgf.gather_frames(jnp.asarray(src), jnp.asarray(idx)))
    got = tgf.gather_frames(torch.from_numpy(src), torch.from_numpy(idx))
    assert got.dtype == TORCH_DTYPES[dtype] and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,dtype", CASES)
def test_gather_frames_packed_bit_exact_with_jax(shape, dtype):
    src = _src(shape, dtype, seed=1)
    words = tgf.pack_frames_host(src)
    np.testing.assert_array_equal(words, jgf.pack_frames_host(src))
    idx = np.array([i % shape[0] for i in IDX], np.int32)
    want = np.asarray(jgf.gather_frames_packed(jnp.asarray(words), jnp.asarray(idx),
                                               shape[1:], dtype))
    np.testing.assert_array_equal(want, src[idx])
    # the port holds words as int32 (the store's layout) or uint32
    for held in (words.view(np.int32), words):
        got = tgf.gather_frames_packed(torch.from_numpy(held), torch.from_numpy(idx),
                                       shape[1:], TORCH_DTYPES[dtype])
        assert got.dtype == TORCH_DTYPES[dtype]
        np.testing.assert_array_equal(got.numpy(), want)


def test_odd_geometry_falls_back():
    """Frames that are not whole 128-word rows: the host pack refuses them
    and the gather takes index_select, still bit-exact."""
    for shape, dtype in (((5, 10, 10, 3), np.uint8), ((5, 9, 7), np.uint16)):
        src = _src(shape, dtype, seed=2)
        assert tgf.pack_frames_host(src) is None and jgf.pack_frames_host(src) is None
        idx = np.array([4, 0, 2, 2], np.int32)
        want = np.asarray(jgf.gather_frames(jnp.asarray(src), jnp.asarray(idx)))
        got = tgf.gather_frames(torch.from_numpy(src), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), want)


def test_rows_plain_version_clamps_out_of_range_indices():
    """The stated index contract: an index outside [0, N) reads the nearest
    end row (never outside the buffer), as the kernel does."""
    words = torch.from_numpy(_src((4, 256), np.uint32).view(np.int32))
    got = tgf.gather_rows_u32(words, torch.tensor([-3, 0, 3, 4, 99]))
    want = words[torch.tensor([0, 0, 3, 3, 3])]
    assert torch.equal(got, want)


def test_rows_refuses_what_the_kernel_does_not_take():
    ok = torch.zeros(2, 128, dtype=torch.int32)
    with pytest.raises(ValueError):
        tgf.gather_rows_u32(torch.zeros(2, 100, dtype=torch.int32), torch.tensor([0]))
    with pytest.raises(TypeError):
        tgf.gather_rows_u32(torch.zeros(2, 128, dtype=torch.uint8), torch.tensor([0]))
    with pytest.raises(TypeError):
        tgf.gather_rows_u32(ok, torch.tensor([0.0]))
    with pytest.raises(ValueError):
        tgf.gather_rows_u32(ok.to("meta"), torch.tensor([0]))


def test_plain_version_counts_no_launch():
    _build.launch_counts.clear()
    tgf.gather_rows_u32(torch.zeros(2, 128, dtype=torch.int32), torch.tensor([1, 0]))
    assert _build.launch_counts["gather_rows_u32"] == 0


def test_gather_frames_refuses_non_contiguous():
    """A strided src raises on the CPU as on the card, for whole-row and odd
    geometry alike: no quiet copy or index_select stands in for the kernel."""
    for shape, dtype in (((7, 48, 64, 3), np.uint8), ((5, 9, 7), np.uint16)):
        src = torch.from_numpy(_src(shape, dtype, seed=3))[::2]
        assert not src.is_contiguous()
        with pytest.raises(ValueError, match="contiguous"):
            tgf.gather_frames(src, torch.tensor([0, 1]))
