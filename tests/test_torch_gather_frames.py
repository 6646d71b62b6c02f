"""pose6d_tpu_torch.ops.gather_frames against the JAX gather_frames /
gather_frames_packed (its Pallas row gather in interpret mode on the CPU)
and jnp.take: bit-exact for uint8 RGB, uint16 depth and uint32 frames, the
odd-geometry fallback, and the host pack. The port's wrapper runs its
plain version here (CPU tensors); the kernel is held to it on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py). The kernel's share plan
(gather_shares, the split csrc/gather.cu computes: the output's 16-byte
vectors in chunks of CHUNK_VECS, block i of G taking chunks i, i + G, ...)
is checked here: every 16-byte vector once, each share in order, shares
that differ by at most one chunk, pieces that break only at chunk ends
and row crossings, and a copy that follows the plan bit for bit equal to
src[clamp(idx)]."""

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


SLOTS = (132 * 8, 132 * 3, 1)  # an H100's slots (8 blocks a SM), fewer, one block


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("r", [128, 384, 153_600, 230_400])
@pytest.mark.parametrize("batch", [1, 3, 32, 33])
def test_shares_cover_every_vector_once_in_order(batch, r, slots):
    vpr, chunk = r // 4, tgf.CHUNK_VECS
    total = batch * vpr
    blocks = tgf.gather_blocks(total, slots)
    assert blocks == min(slots, -(-total // chunk)) >= 1  # every slot, or a block per chunk
    shares = tgf.gather_shares(batch, r, blocks)
    assert len(shares) == blocks
    sizes = [sum(n for _, _, n in pieces) for pieces in shares]
    assert max(sizes) - min(sizes) <= chunk
    covered = []
    for i, pieces in enumerate(shares):
        at = [b * vpr + first for b, first, _ in pieces]
        assert at == sorted(at)  # in order
        for j, (b, first, n) in enumerate(pieces):
            assert n > 0 and first + n <= vpr  # inside one row
            start = b * vpr + first
            assert start // chunk % blocks == i  # one of block i's chunks
            if start % chunk:  # not a chunk's head: it follows a row crossing
                prev_b, prev_first, prev_n = pieces[j - 1]
                assert first == 0 and b == prev_b + 1 and prev_first + prev_n == vpr
            covered.append((start, n))
    covered.sort()
    assert covered[0][0] == 0 and sum(n for _, n in covered) == total
    assert all(a + n == c for (a, n), (c, _) in zip(covered, covered[1:]))  # once each


@pytest.mark.parametrize("batch,r", [(1, 128), (3, 384), (33, 128)])
def test_copy_by_the_share_plan_is_the_gather(batch, r):
    """Each block's segments, copied from source row clamp(idx[b]), give
    src[clamp(idx)] bit for bit, repeated and out-of-range indices included."""
    n = 5
    src = _src((n, r), np.uint32)
    idx = np.resize([4, -2, 2, 2, 9, 0], batch)
    blocks = tgf.gather_blocks(batch * r // 4, 132 * 3)
    out = np.zeros((batch, r), np.uint32)
    vec = lambda a: a.reshape(a.shape[0], -1, 4)  # noqa: E731 — 16-byte vectors
    for segs in tgf.gather_shares(batch, r, blocks):
        for b, first, cnt in segs:
            row = min(max(int(idx[b]), 0), n - 1)
            vec(out)[b, first:first + cnt] = vec(src)[row, first:first + cnt]
    np.testing.assert_array_equal(out, src[np.clip(idx, 0, n - 1)])

