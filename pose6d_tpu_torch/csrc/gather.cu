// Resident-frame row gather: out[b, :] = src[idx[b], :] for B rows of R
// 32-bit words out of an [N, R] buffer, bit for bit. The buffer holds a
// training split's decoded frames packed on the host (uint8 RGB or uint16
// depth viewed as 32-bit words), so a row is one frame.
//
// Replaces: pose6d_tpu/ops/gather_frames.py _gather_rows_u32 /
// _gather_rows_kernel, a Pallas copy whose BlockSpec index_map read the
// batch indices from scalar-prefetch memory so that the TPU's pipeline
// DMA'd exactly the B requested frames HBM -> VMEM -> HBM.
//
// What bounds it on an H100: it does no arithmetic; it reads B rows and
// writes B rows, 2 * B * R * 4 bytes through device memory (at LineMOD's
// 640x480 and B = 32: 59.0 MB for RGB, 39.3 MB for depth). The bound is
// those bytes over 3.35 TB/s.
//
// Design: a persistent copy with even shares. The output's B * R / 4
// 16-byte vectors are cut into chunks of 1024 (16 KB; the last may be
// short), and the caller sizes the grid to the card
// (ops/gather_frames.gather_blocks: its SM count times the 8 blocks of 256
// threads an SM runs at once, or one block per chunk if that is fewer).
// Block i copies chunks i, i + G, i + 2G, ...: shares differ by at most one
// chunk, so every SM moves the same bytes, with no tail wave and no
// half-empty block at each row's end (the fixed 16 KB blocks of the first
// version left 1.15 / 1.73 waves at batch 32), and the blocks running at
// once work on neighbouring chunks, which keeps device memory's accesses
// close together (one contiguous run per block, tried first, read slower).
// A chunk may run from the tail of one row into the head of the next; at
// each crossing the block reads that row's index and clamps it into
// [0, N): no index reads outside the buffer, as JAX's indexing gather
// clamps. ops/gather_frames.gather_shares is the same split in Python, for
// the tests. Rows are whole multiples of 128 words, so every vector is
// aligned and no row needs a tail. A block copies a chunk's pieces (its
// runs inside one row) with 4 16-byte vectors per thread, loads streaming
// past L1 (__ldcs: each frame is read once), stores default-cached, since
// the crop that follows reads them. (Hopper's bulk copies through a
// shared-memory ring, timed beside this loop on the same shares, were no
// faster: PERF.md.)

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK_VECS = 1024;  // 16 KB: the unit of the shares
constexpr int THREADS = 256;
constexpr int PER_THREAD = CHUNK_VECS / THREADS;  // a piece in one pass

// The pieces of this block's share in order: its chunks blockIdx.x,
// blockIdx.x + gridDim.x, ..., each cut at the row crossings inside it.
struct Pieces {
  const int* idx;
  long long vpr, total, chunk, v, chunk_end, seg_end, delta = 0;
  int n_rows;

  __device__ Pieces(const int* idx_, int n_rows_, long long vpr_, long long total_)
      : idx(idx_), vpr(vpr_), total(total_), chunk(blockIdx.x), n_rows(n_rows_) {
    start_chunk();
  }
  __device__ void start_chunk() {
    v = seg_end = chunk * CHUNK_VECS;
    chunk_end = min(total, v + CHUNK_VECS);
  }
  __device__ bool more() const { return v < chunk_end; }
  // The next piece: output vectors [dst, dst + n), n <= CHUNK_VECS, from
  // source vectors [src, src + n) (delta moves output row b onto source row
  // clamp(idx[b])).
  __device__ void next(long long& dst, long long& src, int& n) {
    if (v == seg_end) {
      const long long b = v / vpr;
      const int row = min(max(__ldg(idx + b), 0), n_rows - 1);
      seg_end = min(chunk_end, (b + 1) * vpr);
      delta = (row - b) * vpr;
    }
    n = static_cast<int>(seg_end - v);
    dst = v;
    src = v + delta;
    v += n;
    if (v == chunk_end) {
      chunk += gridDim.x;
      start_chunk();
    }
  }
};

__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const uint4* __restrict__ src, const int* __restrict__ idx,
                   uint4* __restrict__ out, int n_rows, long long vpr, long long total) {
  Pieces pieces(idx, n_rows, vpr, total);
  while (pieces.more()) {
    long long dst, from;
    int n;
    pieces.next(dst, from, n);
    uint4 v[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int i = threadIdx.x + k * THREADS;
      if (i < n) v[k] = __ldcs(src + from + i);
    }
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int i = threadIdx.x + k * THREADS;
      if (i < n) out[dst + i] = v[k];
    }
  }
}

}  // namespace

// src [N, R] and out [B, R] 32-bit words, 16-byte aligned, R % 4 == 0;
// idx [B] int32; blocks: the grid (the number of shares, at most the
// chunks).
extern "C" int pose6d_gather_rows_u32(const void* src, const void* idx, void* out, int N,
                                      int B, int R, int blocks, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long vpr = R / 4;
  gather_rows_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<const int*>(idx), static_cast<uint4*>(out), N,
      vpr, vpr * B);
  return static_cast<int>(cudaGetLastError());
}
