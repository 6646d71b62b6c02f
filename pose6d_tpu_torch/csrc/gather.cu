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
// Design: a grid of (row chunk, batch row) blocks of 256 threads; each
// thread moves 4 x 16-byte vectors (uint4), loaded all before any store so
// that 64 bytes per thread are in flight. Rows are whole multiples of 128
// words (512 bytes), so every vector is aligned and no row needs a tail. The
// block reads its own index (the TPU kernel's scalar prefetch) and clamps
// it into [0, N): no index reads outside the buffer, as JAX's indexing
// gather clamps. Loads stream past L1 (__ldcs: each frame is read once);
// stores stay default-cached, since the crop that follows reads them.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VECS_PER_THREAD = 4;
constexpr int VECS_PER_BLOCK = THREADS * VECS_PER_THREAD;  // 16 KB per block

__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const uint4* __restrict__ src, const int* __restrict__ idx,
                   uint4* __restrict__ out, int n_rows, long long vecs_per_row) {
  const int b = blockIdx.y;
  const int row = min(max(idx[b], 0), n_rows - 1);
  const uint4* s = src + (long long)row * vecs_per_row;
  uint4* o = out + (long long)b * vecs_per_row;
  const long long base = (long long)blockIdx.x * VECS_PER_BLOCK + threadIdx.x;
  uint4 v[VECS_PER_THREAD];
#pragma unroll
  for (int k = 0; k < VECS_PER_THREAD; ++k) {
    const long long i = base + (long long)k * THREADS;
    if (i < vecs_per_row) v[k] = __ldcs(s + i);
  }
#pragma unroll
  for (int k = 0; k < VECS_PER_THREAD; ++k) {
    const long long i = base + (long long)k * THREADS;
    if (i < vecs_per_row) o[i] = v[k];
  }
}

}  // namespace

// src [N, R] and out [B, R] 32-bit words, 16-byte aligned, R % 4 == 0;
// idx [B] int32. B <= 65535 (grid y).
extern "C" int pose6d_gather_rows_u32(const void* src, const void* idx, void* out,
                                      int N, int B, int R, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  const long long vecs = R / 4;
  const dim3 grid((unsigned)((vecs + VECS_PER_BLOCK - 1) / VECS_PER_BLOCK), B);
  gather_rows_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (const int*)idx, (uint4*)out, N, vecs);
  return (int)cudaGetLastError();
}
