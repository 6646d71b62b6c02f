// ADD-S nearest-point distance: for each of P predicted model points, the
// Euclidean distance to the nearest of the P ground-truth points, per
// sample. pred, gt [B, P, 3] f32 (centred by the caller) -> out [B, P] f32.
//
// Replaces: pose6d_tpu/ops/pallas_addmin.py pairwise_min_dist_pallas /
// _addmin_kernel, which formed the [P, P] matrix on the TPU's matrix unit
// as |a|^2 + |b|^2 - 2 a.b (clamped at 0) with P padded to a multiple of
// 128 by 1e9 sentinel rows.
//
// What bounds it on an H100: about 8 f32 operations per point pair (2 MFLOP
// per sample at P = 500) against 14 KB of input and output per sample, so
// it is compute-bound in principle; at the serving batch (B = 8, 16 MFLOP)
// a launch takes longer than the work, so launch latency bounds it.
//
// Design: one block per (sample, tile of 128 predicted points), one thread
// per predicted point. The block stages the sample's GT points in shared
// memory in chunks of 512 (every thread then reads the same GT point: a
// broadcast) and keeps a running minimum of the squared distance in a
// register; each thread ends with one sqrtf. The difference form
// (a - b)^2 needs neither padding nor sentinels (bounds are checked) and
// does not cancel near zero as the expansion does.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_P = 128;  // predicted points per block (threads)
constexpr int CHUNK = 512;   // GT points staged per pass

__global__ void __launch_bounds__(TILE_P)
addmin_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
              float* __restrict__ out, int P) {
  __shared__ float s_gt[CHUNK * 3];
  const int b = blockIdx.y;
  const int i = blockIdx.x * TILE_P + threadIdx.x;
  const float* pb = pred + (size_t)b * P * 3;
  const float* gb = gt + (size_t)b * P * 3;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (i < P) {
    px = pb[3 * i];
    py = pb[3 * i + 1];
    pz = pb[3 * i + 2];
  }
  float best = 3.402823466e38f;
  for (int c0 = 0; c0 < P; c0 += CHUNK) {
    const int n = min(CHUNK, P - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < 3 * n; j += TILE_P) s_gt[j] = gb[3 * c0 + j];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = px - s_gt[3 * j];
      const float dy = py - s_gt[3 * j + 1];
      const float dz = pz - s_gt[3 * j + 2];
      best = fminf(best, dx * dx + dy * dy + dz * dz);
    }
  }
  if (i < P) out[(size_t)b * P + i] = sqrtf(best);
}

}  // namespace

extern "C" int pose6d_addmin_forward(const void* pred, const void* gt,
                                     void* out, int B, int P, void* stream) {
  const dim3 grid((P + TILE_P - 1) / TILE_P, B);
  addmin_kernel<<<grid, TILE_P, 0, (cudaStream_t)stream>>>(
      (const float*)pred, (const float*)gt, (float*)out, P);
  return (int)cudaGetLastError();
}
