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
// register, with the index of the GT point that gave it; each thread ends
// by recomputing that one distance in f64 and rounding it once to f32, so
// the result is within about half an f32 ulp of the exact distance (an f32
// sum of squares and sqrtf can be 2 ulp off, 1.2e-7 m at 1 m) at the cost
// of one select per pair. The difference form (a - b)^2 needs neither
// padding nor sentinels (bounds are checked) and does not cancel near zero
// as the expansion does.

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
  int arg = 0;  // the first GT point at the smallest squared distance
  for (int c0 = 0; c0 < P; c0 += CHUNK) {
    const int n = min(CHUNK, P - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < 3 * n; j += TILE_P) s_gt[j] = gb[3 * c0 + j];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = px - s_gt[3 * j];
      const float dy = py - s_gt[3 * j + 1];
      const float dz = pz - s_gt[3 * j + 2];
      const float d2 = dx * dx + dy * dy + dz * dz;
      arg = d2 < best ? c0 + j : arg;
      best = fminf(best, d2);
    }
  }
  if (i < P) {
    const double dx = (double)px - gb[3 * arg];
    const double dy = (double)py - gb[3 * arg + 1];
    const double dz = (double)pz - gb[3 * arg + 2];
    out[(size_t)b * P + i] = (float)sqrt(dx * dx + dy * dy + dz * dz);
  }
}

}  // namespace

extern "C" int pose6d_addmin_forward(const void* pred, const void* gt,
                                     void* out, int B, int P, void* stream) {
  const dim3 grid((P + TILE_P - 1) / TILE_P, B);
  addmin_kernel<<<grid, TILE_P, 0, (cudaStream_t)stream>>>(
      (const float*)pred, (const float*)gt, (float*)out, P);
  return (int)cudaGetLastError();
}
