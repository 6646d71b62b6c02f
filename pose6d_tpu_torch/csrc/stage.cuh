// What stage.cu (the f32 FMA GEMM) and stage_wgmma.cu (the bf16 wgmma GEMM)
// share: the GEMM a bottleneck conv becomes, and the loop that turns one
// ResNet50 bottleneck stage into three GEMM launches per block.
#pragma once

#include <cuda_runtime.h>

namespace pose6d_stage {

// Where the output rows of a GEMM sit: B images of ho x wo pixels, computed
// from an input map of h x w pixels at `stride`. The 3x3 implicit GEMM reads
// its A1 from the input map; the shortcut A2 reads input pixel (s*oy, s*ox).
struct Geometry {
  int h, w, ho, wo, stride;
};

// out[m, n] = relu(sum_k A1[m, k] W1[k, n] + sum_k A2[m, k] W2[k, n]
//                 + bias[n] + bias2[n] + res[m, n])
// A2/W2 (K2 = 0), bias2 and res are optional (nullptr). With conv3x3, A1 is
// the [B, h, w, K1/9] map read as its 3x3 patch matrix in (ky, kx, cin)
// column order; else A1 is [M, K1]. Every matrix is row-major, W [K, N].
struct Gemm {
  const void *a1, *w1, *a2, *w2;
  const float *bias, *bias2;
  const void* res;
  void* out;
  int M, N, K1, K2;
  Geometry g;
  bool conv3x3;
};

// One ResNet50 bottleneck stage: n_blocks folded blocks cin -> cmid -> cout
// on an [B, h, w, cin] NHWC map, block 0 at `stride` with a projection
// shortcut, giving [B, h/stride, w/stride, cout]. Calls
// gemm(i, Gemm) for the i-th GEMM (3 per block: conv1, conv2, conv3 with its
// shortcut) in launch order and stops at the first error.
//
// wt holds the 6*n_blocks+2 device pointers of pack_stage_weights, in its
// order: block 0 w1 b1 w2 b2 w3 b3 wd bd; blocks >= 1 w1 b1 w2 b2 w3 b3.
// Caller-allocated scratch: t1 [B*h*w, cmid] (block 0's conv1 runs at the
// input resolution), t2 [B*ho*wo, cmid], ya and yb [B*ho*wo, cout].
template <class GemmFn>
cudaError_t run_stage(GemmFn&& gemm, const void* x, const void* const* wt,
                      int n_weights, int n_blocks, int B, int h, int w,
                      int stride, int cin, int cmid, int cout, void* t1,
                      void* t2, void* ya, void* yb, void* out) {
  if (n_blocks < 1 || n_weights != 6 * n_blocks + 2 || (stride != 1 && stride != 2) ||
      h % stride || w % stride)
    return cudaErrorInvalidValue;
  const int ho = h / stride, wo = w / stride;
  const int m_out = B * ho * wo;
  const Geometry g0 = {h, w, ho, wo, stride};  // block 0's 3x3 and shortcut
  const Geometry g1 = {ho, wo, ho, wo, 1};      // blocks >= 1
  const float* const* f = reinterpret_cast<const float* const*>(wt);
  const void* in = x;
  int at = 0;
  for (int j = 0; j < n_blocks; ++j) {
    const Geometry& g = j == 0 ? g0 : g1;
    const int ci = j == 0 ? cin : cout;
    void* y = j == n_blocks - 1 ? out : (j % 2 == 0 ? ya : yb);
    const Gemm conv1 = {in, wt[at], nullptr, nullptr, f[at + 1], nullptr, nullptr, t1,
                        B * g.h * g.w, cmid, ci, 0, g1, false};
    const Gemm conv2 = {t1, wt[at + 2], nullptr, nullptr, f[at + 3], nullptr, nullptr, t2,
                        m_out, cmid, 9 * cmid, 0, g, true};
    Gemm conv3 = {t2, wt[at + 4], nullptr, nullptr, f[at + 5], nullptr, in, y,
                  m_out, cout, cmid, 0, g1, false};
    at += 6;
    if (j == 0) {  // conv3 + projection shortcut in one accumulator
      conv3.a2 = x;
      conv3.w2 = wt[at];
      conv3.bias2 = f[at + 1];
      conv3.res = nullptr;
      conv3.K2 = cin;
      conv3.g = g0;
      at += 2;
    }
    cudaError_t err;
    if ((err = gemm(3 * j, conv1)) != cudaSuccess) return err;
    if ((err = gemm(3 * j + 1, conv2)) != cudaSuccess) return err;
    if ((err = gemm(3 * j + 2, conv3)) != cudaSuccess) return err;
    in = y;
  }
  return cudaSuccess;
}

// One GEMM on the bf16 wgmma kernel (stage_wgmma.cu) with tile N `bn` and
// `splits` K splits; ws (f32, splits*M*N) and tickets (int32, one per
// output tile, zero) are caller-allocated and used only when splits > 1.
cudaError_t gemm_bf16(const Gemm& g, int bn, int splits, float* ws, int* tickets,
                      cudaStream_t stream);

}  // namespace pose6d_stage
