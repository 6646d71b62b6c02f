// Any ResNet50 bottleneck stage (1-4) of the folded serving towers as one
// call: n_blocks BN-folded blocks cin -> cmid -> cout, block 0 at stride 1
// or 2 with a projection shortcut, [B,h,w,cin] NHWC -> [B,h/s,w/s,cout].
// This file holds the call's entry point and its f32 GEMM; bf16 runs the
// same three GEMMs per block on the tensor cores (stage_wgmma.cu).
//
// Replaces: pose6d_tpu/ops/pallas_block.py fused_stage / _stage_kernel, the
// parametric generalisation of fused_layer1: one image per grid step with
// every bottleneck intermediate in TPU VMEM, the 3x3 conv as one im2col
// matmul, and a stride-2 block 0 as subsampled im2col chunks plus a 1x1
// conv over the even rows and columns. At stage 1 it also replaces
// fused_layer1 / _layer1_kernel, the same computation specialised to
// layer1, which the port runs as this code behind its own wrapper.
//
// What bounds the f32 path on an H100: per image 0.67 / 1.03 / 1.46 / 0.81
// GMAC for stages 1-4 on the CUDA cores' 67 TFLOP/s f32 FMAs (on the tensor
// cores f32 would be TF32, another function than the JAX f32 kernel's); no
// served path runs it, the folded serving is bf16. It streams every weight
// tile from device memory (L2 for the later row tiles).
//
// Design: three launches of one tiled GEMM kernel per block over
// caller-allocated scratch (stage.cuh run_stage); fused_layer1 is this code
// at stage 1. Block 0's conv1 runs at the input resolution, its 3x3/s2 conv
// reads input pixel (2*oy+ky-1, 2*ox+kx-1) (padding 1 on every side, as
// torch and the JAX package's folded forward pad it) and its shortcut reads
// input pixel (2*oy, 2*ox). M = B*ho*wo need not be a multiple of the
// 64-row tile (stage 2 at B=1 has 784 rows, stage 4 49 per image).
//
// Every conv of a bottleneck stage is a GEMM over the pixel rows of an NHWC
// map. The 1x1 convs read the activation as a dense [M, Cin] matrix. The 3x3
// conv (stride 1 or 2, padding 1 on every side as in torch) is an implicit
// GEMM: its A tile is gathered on the fly in the (ky, kx, cin) column order of
// the packed [9*Cin, Cout] weight, with zeros outside the input map, so no
// im2col buffer is written. Block 0's conv3 and its projection shortcut are
// one GEMM over two (A, W) pairs summed in one f32 accumulator; the shortcut's
// A rows are the input pixels (s*oy, s*ox), which is the 1x1/s2 conv of a
// stride-2 block. The epilogue adds the biases and, for blocks >= 1, the
// identity shortcut read from the block input, applies ReLU and stores f32.
//
// Tiles: 64x64 outputs per block of 256 threads, 4x4 per thread strided by
// 16 so that shared-memory reads are conflict-free or broadcast; K steps of
// 16. N must be a multiple of 64 and every K of 16 (true of every ResNet50
// stage); M is any size: rows past M load zeros and store nothing.

#include <cuda_runtime.h>

#include "stage.cuh"

// Internal linkage: no symbol of this file meets one of another source.
namespace {

using pose6d_stage::Gemm;
using pose6d_stage::Geometry;

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

// out[m, n] = relu(sum_k A1[m, k] W1[k, n] + sum_k A2[m, k] W2[k, n]
//                 + bias[n] + bias2[n] + res[m, n])
// A2/W2, bias2 and res are optional (nullptr). With IM2COL, A1 is the
// [B, h, w, K1/9] map read as its 3x3 patch matrix; else A1 is [M, K1].
template <bool IM2COL>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const float* __restrict__ a1, const float* __restrict__ w1,
            const float* __restrict__ a2, const float* __restrict__ w2,
            const float* __restrict__ bias, const float* __restrict__ bias2,
            const float* __restrict__ res, float* __restrict__ out,
            int M, int N, int K1, int K2, Geometry g) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // loader roles: A tile row lr with 4 consecutive k; W tile row wk with 4
  // consecutive n
  const int lr = tid / 4, lk = (tid % 4) * 4;
  const int wk = tid / 16, wn = (tid % 16) * 4;
  const int m = m0 + lr;
  const bool row_ok = m < M;
  const int pix = m % (g.ho * g.wo), img = m / (g.ho * g.wo);
  const int oy = pix / g.wo, ox = pix % g.wo;
  // the input pixel under output pixel (oy, ox): the 3x3 window's centre and
  // the strided shortcut's source
  const int cy = oy * g.stride, cx = ox * g.stride;
  const size_t centre = ((size_t)img * g.h + cy) * g.w + cx;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int phase = 0; phase < 2; ++phase) {
    const float* a = phase == 0 ? a1 : a2;
    const float* w = phase == 0 ? w1 : w2;
    const int K = phase == 0 ? K1 : K2;
    if (a == nullptr) break;
    for (int k0 = 0; k0 < K; k0 += BK) {
      const int k = k0 + lk;
      if (IM2COL && phase == 0) {
        const int cin = K / 9, tap = k / cin, ci = k % cin;
        const int yy = cy + tap / 3 - 1, xx = cx + tap % 3 - 1;
        const bool inside = row_ok && yy >= 0 && yy < g.h && xx >= 0 && xx < g.w;
        const float* src = a + (((size_t)img * g.h + yy) * g.w + xx) * cin + ci;
#pragma unroll
        for (int q = 0; q < 4; ++q) As[lk + q][lr] = inside ? src[q] : 0.f;
      } else {
        const float* src = a + (phase == 0 ? (size_t)m : centre) * K + k;
#pragma unroll
        for (int q = 0; q < 4; ++q) As[lk + q][lr] = row_ok ? src[q] : 0.f;
      }
      const float* wsrc = w + (size_t)(k0 + wk) * N + n0 + wn;
#pragma unroll
      for (int q = 0; q < 4; ++q) Ws[wk][wn + q] = wsrc[q];
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = Ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
    const size_t row = (size_t)r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      float v = acc[i][j] + bias[n];
      if (bias2 != nullptr) v += bias2[n];
      if (res != nullptr) v += res[row * N + n];
      out[row * N + n] = fmaxf(v, 0.f);
    }
  }
}

cudaError_t gemm_f32(const Gemm& p, cudaStream_t stream) {
  if (p.N % BN || p.K1 % BK || p.K2 % BK) return cudaErrorInvalidValue;
  const dim3 grid(p.N / BN, (p.M + BM - 1) / BM);
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  if (p.conv3x3)
    gemm_kernel<true><<<grid, THREADS, 0, stream>>>(
        f(p.a1), f(p.w1), f(p.a2), f(p.w2), p.bias, p.bias2, f(p.res),
        static_cast<float*>(p.out), p.M, p.N, p.K1, p.K2, p.g);
  else
    gemm_kernel<false><<<grid, THREADS, 0, stream>>>(
        f(p.a1), f(p.w1), f(p.a2), f(p.w2), p.bias, p.bias2, f(p.res),
        static_cast<float*>(p.out), p.M, p.N, p.K1, p.K2, p.g);
  return cudaGetLastError();
}

}  // namespace

// weights: the 6*n_blocks+2 device pointers of pack_stage_weights (n_weights
// of them, checked); t1 [B*h*w, cmid], t2 [B*ho*wo, cmid] and ya, yb
// [B*ho*wo, cout] are caller-allocated scratch. bf16 only: plan holds
// (tile N, K splits) for each of the 3*n_blocks GEMMs in launch order
// (ops/fused_block.stage_plan), ws is the f32 split-K workspace and
// tickets the zeroed int32 ticket per output tile; f32 takes n_plan 0.
extern "C" int pose6d_stage_forward(const void* x, const void* const* weights,
                                    int n_weights, int n_blocks, void* t1,
                                    void* t2, void* ya, void* yb, void* out,
                                    int B, int h, int w, int stride, int cin,
                                    int cmid, int cout, int is_bf16,
                                    const int* plan, int n_plan, void* ws,
                                    void* tickets, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (n_plan != 3 * n_blocks) return cudaErrorInvalidValue;
    return pose6d_stage::run_stage(
        [&](int i, const Gemm& g) {
          return pose6d_stage::gemm_bf16(g, plan[2 * i], plan[2 * i + 1],
                                         static_cast<float*>(ws), static_cast<int*>(tickets), s);
        },
        x, weights, n_weights, n_blocks, B, h, w, stride, cin, cmid, cout, t1, t2, ya, yb, out);
  }
  return pose6d_stage::run_stage([&](int, const Gemm& g) { return gemm_f32(g, s); }, x,
                                 weights, n_weights, n_blocks, B, h, w, stride, cin, cmid,
                                 cout, t1, t2, ya, yb, out);
}
