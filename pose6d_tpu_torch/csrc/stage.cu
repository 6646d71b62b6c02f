// Any ResNet50 bottleneck stage (1-4) of the folded serving towers as one
// call: n_blocks BN-folded blocks cin -> cmid -> cout, block 0 at stride 1
// or 2 with a projection shortcut, [B,h,w,cin] NHWC -> [B,h/s,w/s,cout].
//
// Replaces: pose6d_tpu/ops/pallas_block.py fused_stage / _stage_kernel, the
// parametric generalisation of fused_layer1: one image per grid step with
// every bottleneck intermediate in TPU VMEM, the 3x3 conv as one im2col
// matmul, and a stride-2 block 0 as subsampled im2col chunks plus a 1x1
// conv over the even rows and columns. At stage 1 it also replaces
// fused_layer1 / _layer1_kernel, the same computation specialised to
// layer1, which the port runs as this code behind its own wrapper.
//
// What bounds it on an H100: per image 0.67 / 1.03 / 1.46 / 0.81 GMAC for
// stages 1-4 against 2.0 / 2.4 / 1.2 / 0.6 MB of bf16 input and output plus
// 0.4 / 2.4 / 14 / 30 MB of bf16 weights read once per call. With tensor
// cores the small batches of serving are bandwidth- or weight-bound; this
// first version runs f32 FMAs on the CUDA cores, so it is FMA-bound, and it
// streams every weight tile from device memory (L2 for the later row
// tiles): stage 4's 30 MB never fit on chip.
//
// Design: three launches of one tiled GEMM kernel per block over
// caller-allocated scratch; fused_layer1 is this code at stage 1. Block 0's
// conv1 runs at the input resolution, its 3x3/s2 conv reads input pixel
// (2*oy+ky-1, 2*ox+kx-1) (padding 1 on every side, as torch and the JAX
// package's folded forward pad it) and its shortcut reads input pixel
// (2*oy, 2*ox). M = B*ho*wo need not be a multiple of the 64-row tile
// (stage 2 at B=1 has 784 rows, stage 4 49 per image).
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
// identity shortcut read from the block input, applies ReLU and rounds to
// the storage type: activations round to the compute type exactly where the
// TPU kernel rounded them, with f32 accumulation everywhere.
//
// Tiles: 64x64 outputs per block of 256 threads, 4x4 per thread strided by
// 16 so that shared-memory reads are conflict-free or broadcast; K steps of
// 16. N must be a multiple of 64 and every K of 16 (true of every ResNet50
// stage); M is any size: rows past M load zeros and store nothing. f32 FMAs
// on the CUDA cores; a wgmma version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Internal linkage: no symbol of this file meets one of another source.
namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Where the output rows of a GEMM sit: B images of ho x wo pixels, computed
// from an input map of h x w pixels at `stride`. The 3x3 implicit GEMM reads
// its A1 from the input map; the shortcut A2 reads input pixel (s*oy, s*ox).
struct Geometry {
  int h, w, ho, wo, stride;
};

// out[m, n] = relu(sum_k A1[m, k] W1[k, n] + sum_k A2[m, k] W2[k, n]
//                 + bias[n] + bias2[n] + res[m, n])
// A2/W2, bias2 and res are optional (nullptr). With IM2COL, A1 is the
// [B, h, w, K1/9] map read as its 3x3 patch matrix; else A1 is [M, K1].
template <typename T, bool IM2COL>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ a1, const T* __restrict__ w1,
            const T* __restrict__ a2, const T* __restrict__ w2,
            const float* __restrict__ bias, const float* __restrict__ bias2,
            const T* __restrict__ res, T* __restrict__ out,
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
    const T* a = phase == 0 ? a1 : a2;
    const T* w = phase == 0 ? w1 : w2;
    const int K = phase == 0 ? K1 : K2;
    if (a == nullptr) break;
    for (int k0 = 0; k0 < K; k0 += BK) {
      const int k = k0 + lk;
      if (IM2COL && phase == 0) {
        const int cin = K / 9, tap = k / cin, ci = k % cin;
        const int yy = cy + tap / 3 - 1, xx = cx + tap % 3 - 1;
        const bool inside = row_ok && yy >= 0 && yy < g.h && xx >= 0 && xx < g.w;
        const T* src = a + (((size_t)img * g.h + yy) * g.w + xx) * cin + ci;
#pragma unroll
        for (int q = 0; q < 4; ++q) As[lk + q][lr] = inside ? to_f(src[q]) : 0.f;
      } else {
        const T* src = a + (phase == 0 ? (size_t)m : centre) * K + k;
#pragma unroll
        for (int q = 0; q < 4; ++q) As[lk + q][lr] = row_ok ? to_f(src[q]) : 0.f;
      }
      const T* wsrc = w + (size_t)(k0 + wk) * N + n0 + wn;
#pragma unroll
      for (int q = 0; q < 4; ++q) Ws[wk][wn + q] = to_f(wsrc[q]);
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
      if (res != nullptr) v += to_f(res[row * N + n]);
      out[row * N + n] = from_f<T>(fmaxf(v, 0.f));
    }
  }
}

template <typename T, bool IM2COL>
cudaError_t gemm(const void* a1, const void* w1, const void* a2, const void* w2,
                 const void* bias, const void* bias2, const void* res, void* out,
                 int M, int N, int K1, int K2, Geometry g, cudaStream_t stream) {
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_kernel<T, IM2COL><<<grid, THREADS, 0, stream>>>(
      (const T*)a1, (const T*)w1, (const T*)a2, (const T*)w2,
      (const float*)bias, (const float*)bias2, (const T*)res, (T*)out,
      M, N, K1, K2, g);
  return cudaGetLastError();
}

// One ResNet50 bottleneck stage: n_blocks folded blocks cin -> cmid -> cout
// on an [B, h, w, cin] NHWC map, block 0 at `stride` with a projection
// shortcut, giving [B, h/stride, w/stride, cout].
//
// wt holds the 6*n_blocks+2 device pointers of pack_stage_weights, in its
// order: block 0 w1 b1 w2 b2 w3 b3 wd bd; blocks >= 1 w1 b1 w2 b2 w3 b3.
// Caller-allocated scratch: t1 [B*h*w, cmid] (block 0's conv1 runs at the
// input resolution), t2 [B*ho*wo, cmid], ya and yb [B*ho*wo, cout].
template <typename T>
cudaError_t launch_stage(const void* x, const void* const* wt, int n_weights,
                         int n_blocks, int B, int h, int w, int stride, int cin,
                         int cmid, int cout, void* t1, void* t2, void* ya,
                         void* yb, void* out, cudaStream_t s) {
  if (n_blocks < 1 || n_weights != 6 * n_blocks + 2 || (stride != 1 && stride != 2) ||
      h % stride || w % stride || cin % BK || cmid % BN || cout % BN)
    return cudaErrorInvalidValue;
  const int ho = h / stride, wo = w / stride;
  const int m_out = B * ho * wo;
  const Geometry g0 = {h, w, ho, wo, stride};  // block 0's 3x3 and shortcut
  const Geometry g1 = {ho, wo, ho, wo, 1};      // blocks >= 1
  const void* in = x;
  int at = 0;
  for (int j = 0; j < n_blocks; ++j) {
    const void *w1 = wt[at], *b1 = wt[at + 1], *w2 = wt[at + 2], *b2 = wt[at + 3];
    const void *w3 = wt[at + 4], *b3 = wt[at + 5];
    at += 6;
    const Geometry& g = j == 0 ? g0 : g1;
    const int ci = j == 0 ? cin : cout;
    const int m_in = B * g.h * g.w;
    void* y = j == n_blocks - 1 ? out : (j % 2 == 0 ? ya : yb);
    cudaError_t err;
    err = gemm<T, false>(in, w1, nullptr, nullptr, b1, nullptr, nullptr, t1,
                         m_in, cmid, ci, 0, g1, s);
    if (err != cudaSuccess) return err;
    err = gemm<T, true>(t1, w2, nullptr, nullptr, b2, nullptr, nullptr, t2,
                        m_out, cmid, 9 * cmid, 0, g, s);
    if (err != cudaSuccess) return err;
    if (j == 0) {  // conv3 + projection shortcut in one accumulator
      const void *wd = wt[at], *bd = wt[at + 1];
      at += 2;
      err = gemm<T, false>(t2, w3, x, wd, b3, bd, nullptr, y, m_out, cout,
                           cmid, cin, g0, s);
    } else {  // conv3 + identity shortcut
      err = gemm<T, false>(t2, w3, nullptr, nullptr, b3, nullptr, in, y, m_out,
                           cout, cmid, 0, g1, s);
    }
    if (err != cudaSuccess) return err;
    in = y;
  }
  return cudaSuccess;
}

template <typename... Args>
cudaError_t launch_stage_dtype(int is_bf16, Args... args) {
  return is_bf16 ? launch_stage<__nv_bfloat16>(args...) : launch_stage<float>(args...);
}

}  // namespace

// weights: the 6*n_blocks+2 device pointers of pack_stage_weights (n_weights
// of them, checked); t1 [B*h*w, cmid], t2 [B*ho*wo, cmid] and ya, yb
// [B*ho*wo, cout] are caller-allocated scratch.
extern "C" int pose6d_stage_forward(const void* x, const void* const* weights,
                                    int n_weights, int n_blocks, void* t1,
                                    void* t2, void* ya, void* yb, void* out,
                                    int B, int h, int w, int stride, int cin,
                                    int cmid, int cout, int is_bf16,
                                    void* stream) {
  return launch_stage_dtype(is_bf16, x, weights, n_weights, n_blocks, B, h, w, stride,
                            cin, cmid, cout, t1, t2, ya, yb, out, (cudaStream_t)stream);
}
