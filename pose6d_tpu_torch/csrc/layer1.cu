// ResNet50 layer1 for the folded serving towers: three BN-folded bottleneck
// blocks 64 -> 256 on the 56x56 map, projection shortcut in block 0,
// [B,56,56,64] NHWC -> [B,56,56,256] NHWC.
//
// Replaces: pose6d_tpu/ops/pallas_block.py fused_layer1 / _layer1_kernel,
// which kept one image's intermediates in TPU VMEM and built each 3x3 conv
// as an im2col of nine row-rolls.
//
// What bounds it on an H100: 1.34 GFLOP per image against 2.0 MB of input
// and output; with tensor cores (989 TFLOP/s bf16) that is bandwidth-bound
// at the block boundaries the TPU kernel kept on chip. This first version
// is one tiled shared-memory GEMM kernel run nine times (three per block)
// with f32 FMAs on the CUDA cores, so it is FMA-bound; the persistent
// one-image-per-block design with wgmma is later work.
//
// Design: every conv of the stage is a GEMM over the M = B*56*56 pixel rows
// of the NHWC map. The 1x1 convs read the activation as a dense [M, Cin]
// matrix. The 3x3 conv is an implicit GEMM: its A tile is gathered on the
// fly from the (ky, kx, cin) column order of the packed [576, 64] weight,
// with zeros outside the map (the conv's 'same' padding), so no im2col
// buffer is written. Block 0's conv3 and its projection shortcut are one
// GEMM over two (A, W) pairs summed in the same f32 accumulator. The
// epilogue adds the biases and, for blocks 1 and 2, the identity shortcut
// read from the block input, applies ReLU and rounds to the storage type;
// so activations round to the compute type exactly at the points where the
// TPU kernel rounded them, with f32 accumulation everywhere.
//
// Tiles: 64x64 outputs per block of 256 threads, 4x4 per thread strided by
// 16 so that shared-memory reads are conflict-free or broadcast; K steps of
// 16. M is a multiple of 64 (56*56 = 49*64), N of 64 and every K of 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
constexpr int HW = 56;  // layer1 map side (3x3 implicit GEMM geometry)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// out[m, n] = relu(sum_k A1[m, k] W1[k, n] + sum_k A2[m, k] W2[k, n]
//                 + bias[n] + bias2[n] + res[m, n])
// A2/W2, bias2 and res are optional (nullptr). With IM2COL, A1 is the
// [B, 56, 56, K1/9] map read as its 3x3 patch matrix.
template <typename T, bool IM2COL>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ a1, const T* __restrict__ w1,
            const T* __restrict__ a2, const T* __restrict__ w2,
            const float* __restrict__ bias, const float* __restrict__ bias2,
            const T* __restrict__ res, T* __restrict__ out,
            int N, int K1, int K2) {
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
  const int pix = m % (HW * HW), img = m / (HW * HW);
  const int py = pix / HW, px = pix % HW;

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
        const int yy = py + tap / 3 - 1, xx = px + tap % 3 - 1;
        const bool inside = yy >= 0 && yy < HW && xx >= 0 && xx < HW;
        const T* src = a + (((size_t)img * HW + yy) * HW + xx) * cin + ci;
#pragma unroll
        for (int q = 0; q < 4; ++q) As[lk + q][lr] = inside ? to_f(src[q]) : 0.f;
      } else {
        const T* src = a + (size_t)m * K + k;
#pragma unroll
        for (int q = 0; q < 4; ++q) As[lk + q][lr] = to_f(src[q]);
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
    const size_t row = (size_t)(m0 + ty + 16 * i);
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
                 int M, int N, int K1, int K2, cudaStream_t stream) {
  const dim3 grid(N / BN, M / BM);
  gemm_kernel<T, IM2COL><<<grid, THREADS, 0, stream>>>(
      (const T*)a1, (const T*)w1, (const T*)a2, (const T*)w2,
      (const float*)bias, (const float*)bias2, (const T*)res, (T*)out,
      N, K1, K2);
  return cudaGetLastError();
}

// weights: the 20 device pointers of pack_layer1_weights, in its order
//   block 0: w1 b1 w2 b2 w3 b3 wd bd; blocks 1, 2: w1 b1 w2 b2 w3 b3
// t1, t2 [M, 64] and ya, yb [M, 256] are caller-allocated scratch.
template <typename T>
cudaError_t launch_layer1(const void* x, const void* const* wt, void* t1,
                          void* t2, void* ya, void* yb, void* out, int B,
                          cudaStream_t s) {
  const int M = B * HW * HW;
  const void* block_in[3] = {x, ya, yb};
  void* block_out[3] = {ya, yb, out};
  int at = 0;
  for (int j = 0; j < 3; ++j) {
    const void *w1 = wt[at], *b1 = wt[at + 1], *w2 = wt[at + 2], *b2 = wt[at + 3];
    const void *w3 = wt[at + 4], *b3 = wt[at + 5];
    at += 6;
    const int cin = j == 0 ? 64 : 256;
    cudaError_t err;
    err = gemm<T, false>(block_in[j], w1, nullptr, nullptr, b1, nullptr, nullptr,
                         t1, M, 64, cin, 0, s);
    if (err != cudaSuccess) return err;
    err = gemm<T, true>(t1, w2, nullptr, nullptr, b2, nullptr, nullptr, t2, M,
                        64, 9 * 64, 0, s);
    if (err != cudaSuccess) return err;
    if (j == 0) {  // conv3 + projection shortcut in one accumulator
      const void *wd = wt[at], *bd = wt[at + 1];
      at += 2;
      err = gemm<T, false>(t2, w3, x, wd, b3, bd, nullptr, block_out[j], M, 256,
                           64, 64, s);
    } else {  // conv3 + identity shortcut
      err = gemm<T, false>(t2, w3, nullptr, nullptr, b3, nullptr, block_in[j],
                           block_out[j], M, 256, 64, 0, s);
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int pose6d_layer1_forward(const void* x, const void* const* weights,
                                     void* t1, void* t2, void* ya, void* yb,
                                     void* out, int B, int is_bf16,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_layer1<__nv_bfloat16>(x, weights, t1, t2, ya, yb, out, B, s)
                 : launch_layer1<float>(x, weights, t1, t2, ya, yb, out, B, s);
}
