// ResNet50 stem for the folded serving towers in f32: BN-folded conv1
// 7x7/s2/pad3 + bias + ReLU + maxpool 3x3/s2/pad1, one kernel,
// [B,224,224,C] NHWC -> [B,56,56,64] NHWC, C = 3 (rgb tower) or 1 (rgbd
// depth tower). The bf16 stem, the served one, runs on the tensor cores
// (stem_tc.cu).
//
// Replaces: pose6d_tpu/ops/pallas_block.py fused_stem / _stem_kernel (the
// TPU kernel ran conv1 as a 4x4/s1 conv on a space-to-depth input so that it
// fed the matrix unit; that layout trick buys nothing here, so this kernel
// reads the plain NHWC image).
//
// What bounds it on an H100: the unfused path writes the [112,112,64] conv1
// map to device memory only for the maxpool to read it back (1.6 MB per
// image in bf16). The fused work is 0.24 GFLOP per image (C=3) against
// 0.7 MB of unavoidable traffic, so with tensor cores it would be
// compute-light and bandwidth-bound; in f32 the MACs run on the CUDA cores,
// which makes this kernel FMA-bound.
//
// Design: one block per 8x8 tile of pooled outputs, all 64 channels. It
// stages the 39x39xC input patch under the tile's 17x17 conv outputs and
// the whole folded 7x7xCx64 weight in shared memory (as f32), computes the
// 17x17x64 conv outputs into shared memory (each thread one channel and a
// row of 17 outputs in registers, so every weight load feeds 17 FMAs and the
// input reads are warp broadcasts), then max-pools them. The conv1 map never
// reaches device memory. Conv outputs outside the 112x112 map are the pool's
// padding: 0 is exact, because every pool window also holds an output inside
// the map and outputs are >= 0 after ReLU. Accumulation is f32.

#include <cuda_runtime.h>

namespace {

constexpr int IN_HW = 224;          // input side
constexpr int CONV_HW = 112;        // conv1 output side
constexpr int OUT_HW = 56;          // pooled output side
constexpr int CO = 64;              // conv1 output channels
constexpr int TILE = 8;             // pooled outputs per block side
constexpr int CT = 2 * TILE + 1;    // conv outputs under the tile: 17
constexpr int PT = 2 * CT + 5;      // input pixels those read: 39
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / CO;

template <int C>
constexpr size_t stem_smem_bytes() {
  return sizeof(float) * (PT * PT * C + 49 * C * CO + CT * CT * CO);
}

template <int C>
__global__ void __launch_bounds__(THREADS)
stem_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_in = smem;                  // [PT][PT][C]
  float* s_w = s_in + PT * PT * C;     // [7][7][C][CO]
  float* s_conv = s_w + 49 * C * CO;   // [CT][CT][CO]

  const int b = blockIdx.z;
  const int py0 = blockIdx.y * TILE, px0 = blockIdx.x * TILE;  // pooled origin
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;  // conv origin under it
  const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;  // input origin they read
  const int tid = threadIdx.x;

  const float* xb = x + (size_t)b * IN_HW * IN_HW * C;
  for (int i = tid; i < PT * PT * C; i += THREADS) {
    const int c = i % C, p = i / C;
    const int iy = iy0 + p / PT, ix = ix0 + p % PT;
    float v = 0.f;  // conv1's zero padding
    if (iy >= 0 && iy < IN_HW && ix >= 0 && ix < IN_HW)
      v = xb[((size_t)iy * IN_HW + ix) * C + c];
    s_in[i] = v;
  }
  for (int i = tid; i < 49 * C * CO; i += THREADS) s_w[i] = w[i];
  __syncthreads();

  const int co = tid % CO;
  const float bco = bias[co];
  for (int r = tid / CO; r < CT; r += ROW_GROUPS) {
    float acc[CT];
#pragma unroll
    for (int k = 0; k < CT; ++k) acc[k] = 0.f;
    for (int ky = 0; ky < 7; ++ky) {
      const float* in_row = s_in + (2 * r + ky) * PT * C;
#pragma unroll
      for (int kx = 0; kx < 7; ++kx) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float wv = s_w[((ky * 7 + kx) * C + c) * CO + co];
#pragma unroll
          for (int k = 0; k < CT; ++k) acc[k] += in_row[(2 * k + kx) * C + c] * wv;
        }
      }
    }
    const int cy = cy0 + r;
#pragma unroll
    for (int k = 0; k < CT; ++k) {
      const int cx = cx0 + k;
      const bool inside = cy >= 0 && cy < CONV_HW && cx >= 0 && cx < CONV_HW;
      s_conv[(r * CT + k) * CO + co] = inside ? fmaxf(acc[k] + bco, 0.f) : 0.f;
    }
  }
  __syncthreads();

  float* ob = out + (size_t)b * OUT_HW * OUT_HW * CO;
  for (int i = tid; i < TILE * TILE * CO; i += THREADS) {
    const int c = i % CO, p = i / CO;
    const int ty = p / TILE, tx = p % TILE;
    float m = 0.f;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx)
        m = fmaxf(m, s_conv[((2 * ty + dy) * CT + 2 * tx + dx) * CO + c]);
    ob[((size_t)(py0 + ty) * OUT_HW + px0 + tx) * CO + c] = m;
  }
}

template <int C>
cudaError_t launch_stem(const void* x, const void* w, const void* b, void* out,
                        int B, cudaStream_t stream) {
  const size_t smem = stem_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(OUT_HW / TILE, OUT_HW / TILE, B);
  stem_kernel<C><<<grid, THREADS, smem, stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)out);
  return cudaGetLastError();
}

}  // namespace

// x [B,224,224,C] f32, w [7,7,C,64] f32 (HWIO), b [64] f32, out [B,56,56,64] f32.
extern "C" int pose6d_stem_f32(const void* x, const void* w, const void* b,
                               void* out, int B, int C, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 3) return launch_stem<3>(x, w, b, out, B, s);
  if (C == 1) return launch_stem<1>(x, w, b, out, B, s);
  return (int)cudaErrorInvalidValue;
}
