// ResNet50 stem for the folded serving towers in bf16, on Hopper's tensor
// cores: BN-folded conv1 7x7/s2/pad3 + bias + ReLU + maxpool 3x3/s2/pad1 as
// one kernel, [B,224,224,C] NHWC bf16 -> [B,56,56,64] NHWC bf16, C = 3 (rgb
// tower) or 1 (rgbd depth tower). The f32 stem stays on stem.cu's FMA kernel.
//
// Replaces: pose6d_tpu/ops/pallas_block.py fused_stem / _stem_kernel, which
// fed the TPU's matrix unit conv1 as a 4x4/s1 conv over a 2x2 space-to-depth
// input: 16 taps x 4C channels, one [12544, 16*4C] @ [16*4C, 64] matmul per
// image, then the maxpool as shifted maxes.
//
// What bounds it on an H100: at batch 8 the operations at C=3 (0.00191 ms at
// 989 TFLOP/s bf16) and the bytes at C=1 (0.00120 ms at 3.35 TB/s: the image
// read once and the pooled map written once). The FMA kernel this replaces
// ran 49x / 29x above those: f32 FMAs on the CUDA cores, each reading shared
// memory, and 127 KB of shared memory per block (an f32 patch, weight and
// conv tile), so one block per SM and three waves of 392 blocks at batch 8.
//
// Design: the TPU kernel's GEMM, per block. One warpgroup computes an 8x8
// tile of pooled outputs, all 64 channels, as an implicit GEMM over the
// 17x17 conv outputs under it: M = 289 rows (5 wgmma m64 tiles, 31 rows of
// padding), N = 64, K = 16 taps x 4C space-to-depth channels (192 at C=3, 64
// at C=1, both whole k16 steps; the zero taps cost ~30 % more MACs than
// K = 49C, and MACs are not what bounds it).
// - Input: the block reads the plain NHWC image (the 40x40 input pixels
//   under the tile, as 32-bit words) and writes it into shared memory in
//   space-to-depth order, [20][20][4C] s2d pixels with channels (py, px, c),
//   zero where conv1 pads: no space-to-depth pass goes through device memory.
// - Weights: the [K, 64] bf16 matrix of ops/fused_block.stem_s2d_weights
//   (the JAX package's w2cat row order: tap (u, v), then (py, px, c)),
//   copied with cp.async into shared memory with the 128-byte swizzle and
//   read by wgmma as an N-major B (trans-b), as in stage_wgmma.cu.
// - MMA: wgmma.mma_async m64n64k16 with A from registers. A[m, k] is s2d
//   pixel (r + u + 2, q + v + 2), channel k % 4C, for the conv output
//   m = (r, q) and the tap (u, v) = k / 4C; 4C is even, so each register's
//   bf16 pair is one 32-bit shared load. f32 accumulators.
// - Epilogue: bias and ReLU in f32, conv outputs outside the 112x112 map set
//   to 0 (the pool's padding: every window also holds an output inside the
//   map, and outputs are >= 0), rounded to bf16 into a 17x17x64 bf16 tile in
//   shared memory (exact: max commutes with the monotone rounding, so
//   rounding before the pool equals rounding after it), then the 3x3/s2
//   max-pool with 16-byte shared loads and 16-byte global stores. The conv1
//   map never reaches device memory.
// - Occupancy: 70.5 KB of shared memory at C=3 (48.3 KB at C=1) and 128
//   threads, so 3 (4) blocks share an SM: 396 slots for the 392 blocks at
//   batch 8, one wave where the FMA kernel ran three. 8x8 is the pooled tile
//   that divides 56 and fits one wave at batch 8: a 7x8 tile (255 conv
//   outputs, one m64 tile less of padding) makes 448 blocks for 396 slots,
//   and an 8x16 tile does not divide 56.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace pose6d_ptx;
using bf16 = __nv_bfloat16;

constexpr int IN_HW = 224;              // input side
constexpr int CONV_HW = 112;            // conv1 output side
constexpr int OUT_HW = 56;              // pooled output side
constexpr int CO = 64;                  // conv1 output channels
constexpr int TILE = 8;                 // pooled outputs per block side
constexpr int CT = 2 * TILE + 1;        // conv outputs under the tile: 17
constexpr int M = CT * CT;              // GEMM rows: 289
constexpr int M_TILES = (M + 63) / 64;  // wgmma m64 tiles: 5
constexpr int SP = CT + 3;              // s2d pixels under them (taps -2..1): 20
constexpr int THREADS = 128;            // one warpgroup
constexpr int ROW_BYTES = CO * 2;       // a weight row and a conv-tile row: 128 bytes

template <int C>
struct Geo {
  static constexpr int CH = 4 * C;                  // s2d channels (py, px, c)
  static constexpr int K = 16 * CH;                 // 192 or 64
  static constexpr int K_STEPS = K / 16;
  static constexpr int W_BYTES = K * ROW_BYTES;
  static constexpr int CONV_BYTES = M * ROW_BYTES;
  static constexpr int PATCH_BYTES = SP * SP * CH * 2;
  static constexpr int ROW_WORDS = 2 * SP * C / 2;  // 32-bit words of one input row's 40 pixels
  static constexpr int WORDS = 2 * SP * ROW_WORDS;  // of the 40 input rows
  static constexpr int WORDS_PER_THREAD = (WORDS + THREADS - 1) / THREADS;
  // [weights, 1024-byte aligned for the swizzle][conv tile][patch]
  static constexpr int SMEM_BYTES = 1024 + W_BYTES + CONV_BYTES + PATCH_BYTES;
  static_assert(K % 16 == 0 && W_BYTES % 1024 == 0, "whole k16 steps, aligned tile");
};

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (a[0..3], the
// mma.m16n8k16 A fragment of this warp's 16 rows: rows g and g + 8, columns
// 2t, 2t + 1 and 2t + 8, 2t + 9, g = lane / 4, t = lane % 4), B N-major in
// shared memory (trans-b 1); bf16 in, f32 accumulators: d[4j], d[4j+1] at
// row g, columns 8j + 2t and 8j + 2t + 1; d[4j+2], d[4j+3] at row g + 8.
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Make this thread's cp.async writes to shared memory visible to wgmma,
// which reads its operands through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int C>
__global__ void __launch_bounds__(THREADS)
stem_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wk,
               const float* __restrict__ bias, bf16* __restrict__ out) {
  using G = Geo<C>;
  extern __shared__ uint8_t smem_raw[];
  // the weight tile at a 1024-byte boundary: the 128-byte swizzle repeats every 8 rows
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_w = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (s_w - raw);
  uint32_t* const conv = reinterpret_cast<uint32_t*>(smem + G::W_BYTES);   // [M][128 B], swizzled
  bf16* const patch = reinterpret_cast<bf16*>(smem + G::W_BYTES + G::CONV_BYTES);  // [SP][SP][CH]

  const int tid = threadIdx.x, b = blockIdx.z;
  const int py0 = blockIdx.y * TILE, px0 = blockIdx.x * TILE;  // pooled origin
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;              // conv origin under it
  const int iy0 = 2 * cy0 - 4, ix0 = 2 * cx0 - 4;              // input pixel of s2d pixel (0, 0)

  // Weights: 16-byte chunk c of K row r at (c ^ r % 8), as the swizzle reads it.
  for (int i = tid; i < G::K * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    cp_async16(s_w + r * ROW_BYTES + ((c ^ (r & 7)) << 4), wk + r * CO + c * 8);
  }

  // The patch: the 40 input rows of 40 pixels x C as 32-bit words, all loads
  // in flight together (ix0 is even, so no word straddles the image's edge),
  // then each element to its s2d place.
  const uint32_t* xb = reinterpret_cast<const uint32_t*>(x + static_cast<size_t>(b) * IN_HW * IN_HW * C);
  uint32_t words[G::WORDS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < G::WORDS_PER_THREAD; ++j) {
    const int i = tid + j * THREADS;
    const int ly = i / G::ROW_WORDS, w = i - ly * G::ROW_WORDS;
    const int iy = iy0 + ly, ix = ix0 + 2 * w / C;
    const bool inside = i < G::WORDS && iy >= 0 && iy < IN_HW && ix >= 0 && ix < IN_HW;
    words[j] = inside ? __ldg(xb + (iy * IN_HW + ix0) * C / 2 + w) : 0u;
  }
#pragma unroll
  for (int j = 0; j < G::WORDS_PER_THREAD; ++j) {
    const int i = tid + j * THREADS;
    if (i < G::WORDS) {
      const int ly = i / G::ROW_WORDS, w = i - ly * G::ROW_WORDS;
      const int sy = ly >> 1, py = ly & 1;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int el = 2 * w + e, lx = el / C, c = el - lx * C;
        patch[(sy * SP + (lx >> 1)) * G::CH + py * 2 * C + (lx & 1) * C + c] =
            __ushort_as_bfloat16(static_cast<unsigned short>(words[j] >> (16 * e)));
      }
    }
  }
  cp_async_wait_all();
  fence_proxy_async();  // the weights, written by cp.async, are read by wgmma
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  // The s2d offset (elements) of this thread's K columns k = 8i + 2t (i = 2
  // step + half): tap (u + 2) * 4 + (v + 2) = k / CH, channel k % CH.
  int koff[2 * G::K_STEPS];
#pragma unroll
  for (int i = 0; i < 2 * G::K_STEPS; ++i) {
    const int k = 8 * i + 2 * t, tap = k / G::CH;
    koff[i] = ((tap >> 2) * SP + (tap & 3)) * G::CH + k - tap * G::CH;
  }
  float bias_v[16];  // columns 8j + 2t, 8j + 2t + 1
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bias_v[2 * j] = bias[8 * j + 2 * t];
    bias_v[2 * j + 1] = bias[8 * j + 2 * t + 1];
  }
  const uint32_t* patch32 = reinterpret_cast<const uint32_t*>(patch);
  const uint64_t desc_w = sw128_desc(s_w, G::W_BYTES, 1024);

  for (int mt = 0; mt < M_TILES; ++mt) {
    // this thread's two GEMM rows and the s2d offsets of their conv outputs
    // (r, q); rows past M read row 0 and are never stored
    int m[2], pix[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = mt * 64 + warp * 16 + g + 8 * h;
      pix[h] = m[h] < M ? ((m[h] / CT) * SP + m[h] % CT) * G::CH : 0;
    }
    uint32_t a[G::K_STEPS][4];
#pragma unroll
    for (int s = 0; s < G::K_STEPS; ++s) {
      a[s][0] = patch32[(pix[0] + koff[2 * s]) >> 1];
      a[s][1] = patch32[(pix[1] + koff[2 * s]) >> 1];
      a[s][2] = patch32[(pix[0] + koff[2 * s + 1]) >> 1];
      a[s][3] = patch32[(pix[1] + koff[2 * s + 1]) >> 1];
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    fence_operands<32>(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < G::K_STEPS; ++s)  // W: +16 K rows (2 KB) per step
      wgmma_rs(acc, a[s], desc_w + s * (16 * ROW_BYTES >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands<32>(acc);

    // bias + ReLU, bf16 into the conv tile: chunk j of row m at (j ^ m % 8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (m[h] >= M) continue;
      const int cy = cy0 + m[h] / CT, cx = cx0 + m[h] % CT;
      const bool inside = cy >= 0 && cy < CONV_HW && cx >= 0 && cx < CONV_HW;
      uint32_t* row = conv + m[h] * (ROW_BYTES / 4);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        row[((j ^ (m[h] & 7)) << 2) + t] =
            inside ? relu_bf16x2(acc[4 * j + 2 * h] + bias_v[2 * j],
                                 acc[4 * j + 2 * h + 1] + bias_v[2 * j + 1])
                   : 0u;
    }
  }
  __syncthreads();

  // max-pool 3x3/s2: each item is 8 channels of one pooled output
  const uint4* conv16 = reinterpret_cast<const uint4*>(conv);
  bf16* ob = out + static_cast<size_t>(b) * OUT_HW * OUT_HW * CO;
  for (int i = tid; i < TILE * TILE * 8; i += THREADS) {
    const int c = i & 7, p = i >> 3, ty = p >> 3, tx = p & 7;
    uint4 pooled;
    __nv_bfloat162* mx = reinterpret_cast<__nv_bfloat162*>(&pooled);
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e] = __float2bfloat162_rn(0.f);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int r = (2 * ty + dy) * CT + 2 * tx + dx;
        const uint4 v = conv16[r * 8 + (c ^ (r & 7))];
        const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e] = __hmax2(mx[e], pv[e]);
      }
    *reinterpret_cast<uint4*>(ob + ((py0 + ty) * OUT_HW + px0 + tx) * CO + c * 8) = pooled;
  }
}

template <int C>
cudaError_t launch_stem(const void* x, const void* wk, const void* b, void* out, int B,
                        cudaStream_t stream) {
  constexpr int smem = Geo<C>::SMEM_BYTES;
  const auto kernel = stem_tc_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // all the SM's shared memory, so that 3 (C=3) or 4 blocks fit
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(OUT_HW / TILE, OUT_HW / TILE, B);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(wk),
                                          static_cast<const float*>(b), static_cast<bf16*>(out));
  return cudaGetLastError();
}

}  // namespace

// x [B,224,224,C] bf16, wk [64C, 64] bf16 (stem_s2d_weights), b [64] f32,
// out [B,56,56,64] bf16; C 3 or 1, B <= 65535 (grid z).
extern "C" int pose6d_stem_bf16(const void* x, const void* wk, const void* b, void* out,
                                int B, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 3) return launch_stem<3>(x, wk, b, out, B, s);
  if (C == 1) return launch_stem<1>(x, wk, b, out, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
