// The bf16 GEMM of every ResNet50 bottleneck stage (1-4) of the folded
// serving towers, on Hopper's tensor cores: fused_stage / fused_layer1 in
// bf16 run stage.cuh's three GEMMs per block on this kernel (f32 stays on
// the FMA kernel of stage.cu).
//
// Replaces: pose6d_tpu/ops/pallas_block.py fused_stage / _stage_kernel and,
// at stage 1, fused_layer1 / _layer1_kernel: per image every bottleneck
// intermediate in TPU VMEM, the 3x3 conv as one im2col matmul, a stride-2
// block 0 as subsampled im2col chunks plus a 1x1 conv over the even rows and
// columns, f32 accumulation and bf16 rounding at conv1, conv2 and each
// block's output.
//
// What bounds it on an H100: at batch 8 a stage is 10.7 / 16.4 / 23.4 /
// 12.9 GFLOP (stages 1-4) against 16 / 22 / 24 / 35 MB of input, output
// and weights, so the card's bound is the tensor cores' 989 TFLOP/s
// (0.011-0.024 ms). In practice its 9-18 dependent GEMMs are small (stage
// 4's have 392 rows): what bounds it is how fast each SM can take in
// operand tiles (a 128 x 64 tile per 64-deep K step needs 24 KB for 0.5
// MMAC), filling 132 SMs, and each launch's fixed cost.
//
// Design: one kernel per GEMM, an implicit GEMM on wgmma.mma_async
// m64nNk16 (bf16 in, f32 accumulators in registers). A block of two
// warpgroups computes a 128 x BN output tile, one m64 half each, over K
// steps of 64 bf16 (one 128-byte run per A row, so 128-byte swizzle). BN
// is 64 or 128, chosen per GEMM by ops/fused_block.stage_plan; either way
// a block needs 96 KB of shared memory and at most 128 registers a thread,
// so two blocks share an SM (a 256-wide tile, 255 registers and one block
// per SM, was slower on every GEMM at batch 8 and 32: PERF.md).
// - A is K-major: the dense [M, K] map for the 1x1 convs; for the 3x3 conv
//   a K step lies inside one tap (ky, kx) because cin is a multiple of 64,
//   so each A row is the 128-byte channel run at input pixel
//   (s*oy+ky-1, s*ox+kx-1), zero outside the map; block 0's strided
//   shortcut reads input pixel (s*oy, s*ox). Each thread works out its rows'
//   addresses and in-map taps once, so a K step costs a pointer add per
//   copy. The weight [K, N] is N-major (pack_stage_weights' layout, pinned
//   against JAX): wgmma reads it through the B-transpose immediate, as
//   64-column blocks of 64 K rows.
// - Copies: every thread issues 16-byte cp.async (zero-fill form: rows
//   outside the map or past M copy 0 bytes, so padding costs no branch) into
//   a ring of 4 stages (3 at BN 128) in dynamic shared memory, filled
//   STAGES-1 tiles ahead of the one wgmma runs on. A "full" mbarrier per
//   stage completes when every thread's copies of it have landed
//   (cp.async.mbarrier.arrive), an "empty" one when both warpgroups' wgmma
//   on it have retired (wgmma.wait_group 1 keeps one K step's wgmma in
//   flight behind the next). A wait that never ends traps.
// - Split-K: a GEMM with fewer tiles than SMs splits its K steps into
//   `splits` contiguous ranges (grid z; the same partition as
//   GemmPlan.split_steps). Each block writes its f32 partial tile to a
//   workspace [splits, M, N]; the last block of a tile (an acquire-release
//   ticket per tile, which it resets) sums the partials in split order and
//   runs the epilogue, so results are deterministic and never depend on
//   which block finished last. No atomics touch output values.
// - Epilogue: the accumulators go through shared memory so that each thread
//   owns 8 consecutive columns: bias, second bias and residual added in f32,
//   ReLU, bf16, 16-byte stores; rows past M store nothing.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "stage.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BK = 64, THREADS = 256;
constexpr int A_BYTES = BM * BK * 2;  // 128 rows of one 128-byte K run

template <int BN>
struct Tile {
  static constexpr int B_BYTES = BK * BN * 2;  // BN/64 blocks of 64 K rows x 128 bytes
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // 96 KB of ring either way (4 stages at BN 64, 3 at 128): two blocks per SM
  static constexpr int STAGES = BN == 128 ? 3 : 4;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int C_STRIDE = BN + 8;  // f32 epilogue row: 8 pad words keep float2 stores conflict-free
  static constexpr int SMEM_BYTES = RING_BYTES + 2 * STAGES * 8 + 1024;  // + barriers + alignment
  static_assert(BM * C_STRIDE * 4 <= RING_BYTES, "the epilogue tile reuses the ring");
};

struct Params {
  const bf16 *a1, *w1, *a2, *w2;
  const float *bias, *bias2;
  const bf16* res;
  bf16* out;
  float* ws;
  int* tickets;
  int M, N, K1, K2, splits;
  int h, w, ho, wo, stride;
};

// ------------------------------------------------------------------ PTX
// (the shared helpers are in hopper.cuh)

using namespace pose6d_ptx;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Arrive on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void mbar_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of `bar` with this parity has completed. A phase that
// never completes is a bug: trap after ~2 s rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (!mbar_try_wait(bar, parity)) {
    const long long t0 = clock64();
    while (!mbar_try_wait(bar, parity))
      if (clock64() - t0 > (1ll << 32)) __trap();
  }
  __syncwarp();
}

// atomicAdd(ticket, 1) with acquire-release ordering at device scope; returns
// the old value.
__device__ __forceinline__ int ticket_acq_rel(int* ticket) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(ticket) : "memory");
  return old;
}

// d[64 x BN] += A[64 x 16] B[16 x BN]: A K-major, B N-major (trans-b 1), bf16
// in, f32 accumulators. A thread's d[4j], d[4j+1] sit at row g of its warp's
// 16, columns 8j + 2t and 8j + 2t + 1; d[4j+2], d[4j+3] at row g + 8
// (g = lane / 4, t = lane % 4).
template <int BN>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db);

template <> __device__ __forceinline__ void wgmma<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma<128>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------- kernel

// One 128 x BN output tile of out = relu(A1 W1 + A2 W2 + bias + bias2 + res)
// over this block's range of K steps (blockIdx.z of p.splits).
template <int BN, bool CONV3X3>
__global__ void __launch_bounds__(THREADS, 2) wgmma_gemm_kernel(const Params p) {
  using T = Tile<BN>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;

  // the ring at a 1024-byte boundary: the 128-byte swizzle repeats every 8 rows
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + T::RING_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int nk1 = p.K1 / BK, nk = nk1 + p.K2 / BK;
  const int t_begin = static_cast<int>(static_cast<long long>(split) * nk / p.splits);
  const int nsteps = static_cast<int>(static_cast<long long>(split + 1) * nk / p.splits) - t_begin;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), THREADS);
      mbar_init(empty(s), THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // This thread copies 16-byte chunk c of A rows r_i = tid/8 + 32i: output
  // pixel m = m0 + r_i, i.e. image img, pixel (oy, ox), whose input pixel
  // (s*oy, s*ox) is the 3x3 window's centre and the strided shortcut's
  // source. Per row: the A1 and A2 row starts (chunk c included) and which
  // of the 9 taps lie inside the map (bit 4 alone, the centre, for a 1x1
  // A1 or A2; none past M), so that a K step costs a pointer add per copy.
  const int c = tid & 7;
  const int C1 = CONV3X3 ? p.K1 / 9 : p.K1;  // A1's channels per pixel
  const bf16* row_a1[4];
  const bf16* row_a2[4];
  uint32_t row_taps[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (tid >> 3) + 32 * i;
    const int img = m / (p.ho * p.wo), pix = m - img * p.ho * p.wo;
    const int oy = pix / p.wo, ox = pix - oy * p.wo;
    const int cy = oy * p.stride, cx = ox * p.stride;
    const size_t centre = static_cast<size_t>((img * p.h + cy) * p.w + cx);
    uint32_t taps = 0;
    if (m < p.M) {
      taps = 1u << 4;
      if (CONV3X3) {
        for (int tap = 0; tap < 9; ++tap) {
          const int y = cy + tap / 3 - 1, x = cx + tap % 3 - 1;
          if (y >= 0 && y < p.h && x >= 0 && x < p.w) taps |= 1u << tap;
        }
      }
    }
    row_taps[i] = taps;
    row_a1[i] = taps ? p.a1 + (CONV3X3 ? centre : static_cast<size_t>(m)) * C1 + c * 8 : p.a1;
    row_a2[i] = taps && p.K2 ? p.a2 + centre * p.K2 + c * 8 : p.a1;
  }
  // The weight chunks this thread copies: K row kr_j = kr_0 + j * (256 / CPR),
  // 16-byte chunk cn of the tile's BN columns.
  constexpr int CPR = BN / 8, B_ROWS = THREADS / CPR;
  const int kr0 = tid / CPR, cn = tid % CPR;
  const uint32_t b_dst0 = (cn >> 3) * (BK * 128) + kr0 * 128 + (((cn & 7) ^ (kr0 & 7)) << 4);
  const size_t b_src0 = static_cast<size_t>(kr0) * p.N + n0 + cn * 8;
  const uint32_t a_dst0 = (tid >> 3) * 128 + ((c ^ ((tid >> 3) & 7)) << 4);

  // Copy K step t (global over A1 then A2) into ring slot `slot`: A as 128
  // rows of 128 bytes, chunk c of row r at (c ^ r%8); W as BN/64 blocks of
  // 64 K rows x 128 bytes, the same swizzle over the K row.
  auto load = [&](int t, int slot) {
    const uint32_t sa = base + slot * T::STAGE_BYTES + a_dst0;
    const uint32_t sb = base + slot * T::STAGE_BYTES + A_BYTES + b_dst0;
    const bool second = t >= nk1;
    const int k0 = (second ? t - nk1 : t) * BK;
    int tap = 4;
    long long a_off = k0;  // elements past the row start
    if (!second && CONV3X3) {  // tap (ky, kx) of this K step, channels ci0..ci0+63
      tap = k0 / C1;
      a_off = static_cast<long long>((tap / 3 - 1) * p.w + tap % 3 - 1) * C1 + (k0 - tap * C1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = (row_taps[i] >> tap) & 1u;
      const bf16* src = second ? row_a2[i] : row_a1[i];
      cp_async16(sa + i * 32 * 128, ok ? src + a_off : p.a1, ok);
    }
    const bf16* wsrc = (second ? p.w2 : p.w1) + static_cast<size_t>(k0) * p.N + b_src0;
#pragma unroll
    for (int j = 0; j < BK / B_ROWS; ++j)
      cp_async16(sb + j * B_ROWS * 128, wsrc + static_cast<size_t>(j) * B_ROWS * p.N, true);
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // slot 0's operands: this warpgroup's 64 A rows, and W
  const uint64_t desc_a = sw128_desc(base + wg * (64 * 128), 16, 1024);
  const uint64_t desc_b = sw128_desc(base + A_BYTES, BK * 128, 1024);

  const int ahead = nsteps < STAGES - 1 ? nsteps : STAGES - 1;
  for (int k = 0; k < ahead; ++k) {
    load(t_begin + k, k);
    mbar_arrive_on_copies(full(k));
  }

  for (int k = 0; k < nsteps; ++k) {
    const int slot = k % STAGES;
    mbar_wait(full(slot), (k / STAGES) & 1);
    const uint32_t at = (slot * T::STAGE_BYTES) >> 4;  // the descriptors' start field counts 16 bytes
    fence_operands<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // A: +32 bytes per k16 in the swizzled row; W: +16 rows
      wgmma<BN>(acc, desc_a + at + kk * 2, desc_b + at + kk * 128);
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's wgmma of step k-1 has retired
    fence_operands<BN / 2>(acc);
    if (k > 0) mbar_arrive(empty((k - 1) % STAGES));
    const int next = k + STAGES - 1;  // refill the slot of step k-1
    if (next < nsteps) {
      const int ns = next % STAGES;
      if (next >= STAGES) mbar_wait(empty(ns), (next / STAGES - 1) & 1);
      load(t_begin + next, ns);
      mbar_arrive_on_copies(full(ns));
    }
  }
  wgmma_wait<0>();
  fence_operands<BN / 2>(acc);
  __syncthreads();  // every wgmma and copy is done: the ring becomes the f32 tile

  constexpr int CS = T::C_STRIDE;
  float* tile_c = reinterpret_cast<float*>(smem);
  {
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int r = wg * 64 + warp * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(&tile_c[r * CS + 8 * j + col]) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(&tile_c[(r + 8) * CS + 8 * j + col]) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();

  // Each thread owns PER_THREAD chunks of 8 columns: chunk q = tid + THREADS*i
  // is row q / CHUNKS, columns 8 (q % CHUNKS)..+8 of the tile.
  constexpr int CHUNKS = BN / 8, PER_THREAD = BM * CHUNKS / THREADS;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  auto tile_row = [&](int i) { return (tid + THREADS * i) / CHUNKS; };
  auto tile_col = [&](int i) { return (tid + THREADS * i) % CHUNKS * 8; };
  float v[PER_THREAD][8];
  if (p.splits > 1) {  // partial tile to the workspace; the tile's last block goes on
    float* part = p.ws + static_cast<size_t>(split) * p.M * p.N;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int r = tile_row(i), cc = tile_col(i);
      if (m0 + r >= p.M) continue;
      float4* dst = reinterpret_cast<float4*>(part + static_cast<size_t>(m0 + r) * p.N + n0 + cc);
      __stcg(dst, *reinterpret_cast<const float4*>(&tile_c[r * CS + cc]));
      __stcg(dst + 1, *reinterpret_cast<const float4*>(&tile_c[r * CS + cc + 4]));
    }
    // One thread takes the tile's ticket for the block: its release publishes
    // the block's partial (ordered before it by the barrier), its acquire
    // makes the other splits' partials visible before the barrier after it.
    __syncthreads();
    if (tid == 0) s_last = ticket_acq_rel(p.tickets + tile) == p.splits - 1;
    __syncthreads();
    if (!s_last) return;
    if (tid == 0) p.tickets[tile] = 0;  // ready for the next launch
    // The partials in split order, the same sum whichever block is last
    // (this block's own is still in shared memory); each split's loads for
    // all of a thread's chunks are in flight together.
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] = 0.f;
    for (int s = 0; s < p.splits; ++s) {
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        const int r = tile_row(i), cc = tile_col(i);
        float4 lo, hi;
        if (s == split || m0 + r >= p.M) {
          lo = *reinterpret_cast<const float4*>(&tile_c[r * CS + cc]);
          hi = *reinterpret_cast<const float4*>(&tile_c[r * CS + cc + 4]);
        } else {
          const float4* src = reinterpret_cast<const float4*>(
              p.ws + (static_cast<size_t>(s) * p.M + m0 + r) * p.N + n0 + cc);
          lo = __ldcg(src);
          hi = __ldcg(src + 1);
        }
        v[i][0] += lo.x; v[i][1] += lo.y; v[i][2] += lo.z; v[i][3] += lo.w;
        v[i][4] += hi.x; v[i][5] += hi.y; v[i][6] += hi.z; v[i][7] += hi.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] = tile_c[tile_row(i) * CS + tile_col(i) + e];
  }

#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int m = m0 + tile_row(i), n = n0 + tile_col(i);
    if (m >= p.M) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[i][e] += p.bias[n + e];
    if (p.bias2 != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] += p.bias2[n + e];
    }
    const size_t at = static_cast<size_t>(m) * p.N + n;
    if (p.res != nullptr) {
      const uint4 raw_res = *reinterpret_cast<const uint4*>(p.res + at);
      const __nv_bfloat162* rv = reinterpret_cast<const __nv_bfloat162*>(&raw_res);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(rv[e]);
        v[i][2 * e] += f.x;
        v[i][2 * e + 1] += f.y;
      }
    }
    uint4 packed;
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ov[e] = __floats2bfloat162_rn(fmaxf(v[i][2 * e], 0.f), fmaxf(v[i][2 * e + 1], 0.f));
    *reinterpret_cast<uint4*>(p.out + at) = packed;
  }
}

template <int BN, bool CONV3X3>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = Tile<BN>::SMEM_BYTES;
  const auto kernel = wgmma_gemm_kernel<BN, CONV3X3>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.N / BN, (p.M + BM - 1) / BM, p.splits);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool CONV3X3>
cudaError_t launch_bn(const Params& p, int bn, cudaStream_t stream) {
  switch (bn) {
    case 64: return launch<64, CONV3X3>(p, stream);
    case 128: return launch<128, CONV3X3>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace pose6d_stage {

cudaError_t gemm_bf16(const Gemm& g, int bn, int splits, float* ws, int* tickets,
                      cudaStream_t stream) {
  const int nk = (g.K1 + g.K2) / BK;
  if (bn <= 0 || g.N % bn || g.K1 % BK || g.K2 % BK || g.M < 1 || splits < 1 || splits > nk ||
      (g.conv3x3 && ((g.K1 / 9) % BK || g.K1 % 9 || g.K2)) ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const Params p = {static_cast<const bf16*>(g.a1), static_cast<const bf16*>(g.w1),
                    static_cast<const bf16*>(g.a2), static_cast<const bf16*>(g.w2),
                    g.bias, g.bias2, static_cast<const bf16*>(g.res), static_cast<bf16*>(g.out),
                    ws, tickets, g.M, g.N, g.K1, g.K2, splits,
                    g.g.h, g.g.w, g.g.ho, g.g.wo, g.g.stride};
  return g.conv3x3 ? launch_bn<true>(p, bn, stream) : launch_bn<false>(p, bn, stream);
}

}  // namespace pose6d_stage

// One GEMM of the bf16 kernel, for the tests: out [M, N] bf16, w1 [K1, N],
// w2 [K2, N] (K2 = 0: none), bias [N] f32, bias2 and res optional (0). With
// conv3x3, a1 is a [B, h, w, K1/9] map and the output rows are B*ho*wo
// pixels at `stride`; a2 (the shortcut) reads input pixel (s*oy, s*ox).
extern "C" int pose6d_gemm_bf16(const void* a1, const void* w1, const void* a2,
                                const void* w2, const void* bias, const void* bias2,
                                const void* res, void* out, void* ws, void* tickets,
                                int M, int N, int K1, int K2, int h, int w, int ho,
                                int wo, int stride, int conv3x3, int bn, int splits,
                                void* stream) {
  const pose6d_stage::Gemm g = {a1, w1, a2, w2, static_cast<const float*>(bias),
                                static_cast<const float*>(bias2), res, out, M, N, K1, K2,
                                {h, w, ho, wo, stride}, conv3x3 != 0};
  return pose6d_stage::gemm_bf16(g, bn, splits, static_cast<float*>(ws),
                                 static_cast<int*>(tickets), static_cast<cudaStream_t>(stream));
}
