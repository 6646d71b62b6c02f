// ADD-S nearest-point distance: for each of P predicted model points, the
// Euclidean distance to the nearest of the P ground-truth points, per
// sample. pred, gt [B, P, 3] f32 (centred by the caller) -> out [B, P] f32,
// and, where the caller passes an `idx` buffer, the index of that nearest
// GT point [B, P] int32 (the merged argmin below; the differentiable ADD-S
// loss's backward reads it, losses/add.py). The distances are the same bits
// with or without it.
//
// Replaces: pose6d_tpu/ops/pallas_addmin.py pairwise_min_dist_pallas /
// _addmin_kernel, which formed the [P, P] matrix on the TPU's matrix unit
// as |a|^2 + |b|^2 - 2 a.b (clamped at 0) with P padded to a multiple of
// 128 by 1e9 sentinel rows.
//
// What bounds it on an H100: 9 f32 operations per point pair, 2.25 MFLOP
// per sample at P = 500 (0.27 us of the card's f32 peak at B = 8, 1.1 us
// at B = 32), against 14 KB of input and output per sample. Neither sets
// its time at these shapes; the launch does, with the block's dependent
// steps. An empty launch reads 0.0048 ms between the event pair that times
// it, 0.0017 ms a launch back to back; this kernel reads 0.0076-0.0078 ms
// at B = 8 and 0.0098-0.0101 ms at B = 32 (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py and ops/addmin_sweep.py): ~0.003 ms above the floor at
// B = 8, for the global loads, the GT staging and its barriers, the scan,
// the merge and the f64 recompute, one after another in each block. The
// first design, one thread per predicted point walking all P GT points,
// read 0.0113 ms at B = 8: 32 blocks of 4 warps (a quarter of the SMs, one
// warp per scheduler), each thread a serial min/argmin chain of P steps.
//
// Design: spread each sample's pairs over the card. A block takes
// (sample, tile of `tile` predicted points); its threads are `splits` GT
// splits x (tile / R) threads, and each thread keeps R predicted points in
// registers, so one shared-memory GT load serves R pairs and R min chains
// interleave. Split s scans GT points s, s + splits, s + 2 splits, ...
// in increasing order with a strict `<`, keeping (smallest f32 d^2, first
// index at it), as the single pass did. The sample's GT cloud is staged in
// shared memory as float4 (CHUNK points a pass, all splits reading one
// chunk). The splits then merge through shared memory by (d^2, index)
// lexicographically, in split order (a tree merge, with the recompute in
// split 0's threads, read 12-19 % slower: more registers, fewer blocks an
// SM): the argmin is the single-pass first-index argmin
// whatever the plan, and the output is bit-for-bit independent of it
// (ops/addmin.py addmin_plan picks the plan; a test may force another).
// Every split computes the same f32 d^2 for a pair: the expression is
// written once with explicit round-to-nearest intrinsics, so no compiler
// contraction can differ between instantiations. The argmin's distance is
// recomputed in f64 and rounded once to f32: within about half an f32 ulp
// of the exact distance (an f32 sum of squares and sqrtf can be 2 ulp off,
// 1.2e-7 m at 1 m). Padded clouds repeat real points, so exact d^2 ties do
// occur: the first index keeps that recompute deterministic. The
// difference form (a - b)^2 needs no padding and no sentinels (bounds are
// checked, the ragged last tile is masked) and does not cancel near zero
// as the expansion does. No workspace, no atomics.
//
// Why not the tensor cores: the contraction depth is 3 (an MMA of depth
// 8-16 would be mostly zeros) and the whole job is ~1 us of f32 FMA at
// peak; the expansion in TF32 or bf16 would pick wrong argmins on
// near-ties, against the port's 1e-7 m contract with f64 cdist.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 512;         // GT points staged per pass (8 KB as float4)
constexpr int MAX_THREADS = 1024;  // splits * tile / R

// The f32 squared distance of one pair, the same bits in every split.
__device__ __forceinline__ float pair_d2(float px, float py, float pz, float4 q) {
  const float dx = __fsub_rn(px, q.x);
  const float dy = __fsub_rn(py, q.y);
  const float dz = __fsub_rn(pz, q.z);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// (b2, a2) before (b, a) in (d^2, index) order
__device__ __forceinline__ bool before(float b2, int a2, float b, int a) {
  return b2 < b || (b2 == b && a2 < a);
}

template <int R>
__global__ void addmin_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
                              float* __restrict__ out, int* __restrict__ idx, int P, int tile,
                              int splits) {
  extern __shared__ float4 smem[];
  const int stage_n = min(P, CHUNK);
  float4* s_gt = smem;                                        // [stage_n]
  float* s_best = reinterpret_cast<float*>(smem + stage_n);   // [splits][tile]
  int* s_arg = reinterpret_cast<int*>(s_best + splits * tile);

  const int tiles = (P + tile - 1) / tile;
  const int b = blockIdx.x / tiles;
  const int i0 = (blockIdx.x - b * tiles) * tile;
  const int G = tile / R;  // threads of one split
  const int g = threadIdx.x % G;
  const int s = threadIdx.x / G;
  const float* pb = pred + (size_t)b * P * 3;
  const float* gb = gt + (size_t)b * P * 3;

  float px[R], py[R], pz[R], best[R];
  int arg[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + g + r * G;
    px[r] = py[r] = pz[r] = 0.f;
    if (i < P) {
      px[r] = pb[3 * i];
      py[r] = pb[3 * i + 1];
      pz[r] = pb[3 * i + 2];
    }
    best[r] = 3.402823466e38f;
    arg[r] = 0;  // what the single pass leaves when no d^2 is below FLT_MAX
  }
  for (int c0 = 0; c0 < P; c0 += CHUNK) {
    const int n = min(CHUNK, P - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float* q = gb + 3 * (size_t)(c0 + j);
      s_gt[j] = make_float4(q[0], q[1], q[2], 0.f);
    }
    __syncthreads();
    // this split's first point of the chunk: the least j >= c0, j = s (mod splits)
    for (int j = (s - c0 % splits + splits) % splits; j < n; j += splits) {
      const float4 q = s_gt[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d2 = pair_d2(px[r], py[r], pz[r], q);
        arg[r] = d2 < best[r] ? c0 + j : arg[r];
        best[r] = fminf(best[r], d2);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s_best[s * tile + g + r * G] = best[r];
    s_arg[s * tile + g + r * G] = arg[r];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const int i = i0 + t;
    if (i >= P) break;
    float bb = s_best[t];
    int aa = s_arg[t];
    for (int k = 1; k < splits; ++k) {
      const float b2 = s_best[k * tile + t];
      const int a2 = s_arg[k * tile + t];
      if (before(b2, a2, bb, aa)) {
        bb = b2;
        aa = a2;
      }
    }
    const double dx = (double)pb[3 * i] - gb[3 * aa];
    const double dy = (double)pb[3 * i + 1] - gb[3 * aa + 1];
    const double dz = (double)pb[3 * i + 2] - gb[3 * aa + 2];
    out[(size_t)b * P + i] = (float)sqrt(__fma_rn(dz, dz, __fma_rn(dy, dy, __dmul_rn(dx, dx))));
    if (idx != nullptr) idx[(size_t)b * P + i] = aa;
  }
}

template <int R>
cudaError_t launch(const float* pred, const float* gt, float* out, int* idx, int B, int P,
                   int tile, int splits, cudaStream_t stream) {
  const int threads = splits * (tile / R);
  const size_t smem = (size_t)min(P, CHUNK) * sizeof(float4) + (size_t)splits * tile * 8;
  const long long blocks = (long long)B * ((P + tile - 1) / tile);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  addmin_kernel<R><<<(unsigned)blocks, threads, smem, stream>>>(pred, gt, out, idx, P, tile,
                                                                 splits);
  return cudaGetLastError();
}

}  // namespace

// The plan (tile, R, splits): R in {1, 2, 4}, tile a multiple of R, and at
// most MAX_THREADS threads (splits * tile / R); anything else is refused.
// idx may be null (no index output).
extern "C" int pose6d_addmin_forward(const void* pred, const void* gt, void* out, void* idx, int B,
                                     int P, int tile, int R, int splits, void* stream) {
  if (B < 1 || P < 1 || tile < R || R < 1 || tile % R != 0 || splits < 1 ||
      (long long)splits * (tile / R) > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const auto* p = (const float*)pred;
  const auto* q = (const float*)gt;
  auto* o = (float*)out;
  auto* ix = (int*)idx;
  const auto st = (cudaStream_t)stream;
  switch (R) {
    case 1: return (int)launch<1>(p, q, o, ix, B, P, tile, splits, st);
    case 2: return (int)launch<2>(p, q, o, ix, B, P, tile, splits, st);
    case 4: return (int)launch<4>(p, q, o, ix, B, P, tile, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
