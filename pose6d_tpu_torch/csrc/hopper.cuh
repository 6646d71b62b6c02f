// The Hopper (sm_90a) PTX that both wgmma kernels use (stage_wgmma.cu,
// stem_tc.cu): shared-memory addresses, 16-byte cp.async, and the wgmma
// descriptor, fences and groups.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace pose6d_ptx {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; 0 source bytes (zero fill) when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Keep the compiler from moving accesses of wgmma's registers across a fence.
template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

}  // namespace pose6d_ptx
