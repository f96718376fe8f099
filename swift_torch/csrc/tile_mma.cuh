// Shared pieces of the port's hand-written kernels that are not wgmma.cuh's:
// cp.async 16-byte copies into shared memory, the warp reductions, the
// 8-wide bf16 pack, and the size of a block's shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace swift {

using bf16 = __nv_bfloat16;

// Largest dynamic shared memory one block may use on sm_90 (227 KB).
constexpr int kMaxSmem = 232448;

__host__ __device__ constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 -> the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Pack 8 floats into 8 bf16 (round to nearest even) for one 16-byte store.
__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 out;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return out;
}

}  // namespace swift
