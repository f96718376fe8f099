// Per-token int8 quantization, the pass before the int8 products of kernels
// 18 (ffn_int8.cu: x, then h) and 19 (gemm.cu: x). Symmetric abs-max, as the
// JAX mirror (swift_tpu/ops/quant.py) and the port's ops/quant.py compute it:
// scale = max(amax, 1e-30) / 127, q = clip(round(v / scale), +-127) with
// round half to even. A row's abs-max runs over all its K values before any
// of it can be quantized, so it is a launch of its own, one warp a row,
// reading the row twice (the second read from L1/L2) and writing K int8 and
// one fp32 scale. Bound by device memory: 2K + K + 4 bytes a bf16 row.
#pragma once

#include "tile_mma.cuh"

namespace swift {
namespace {  // each source that launches the kernel keeps its own copy

// Symmetric int8 of v at scale s: IEEE division (the build has no
// fast-math) and round half to even (rintf; roundf would round half away
// from zero), clipped to +-127.
__device__ __forceinline__ signed char quant8(float v, float s) {
  return (signed char)fminf(fmaxf(rintf(v / s), -127.0f), 127.0f);
}

__device__ __forceinline__ float quant_scale(float amax) { return fmaxf(amax, 1e-30f) / 127.0f; }

__device__ __forceinline__ uint32_t pack_s8x4(float a, float b, float c, float d, float s) {
  return (uint32_t)(uint8_t)quant8(a, s) | (uint32_t)(uint8_t)quant8(b, s) << 8 |
         (uint32_t)(uint8_t)quant8(c, s) << 16 | (uint32_t)(uint8_t)quant8(d, s) << 24;
}

__device__ __forceinline__ void load8(const bf16* p, float f[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(e[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

constexpr int kQuantRows = 8;  // token rows a block: one a warp

// One warp a token row of X (M x K, K % 8 == 0, 16-byte aligned rows): the
// scale of its abs-max and its int8 values at that scale, into Q (M x K) and
// scale (M,). The abs-max is the row's own (``partials`` null) or the
// largest of its ``tiles`` partial maxima (kernel 18's h, whose maxima its
// pass 1 leaves).
template <class T>
__global__ void __launch_bounds__(32 * kQuantRows)
    quantize_rows_kernel(const T* __restrict__ X, const float* __restrict__ partials, int tiles,
                         signed char* __restrict__ Q, float* __restrict__ scale, int M, int K) {
  const int lane = threadIdx.x % 32, row = blockIdx.x * kQuantRows + threadIdx.x / 32;
  if (row >= M) return;
  const T* x = X + (size_t)row * K;
  float top = 0.0f;
  if (partials) {
    for (int t = lane; t < tiles; t += 32) top = fmaxf(top, partials[(size_t)row * tiles + t]);
  } else {
    for (int i = lane; i < K / 8; i += 32) {
      float f[8];
      load8(x + 8 * i, f);
#pragma unroll
      for (int k = 0; k < 8; ++k) top = fmaxf(top, fabsf(f[k]));
    }
  }
  const float s = quant_scale(warp_max(top));
  if (lane == 0) scale[row] = s;
  uint2* q = reinterpret_cast<uint2*>(Q + (size_t)row * K);
#pragma unroll 2
  for (int i = lane; i < K / 8; i += 32) {
    float f[8];
    load8(x + 8 * i, f);
    q[i] = make_uint2(pack_s8x4(f[0], f[1], f[2], f[3], s), pack_s8x4(f[4], f[5], f[6], f[7], s));
  }
}

// quantize_rows_kernel over M rows on ``stream``; returns the launch's error.
template <class T>
int quantize_rows(const T* x, const float* partials, int tiles, signed char* q, float* scale,
                  int M, int K, cudaStream_t stream) {
  quantize_rows_kernel<<<(M + kQuantRows - 1) / kQuantRows, 32 * kQuantRows, 0, stream>>>(
      x, partials, tiles, q, scale, M, K);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace swift
