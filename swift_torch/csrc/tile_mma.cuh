// Shared pieces of the port's hand-written Hopper kernels: cp.async tile
// loads and a double-buffered bf16 tensor-core main loop (WMMA, fp32
// accumulation) for C[BM x BN] = A[BM x K] . B[BN x K]^T, and beside it the
// int8 main loop (s8 x s8 -> s32) of kernel 19, with its per-row
// quantization (whose rounding kernel 18 shares).
//
// Every GEMM of the SwinV2 block multiplies an activation (tokens x K,
// row-major) by a torch ``nn.Linear`` weight (out x K, row-major), so both
// operands are read K-contiguous and the weight tile is the col-major
// ``matrix_b`` WMMA expects -- no transposed copy of any weight is made.
//
// Requirements the wrappers enforce: K % 8 == 0 (16-byte chunks) and
// 16-byte aligned base pointers. Rows or K-chunks past the edge are
// zero-filled by cp.async's src-size operand, so M, N and K need not be
// multiples of the tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace swift {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// Largest dynamic shared memory one block may use on sm_90 (227 KB).
constexpr int kMaxSmem = 232448;

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

// Copy rows x [k0, k0+BK) into shared memory (row stride LDS elements).
// ``rowptr(r)`` gives tile row r's first element in device memory, or
// nullptr for a row past the edge (zero-filled; cp.async then reads nothing
// and is handed ``any``, a valid address).
template <int ROWS, int BK, int LDS, int NT, class RowPtr>
__device__ __forceinline__ void load_rows(bf16* smem, RowPtr rowptr, const bf16* any, int k0,
                                          int K, int tid) {
  constexpr int CPR = BK / 8;
  for (int c = tid; c < ROWS * CPR; c += NT) {
    int r = c / CPR, kc = (c % CPR) * 8;
    const bf16* src = rowptr(r);
    bool ok = src != nullptr && k0 + kc < K;
    cp_async16(smem + r * LDS + kc, ok ? src + k0 + kc : any, ok);
  }
}

// The same for a row-major bf16 matrix ``g`` with row stride ``ld``:
// ``row(r)`` maps tile row r to a matrix row, or -1 past the edge.
template <int ROWS, int BK, int LDS, int NT, class RowFn>
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* g, int ld, RowFn row, int k0,
                                          int K, int tid) {
  load_rows<ROWS, BK, LDS, NT>(
      smem,
      [=](int r) -> const bf16* {
        const int gr = row(r);
        return gr >= 0 ? g + (size_t)gr * ld : nullptr;
      },
      g, k0, K, tid);
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

// C[BM x BN] (registers, WM x WN warps, each (BM/WM) x (BN/WN)) =
// A[arow(0..BM) x K] . B[brow(0..BN) x K]^T, double-buffered over BK. The
// operand rows are given as row indices of A and B (``run``) or as row
// pointers (``run_rows``, for an A whose rows come from two tensors).
template <int BM, int BN, int BK, int WM, int WN>
struct TileMma {
  static constexpr int NT = WM * WN * 32;
  static constexpr int LDS = BK + 8;  // +16 bytes a row against bank conflicts
  static constexpr int FM = BM / WM / 16;
  static constexpr int FN = BN / WN / 16;
  static constexpr int SMEM = 2 * (BM + BN) * LDS * (int)sizeof(bf16);
  static_assert(FM >= 1 && FN >= 1 && BK % 16 == 0, "tile shape");
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  template <class ARow, class BRow>
  __device__ static void run(Acc (&acc)[FM][FN], bf16* smem, const bf16* A, int lda, ARow arow,
                             const bf16* B, int ldb, BRow brow, int K) {
    run_rows(
        acc, smem,
        [=](int r) -> const bf16* {
          const int gr = arow(r);
          return gr >= 0 ? A + (size_t)gr * lda : nullptr;
        },
        A,
        [=](int r) -> const bf16* {
          const int gr = brow(r);
          return gr >= 0 ? B + (size_t)gr * ldb : nullptr;
        },
        B, K);
  }

  template <class ARowPtr, class BRowPtr>
  __device__ static void run_rows(Acc (&acc)[FM][FN], bf16* smem, ARowPtr arow, const bf16* A,
                                  BRowPtr brow, const bf16* B, int K) {
    const int tid = threadIdx.x, warp = tid / 32;
    const int wm = warp / WN, wn = warp % WN;
    bf16* As[2] = {smem, smem + BM * LDS};
    bf16* Bs[2] = {smem + 2 * BM * LDS, smem + 2 * BM * LDS + BN * LDS};
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    const int nk = (K + BK - 1) / BK;
    load_rows<BM, BK, LDS, NT>(As[0], arow, A, 0, K, tid);
    load_rows<BN, BK, LDS, NT>(Bs[0], brow, B, 0, K, tid);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      const int cur = kt & 1;
      if (kt + 1 < nk) {
        load_rows<BM, BK, LDS, NT>(As[cur ^ 1], arow, A, (kt + 1) * BK, K, tid);
        load_rows<BN, BK, LDS, NT>(Bs[cur ^ 1], brow, B, (kt + 1) * BK, K, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(a[i], As[cur] + (wm * FM * 16 + i * 16) * LDS + kk, LDS);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(b[j], Bs[cur] + (wn * FN * 16 + j * 16) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
};

// ---------------------------------------------------------------------------
// int8 (kernel 19; kernel 18 shares quant8 and quant_scale): s8 x s8 -> s32
// WMMA 16x16x16 products.
//
// An int8 operand tile of R rows over a K range lies k-chunk-major in shared
// memory, [K/16][R][16] bytes, so the 16x16 fragment at (row r0, k-chunk kc)
// is 256 contiguous bytes, 32-byte aligned, ldm 16 -- WMMA's alignment rule
// holds at every 16-byte k step. A streamed tile's chunk planes are 32 bytes
// apart beyond R*16 so that cp.async's 16-byte writes of one row's chunks
// fall on different banks. K must be a multiple of 16 (whole 16-byte chunks).

__host__ __device__ constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

// Symmetric int8 of v at scale s, as the JAX mirror (quant.py) computes it:
// IEEE division (the build has no fast-math) and round half to even (rintf;
// roundf would round half away from zero), clipped to +-127.
__device__ __forceinline__ signed char quant8(float v, float s) {
  return (signed char)fminf(fmaxf(rintf(v / s), -127.0f), 127.0f);
}

__device__ __forceinline__ float quant_scale(float amax) { return fmaxf(amax, 1e-30f) / 127.0f; }

// Rows m0..m0+R of the bf16 matrix X (M x K, row-major) quantized per row
// into the resident k-chunk-major tile q ([K/16][R][16]) and their scales,
// one warp a row: the abs-max runs over all K columns. Rows past M become
// zeros.
template <int R, int NT>
__device__ void quantize_rows(signed char* q, float* scale, const bf16* X, int m0, int M, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += NT / 32) {
    const bool live = m0 + r < M;
    const bf16* x = X + (size_t)(live ? m0 + r : 0) * K;
    float amax = 0.0f;
    if (live)
      for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(__bfloat162float(x[k])));
    const float s = quant_scale(warp_max(amax));
    if (lane == 0) scale[r] = s;
    for (int k = lane; k < K; k += 32)
      q[((k >> 4) * R + r) * 16 + (k & 15)] = live ? quant8(__bfloat162float(x[k]), s) : 0;
  }
}

// Copy rows x [k0, k0+BK) bytes of an int8 matrix into a streamed tile
// (chunk planes PLANE bytes apart); ``rowptr(r)`` as for load_rows.
template <int ROWS, int BK, int PLANE, int NT, class RowPtr>
__device__ __forceinline__ void load_rows_i8(signed char* smem, RowPtr rowptr,
                                             const signed char* any, int k0, int K, int tid) {
  constexpr int CPR = BK / 16;
  for (int c = tid; c < ROWS * CPR; c += NT) {
    const int r = c / CPR, kc = c % CPR;
    const signed char* src = rowptr(r);
    const bool ok = src != nullptr && k0 + kc * 16 < K;
    cp_async16(smem + kc * PLANE + r * 16, ok ? src + k0 + kc * 16 : any, ok);
  }
}

// C[BM x BN] (int32 fragments, WM x WN warps) = A[BM x K] . B[brow(0..BN) x
// K]^T with A resident in shared memory (k-chunk-major, quantized by the
// caller) and B's rows streamed BK bytes at a time, double-buffered with
// cp.async through ``bs`` (SMEM bytes). Integer sums are exact, so the order
// of the k steps does not matter.
template <int BM, int BN, int BK, int WM, int WN>
struct TileMmaI8 {
  static constexpr int NT = WM * WN * 32;
  static constexpr int FM = BM / WM / 16;
  static constexpr int FN = BN / WN / 16;
  static constexpr int PLANE = BN * 16 + 32;
  static constexpr int STAGE = (BK / 16) * PLANE;
  static constexpr int SMEM = 2 * STAGE;
  static_assert(FM >= 1 && FN >= 1 && BK % 16 == 0 && STAGE % 128 == 0, "tile shape");
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

  template <class BRowPtr>
  __device__ static void run(Acc (&acc)[FM][FN], const signed char* As, signed char* bs,
                             BRowPtr brow, const signed char* B, int K) {
    const int tid = threadIdx.x, warp = tid / 32;
    const int wm = warp / WN, wn = warp % WN;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

    const int nk = (K + BK - 1) / BK;
    load_rows_i8<BN, BK, PLANE, NT>(bs, brow, B, 0, K, tid);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk)
        load_rows_i8<BN, BK, PLANE, NT>(bs + ((kt + 1) & 1) * STAGE, brow, B, (kt + 1) * BK, K,
                                        tid);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const signed char* bt = bs + (kt & 1) * STAGE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int kc = kt * (BK / 16) + kk;
        if (kc * 16 >= K) break;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(a[i], As + ((size_t)kc * BM + wm * FM * 16 + i * 16) * 16, 16);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(b[j], bt + kk * PLANE + (wn * FN * 16 + j * 16) * 16, 16);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
};

}  // namespace swift
