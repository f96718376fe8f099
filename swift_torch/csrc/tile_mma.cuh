// Shared pieces of the port's hand-written Hopper kernels: cp.async tile
// loads and a double-buffered bf16 tensor-core main loop (WMMA, fp32
// accumulation) for C[BM x BN] = A[BM x K] . B[BN x K]^T, kernel 20's
// loop, and the warp reductions.
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

}  // namespace swift
