// Per-(window, head) attention core on Hopper: softmax(q̂·k̂ᵀ)·v at scale 1
// on separate q̂, k̂, v of shape (BW, h, n, d), bf16, where q̂ and k̂ arrive
// already L2-normalised (q̂ with the logit scale) and rounded to bf16.
//
// Kernel 21 (swift_window_attention) replaces
// swift_tpu/ops/pallas_attention.py::_sdpa_fwd (body _sdpa_fwd_kernel),
// kernel 22b (swift_window_attention_bwd) replaces _sdpa_bwd_call (body
// _sdpa_bwd_kernel) and kernel 22t (swift_window_attention_tangent)
// replaces _sdpa_tangent_call (body _sdpa_tangent_kernel). The rounding
// points are the TPU kernels': bf16 operands of every product with fp32
// accumulation, the softmax in fp32, p (and in 22t the tangent dP) rounded
// to bf16 before the product with v, and in 22b dS rounded to bf16 before
// dq̂ and dk̂.
//
// The TPU kernels hold a window's whole n x n fp32 logit tile in VMEM. At
// n = 256 that is 256 KB, more than the 227 KB of shared memory a Hopper
// block may have, and the port routes windows of up to 1024 tokens here. So
// every kernel walks T-row tiles (T = 64 for d <= 128, else 32; d is
// zero-padded to DP, a multiple of 32 or 16, in shared memory only), with
// one block per (window·head, row tile) and products on the tensor cores
// (WMMA 16x16x16, operands and fp32 accumulators in shared memory):
//
// * 21: one block per query tile streams the key tiles with an online
//   softmax (running max and sum; the fp32 output rows in shared memory are
//   rescaled when the max grows) and divides by the sum at the end, so the
//   bf16 p it rounds is exp(s - m_running), as in FlashAttention.
// * 22b: a query pass, one block per query tile, forms each row's max m,
//   sum l and D = Σ p·dp (dp = do·vᵀ) over the key tiles, writes them as
//   12 bytes a row of scratch, then walks the key tiles again for
//   dq̂ = bf16(dS)·k̂. A key pass, one block per key tile, walks the query tiles, rebuilds p and dS
//   from the statistics, and sums dv = bf16(p)ᵀ·do and dk̂ = bf16(dS)ᵀ·q̂ in
//   shared memory: no fp32 partials that grow with the number of query
//   tiles (kernel 16's design).
// * 22t: one block per query tile, two passes over the key tiles: the
//   first forms m, l and E = Σ p·dS (dS = dq̂·k̂ᵀ + q̂·dk̂ᵀ), the second
//   dP = p (dS − E) and do = bf16(dP)·v + bf16(p)·dv. No scratch.
//
// What bounds them on the H100: at the model's windows (n = 4 to 256) the
// bytes, about 4 to 7 (BW·h·n·d) bf16 tensors a call; the recomputed
// products (21: 2 a key tile, 22b: 9 against the TPU kernel's 5, 22t: 8
// against 5) cost tensor-core time that a wgmma/TMA design would win back.
// Any n >= 1 (the tail of the last query and key tile is masked) and
// d <= 256; q̂, k̂, v, do and the tangents contiguous and 16-byte aligned.
#include <type_traits>

#include "tile_mma.cuh"

namespace swift {

constexpr int kWinNT = 256;  // 8 warps a block

template <int DP>
struct WinCfg {
  static constexpr int T = DP <= 128 ? 64 : 32;  // query and key rows a tile
  static constexpr int LD = DP + 8;              // bf16 row stride of a (T, DP) tile
  static constexpr int SLD = T + 4;              // fp32 row stride of a (T, T) tile
  static constexpr int PLD = T + 8;              // bf16 row stride of a (T, T) tile
  static constexpr int OLD = DP + 4;             // fp32 row stride of a (T, DP) tile
  static constexpr int TILE = round128(T * LD * 2);
  static constexpr int STILE = round128(T * SLD * 4);
  static constexpr int PTILE = round128(T * PLD * 2);
  static constexpr int OTILE = round128(T * OLD * 4);
  static constexpr int STATS = round128(3 * T * 4);
  static constexpr int FWD = 3 * TILE + STILE + PTILE + OTILE + STATS;            // 21
  static constexpr int BWD_Q = 4 * TILE + 2 * STILE + PTILE + OTILE + STATS;      // 22b, queries
  static constexpr int BWD_KV = 4 * TILE + 2 * STILE + 2 * PTILE + 2 * OTILE + STATS;  // keys
  static constexpr int TAN = 6 * TILE + 2 * STILE + 2 * PTILE + OTILE + STATS;    // 22t
  static_assert(DP % 16 == 0 && DP <= 256, "head width");
  static_assert(FWD <= kMaxSmem && BWD_Q <= kMaxSmem && BWD_KV <= kMaxSmem && TAN <= kMaxSmem,
                "shared memory");
};

// Rows r0 .. r0+ROWS of the (n, d) bf16 matrix ``src`` (row stride d) into
// the shared tile ``dst`` (row stride LD), zero past row n and, up to DP,
// past column d. 16-byte loads when d % 8 == 0, else element by element.
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_win_rows(bf16* dst, const bf16* __restrict__ src, int r0,
                                              int n, int d) {
  constexpr int CPR = DP / 8;
  const bool vec = d % 8 == 0;
  for (int c = threadIdx.x; c < ROWS * CPR; c += kWinNT) {
    const int r = c / CPR, k = (c % CPR) * 8, row = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < n && k < d) {
      const bf16* s = src + (size_t)row * d + k;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(s);
      } else {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (k + i < d) e[i] = s[i];
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + k) = val;
  }
}

// Rows of the fp32 shared tile ``src`` (row stride OLD), each times
// ``rowmul[r]`` (or 1), rounded to bf16 into rows r0.. of the (n, d) matrix
// ``dst``; rows past n and columns past d are not written.
template <int ROWS, int DP, int OLD>
__device__ __forceinline__ void store_win_rows(bf16* __restrict__ dst, const float* src,
                                               const float* rowmul, int r0, int n, int d) {
  constexpr int CPR = DP / 8;
  const bool vec = d % 8 == 0;
  for (int c = threadIdx.x; c < ROWS * CPR; c += kWinNT) {
    const int r = c / CPR, k = (c % CPR) * 8, row = r0 + r;
    if (row >= n || k >= d) continue;
    const float mul = rowmul ? rowmul[r] : 1.0f;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = src[r * OLD + k + i] * mul;
    bf16* out = dst + (size_t)row * d + k;
    if (vec) {
      *reinterpret_cast<uint4*>(out) = pack8(v);
    } else {
      for (int i = 0; i < 8 && k + i < d; ++i) out[i] = __float2bfloat16_rn(v[i]);
    }
  }
}

// C[M x N] (fp32, shared, row stride ldc) (+)= A[M x K] . B[K x N], all
// warps of the block, one 16x16 output fragment a warp at a time. A and B
// are bf16 in shared memory: LA row_major reads A(m, k) at A[m*lda + k],
// col_major at A[k*lda + m]; LB row_major reads B(k, n) at B[k*ldb + n],
// col_major at B[n*ldb + k] (so B = Xᵀ for a row-major X).
template <class LA, class LB>
__device__ __forceinline__ void block_mma(float* C, int ldc, const bf16* A, int lda, const bf16* B,
                                          int ldb, int M, int N, int K, bool accumulate) {
  const int warp = threadIdx.x / 32, tn = N / 16;
  for (int f = warp; f < (M / 16) * tn; f += kWinNT / 32) {
    const int mt = f / tn, nt = f % tn;
    float* cp = C + mt * 16 * ldc + nt * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate)
      wmma::load_matrix_sync(acc, cp, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
      if constexpr (std::is_same<LA, wmma::row_major>::value)
        wmma::load_matrix_sync(a, A + mt * 16 * lda + kk, lda);
      else
        wmma::load_matrix_sync(a, A + kk * lda + mt * 16, lda);
      if constexpr (std::is_same<LB, wmma::row_major>::value)
        wmma::load_matrix_sync(b, B + kk * ldb + nt * 16, ldb);
      else
        wmma::load_matrix_sync(b, B + nt * 16 * ldb + kk, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(cp, acc, ldc, wmma::mem_row_major);
  }
}

using RowM = wmma::row_major;
using ColM = wmma::col_major;

// ---------------------------------------------------------------------------
// Kernel 21: o = softmax(q̂·k̂ᵀ)·v, one block per (window·head, query tile).
template <int DP>
__global__ void __launch_bounds__(kWinNT)
    win_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o, int n, int d) {
  using C = WinCfg<DP>;
  constexpr int T = C::T, NW = kWinNT / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + C::TILE);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 2 * C::TILE);
  float* Ss = reinterpret_cast<float*>(smem + 3 * C::TILE);
  bf16* Ps = reinterpret_cast<bf16*>(smem + 3 * C::TILE + C::STILE);
  float* Os = reinterpret_cast<float*>(smem + 3 * C::TILE + C::STILE + C::PTILE);
  float* mrow = reinterpret_cast<float*>(smem + 3 * C::TILE + C::STILE + C::PTILE + C::OTILE);
  float* lrow = mrow + T;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)blockIdx.x * n * d;
  const int q0 = blockIdx.y * T;
  load_win_rows<T, DP, C::LD>(Qs, q + base, q0, n, d);
  for (int i = threadIdx.x; i < T * C::OLD; i += kWinNT) Os[i] = 0.0f;
  for (int r = threadIdx.x; r < T; r += kWinNT) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.0f;
  }
  for (int k0 = 0; k0 < n; k0 += T) {
    load_win_rows<T, DP, C::LD>(Ks, k + base, k0, n, d);
    load_win_rows<T, DP, C::LD>(Vs, v + base, k0, n, d);
    __syncthreads();
    block_mma<RowM, ColM>(Ss, C::SLD, Qs, C::LD, Ks, C::LD, T, T, DP, false);  // q̂·k̂ᵀ
    __syncthreads();
    const int kn = min(T, n - k0);  // live keys of this tile
    // one warp a query row: the running max and sum, bf16 exp(s - m) into
    // p, and the row of the output rescaled to the new max
    for (int r = warp; r < T; r += NW) {
      float s[T / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < T / 32; ++i) {
        const int j = lane + 32 * i;
        s[i] = j < kn ? Ss[r * C::SLD + j] : -INFINITY;
        mx = fmaxf(mx, s[i]);
      }
      mx = warp_max(mx);
      const float m_old = mrow[r], m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);  // 0 on the first tile
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < T / 32; ++i) {
        const float e = expf(s[i] - m_new);  // 0 past the live keys
        sum += e;
        Ps[r * C::PLD + lane + 32 * i] = __float2bfloat16_rn(e);
      }
      sum = warp_sum(sum);
      for (int c = lane; c < DP; c += 32) Os[r * C::OLD + c] *= alpha;
      __syncwarp();  // every lane has read m and l
      if (lane == 0) {
        mrow[r] = m_new;
        lrow[r] = lrow[r] * alpha + sum;
      }
    }
    __syncthreads();
    block_mma<RowM, RowM>(Os, C::OLD, Ps, C::PLD, Vs, C::LD, T, DP, T, true);  // + p·v
    __syncthreads();
  }
  for (int r = threadIdx.x; r < T; r += kWinNT) lrow[r] = 1.0f / lrow[r];
  __syncthreads();
  store_win_rows<T, DP, C::OLD>(o + base, Os, lrow, q0, n, d);
}

// ---------------------------------------------------------------------------
// Kernel 22b, query pass: per query tile, each row's max m, sum l and
// D = Σ p·dp into ``stats`` ((BW·h, 3, n) fp32), then dq̂ = bf16(dS)·k̂.
template <int DP>
__global__ void __launch_bounds__(kWinNT)
    win_attn_bwd_q_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          bf16* __restrict__ dq, float* __restrict__ stats, int n, int d) {
  using C = WinCfg<DP>;
  constexpr int T = C::T, NW = kWinNT / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + C::TILE);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * C::TILE);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * C::TILE);
  float* Ss = reinterpret_cast<float*>(smem + 4 * C::TILE);
  float* dPs = reinterpret_cast<float*>(smem + 4 * C::TILE + C::STILE);
  bf16* dSs = reinterpret_cast<bf16*>(smem + 4 * C::TILE + 2 * C::STILE);
  float* dQs = reinterpret_cast<float*>(smem + 4 * C::TILE + 2 * C::STILE + C::PTILE);
  float* mrow =
      reinterpret_cast<float*>(smem + 4 * C::TILE + 2 * C::STILE + C::PTILE + C::OTILE);
  float* lrow = mrow + T;
  float* drow = lrow + T;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)blockIdx.x * n * d;
  const int q0 = blockIdx.y * T;
  load_win_rows<T, DP, C::LD>(Qs, q + base, q0, n, d);
  load_win_rows<T, DP, C::LD>(dOs, dout + base, q0, n, d);
  for (int i = threadIdx.x; i < T * C::OLD; i += kWinNT) dQs[i] = 0.0f;
  for (int r = threadIdx.x; r < T; r += kWinNT) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.0f;
    drow[r] = 0.0f;
  }
  // first walk: the statistics, online
  for (int k0 = 0; k0 < n; k0 += T) {
    load_win_rows<T, DP, C::LD>(Ks, k + base, k0, n, d);
    load_win_rows<T, DP, C::LD>(Vs, v + base, k0, n, d);
    __syncthreads();
    block_mma<RowM, ColM>(Ss, C::SLD, Qs, C::LD, Ks, C::LD, T, T, DP, false);   // q̂·k̂ᵀ
    block_mma<RowM, ColM>(dPs, C::SLD, dOs, C::LD, Vs, C::LD, T, T, DP, false); // do·vᵀ
    __syncthreads();
    const int kn = min(T, n - k0);
    for (int r = warp; r < T; r += NW) {
      float s[T / 32], dp[T / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < T / 32; ++i) {
        const int j = lane + 32 * i;
        s[i] = j < kn ? Ss[r * C::SLD + j] : -INFINITY;
        dp[i] = dPs[r * C::SLD + j];
        mx = fmaxf(mx, s[i]);
      }
      mx = warp_max(mx);
      const float m_old = mrow[r], m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.0f, pdp = 0.0f;
#pragma unroll
      for (int i = 0; i < T / 32; ++i) {
        const float e = expf(s[i] - m_new);
        sum += e;
        pdp += e * dp[i];
      }
      sum = warp_sum(sum);
      pdp = warp_sum(pdp);
      __syncwarp();
      if (lane == 0) {
        mrow[r] = m_new;
        lrow[r] = lrow[r] * alpha + sum;
        drow[r] = drow[r] * alpha + pdp;
      }
    }
    __syncthreads();
  }
  float* st = stats + (size_t)blockIdx.x * 3 * n;
  for (int r = threadIdx.x; r < T; r += kWinNT) {
    drow[r] /= lrow[r];
    if (q0 + r < n) {
      st[q0 + r] = mrow[r];
      st[n + q0 + r] = lrow[r];
      st[2 * n + q0 + r] = drow[r];
    }
  }
  __syncthreads();
  // second walk: dS = p (dp − D) rounded to bf16, dq̂ += dS·k̂
  for (int k0 = 0; k0 < n; k0 += T) {
    load_win_rows<T, DP, C::LD>(Ks, k + base, k0, n, d);
    load_win_rows<T, DP, C::LD>(Vs, v + base, k0, n, d);
    __syncthreads();
    block_mma<RowM, ColM>(Ss, C::SLD, Qs, C::LD, Ks, C::LD, T, T, DP, false);
    block_mma<RowM, ColM>(dPs, C::SLD, dOs, C::LD, Vs, C::LD, T, T, DP, false);
    __syncthreads();
    const int kn = min(T, n - k0);
    for (int r = warp; r < T; r += NW) {
      const float m = mrow[r], inv_l = 1.0f / lrow[r], D = drow[r];
#pragma unroll
      for (int i = 0; i < T / 32; ++i) {
        const int j = lane + 32 * i;
        const float s = Ss[r * C::SLD + j];
        const float p = j < kn ? expf(s - m) * inv_l : 0.0f;
        dSs[r * C::PLD + j] = __float2bfloat16_rn(p * (dPs[r * C::SLD + j] - D));
      }
    }
    __syncthreads();
    block_mma<RowM, RowM>(dQs, C::OLD, dSs, C::PLD, Ks, C::LD, T, DP, T, true);
    __syncthreads();
  }
  store_win_rows<T, DP, C::OLD>(dq + base, dQs, nullptr, q0, n, d);
}

// Kernel 22b, key pass: per key tile, dv = Σ bf16(p)ᵀ·do and
// dk̂ = Σ bf16(dS)ᵀ·q̂ over the query tiles, p and dS rebuilt from the
// query pass's statistics.
template <int DP>
__global__ void __launch_bounds__(kWinNT)
    win_attn_bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ stats, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int n, int d) {
  using C = WinCfg<DP>;
  constexpr int T = C::T, NW = kWinNT / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + C::TILE);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * C::TILE);
  bf16* dOs = reinterpret_cast<bf16*>(smem + 3 * C::TILE);
  float* Ss = reinterpret_cast<float*>(smem + 4 * C::TILE);
  float* dPs = reinterpret_cast<float*>(smem + 4 * C::TILE + C::STILE);
  bf16* Ps = reinterpret_cast<bf16*>(smem + 4 * C::TILE + 2 * C::STILE);
  bf16* dSs = reinterpret_cast<bf16*>(smem + 4 * C::TILE + 2 * C::STILE + C::PTILE);
  float* dKs = reinterpret_cast<float*>(smem + 4 * C::TILE + 2 * C::STILE + 2 * C::PTILE);
  float* dVs = dKs + C::OTILE / 4;
  float* mrow = reinterpret_cast<float*>(smem + 4 * C::TILE + 2 * C::STILE + 2 * C::PTILE +
                                         2 * C::OTILE);
  float* lrow = mrow + T;
  float* drow = lrow + T;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)blockIdx.x * n * d;
  const int k0 = blockIdx.y * T;
  const int kn = min(T, n - k0);
  const float* st = stats + (size_t)blockIdx.x * 3 * n;
  load_win_rows<T, DP, C::LD>(Ks, k + base, k0, n, d);
  load_win_rows<T, DP, C::LD>(Vs, v + base, k0, n, d);
  for (int i = threadIdx.x; i < T * C::OLD; i += kWinNT) dKs[i] = dVs[i] = 0.0f;
  for (int q0 = 0; q0 < n; q0 += T) {
    load_win_rows<T, DP, C::LD>(Qs, q + base, q0, n, d);
    load_win_rows<T, DP, C::LD>(dOs, dout + base, q0, n, d);
    for (int r = threadIdx.x; r < T; r += kWinNT) {
      const bool live = q0 + r < n;
      mrow[r] = live ? st[q0 + r] : 0.0f;
      lrow[r] = live ? st[n + q0 + r] : 1.0f;
      drow[r] = live ? st[2 * n + q0 + r] : 0.0f;
    }
    __syncthreads();
    block_mma<RowM, ColM>(Ss, C::SLD, Qs, C::LD, Ks, C::LD, T, T, DP, false);   // q̂·k̂ᵀ
    block_mma<RowM, ColM>(dPs, C::SLD, dOs, C::LD, Vs, C::LD, T, T, DP, false); // do·vᵀ
    __syncthreads();
    const int qn = min(T, n - q0);
    for (int r = warp; r < T; r += NW) {
      const float m = mrow[r], inv_l = 1.0f / lrow[r], D = drow[r];
#pragma unroll
      for (int i = 0; i < T / 32; ++i) {
        const int j = lane + 32 * i;
        const float p = r < qn && j < kn ? expf(Ss[r * C::SLD + j] - m) * inv_l : 0.0f;
        Ps[r * C::PLD + j] = __float2bfloat16_rn(p);
        dSs[r * C::PLD + j] = __float2bfloat16_rn(p * (dPs[r * C::SLD + j] - D));
      }
    }
    __syncthreads();
    block_mma<ColM, RowM>(dVs, C::OLD, Ps, C::PLD, dOs, C::LD, T, DP, T, true);  // + pᵀ·do
    block_mma<ColM, RowM>(dKs, C::OLD, dSs, C::PLD, Qs, C::LD, T, DP, T, true);  // + dSᵀ·q̂
    __syncthreads();
  }
  store_win_rows<T, DP, C::OLD>(dk + base, dKs, nullptr, k0, n, d);
  store_win_rows<T, DP, C::OLD>(dv + base, dVs, nullptr, k0, n, d);
}

// ---------------------------------------------------------------------------
// Kernel 22t: do = dP·v + p·dv with dS = dq̂·k̂ᵀ + q̂·dk̂ᵀ and
// dP = p (dS − Σ p dS), one block per (window·head, query tile).
template <int DP>
__global__ void __launch_bounds__(kWinNT)
    win_attn_tangent_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ tq,
                            const bf16* __restrict__ tk, const bf16* __restrict__ tv,
                            bf16* __restrict__ tout, int n, int d) {
  using C = WinCfg<DP>;
  constexpr int T = C::T, NW = kWinNT / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dQs = reinterpret_cast<bf16*>(smem + C::TILE);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * C::TILE);
  bf16* dKs = reinterpret_cast<bf16*>(smem + 3 * C::TILE);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 4 * C::TILE);
  bf16* dVs = reinterpret_cast<bf16*>(smem + 5 * C::TILE);
  float* Ss = reinterpret_cast<float*>(smem + 6 * C::TILE);
  float* dSs = reinterpret_cast<float*>(smem + 6 * C::TILE + C::STILE);
  bf16* Ps = reinterpret_cast<bf16*>(smem + 6 * C::TILE + 2 * C::STILE);
  bf16* dPs = reinterpret_cast<bf16*>(smem + 6 * C::TILE + 2 * C::STILE + C::PTILE);
  float* Os = reinterpret_cast<float*>(smem + 6 * C::TILE + 2 * C::STILE + 2 * C::PTILE);
  float* mrow = reinterpret_cast<float*>(smem + 6 * C::TILE + 2 * C::STILE + 2 * C::PTILE +
                                         C::OTILE);
  float* lrow = mrow + T;
  float* erow = lrow + T;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)blockIdx.x * n * d;
  const int q0 = blockIdx.y * T;
  load_win_rows<T, DP, C::LD>(Qs, q + base, q0, n, d);
  load_win_rows<T, DP, C::LD>(dQs, tq + base, q0, n, d);
  for (int i = threadIdx.x; i < T * C::OLD; i += kWinNT) Os[i] = 0.0f;
  for (int r = threadIdx.x; r < T; r += kWinNT) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.0f;
    erow[r] = 0.0f;
  }
  // logits and their tangent for the key tile at k0: S = q̂·k̂ᵀ,
  // dS = dq̂·k̂ᵀ + q̂·dk̂ᵀ
  auto logits = [&](int k0) {
    load_win_rows<T, DP, C::LD>(Ks, k + base, k0, n, d);
    load_win_rows<T, DP, C::LD>(dKs, tk + base, k0, n, d);
    __syncthreads();
    block_mma<RowM, ColM>(Ss, C::SLD, Qs, C::LD, Ks, C::LD, T, T, DP, false);
    block_mma<RowM, ColM>(dSs, C::SLD, dQs, C::LD, Ks, C::LD, T, T, DP, false);
    block_mma<RowM, ColM>(dSs, C::SLD, Qs, C::LD, dKs, C::LD, T, T, DP, true);
  };
  // first walk: m, l and E = Σ p·dS, online
  for (int k0 = 0; k0 < n; k0 += T) {
    logits(k0);
    __syncthreads();
    const int kn = min(T, n - k0);
    for (int r = warp; r < T; r += NW) {
      float s[T / 32], ds[T / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < T / 32; ++i) {
        const int j = lane + 32 * i;
        s[i] = j < kn ? Ss[r * C::SLD + j] : -INFINITY;
        ds[i] = dSs[r * C::SLD + j];
        mx = fmaxf(mx, s[i]);
      }
      mx = warp_max(mx);
      const float m_old = mrow[r], m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.0f, pds = 0.0f;
#pragma unroll
      for (int i = 0; i < T / 32; ++i) {
        const float e = expf(s[i] - m_new);
        sum += e;
        pds += e * ds[i];
      }
      sum = warp_sum(sum);
      pds = warp_sum(pds);
      __syncwarp();
      if (lane == 0) {
        mrow[r] = m_new;
        lrow[r] = lrow[r] * alpha + sum;
        erow[r] = erow[r] * alpha + pds;
      }
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < T; r += kWinNT) erow[r] /= lrow[r];
  // second walk: p and dP rounded to bf16, do += dP·v + p·dv
  for (int k0 = 0; k0 < n; k0 += T) {
    load_win_rows<T, DP, C::LD>(Vs, v + base, k0, n, d);
    load_win_rows<T, DP, C::LD>(dVs, tv + base, k0, n, d);
    logits(k0);  // its barrier also orders the statistics above
    __syncthreads();
    const int kn = min(T, n - k0);
    for (int r = warp; r < T; r += NW) {
      const float m = mrow[r], inv_l = 1.0f / lrow[r], E = erow[r];
#pragma unroll
      for (int i = 0; i < T / 32; ++i) {
        const int j = lane + 32 * i;
        const float p = j < kn ? expf(Ss[r * C::SLD + j] - m) * inv_l : 0.0f;
        Ps[r * C::PLD + j] = __float2bfloat16_rn(p);
        dPs[r * C::PLD + j] = __float2bfloat16_rn(p * (dSs[r * C::SLD + j] - E));
      }
    }
    __syncthreads();
    block_mma<RowM, RowM>(Os, C::OLD, dPs, C::PLD, Vs, C::LD, T, DP, T, true);   // + dP·v
    block_mma<RowM, RowM>(Os, C::OLD, Ps, C::PLD, dVs, C::LD, T, DP, T, true);   // + p·dv
    __syncthreads();
  }
  store_win_rows<T, DP, C::OLD>(tout + base, Os, nullptr, q0, n, d);
}

template <int DP>
int launch_win_fwd(const void* q, const void* k, const void* v, void* o, int bh, int n, int d,
                   cudaStream_t st) {
  using C = WinCfg<DP>;
  cudaFuncSetAttribute(win_attn_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::FWD);
  win_attn_fwd_kernel<DP><<<dim3(bh, (n + C::T - 1) / C::T), kWinNT, C::FWD, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, n, d);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_win_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, void* stats, int bh, int n, int d, cudaStream_t st) {
  using C = WinCfg<DP>;
  const dim3 grid(bh, (n + C::T - 1) / C::T);
  cudaFuncSetAttribute(win_attn_bwd_q_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::BWD_Q);
  win_attn_bwd_q_kernel<DP><<<grid, kWinNT, C::BWD_Q, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (bf16*)dq,
      (float*)stats, n, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaFuncSetAttribute(win_attn_bwd_kv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::BWD_KV);
  win_attn_bwd_kv_kernel<DP><<<grid, kWinNT, C::BWD_KV, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)stats,
      (bf16*)dk, (bf16*)dv, n, d);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_win_tangent(const void* q, const void* k, const void* v, const void* tq,
                       const void* tk, const void* tv, void* tout, int bh, int n, int d,
                       cudaStream_t st) {
  using C = WinCfg<DP>;
  cudaFuncSetAttribute(win_attn_tangent_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::TAN);
  win_attn_tangent_kernel<DP><<<dim3(bh, (n + C::T - 1) / C::T), kWinNT, C::TAN, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)tq, (const bf16*)tk,
      (const bf16*)tv, (bf16*)tout, n, d);
  return (int)cudaGetLastError();
}

}  // namespace swift

// The padded head width every kernel of this file takes for d (0 when d is
// out of range): 16 up to d = 16, else d rounded up to a multiple of 32.
static int win_dp(int d) {
  if (d < 1 || d > 256) return 0;
  return d <= 16 ? 16 : (d + 31) / 32 * 32;
}

#define SWIFT_WIN_DISPATCH(CALL)       \
  switch (win_dp(d)) {                 \
    case 16: return CALL(16);          \
    case 32: return CALL(32);          \
    case 64: return CALL(64);          \
    case 96: return CALL(96);          \
    case 128: return CALL(128);        \
    case 160: return CALL(160);        \
    case 192: return CALL(192);        \
    case 224: return CALL(224);        \
    case 256: return CALL(256);        \
    default: return (int)cudaErrorInvalidValue; \
  }

// Kernel 21: q, k, v, o (bh, n, d) bf16, contiguous; bh = BW·heads,
// n >= 1, 1 <= d <= 256. Returns a cudaError_t.
extern "C" int swift_window_attention(const void* q, const void* k, const void* v, void* o,
                                      int bh, int n, int d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define SWIFT_CALL(DP) swift::launch_win_fwd<DP>(q, k, v, o, bh, n, d, st)
  SWIFT_WIN_DISPATCH(SWIFT_CALL)
#undef SWIFT_CALL
}

// Kernel 22b: (dq, dk, dv) of swift_window_attention at (q, k, v) along
// dout, all (bh, n, d) bf16, and stats fp32 scratch of bh*3*n elements (each
// query row's max, sum and Σ p·dp).
extern "C" int swift_window_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          void* stats, int bh, int n, int d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define SWIFT_CALL(DP) swift::launch_win_bwd<DP>(q, k, v, dout, dq, dk, dv, stats, bh, n, d, st)
  SWIFT_WIN_DISPATCH(SWIFT_CALL)
#undef SWIFT_CALL
}

// Kernel 22t: the tangent of swift_window_attention at (q, k, v) along
// (tq, tk, tv), all (bh, n, d) bf16, into tout.
extern "C" int swift_window_attention_tangent(const void* q, const void* k, const void* v,
                                              const void* tq, const void* tk, const void* tv,
                                              void* tout, int bh, int n, int d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define SWIFT_CALL(DP) swift::launch_win_tangent<DP>(q, k, v, tq, tk, tv, tout, bh, n, d, st)
  SWIFT_WIN_DISPATCH(SWIFT_CALL)
#undef SWIFT_CALL
}

#undef SWIFT_WIN_DISPATCH
