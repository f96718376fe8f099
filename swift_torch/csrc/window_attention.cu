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
// block may have, and the port routes windows of up to 1024 tokens here.
// d is zero-padded to DP (16, or a multiple of 32) in shared memory only.
//
// Kernel 21 runs on wgmma and TMA (csrc/wgmma.cuh). What bounds it on the
// H100: the bytes. It reads q̂, k̂, v and writes o, 4 (BW·h·n·d) bf16
// tensors, for 4 n² d flops a window-head: n / 2 flops a byte, 32 at n = 64
// (path B) and 128 at n = 256, under the ~295 at which the tensor cores
// would set the pace; at n = 1024 the operations bound it. So the design keeps many
// loads in flight, multiplies without shared-memory accumulators, reads
// each byte once where the form allows, and writes only live rows.
// Persistent blocks of 384 threads (as many as SMs, no more than work
// items): a producer warpgroup whose one thread issues TMA loads of 64-
// column boxes with the 128-byte swizzle (setmaxnreg 80), and two consumer
// warpgroups (208) that multiply S = q̂·k̂ᵀ from shared memory by
// wgmma_m64nNk16 and o = p·v by wgmma_m64nNk16_rs, p packed in registers
// and v read MN-major, with the logits, p and o in registers, and store o
// through staging rows by one bulk copy a tile (its live rows are
// contiguous in o). q̂, k̂, v and o are viewed as (BW·h·n, d) matrices; TMA
// fills zeros past row BW·h·n and past column d. Where d % 8 != 0 (rows not
// 16 bytes apart, which TMA needs) the same kernel loads element by element
// with the producer's 128 threads and stores from registers. The forms:
//
//   n <= 64             packed: a 64-row tile holds G = floor(64 / n)
//                       whole window-heads (path A, n 4: 16; path B, n 64:
//                       1); its q̂, k̂, v in one stage of a ring (4 stages
//                       for DP <= 128, else 2); S is 64 x 64, masked
//                       block-diagonally (a query sees the keys of its own
//                       window-head; the rows a box reads past the tile's
//                       window-heads are masked and never stored); p is
//                       normalised before it is rounded.
//   n > 64              rows: a work item is one pass (two query tiles,
//                       one a consumer) of one window-head, which walks T =
//                       ceil(n / NK) key tiles of NK = 128 rows (64 for DP
//                       160-192, 32 past it, where o takes 112 or 128
//                       registers), keys past n masked. T = 1 (n <= 128 at
//                       DP <= 128): whole rows of S in registers, p
//                       normalised before it is rounded (the TPU kernel's
//                       rounding point). T > 1: the running max and sum and
//                       o rescaled in registers; p is rounded as exp(s −
//                       m_running) and o divided by the sum at the end, as
//                       in FlashAttention. (A whole key tile of 256 keys
//                       spilled 224-772 bytes a thread: S alone takes 128
//                       registers.)
//
// Kernels 22b and 22t walk T-row tiles (T = 64 for d <= 128, else 32),
// with one block per (window·head, row tile) and products on the tensor
// cores (WMMA 16x16x16, operands and fp32 accumulators in shared memory):
//
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
// What bounds 22b and 22t: the bytes, about 5 to 7 (BW·h·n·d) bf16 tensors
// a call; their recomputed products (22b: 9 against the TPU kernel's 5,
// 22t: 8 against 5) cost tensor-core time that a wgmma/TMA design would
// win back. All three take any n >= 1 and d <= 256; q̂, k̂, v, do and the
// tangents contiguous and 16-byte aligned.
#include <climits>
#include <type_traits>

#include "tile_mma.cuh"
#include "wgmma.cuh"

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
  static constexpr int BWD_Q = 4 * TILE + 2 * STILE + PTILE + OTILE + STATS;      // 22b, queries
  static constexpr int BWD_KV = 4 * TILE + 2 * STILE + 2 * PTILE + 2 * OTILE + STATS;  // keys
  static constexpr int TAN = 6 * TILE + 2 * STILE + 2 * PTILE + OTILE + STATS;    // 22t
  static_assert(DP % 16 == 0 && DP <= 256, "head width");
  static_assert(BWD_Q <= kMaxSmem && BWD_KV <= kMaxSmem && TAN <= kMaxSmem, "shared memory");
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
// Kernel 21 on wgmma: o = softmax(q̂·k̂ᵀ)·v (the forms are in the header).

// the producer warpgroup and two consumers; a block launched at 168 registers
// a thread holds 64,512: 80 a producer thread and 208 a consumer's
constexpr int kWinFwdThreads = 384;
constexpr float kWinLog2e = 1.4426950408889634f;

// The first of the two rows (r, r + 8) of a 64-row wgmma accumulator that
// thread ``tid`` of its warpgroup holds.
__device__ __forceinline__ int win_acc_row(int tid) { return tid / 32 * 16 + tid % 32 / 4; }

// 64-column boxes of a padded row, and the width of p·v (wgmma's N: at
// DP = 16 it reads 16 more columns of v, zero in shared memory).
template <int DP>
struct WinFwdWidth {
  static constexpr int NBOX = (DP + 63) / 64;
  static constexpr int NO = DP < 32 ? 32 : DP;
};

// Rows row0 .. row0 + ROWS of the (R, d) bf16 matrix ``src`` into ``tile``:
// NBOX boxes of ROWS rows x 64 columns with the 128-byte swizzle, one after
// another, zero past row R and column d. By TMA (``tma``: one thread issues
// the boxes, whose bytes complete ``bar``) or, where d % 8 != 0 (rows not
// 16 bytes apart, as TMA needs), by the producer's 128 threads element by
// element.
template <int ROWS, int NBOX>
__device__ __forceinline__ void win_load(unsigned char* tile, const CUtensorMap* map,
                                         const bf16* __restrict__ src, int row0, int R, int d,
                                         uint64_t* bar, bool tma, int tid) {
  constexpr int BOX = ROWS * 128;
  if (tma) {
#pragma unroll
    for (int b = 0; b < NBOX; ++b) tma_load_2d(tile + b * BOX, map, bar, 64 * b, row0);
    return;
  }
  for (int i = tid; i < ROWS * NBOX * 8; i += 128) {
    const int r = i / (NBOX * 8), c = i % (NBOX * 8), row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    bf16* e = reinterpret_cast<bf16*>(&val);
    if (row < R) {
      const bf16* s = src + (size_t)row * d;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c * 8 + j < d) e[j] = s[c * 8 + j];
    }
    *reinterpret_cast<uint4*>(tile + (c / 8) * BOX + r * 128 + (((c % 8) ^ (r % 8)) << 4)) = val;
  }
}

// The producer's fill of one buffer: ``bytes`` announced on ``full`` (TMA:
// one arrive.expect_tx), the loads, then on the element-wise path each
// thread's writes fenced for wgmma and its arrival (``full`` counts 128).
template <class Load>
__device__ __forceinline__ void win_fill(uint64_t* full, uint32_t bytes, bool tma, Load load) {
  if (tma) mbar_expect_tx(full, bytes);
  load();
  if (!tma) {
    fence_async_smem();
    mbar_arrive(full);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S = q̂·k̂ᵀ of a 64-row query tile against N keys: DP/16 k16 slices, both
// tiles K-major in 64-column boxes ``qbox`` and ``kbox`` bytes apart.
template <int DP, int N>
__device__ __forceinline__ void win_qk(float (&s)[N / 2], const unsigned char* Q, int qbox,
                                       const unsigned char* K, int kbox) {
#pragma unroll
  for (int k = 0; k < DP / 16; ++k)
    wgmma_m64nNk16<N>(s, wgmma_desc(Q + (k / 4) * qbox) + 2 * (k % 4),
                      wgmma_desc(K + (k / 4) * kbox) + 2 * (k % 4), k > 0);
}

// The logits of keys a row may not see set to -inf: thread t holds
// s[4 j + 2 h + e] = S[row r + 8 h][column 8 j + 2 (t % 4) + e]; row h sees
// the columns lo[h] .. hi[h] - 1.
template <int N>
__device__ __forceinline__ void win_mask(float (&s)[N / 2], const int (&lo)[2], const int (&hi)[2],
                                         int q4) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int col = 8 * (i >> 2) + 2 * q4 + (i & 1), h = (i >> 1) & 1;
    if (col < lo[h] || col >= hi[h]) s[i] = -INFINITY;
  }
}

// The softmax of whole rows of a 64 x N logit tile in registers: p = e / Σe
// normalised in fp32 before it is rounded to bf16 (the TPU kernel's rounding
// point), as the A fragments of the N/16 k16 slices of p·v (the m64nN
// accumulator's layout is theirs).
template <int N>
__device__ __forceinline__ void win_softmax(float (&s)[N / 2], uint32_t (&p)[N / 16][4]) {
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = quad_max(m[h]) * kWinLog2e;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    s[i] = exp2f(fmaf(s[i], kWinLog2e, -m[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = 1.0f / quad_sum(l[h]);
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      p[k][q] = pack_bf16x2(s[8 * k + 2 * q] * l[q & 1], s[8 * k + 2 * q + 1] * l[q & 1]);
}

// One key tile of the online softmax: each row's running max m and this
// thread's share of the running sum l (fp32 e, the quad's shares added at
// the end) brought up to the tile, o rescaled by exp(m_old − m_new) where
// ``rescale`` (every tile but the first), p = bf16(exp(s − m_new)) as A
// fragments; the caller divides o by the sum at the end.
template <int N, int NO>
__device__ __forceinline__ void win_online(float (&s)[N / 2], uint32_t (&p)[N / 16][4],
                                           float (&m)[2], float (&l)[2], float (&o)[NO / 2],
                                           bool rescale) {
  float mx[2] = {m[0], m[1]}, alpha[2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    alpha[h] = exp2f((m[h] - mx[h]) * kWinLog2e);  // 0 on the first tile
    m[h] = mx[h];
    mx[h] *= kWinLog2e;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    s[i] = exp2f(fmaf(s[i], kWinLog2e, -mx[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
  if (rescale) {
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  }
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) p[k][q] = pack_bf16x2(s[8 * k + 2 * q], s[8 * k + 2 * q + 1]);
}

// o (+)= p·v over the N/16 k16 slices of a key tile: p from registers, v's
// boxes (``box`` bytes apart) read MN-major, o's NO columns in wgmma widths
// of at most 128 (columns 128.. from box 2 on; the accumulator of columns
// 128 + c continues the layout of columns c, so o stays one array).
template <int N, int NO>
__device__ __forceinline__ void win_pv(float (&o)[NO / 2], const uint32_t (&p)[N / 16][4],
                                       const unsigned char* V, int box, bool accumulate) {
  constexpr int N0 = NO < 128 ? NO : 128, N1 = NO - N0;
  const uint64_t d0 = wgmma_desc_mn(V, box);
  float(&o0)[N0 / 2] = *reinterpret_cast<float(*)[N0 / 2]>(&o[0]);
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
    wgmma_m64nNk16_rs<N0>(o0, p[k], d0 + 128 * k, accumulate || k > 0);
  if constexpr (N1 > 0) {
    const uint64_t d1 = wgmma_desc_mn(V + 2 * box, box);
    float(&o1)[N1 / 2] = *reinterpret_cast<float(*)[N1 / 2]>(&o[N0 / 2]);
#pragma unroll
    for (int k = 0; k < N / 16; ++k)
      wgmma_m64nNk16_rs<N1>(o1, p[k], d1 + 128 * k, accumulate || k > 0);
  }
}

// A consumer's 64 output rows, rounded to bf16, into rows row0 .. row0 +
// live of the (R, d) matrix ``out``. Where ``tma`` (d % 8 == 0): into the
// staging rows ``stg`` (row stride d), then one bulk copy of the live rows,
// contiguous in ``out``, issued by thread 0 -- the caller waits for its read
// before ``stg`` is written again; else element by element from registers.
// Rows past ``live`` (another tile's, or past the end) are never written.
template <int NO>
__device__ __forceinline__ void win_store(const float (&o)[NO / 2], bf16* stg, bf16* out,
                                          size_t row0, int live, int d, bool tma, int c,
                                          int tid) {
  const int q4 = tid % 4, r = win_acc_row(tid);
  if (tma) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r + 8 * h >= live) continue;
#pragma unroll
      for (int j = 0; j < NO / 8; ++j) {
        const int col = 8 * j + 2 * q4;
        if (col < d)
          *reinterpret_cast<uint32_t*>(stg + (r + 8 * h) * d + col) =
              pack_bf16x2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      }
    }
    fence_async_smem();
    named_barrier_sync(1 + c, 128);
    if (tid == 0) {
      bulk_store(out + row0 * d, stg, (uint32_t)live * d * 2);
      tma_store_commit();
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= live) continue;
    bf16* dst = out + (row0 + r + 8 * h) * d;
#pragma unroll
    for (int j = 0; j < NO / 8; ++j) {
      const int col = 8 * j + 2 * q4;
      if (col < d) dst[col] = __float2bfloat16_rn(o[4 * j + 2 * h]);
      if (col + 1 < d) dst[col + 1] = __float2bfloat16_rn(o[4 * j + 2 * h + 1]);
    }
  }
}

// One warp's arrival on ``bar`` once all its lanes are past this point.
__device__ __forceinline__ void win_release(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// The packed form, n <= 64: tiles of G = 64 / n whole window-heads (rows
// tile·G·n .. + G·n of the (BW·h·n, d) matrices), each with its own q, k and
// v in one stage of a ring; consumer c of NC = 2 takes the block's tiles
// c, c + 2, ... and so owns stages c, c + 2, ... (the count a multiple of
// NC). The output goes through staging rows of its own where they fit
// beside 2·NC (or NC) stages, else through the stage's q box, whose product
// has retired.
template <int DP>
struct WinPacked {
  static constexpr int NC = 2;
  static constexpr int NBOX = WinFwdWidth<DP>::NBOX;
  static constexpr int BOX = 64 * 128;                // one 64-row box
  static constexpr int TILE = NBOX * BOX;             // q, k or v of a tile
  static constexpr int STAGE = 3 * TILE;
  static constexpr int STG = round128(64 * DP * 2);   // a consumer's staging rows
  static constexpr int BARS = 2 * 2 * NC * 8;
  static constexpr bool OWN_STG = 1024 + NC * STAGE + NC * STG + BARS <= kMaxSmem;
  static constexpr int STAGES =
      OWN_STG && 1024 + 2 * NC * STAGE + NC * STG + BARS <= kMaxSmem ? 2 * NC : NC;
  static constexpr int STG_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = STG_OFF + (OWN_STG ? NC * STG : 0);
  static constexpr int SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;
  static_assert(SMEM <= kMaxSmem, "the packed form's buffers do not fit");
};

template <int DP>
__global__ void __launch_bounds__(kWinFwdThreads, 1)
    win_fwd_packed_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv, const bf16* __restrict__ q,
                          const bf16* __restrict__ k, const bf16* __restrict__ v,
                          bf16* __restrict__ o, int R, int n, int d, int tile_rows, int tiles) {
  using L = WinPacked<DP>;
  constexpr int NBOX = L::NBOX, NO = WinFwdWidth<DP>::NO;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  const bool tma = d % 8 == 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], tma ? 1 : 128);
      mbar_init(&empty[s], L::OWN_STG ? 4 : 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer: one thread (TMA) or 128
    setmaxnreg_dec<80>();
    const int tid = threadIdx.x;
    if (tma && tid != 0) return;
    if (tma) {
      tma_prefetch(&mq);
      tma_prefetch(&mk);
      tma_prefetch(&mv);
    }
    for (int i = 0, item = blockIdx.x; item < tiles; ++i, item += gridDim.x) {
      const int s = i % L::STAGES, row0 = item * tile_rows;
      unsigned char* st = smem + s * L::STAGE;
      mbar_wait(&empty[s], ((i / L::STAGES) & 1) ^ 1);
      win_fill(&full[s], L::STAGE, tma, [&] {
        win_load<64, NBOX>(st, &mq, q, row0, R, d, &full[s], tma, tid);
        win_load<64, NBOX>(st + L::TILE, &mk, k, row0, R, d, &full[s], tma, tid);
        win_load<64, NBOX>(st + 2 * L::TILE, &mv, v, row0, R, d, &full[s], tma, tid);
      });
    }
    return;
  }
  setmaxnreg_inc<208>();  // the consumers
  const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, q4 = tid % 4;
  const int r = win_acc_row(tid);
  bf16* own = reinterpret_cast<bf16*>(smem + L::STG_OFF + c * L::STG);
  // each row sees the keys of its own window-head: columns lo .. lo + n
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lo[h] = (r + 8 * h) / n * n;
    hi[h] = lo[h] + n;
  }
  for (int i = c, item = blockIdx.x + c * gridDim.x; item < tiles;
       i += L::NC, item += L::NC * gridDim.x) {
    const int s = i % L::STAGES, row0 = item * tile_rows;
    const int live = min(tile_rows, R - row0);
    unsigned char* st = smem + s * L::STAGE;
    mbar_wait(&full[s], (i / L::STAGES) & 1);
    float sc[32];
    wgmma_fence();
    win_qk<DP, 64>(sc, st, L::BOX, st + L::TILE, L::BOX);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (n != 64) win_mask<64>(sc, lo, hi, q4);
    uint32_t p[4][4];
    win_softmax<64>(sc, p);
    float oc[NO / 2];
    wgmma_fence();
    win_pv<64, NO>(oc, p, st + 2 * L::TILE, L::BOX, false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oc);
    if constexpr (L::OWN_STG) {
      win_release(&empty[s]);
      if (tma) {
        if (tid == 0) tma_store_wait_read<0>();  // the last tile's copy has read the rows
        named_barrier_sync(1 + c, 128);
      }
      win_store<NO>(oc, own, o, row0, live, d, tma, c, tid);
    } else {
      win_store<NO>(oc, reinterpret_cast<bf16*>(st), o, row0, live, d, tma, c, tid);
      if (!tma) named_barrier_sync(1 + c, 128);
      if (tid == 0) {
        tma_store_wait_read<0>();  // the copy has read the stage's q box
        mbar_arrive(&empty[s]);
      }
    }
  }
  if (tid == 0) tma_store_wait_all();
}

// The row form, n > 64: a window-head's query tiles (rows 64 t .. 64 t + 63
// of it, QT = ceil(n / 64)) go in passes of two, consumer c taking tile
// 2 p + c of pass p from one of its two q slots. A block's work item is one
// pass, which walks the window-head's T = ceil(n / NK) key tiles (loaded
// again each pass, from L2) through a ring of k and v stages that both
// consumers read (each of their warps releases a stage). A query tile's
// output is staged in its q slot, which is handed back once the bulk copy
// has read it (after the consumer's next S is issued).
//
// The key tile: 128 keys where o takes at most 64 registers a thread (DP <=
// 128), 64 up to DP 192, 32 past it (o 112 or 128 registers). A whole tile
// of 256 keys spilled 224-772 bytes a thread (S alone takes 128 registers),
// so windows of 129-256 keys walk two tiles of 128.
template <int DP>
struct WinRowKeys {
  static constexpr int NK = DP <= 128 ? 128 : DP <= 192 ? 64 : 32;
};

template <int DP, int NK>
struct WinRows {
  static constexpr int NBOX = WinFwdWidth<DP>::NBOX;
  static constexpr int QBOX = 64 * 128, QTILE = NBOX * QBOX;
  static constexpr int KBOX = NK * 128, KTILE = NBOX * KBOX;
  static constexpr int KV_OFF = 4 * QTILE;  // two q slots a consumer
  static constexpr int STAGES_FIT = (kMaxSmem - 1024 - KV_OFF - 24 * 8) / (2 * KTILE);
  static constexpr int STAGES = STAGES_FIT < 4 ? STAGES_FIT : 4;
  static constexpr int BAR_OFF = KV_OFF + STAGES * 2 * KTILE;
  static constexpr int SMEM = 1024 + BAR_OFF + (8 + 4 * STAGES) * 8;
  static_assert(STAGES >= 1 && SMEM <= kMaxSmem, "the row form's buffers do not fit");
};

template <int DP>
__global__ void __launch_bounds__(kWinFwdThreads, 1)
    win_fwd_rows_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv, const bf16* __restrict__ q,
                        const bf16* __restrict__ k, const bf16* __restrict__ v,
                        bf16* __restrict__ o, int R, int n, int d, int bh) {
  constexpr int NK = WinRowKeys<DP>::NK;
  using L = WinRows<DP, NK>;
  constexpr int NBOX = L::NBOX, NO = WinFwdWidth<DP>::NO, S = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_empty = q_full + 4;
  uint64_t* k_full = q_empty + 4;
  uint64_t* k_empty = k_full + S;
  uint64_t* v_full = k_empty + S;
  uint64_t* v_empty = v_full + S;
  const bool tma = d % 8 == 0;
  const int QT = (n + 63) / 64, P = (QT + 1) / 2, T = (n + NK - 1) / NK, items = bh * P;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) {
      mbar_init(&q_full[i], tma ? 1 : 128);
      mbar_init(&q_empty[i], 1);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], tma ? 1 : 128);
      mbar_init(&v_full[s], tma ? 1 : 128);
      mbar_init(&k_empty[s], 8);
      mbar_init(&v_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer: one thread (TMA) or 128
    setmaxnreg_dec<80>();
    const int tid = threadIdx.x;
    if (tma && tid != 0) return;
    if (tma) {
      tma_prefetch(&mq);
      tma_prefetch(&mk);
      tma_prefetch(&mv);
    }
    int kv = 0, qn[2] = {0, 0};
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int base = item / P * n, p = item % P;
      for (int c = 0; c < 2; ++c) {
        if (2 * p + c >= QT) continue;
        const int slot = 2 * c + (qn[c] & 1);
        unsigned char* Q = smem + slot * L::QTILE;
        mbar_wait(&q_empty[slot], ((qn[c] >> 1) & 1) ^ 1);
        win_fill(&q_full[slot], L::QTILE, tma, [&] {
          win_load<64, NBOX>(Q, &mq, q, base + 64 * (2 * p + c), R, d, &q_full[slot], tma, tid);
        });
        ++qn[c];
      }
      for (int j = 0; j < T; ++j, ++kv) {
        const int s = kv % S;
        const uint32_t ph = ((kv / S) & 1) ^ 1;
        unsigned char* K = smem + L::KV_OFF + s * 2 * L::KTILE;
        mbar_wait(&k_empty[s], ph);
        win_fill(&k_full[s], L::KTILE, tma, [&] {
          win_load<NK, NBOX>(K, &mk, k, base + j * NK, R, d, &k_full[s], tma, tid);
        });
        mbar_wait(&v_empty[s], ph);
        win_fill(&v_full[s], L::KTILE, tma, [&] {
          win_load<NK, NBOX>(K + L::KTILE, &mv, v, base + j * NK, R, d, &v_full[s], tma, tid);
        });
      }
    }
    return;
  }
  setmaxnreg_inc<208>();  // the consumers
  const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, q4 = tid % 4;
  int kv = 0, qn = 0, pend = -1;  // pend: the q slot whose output copy is in flight
  for (int item = blockIdx.x; item < items; item += gridDim.x, kv += T) {
    const int base = item / P * n, qt = 2 * (item % P) + c, slot = 2 * c + (qn & 1);
    const bool have = qt < QT;
    unsigned char* Q = smem + slot * L::QTILE;
    if (have) mbar_wait(&q_full[slot], (qn >> 1) & 1);
    float oc[NO / 2];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int j = 0; j < T; ++j) {
      const int s = (kv + j) % S;
      const uint32_t ph = ((kv + j) / S) & 1;
      const unsigned char* K = smem + L::KV_OFF + s * 2 * L::KTILE;
      float sc[NK / 2];
      uint32_t pf[NK / 16][4];
      mbar_wait(&k_full[s], ph);
      if (have) {  // S = q̂·k̂ᵀ for key tile j
        wgmma_fence();
        win_qk<DP, NK>(sc, Q, L::QBOX, K, L::KBOX);
        wgmma_commit();
      }
      if (j == 0 && pend >= 0) {  // the previous tile's q slot, once its output copy has read it
        if (tid == 0) {
          tma_store_wait_read<0>();
          mbar_arrive(&q_empty[pend]);
        }
        __syncwarp();
        pend = -1;
      }
      if (have) {
        wgmma_wait<0>();
        fence_regs(sc);
        if (j * NK + NK > n) {  // keys past the window-head
          const int lo[2] = {0, 0}, hi[2] = {n - j * NK, n - j * NK};
          win_mask<NK>(sc, lo, hi, q4);
        }
      }
      win_release(&k_empty[s]);
      if (have) {
        if (T == 1)
          win_softmax<NK>(sc, pf);
        else
          win_online<NK, NO>(sc, pf, m, l, oc, j > 0);
      }
      mbar_wait(&v_full[s], ph);
      if (have) {  // o (+)= p·v
        wgmma_fence();
        win_pv<NK, NO>(oc, pf, K + L::KTILE, L::KBOX, j > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(oc);
      }
      win_release(&v_empty[s]);
    }
    if (!have) continue;
    if (T > 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = 1.0f / quad_sum(l[h]);
#pragma unroll
      for (int i = 0; i < NO / 2; ++i) oc[i] *= l[(i >> 1) & 1];
    }
    win_store<NO>(oc, reinterpret_cast<bf16*>(Q), o, (size_t)base + 64 * qt, min(64, n - 64 * qt),
                  d, tma, c, tid);
    if (tma) {
      pend = slot;
    } else {
      named_barrier_sync(1 + c, 128);
      if (tid == 0) mbar_arrive(&q_empty[slot]);
    }
    ++qn;
  }
  if (tid == 0) {
    if (pend >= 0) {
      tma_store_wait_read<0>();
      mbar_arrive(&q_empty[pend]);
    }
    tma_store_wait_all();
  }
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

// Kernel 21's launch: the form for n (the header's table), three tensor
// maps of the (BW·h·n, d) matrices where d % 8 == 0, and as many blocks as
// SMs, no more than work items (launch_persistent: the SM counts of the
// packed and the row form by DP index are kept here).
static int win_fwd_sms[2][9][64];

__host__ __device__ constexpr int win_dp_index(int DP) { return DP == 16 ? 0 : DP / 32; }

template <int DP>
int launch_win_fwd(const void* q, const void* k, const void* v, void* o, int bh, int n, int d,
                   cudaStream_t st) {
  constexpr int ID = win_dp_index(DP), NK = WinRowKeys<DP>::NK;
  const long long rows = (long long)bh * n;
  if (rows > INT_MAX) return (int)cudaErrorInvalidValue;
  const int R = (int)rows;
  const bool tma = d % 8 == 0, packed = n <= 64;
  CUtensorMap mq = {}, mk = {}, mv = {};
  const int key_rows = packed ? 64 : NK;
  if (tma && !(tensor_map_bf16(&mq, q, R, d, 64, 64) &&
               tensor_map_bf16(&mk, k, R, d, key_rows, 64) &&
               tensor_map_bf16(&mv, v, R, d, key_rows, 64)))
    return kTensorMapError;
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
  bf16* ob = (bf16*)o;
  if (packed) {
    const int g = 64 / n, tiles = (bh + g - 1) / g;
    return launch_persistent(win_fwd_packed_kernel<DP>, win_fwd_sms[0][ID], kWinFwdThreads,
                             WinPacked<DP>::SMEM, tiles, st, mq, mk, mv, qb, kb, vb, ob, R, n, d,
                             g * n, tiles);
  }
  const int P = ((n + 63) / 64 + 1) / 2;  // passes of a window-head
  return launch_persistent(win_fwd_rows_kernel<DP>, win_fwd_sms[1][ID], kWinFwdThreads,
                           WinRows<DP, NK>::SMEM, bh * P, st, mq, mk, mv, qb, kb, vb, ob, R, n,
                           d, bh);
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
