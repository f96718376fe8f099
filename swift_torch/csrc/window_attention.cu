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
// Kernel 22b runs on the same pieces. It forms the TPU kernel's p =
// softmax(q̂·k̂ᵀ) normalised in fp32, dv = bf16(p)ᵀ·do, dp = do·vᵀ, D = Σ p·dp
// from the fp32 p, dS = p (dp − D) in fp32, and dq̂ = bf16(dS)·k̂ and dk̂ =
// bf16(dS)ᵀ·q̂, every product accumulated in fp32; D is never taken as
// rowsum(do ∘ o), whose bf16 o would move the rounding point. What bounds it
// on the H100: it reads q̂, k̂, v, do and writes dq̂, dk̂, dv, 7 (BW·h·n·d)
// bf16 tensors, for 10 n² d flops a window-head: 5n/7 flops a byte, 46 at n
// = 64 (path B) and 183 at n = 256 (path C), so the bytes; at n = 1024 the
// operations. No float atomics and one order of every sum: two calls give
// the same bits. The forms:
//
//   n <= 64, DP <= 128  packed (win_bwd_packed_kernel): kernel 21's tiles of
//                       G = floor(64 / n) whole window-heads, with q̂, k̂, v
//                       and do in one stage of a ring (3 stages at DP 96-128,
//                       6 below: a stage of four tensors is 64 KB at DP 128
//                       and would be 128 KB at DP 256, where the form stops).
//                       A consumer forms S and dp as two m64n64 accumulators
//                       (S masked block-diagonally), p, D and dS in registers,
//                       dq̂ with dS as A fragments and k̂ read MN-major, and,
//                       from bf16 p and dS written into its own swizzled 64 x
//                       64 tiles, dv = pᵀ·do and dk̂ = dSᵀ·q̂ with A read
//                       MN-major (the transpose flags): 5 products, each
//                       tensor read or written once, no scratch. Masked p and
//                       dS are exactly 0, so the transposed products sum
//                       within a window-head. Outputs go out as kernel 21's:
//                       staging rows (here the stage's k̂, do and q̂ tiles as
//                       their last product retires), one bulk copy of the
//                       live rows each.
//   n > 64, or DP > 128  rows: two launches, the scratch 12 bytes a query row
//                       (each row's max, 1 / Σ e and D, 64 rows a query
//                       tile). The query pass (win_bwd_q_kernel) takes kernel
//                       21's row form: a work item is a pass of two query
//                       tiles (q̂ and do in a consumer's slot) over the
//                       window-head's key tiles of NK keys (128 at DP <= 128,
//                       else 64, 32 past DP 192). One tile (n <= NK): whole
//                       rows of S and dp in registers, one walk of 3
//                       products. More: a statistics walk (S, dp: the running
//                       max, Σ e and Σ e·dp), then a walk that forms p, dS
//                       and dq̂ in slices of 64 keys (S and dp of 128 keys
//                       beside dq̂ would take 192 registers). The key pass
//                       (win_bwd_kv_kernel) is kernel 16's: a work item owns
//                       64 keys a consumer and walks the query tiles, Sᵀ =
//                       k̂·q̂ᵀ, pᵀ from the statistics, dpᵀ = v·doᵀ, dv and dk̂
//                       fp32 sums in registers (4 products a step), and from
//                       DP 128, where both sums do not fit a consumer's
//                       registers, the same 64 keys in both consumers, dv in
//                       one and dk̂ in the other (5 a step).
//
// It departs from kernel 21's forms in the packed stage (do beside q̂, k̂ and
// v, and fewer stages), in one q̂/do slot a consumer in the query pass (two
// of q̂ and do would leave one key stage at DP 128), and in the key pass,
// which kernel 21 has no need of. The key pass's p comes from another wgmma
// orientation and exp(S − m) / Σ e, so it may differ from the query pass's
// in the last bit.
//
// Kernel 22t runs on the same pieces. It forms the TPU kernel's p =
// softmax(q̂·k̂ᵀ) normalised in fp32, dS = dq̂·k̂ᵀ + q̂·dk̂ᵀ (two products into
// one fp32 accumulator), E = Σ p·dS and dP = p (dS − E) in fp32, and do =
// bf16(dP)·v + bf16(p)·dv (two products into one accumulator). What bounds
// it: it reads q̂, k̂, v, dq̂, dk̂, dv and writes do, 7 (BW·h·n·d) bf16
// tensors, for 10 n² d flops a window-head, as 22b: the bytes at n = 64 and
// 256, the operations at n = 1024. No atomics, one order of every sum. The
// forms:
//
//   n <= 64, DP <= 128  packed (win_tan_packed_kernel): kernel 21's tiles of
//                       G = floor(64 / n) whole window-heads with the six
//                       inputs in one stage of a ring (2 stages of 96 KB at
//                       DP 96-128, 4 below), the output through staging rows
//                       of each consumer's own, so a stage goes back as soon
//                       as its last product retires. A consumer forms S and dS
//                       as two m64n64 accumulators (S masked block-
//                       diagonally), p, E and dP in registers, and do from p
//                       and dP as A fragments with v and dv read MN-major: the
//                       TPU kernel's 5 products, each tensor read once.
//   n > 64, or DP > 128  rows (win_tan_rows_kernel): kernel 21's row form with
//                       22b's query pass: a work item is a pass of two query
//                       tiles of a window-head (q̂ and dq̂ in a consumer's
//                       slot) over its key tiles of NK keys (64 at DP <= 128,
//                       32 to DP 192, 16 past it: S and dS of NK keys beside
//                       the fp32 o, within ptxas's 168 registers a thread),
//                       which come as two halves, (k̂, dk̂) and (v, dv), through
//                       one ring both consumers read. One key tile (n <= NK):
//                       one walk of 5 products. More: a statistics walk over
//                       the (k̂, dk̂) halves (S, dS: the running max, Σ e and
//                       Σ e·dS), then a walk over both halves that forms p =
//                       exp(S − m) / Σ e and dP in fp32, rounds both and adds
//                       their products to do: 8 products, the TPU kernel's
//                       rounding points (the one-walk identity do = (Σ e·dS·v
//                       + Σ e·dv − E·Σ e·v) / Σ e would round e·dS where the
//                       TPU rounds dP).
//
// All three kernels take any n >= 1 and d <= 256; q̂, k̂, v, do and the
// tangents contiguous and 16-byte aligned.
#include <climits>
#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace swift {

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

// Whole rows of a 64 x N logit tile in registers turned in place into p =
// e / Σe in fp32 (rounded to bf16 only as an operand, later); each row's max
// m (of the logits) and 1 / Σe for rows r and r + 8.
template <int N>
__device__ __forceinline__ void win_probs(float (&s)[N / 2], float (&m)[2], float (&il)[2]) {
  float l[2] = {0.f, 0.f}, ms[2];
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = quad_max(m[h]);
    ms[h] = m[h] * kWinLog2e;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    s[i] = exp2f(fmaf(s[i], kWinLog2e, -ms[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) il[h] = 1.0f / quad_sum(l[h]);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] *= il[(i >> 1) & 1];
}

// A 64 x N accumulator rounded to bf16 as the A fragments of its N/16 k16
// slices (wgmma_m64nNk16_rs's layout).
template <int N>
__device__ __forceinline__ void win_frags(const float (&x)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[k][q] = pack_bf16x2(x[8 * k + 2 * q], x[8 * k + 2 * q + 1]);
}

// The softmax of whole rows of a 64 x N logit tile in registers: p = e / Σe
// normalised in fp32 before it is rounded to bf16 (the TPU kernel's rounding
// point), as the A fragments of the N/16 k16 slices of p·v (the m64nN
// accumulator's layout is theirs).
template <int N>
__device__ __forceinline__ void win_softmax(float (&s)[N / 2], uint32_t (&p)[N / 16][4]) {
  float m[2], il[2];
  win_probs<N>(s, m, il);
  win_frags<N>(s, p);
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
// tile·G·n .. + G·n of the (BW·h·n, d) matrices), each with its NT inputs (q,
// k and v; for kernel 22t also their tangents) in one stage of a ring;
// consumer c of NC = 2 takes the block's tiles c, c + 2, ... and so owns
// stages c, c + 2, ... (the count a multiple of NC). The output goes through
// staging rows of its own where they fit beside 2·NC (or NC) stages, else
// through the stage's q box, whose product has retired.
template <int DP, int NT = 3>
struct WinPacked {
  static constexpr int NC = 2;
  static constexpr int NBOX = WinFwdWidth<DP>::NBOX;
  static constexpr int BOX = 64 * 128;                // one 64-row box
  static constexpr int TILE = NBOX * BOX;             // one input of a tile
  static constexpr int STAGE = NT * TILE;
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
// Kernel 22b on wgmma: (dq̂, dk̂, dv) of kernel 21 (the forms are in the header).

// dS = p (dp − D) of whole rows, D = Σ p·dp in fp32 from the fp32 p (quad
// shuffles), written over dp; D returned for rows r and r + 8. Where p is 0
// (a masked key), dS is 0.
template <int N>
__device__ __forceinline__ void win_ds(const float (&p)[N / 2], float (&dp)[N / 2], float (&D)[2]) {
  float a[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[(i >> 1) & 1] += p[i] * dp[i];
#pragma unroll
  for (int h = 0; h < 2; ++h) D[h] = quad_sum(a[h]);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dp[i] = p[i] * (dp[i] - D[(i >> 1) & 1]);
}

// A 64 x 64 accumulator rounded to bf16 into ``tile`` as TMA's 128-byte
// swizzle lays a 64-column box (row i at i·128 bytes, 16-byte chunk j at
// (j ^ (i % 8))·16): its rows are K, its columns M of the transposed A that
// wgmma_desc_mn_a reads.
__device__ __forceinline__ void win_tile_store(unsigned char* tile, const float (&x)[32], int tid) {
  const int r = win_acc_row(tid), q4 = tid % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(tile + (r + 8 * h) * 128 + ((j ^ (r % 8)) << 4) + q4 * 4) =
          pack_bf16x2(x[4 * j + 2 * h], x[4 * j + 2 * h + 1]);
}

// acc = Xᵀ·Y over a tile's 64 rows: X a 64 x 64 bf16 tile (win_tile_store's
// layout) read as the transposed A, Y's NO columns read MN-major from its
// boxes (``box`` bytes apart), so the tile's columns (keys) are M and its
// rows (queries) K.
template <int NO>
__device__ __forceinline__ void win_tn(float (&acc)[NO / 2], const unsigned char* X,
                                       const unsigned char* Y, int box) {
  static_assert(NO <= 128, "one wgmma width");
  const uint64_t a = wgmma_desc_mn_a(X), b = wgmma_desc_mn(Y, box);
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma_m64nNk16<NO, 1, 1>(acc, a + 128 * k, b + 128 * k, k > 0);
}

// The packed form, n <= 64 at DP <= 128: tiles of G = 64 / n whole
// window-heads as kernel 21's, each with q̂, k̂, v and do in one stage of a
// ring that both consumers take tiles from in turn (tile i of the block to
// consumer i % 2). A consumer's p and dS tiles sit before the stages. Its
// outputs are staged in the stage's tiles as their last reader retires: dq̂
// in k̂'s, dv in do's, dk̂ in q̂'s; the stage is handed back once the bulk
// copies have read them (after the consumer's next S and dp are issued), so
// a consumer's two tiles in a row, i and i + 2, must lie in different stages:
// at least three (two stages hang).
template <int DP>
struct WinBwdPacked {
  static constexpr int NBOX = WinFwdWidth<DP>::NBOX;
  static constexpr int BOX = 64 * 128;                // one 64-row box
  static constexpr int TILE = NBOX * BOX;             // q̂, k̂, v or do of a tile
  static constexpr int STAGE = 4 * TILE;
  static constexpr int PT = 64 * 128;                 // a 64 x 64 bf16 tile of p or dS
  static constexpr int ST_OFF = 2 * 2 * PT;           // [consumer][p, dS], then the stages
  static constexpr int FIT = (kMaxSmem - 1024 - ST_OFF - 16 * 8) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int BAR_OFF = ST_OFF + STAGES * STAGE;
  static constexpr int SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;
  static_assert(DP <= 128 && STAGES >= 3 && SMEM <= kMaxSmem, "the packed backward's buffers");
};

template <int DP>
__global__ void __launch_bounds__(kWinFwdThreads, 1)
    win_bwd_packed_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mdo, const bf16* __restrict__ q,
                          const bf16* __restrict__ k, const bf16* __restrict__ v,
                          const bf16* __restrict__ dout, bf16* __restrict__ dq,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int R, int n, int d,
                          int tile_rows, int tiles) {
  using L = WinBwdPacked<DP>;
  constexpr int NBOX = L::NBOX, NO = WinFwdWidth<DP>::NO, S = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + S;
  const bool tma = d % 8 == 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], tma ? 1 : 128);
      mbar_init(&empty[s], 1);
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
      tma_prefetch(&mdo);
    }
    for (int i = 0, item = blockIdx.x; item < tiles; ++i, item += gridDim.x) {
      const int s = i % S, row0 = item * tile_rows;
      unsigned char* st = smem + L::ST_OFF + s * L::STAGE;
      mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
      win_fill(&full[s], L::STAGE, tma, [&] {
        win_load<64, NBOX>(st, &mq, q, row0, R, d, &full[s], tma, tid);
        win_load<64, NBOX>(st + L::TILE, &mk, k, row0, R, d, &full[s], tma, tid);
        win_load<64, NBOX>(st + 2 * L::TILE, &mv, v, row0, R, d, &full[s], tma, tid);
        win_load<64, NBOX>(st + 3 * L::TILE, &mdo, dout, row0, R, d, &full[s], tma, tid);
      });
    }
    return;
  }
  setmaxnreg_inc<208>();
  const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int q4 = tid % 4, r = win_acc_row(tid);
  unsigned char* P = smem + c * 2 * L::PT;
  unsigned char* DS = P + L::PT;
  int lo[2], hi[2];  // each row sees the keys of its own window-head
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lo[h] = (r + 8 * h) / n * n;
    hi[h] = lo[h] + n;
  }
  int pend = -1;  // the stage whose output copies are in flight
  for (int i = c, item = blockIdx.x + c * gridDim.x; item < tiles;
       i += 2, item += 2 * gridDim.x) {
    const int s = i % S, row0 = item * tile_rows;
    const int live = min(tile_rows, R - row0);
    unsigned char* Q = smem + L::ST_OFF + s * L::STAGE;
    unsigned char *K = Q + L::TILE, *V = Q + 2 * L::TILE, *DO = Q + 3 * L::TILE;
    mbar_wait(&full[s], (i / S) & 1);
    float sc[32], dp[32];
    wgmma_fence();
    win_qk<DP, 64>(sc, Q, L::BOX, K, L::BOX);   // S = q̂·k̂ᵀ
    win_qk<DP, 64>(dp, DO, L::BOX, V, L::BOX);  // dp = do·vᵀ
    wgmma_commit();
    if (pend >= 0) {  // the previous tile's stage, once its output copies have read it
      if (tid == 0) {
        tma_store_wait_read<0>();
        mbar_arrive(&empty[pend]);
      }
      pend = -1;
    }
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    if (n != 64) win_mask<64>(sc, lo, hi, q4);
    float m[2], il[2], D[2];
    win_probs<64>(sc, m, il);
    win_ds<64>(sc, dp, D);
    uint32_t a[4][4];
    win_frags<64>(dp, a);
    win_tile_store(P, sc, tid);
    win_tile_store(DS, dp, tid);
    fence_async_smem();
    named_barrier_sync(1 + c, 128);  // p and dS in place for the transposed products
    float oq[NO / 2], ov[NO / 2], ok[NO / 2];
    wgmma_fence();
    win_pv<64, NO>(oq, a, K, L::BOX, false);  // dq̂ = bf16(dS)·k̂
    wgmma_commit();
    win_tn<NO>(ov, P, DO, L::BOX);  // dv = bf16(p)ᵀ·do
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(oq);
    win_store<NO>(oq, reinterpret_cast<bf16*>(K), dq, row0, live, d, tma, c, tid);
    wgmma_fence();
    win_tn<NO>(ok, DS, Q, L::BOX);  // dk̂ = bf16(dS)ᵀ·q̂
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(ov);
    win_store<NO>(ov, reinterpret_cast<bf16*>(DO), dv, row0, live, d, tma, c, tid);
    wgmma_wait<0>();
    fence_regs(ok);
    win_store<NO>(ok, reinterpret_cast<bf16*>(Q), dk, row0, live, d, tma, c, tid);
    if (tma) {
      pend = s;
    } else {
      named_barrier_sync(1 + c, 128);
      if (tid == 0) mbar_arrive(&empty[s]);
    }
  }
  if (tid == 0) {
    if (pend >= 0) {
      tma_store_wait_read<0>();
      mbar_arrive(&empty[pend]);
    }
    tma_store_wait_all();
  }
}

// The query pass of the row form (n > 64, or DP > 128): a work item is one
// pass of two query tiles of a window-head (consumer c takes tile 2 p + c,
// its q̂ and do in its slot), which walks the window-head's T = ceil(n / NK)
// key tiles of k̂ and v through a ring that both consumers read. T = 1: S
// and dp of whole rows in registers, p normalised, dS and dq̂ in one walk.
// T > 1: a statistics walk (S and dp: the running max, Σ e and Σ e·dp),
// then a walk that forms p, dS and dq̂ in key slices of KW. Each query row's
// max, 1 / Σ e and D go to the scratch, 64 rows of each a query tile, for
// the key pass; dq̂ is staged in the slot's q̂ tile.
template <int DP>
struct WinBwdQ {
  static constexpr int NK = DP <= 128 ? 128 : (DP <= 192 ? 64 : 32);  // keys a stage holds
  static constexpr int KW = NK < 64 ? NK : 64;  // keys a product of the second walk takes
  static constexpr int NBOX = WinFwdWidth<DP>::NBOX;
  static constexpr int BOX = 64 * 128, TILE = NBOX * BOX;   // 64 query rows
  static constexpr int KBOX = NK * 128, KTILE = NBOX * KBOX;
  static constexpr int SLOT = 2 * TILE;  // a consumer's q̂, then do
  static constexpr int KV_OFF = 2 * SLOT;
  static constexpr int STAGE = 2 * KTILE;  // k̂, then v
  static constexpr int FIT = (kMaxSmem - 1024 - KV_OFF - 16 * 8) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int BAR_OFF = KV_OFF + STAGES * STAGE;
  static constexpr int SMEM = 1024 + BAR_OFF + (4 + 2 * STAGES) * 8;
  static_assert(STAGES >= 2 && SMEM <= kMaxSmem, "the query pass's buffers do not fit");
};

// The statistics walk's update from one key tile: each row's running max m,
// this thread's shares of Σ e (l) and Σ e·dp (x), rescaled by exp(m_old −
// m_new) (0 on the first tile).
template <int N>
__device__ __forceinline__ void win_stats(const float (&s)[N / 2], const float (&dp)[N / 2],
                                          float (&m)[2], float (&l)[2], float (&x)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    const float alpha = exp2f((m[h] - mx[h]) * kWinLog2e);
    l[h] *= alpha;
    x[h] *= alpha;
    m[h] = mx[h];
    mx[h] *= kWinLog2e;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float e = exp2f(fmaf(s[i], kWinLog2e, -mx[(i >> 1) & 1]));
    l[(i >> 1) & 1] += e;
    x[(i >> 1) & 1] += e * dp[i];
  }
}

// The second walk's dS = p (dp − D), p = exp(s − m) / Σ e from the rows'
// statistics, 0 for keys at or past ``kn``; written over dp.
template <int N>
__device__ __forceinline__ void win_grad(const float (&s)[N / 2], float (&dp)[N / 2],
                                         const float (&m)[2], const float (&il)[2],
                                         const float (&D)[2], int kn, int q4) {
  const float ms[2] = {m[0] * kWinLog2e, m[1] * kWinLog2e};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int col = 8 * (i >> 2) + 2 * q4 + (i & 1), h = (i >> 1) & 1;
    const float p = col < kn ? exp2f(fmaf(s[i], kWinLog2e, -ms[h])) * il[h] : 0.0f;
    dp[i] = p * (dp[i] - D[h]);
  }
}

template <int DP>
__global__ void __launch_bounds__(kWinFwdThreads, 1)
    win_bwd_q_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mdo, const bf16* __restrict__ q,
                     const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ dout, bf16* __restrict__ dq,
                     float* __restrict__ stats, int R, int n, int d, int bh) {
  using L = WinBwdQ<DP>;
  constexpr int NK = L::NK, KW = L::KW, NBOX = L::NBOX, NO = WinFwdWidth<DP>::NO;
  constexpr int S = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* k_empty = k_full + S;
  const bool tma = d % 8 == 0;
  const int QT = (n + 63) / 64, P = (QT + 1) / 2, T = (n + NK - 1) / NK, W = T > 1 ? 2 : 1;
  const int items = bh * P;
  if (threadIdx.x == 0) {
    for (int c = 0; c < 2; ++c) {
      mbar_init(&q_full[c], tma ? 1 : 128);
      mbar_init(&q_empty[c], 1);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], tma ? 1 : 128);
      mbar_init(&k_empty[s], 8);
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
      tma_prefetch(&mdo);
      tma_prefetch(&mk);
      tma_prefetch(&mv);
    }
    int kv = 0, qn[2] = {0, 0};
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int base = item / P * n, p = item % P;
      for (int c = 0; c < 2; ++c) {
        if (2 * p + c >= QT) continue;
        const int row = base + 64 * (2 * p + c);
        unsigned char* Qs = smem + c * L::SLOT;
        mbar_wait(&q_empty[c], (qn[c]++ & 1) ^ 1);
        win_fill(&q_full[c], L::SLOT, tma, [&] {
          win_load<64, NBOX>(Qs, &mq, q, row, R, d, &q_full[c], tma, tid);
          win_load<64, NBOX>(Qs + L::TILE, &mdo, dout, row, R, d, &q_full[c], tma, tid);
        });
      }
      for (int w = 0; w < W; ++w)
        for (int j = 0; j < T; ++j, ++kv) {
          const int s = kv % S;
          unsigned char* Kt = smem + L::KV_OFF + s * L::STAGE;
          mbar_wait(&k_empty[s], ((kv / S) & 1) ^ 1);
          win_fill(&k_full[s], L::STAGE, tma, [&] {
            win_load<NK, NBOX>(Kt, &mk, k, base + j * NK, R, d, &k_full[s], tma, tid);
            win_load<NK, NBOX>(Kt + L::KTILE, &mv, v, base + j * NK, R, d, &k_full[s], tma, tid);
          });
        }
    }
    return;
  }
  setmaxnreg_inc<208>();
  const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int q4 = tid % 4, r = win_acc_row(tid);
  unsigned char* Qs = smem + c * L::SLOT;
  const unsigned char* DOs = Qs + L::TILE;
  int kv = 0, qn = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, kv += W * T) {
    const int wh = item / P, qt = 2 * (item % P) + c;
    const bool have = qt < QT;
    if (have) mbar_wait(&q_full[c], qn & 1);
    float oq[NO / 2], m[2], il[2], D[2];
    auto stage = [&](int j) {  // the key tile of the walks' j-th stage, once it has landed
      const int s = (kv + j) % S;
      mbar_wait(&k_full[s], ((kv + j) / S) & 1);
      return s;
    };
    // each group of products is issued and waited for within one block: a
    // wgmma in flight across a branch sends its registers to local memory
    if (T == 1) {  // one walk: whole rows of S and dp
      const int s = stage(0);
      const unsigned char* Kt = smem + L::KV_OFF + s * L::STAGE;
      if (have) {
        float sc[NK / 2], dp[NK / 2];
        wgmma_fence();
        win_qk<DP, NK>(sc, Qs, L::BOX, Kt, L::KBOX);
        win_qk<DP, NK>(dp, DOs, L::BOX, Kt + L::KTILE, L::KBOX);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        if (n < NK) {
          const int lo[2] = {0, 0}, hi[2] = {n, n};
          win_mask<NK>(sc, lo, hi, q4);
        }
        win_probs<NK>(sc, m, il);
        win_ds<NK>(sc, dp, D);
        uint32_t a[NK / 16][4];
        win_frags<NK>(dp, a);
        wgmma_fence();
        win_pv<NK, NO>(oq, a, Kt, L::KBOX, false);  // dq̂ = bf16(dS)·k̂
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(oq);
      }
      win_release(&k_empty[s]);
    } else {
      float l[2] = {0.f, 0.f}, x[2] = {0.f, 0.f};
      m[0] = m[1] = -INFINITY;
      for (int j = 0; j < T; ++j) {  // the statistics
        const int s = stage(j);
        const unsigned char* Kt = smem + L::KV_OFF + s * L::STAGE;
        if (have) {
          float sc[NK / 2], dp[NK / 2];
          wgmma_fence();
          win_qk<DP, NK>(sc, Qs, L::BOX, Kt, L::KBOX);
          win_qk<DP, NK>(dp, DOs, L::BOX, Kt + L::KTILE, L::KBOX);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(dp);
          win_release(&k_empty[s]);  // S and dp are in registers
          if (j * NK + NK > n) {  // keys past the window-head
            const int lo[2] = {0, 0}, hi[2] = {n - j * NK, n - j * NK};
            win_mask<NK>(sc, lo, hi, q4);
          }
          win_stats<NK>(sc, dp, m, l, x);
        } else {
          win_release(&k_empty[s]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sum = quad_sum(l[h]);
        il[h] = 1.0f / sum;
        D[h] = quad_sum(x[h]) / sum;
      }
      for (int j = 0; j < T; ++j) {  // p, dS and dq̂
        const int s = stage(T + j);
        const unsigned char* Kt = smem + L::KV_OFF + s * L::STAGE;
#pragma unroll 1
        for (int sub = 0; sub < NK / KW && j * NK + sub * KW < n; ++sub) {
          const unsigned char* Ks = Kt + sub * KW * 128;
          if (have) {
            float sc[KW / 2], dp[KW / 2];
            wgmma_fence();
            win_qk<DP, KW>(sc, Qs, L::BOX, Ks, L::KBOX);
            win_qk<DP, KW>(dp, DOs, L::BOX, Ks + L::KTILE, L::KBOX);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sc);
            fence_regs(dp);
            win_grad<KW>(sc, dp, m, il, D, n - j * NK - sub * KW, q4);
            uint32_t a[KW / 16][4];
            win_frags<KW>(dp, a);
            wgmma_fence();
            win_pv<KW, NO>(oq, a, Ks, L::KBOX, j > 0 || sub > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(oq);
          }
        }
        win_release(&k_empty[s]);
      }
    }
    if (!have) continue;
    float* st = stats + ((size_t)wh * QT + qt) * 3 * 64;  // [m, 1/Σe, D][64]
    if (q4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        st[r + 8 * h] = m[h];
        st[64 + r + 8 * h] = il[h];
        st[128 + r + 8 * h] = D[h];
      }
    }
    win_store<NO>(oq, reinterpret_cast<bf16*>(Qs), dq, (size_t)wh * n + 64 * qt,
                  min(64, n - 64 * qt), d, tma, c, tid);
    if (!tma) named_barrier_sync(1 + c, 128);
    if (tid == 0) {
      tma_store_wait_read<0>();  // the copy has read the slot
      mbar_arrive(&q_empty[c]);
    }
    ++qn;
  }
  if (tid == 0) tma_store_wait_all();
}

// The key pass of the row form, kernel 16's design without its normalise: a
// work item owns KEYS keys of a window-head, k̂ and v in one of two buffers,
// and walks the window-head's query tiles through a ring of stages (q̂, do
// and the rows' statistics) that both consumers read. Each step forms
// Sᵀ = k̂·q̂ᵀ (keys as M) and pᵀ = exp(Sᵀ − m) / Σ e from the statistics,
// 0 for queries past n, and adds dv += bf16(pᵀ)·do and, with dpᵀ = v·doᵀ,
// dk̂ += bf16(pᵀ (dpᵀ − D))·q̂: A from registers, do and q̂ read MN-major, the
// sums fp32 in registers across the walk. Where DP < 128 a consumer owns 64
// keys and both sums (4 products a step); from DP 128 both consumers take
// the same 64 keys, consumer 0 dv and consumer 1 dk̂ (5 products a step, Sᵀ
// twice): both sums with Sᵀ and dpᵀ would take 192 registers. The outputs
// are staged in the item's k̂ and v tiles, and the buffer is handed back once
// the copies have read them (after the next item's first step).
template <int DP>
struct WinBwdKV {
  static constexpr bool SPLIT = DP >= 128;
  static constexpr int KEYS = SPLIT ? 64 : 128;
  static constexpr int NBOX = WinFwdWidth<DP>::NBOX;
  static constexpr int BOX = 64 * 128, TILE = NBOX * BOX;  // 64 rows
  static constexpr int KV = 2 * (KEYS / 64) * TILE;        // k̂ tiles, then v tiles
  static constexpr int STATS = 3 * 64 * 4;
  static constexpr int STAGE = 2 * TILE + 1024;            // q̂, do, the statistics
  static constexpr int ST_OFF = 2 * KV;
  static constexpr int FIT = (kMaxSmem - 1024 - ST_OFF - 16 * 8) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int BAR_OFF = ST_OFF + STAGES * STAGE;
  static constexpr int SMEM = 1024 + BAR_OFF + (4 + 2 * STAGES) * 8;
  static_assert(STAGES >= 1 && SMEM <= kMaxSmem, "the key pass's buffers do not fit");
};

// One step of the key pass (DV: dv, DK: dk̂) over a stage's 64 queries, ``qn``
// of them live.
template <int DP, bool DV, bool DK, int NO = WinFwdWidth<DP>::NO>
__device__ __forceinline__ void win_kv_step(float (&av)[NO / 2], float (&ak)[NO / 2],
                                            const unsigned char* Kc, const unsigned char* Vc,
                                            const unsigned char* st, int qn, int q4) {
  using L = WinBwdKV<DP>;
  const unsigned char* Q = st;
  const unsigned char* DO = st + L::TILE;
  const float* sm = reinterpret_cast<const float*>(st + 2 * L::TILE);  // [m, 1/Σe, D][64]
  float s[32], dp[DK ? 32 : 1];
  wgmma_fence();
  win_qk<DP, 64>(s, Kc, L::BOX, Q, L::BOX);                       // Sᵀ = k̂·q̂ᵀ
  if constexpr (DK) win_qk<DP, 64>(dp, Vc, L::BOX, DO, L::BOX);  // dpᵀ = v·doᵀ
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  if constexpr (DK) fence_regs(dp);
  // s[8 k + 2 q + e] is query 16 k + 8 (q / 2) + 2 q4 + e of the A fragments' k16 slice k
  uint32_t ap[DV ? 4 : 1][4], ad[DK ? 4 : 1][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int i = 8 * kk + 2 * qq, col = 16 * kk + 8 * (qq >> 1) + 2 * q4;
      const float2 m = *reinterpret_cast<const float2*>(sm + col);
      const float2 il = *reinterpret_cast<const float2*>(sm + 64 + col);
      const float p0 =
          col < qn ? exp2f(fmaf(s[i], kWinLog2e, -m.x * kWinLog2e)) * il.x : 0.0f;
      const float p1 =
          col + 1 < qn ? exp2f(fmaf(s[i + 1], kWinLog2e, -m.y * kWinLog2e)) * il.y : 0.0f;
      if constexpr (DV) ap[kk][qq] = pack_bf16x2(p0, p1);
      if constexpr (DK) {
        const float2 D = *reinterpret_cast<const float2*>(sm + 128 + col);
        ad[kk][qq] = pack_bf16x2(p0 * (dp[i] - D.x), p1 * (dp[i + 1] - D.y));
      }
    }
  wgmma_fence();
  if constexpr (DV) win_pv<64, NO>(av, ap, DO, L::BOX, true);  // dv += bf16(pᵀ)·do
  if constexpr (DK) win_pv<64, NO>(ak, ad, Q, L::BOX, true);   // dk̂ += bf16(dSᵀ)·q̂
  wgmma_commit();
  wgmma_wait<0>();
  if constexpr (DV) fence_regs(av);
  if constexpr (DK) fence_regs(ak);
}

template <int DP>
__global__ void __launch_bounds__(kWinFwdThreads, 1)
    win_bwd_kv_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mdo, const bf16* __restrict__ q,
                      const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const bf16* __restrict__ dout, const float* __restrict__ stats,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int R, int n, int d, int bh) {
  using L = WinBwdKV<DP>;
  constexpr int NBOX = L::NBOX, NO = WinFwdWidth<DP>::NO, S = L::STAGES, HALVES = L::KEYS / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* kv_empty = kv_full + 2;
  uint64_t* full = kv_empty + 2;
  uint64_t* empty = full + S;
  const bool tma = d % 8 == 0;
  const int QT = (n + 63) / 64, G = (n + L::KEYS - 1) / L::KEYS, items = bh * G;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&kv_full[b], tma ? 1 : 128);
      mbar_init(&kv_empty[b], 2);  // each consumer, once its copies have read the buffer
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], tma ? 1 : 128);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer: one thread (TMA) or 128
    setmaxnreg_dec<80>();
    const int tid = threadIdx.x;
    if (tma && tid != 0) return;
    if (tma) {
      tma_prefetch(&mk);
      tma_prefetch(&mv);
      tma_prefetch(&mq);
      tma_prefetch(&mdo);
    }
    int qs = 0;
    for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
      const int wh = item / G, base = wh * n, key0 = base + item % G * L::KEYS, b = it & 1;
      unsigned char* Kb = smem + b * L::KV;
      mbar_wait(&kv_empty[b], ((it >> 1) & 1) ^ 1);
      win_fill(&kv_full[b], L::KV, tma, [&] {
        for (int h = 0; h < HALVES; ++h) {
          win_load<64, NBOX>(Kb + h * L::TILE, &mk, k, key0 + 64 * h, R, d, &kv_full[b], tma, tid);
          win_load<64, NBOX>(Kb + (HALVES + h) * L::TILE, &mv, v, key0 + 64 * h, R, d,
                             &kv_full[b], tma, tid);
        }
      });
      for (int qt = 0; qt < QT; ++qt, ++qs) {
        const int s = qs % S;
        unsigned char* st = smem + L::ST_OFF + s * L::STAGE;
        const float* src = stats + ((size_t)wh * QT + qt) * 3 * 64;
        mbar_wait(&empty[s], ((qs / S) & 1) ^ 1);
        win_fill(&full[s], 2 * L::TILE + L::STATS, tma, [&] {
          win_load<64, NBOX>(st, &mq, q, base + 64 * qt, R, d, &full[s], tma, tid);
          win_load<64, NBOX>(st + L::TILE, &mdo, dout, base + 64 * qt, R, d, &full[s], tma, tid);
          float* dst = reinterpret_cast<float*>(st + 2 * L::TILE);
          if (tma)
            bulk_load(dst, src, L::STATS, &full[s]);
          else
            for (int i = tid; i < 3 * 64; i += 128) dst[i] = src[i];
        });
      }
    }
    return;
  }
  setmaxnreg_inc<208>();
  const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, q4 = tid % 4;
  int qs = 0, pend = -1;  // pend: the buffer whose output copies are in flight
  for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
    const int wh = item / G, b = it & 1;
    const int kr0 = item % G * L::KEYS + (L::SPLIT ? 0 : 64 * c);  // the consumer's first key
    unsigned char* Kc = smem + b * L::KV + (L::SPLIT ? 0 : c * L::TILE);
    unsigned char* Vc = Kc + HALVES * L::TILE;
    const bool keys = kr0 < n;
    mbar_wait(&kv_full[b], (it >> 1) & 1);
    float a0[NO / 2], a1[L::SPLIT ? 1 : NO / 2];
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) a0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (L::SPLIT ? 1 : NO / 2); ++i) a1[i] = 0.f;
#pragma unroll 1
    for (int qt = 0; qt < QT; ++qt, ++qs) {
      const int s = qs % S;
      const unsigned char* st = smem + L::ST_OFF + s * L::STAGE;
      mbar_wait(&full[s], (qs / S) & 1);
      if (keys) {
        const int qn = n - 64 * qt;
        if constexpr (!L::SPLIT)
          win_kv_step<DP, true, true>(a0, a1, Kc, Vc, st, qn, q4);
        else if (c == 0)
          win_kv_step<DP, true, false>(a0, a0, Kc, Vc, st, qn, q4);
        else
          win_kv_step<DP, false, true>(a0, a0, Kc, Vc, st, qn, q4);
      }
      win_release(&empty[s]);
      if (pend >= 0) {  // the previous item's buffer, once its output copies have read it
        if (tid == 0) {
          tma_store_wait_read<0>();
          mbar_arrive(&kv_empty[pend]);
        }
        pend = -1;
      }
    }
    if constexpr (L::SPLIT) named_barrier_sync(5, 256);  // both consumers are past k̂ and v
    const int live = min(64, n - kr0);
    const size_t row0 = (size_t)wh * n + kr0;
    if (keys) {
      if constexpr (L::SPLIT) {
        if (c == 0)
          win_store<NO>(a0, reinterpret_cast<bf16*>(Vc), dv, row0, live, d, tma, c, tid);
        else
          win_store<NO>(a0, reinterpret_cast<bf16*>(Kc), dk, row0, live, d, tma, c, tid);
      } else {
        win_store<NO>(a0, reinterpret_cast<bf16*>(Vc), dv, row0, live, d, tma, c, tid);
        win_store<NO>(a1, reinterpret_cast<bf16*>(Kc), dk, row0, live, d, tma, c, tid);
      }
    }
    if (tma) {
      pend = b;
    } else {
      named_barrier_sync(1 + c, 128);
      if (tid == 0) mbar_arrive(&kv_empty[b]);
    }
  }
  if (tid == 0) {
    if (pend >= 0) {
      tma_store_wait_read<0>();
      mbar_arrive(&kv_empty[pend]);
    }
    tma_store_wait_all();
  }
}

// ---------------------------------------------------------------------------
// Kernel 22t on wgmma: the tangent of kernel 21 (the forms are in the header).

// S = q̂·k̂ᵀ and dS = q̂·dk̂ᵀ + dq̂·k̂ᵀ of a 64-row query tile against N keys,
// both into registers as one wgmma group (the caller commits it): q̂ and dq̂
// tiles ``qbox``, k̂ and dk̂ tiles ``kbox`` bytes a box. The three products
// step through the k16 slices together, so that each slice's descriptors
// die with it: as three chains in turn, q̂'s stayed live across the others'
// and the row form spilled at DP 256.
template <int DP, int N>
__device__ __forceinline__ void win_tan_logits(float (&s)[N / 2], float (&ds)[N / 2],
                                               const unsigned char* Q, const unsigned char* DQ,
                                               int qbox, const unsigned char* K,
                                               const unsigned char* DK, int kbox) {
#pragma unroll
  for (int k = 0; k < DP / 16; ++k) {
    const int qo = (k / 4) * qbox, ko = (k / 4) * kbox, step = 2 * (k % 4);
    const uint64_t q = wgmma_desc(Q + qo) + step, kd = wgmma_desc(K + ko) + step;
    wgmma_m64nNk16<N>(s, q, kd, k > 0);
    wgmma_m64nNk16<N>(ds, q, wgmma_desc(DK + ko) + step, k > 0);
    wgmma_m64nNk16<N>(ds, wgmma_desc(DQ + qo) + step, kd, 1);
  }
}

// Whole rows of S and dS in registers turned into p = e / Σe and dP = p (dS −
// Σ p·dS), both in fp32 (the TPU kernel's rounding points), then rounded to
// bf16 as the A fragments of o's products.
template <int N>
__device__ __forceinline__ void win_tan_whole(float (&s)[N / 2], float (&ds)[N / 2],
                                              uint32_t (&pf)[N / 16][4],
                                              uint32_t (&df)[N / 16][4]) {
  float m[2], il[2], E[2];
  win_probs<N>(s, m, il);
  win_ds<N>(s, ds, E);
  win_frags<N>(s, pf);
  win_frags<N>(ds, df);
}

// The second walk's p = exp(s − m) / Σ e from the rows' statistics (0 for
// keys at or past ``kn``) and dP = p (dS − E), in fp32, each pair rounded to
// bf16 as it is formed (A fragments of o's products).
template <int N>
__device__ __forceinline__ void win_tan_slice(const float (&s)[N / 2], const float (&ds)[N / 2],
                                              const float (&m)[2], const float (&il)[2],
                                              const float (&E)[2], int kn, int q4,
                                              uint32_t (&pf)[N / 16][4],
                                              uint32_t (&df)[N / 16][4]) {
  const float ms[2] = {m[0] * kWinLog2e, m[1] * kWinLog2e};
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 8 * k + 2 * q, h = q & 1, col = 16 * k + 8 * (q >> 1) + 2 * q4;
      const float p0 = col < kn ? exp2f(fmaf(s[i], kWinLog2e, -ms[h])) * il[h] : 0.0f;
      const float p1 = col + 1 < kn ? exp2f(fmaf(s[i + 1], kWinLog2e, -ms[h])) * il[h] : 0.0f;
      pf[k][q] = pack_bf16x2(p0, p1);
      df[k][q] = pack_bf16x2(p0 * (ds[i] - E[h]), p1 * (ds[i + 1] - E[h]));
    }
}

// o (+)= bf16(dP)·v + bf16(p)·dv over a key tile's N/16 k16 slices, v and dv
// read MN-major from their boxes (``box`` bytes apart).
template <int N, int NO>
__device__ __forceinline__ void win_tan_out(float (&o)[NO / 2], const uint32_t (&pf)[N / 16][4],
                                            const uint32_t (&df)[N / 16][4],
                                            const unsigned char* V, const unsigned char* DV,
                                            int box, bool accumulate) {
  win_pv<N, NO>(o, df, V, box, accumulate);
  win_pv<N, NO>(o, pf, DV, box, true);
}

// The packed form, n <= 64 at DP <= 128: kernel 21's packed kernel with the
// six inputs in a stage ([q̂, k̂, v, dq̂, dk̂, dv], WinPacked<DP, 6>) and the
// tangent's five products.
template <int DP>
__global__ void __launch_bounds__(kWinFwdThreads, 1)
    win_tan_packed_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mdq,
                          const __grid_constant__ CUtensorMap mdk,
                          const __grid_constant__ CUtensorMap mdv, const bf16* __restrict__ q,
                          const bf16* __restrict__ k, const bf16* __restrict__ v,
                          const bf16* __restrict__ dq, const bf16* __restrict__ dk,
                          const bf16* __restrict__ dv, bf16* __restrict__ tout, int R, int n,
                          int d, int tile_rows, int tiles) {
  using L = WinPacked<DP, 6>;
  static_assert(L::OWN_STG, "the tangent's packed form stages its output in rows of its own");
  constexpr int NBOX = L::NBOX, NO = WinFwdWidth<DP>::NO, T = L::TILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  const bool tma = d % 8 == 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], tma ? 1 : 128);
      mbar_init(&empty[s], 4);  // each consumer warp
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
      tma_prefetch(&mdq);
      tma_prefetch(&mdk);
      tma_prefetch(&mdv);
    }
    for (int i = 0, item = blockIdx.x; item < tiles; ++i, item += gridDim.x) {
      const int s = i % L::STAGES, row0 = item * tile_rows;
      unsigned char* st = smem + s * L::STAGE;
      mbar_wait(&empty[s], ((i / L::STAGES) & 1) ^ 1);
      win_fill(&full[s], L::STAGE, tma, [&] {
        win_load<64, NBOX>(st, &mq, q, row0, R, d, &full[s], tma, tid);
        win_load<64, NBOX>(st + T, &mk, k, row0, R, d, &full[s], tma, tid);
        win_load<64, NBOX>(st + 2 * T, &mv, v, row0, R, d, &full[s], tma, tid);
        win_load<64, NBOX>(st + 3 * T, &mdq, dq, row0, R, d, &full[s], tma, tid);
        win_load<64, NBOX>(st + 4 * T, &mdk, dk, row0, R, d, &full[s], tma, tid);
        win_load<64, NBOX>(st + 5 * T, &mdv, dv, row0, R, d, &full[s], tma, tid);
      });
    }
    return;
  }
  setmaxnreg_inc<208>();  // the consumers
  const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, q4 = tid % 4, r = win_acc_row(tid);
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
    float sc[32], ds[32];
    wgmma_fence();
    win_tan_logits<DP, 64>(sc, ds, st, st + 3 * T, L::BOX, st + T, st + 4 * T, L::BOX);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(ds);
    if (n != 64) win_mask<64>(sc, lo, hi, q4);
    uint32_t pf[4][4], df[4][4];
    win_tan_whole<64>(sc, ds, pf, df);
    float oc[NO / 2];
    wgmma_fence();
    win_tan_out<64, NO>(oc, pf, df, st + 2 * T, st + 5 * T, L::BOX, false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oc);
    win_release(&empty[s]);  // the stage's last product has retired
    if (tma) {
      if (tid == 0) tma_store_wait_read<0>();  // the last tile's copy has read the rows
      named_barrier_sync(1 + c, 128);
    }
    win_store<NO>(oc, own, tout, row0, live, d, tma, c, tid);
  }
  if (tid == 0) tma_store_wait_all();
}

// The row form, n > 64 or DP > 128: a work item is one pass of two query
// tiles of a window-head, consumer c taking tile 2 p + c with its q̂ and dq̂ in
// the consumer's slot; the key tiles of NK keys come as halves of HALF bytes,
// (k̂, dk̂) and (v, dv), through one ring that both consumers read (each of
// their warps releases a half), in the order the walks take them: one key
// tile (n <= NK) its two halves; more, the T (k̂, dk̂) halves of the
// statistics walk, then both halves of each key tile in turn, which a
// consumer holds at once (so the ring has at least two). The output is
// staged in the slot's q̂ tile, which goes back once the copy has read it.
template <int DP>
struct WinTanRows {
  static constexpr int NK = DP <= 128 ? 64 : DP <= 192 ? 32 : 16;
  static constexpr int NBOX = WinFwdWidth<DP>::NBOX;
  static constexpr int BOX = 64 * 128, TILE = NBOX * BOX;  // 64 query rows
  static constexpr int KBOX = NK * 128, KTILE = NBOX * KBOX;
  static constexpr int SLOT = 2 * TILE;   // a consumer's q̂, then dq̂
  static constexpr int KV_OFF = 2 * SLOT;
  static constexpr int HALF = 2 * KTILE;  // k̂ then dk̂, or v then dv
  static constexpr int FIT = (kMaxSmem - 1024 - KV_OFF - 32 * 8) / HALF;
  static constexpr int STAGES = FIT > 6 ? 6 : FIT;
  static constexpr int BAR_OFF = KV_OFF + STAGES * HALF;
  static constexpr int SMEM = 1024 + BAR_OFF + (4 + 2 * STAGES) * 8;
  static_assert(STAGES >= 2 && SMEM <= kMaxSmem, "the tangent's row form does not fit");
};

template <int DP>
__global__ void __launch_bounds__(kWinFwdThreads, 1)
    win_tan_rows_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const __grid_constant__ CUtensorMap mdq,
                        const __grid_constant__ CUtensorMap mdk,
                        const __grid_constant__ CUtensorMap mdv, const bf16* __restrict__ q,
                        const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ dq, const bf16* __restrict__ dk,
                        const bf16* __restrict__ dv, bf16* __restrict__ tout, int R, int n,
                        int d, int bh) {
  using L = WinTanRows<DP>;
  constexpr int NK = L::NK, NBOX = L::NBOX, NO = WinFwdWidth<DP>::NO, S = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + S;
  const bool tma = d % 8 == 0;
  const int QT = (n + 63) / 64, P = (QT + 1) / 2, T = (n + NK - 1) / NK;
  const int halves = T == 1 ? 2 : 3 * T, items = bh * P;
  if (threadIdx.x == 0) {
    for (int c = 0; c < 2; ++c) {
      mbar_init(&q_full[c], tma ? 1 : 128);
      mbar_init(&q_empty[c], 1);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], tma ? 1 : 128);
      mbar_init(&empty[s], 8);
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
      tma_prefetch(&mdq);
      tma_prefetch(&mk);
      tma_prefetch(&mdk);
      tma_prefetch(&mv);
      tma_prefetch(&mdv);
    }
    int kv = 0, qn[2] = {0, 0};
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int base = item / P * n, p = item % P;
      for (int c = 0; c < 2; ++c) {
        if (2 * p + c >= QT) continue;
        const int row = base + 64 * (2 * p + c);
        unsigned char* Qs = smem + c * L::SLOT;
        mbar_wait(&q_empty[c], (qn[c]++ & 1) ^ 1);
        win_fill(&q_full[c], L::SLOT, tma, [&] {
          win_load<64, NBOX>(Qs, &mq, q, row, R, d, &q_full[c], tma, tid);
          win_load<64, NBOX>(Qs + L::TILE, &mdq, dq, row, R, d, &q_full[c], tma, tid);
        });
      }
      for (int i = 0; i < halves; ++i, ++kv) {
        // the walks' i-th half: (k̂, dk̂) of key tile j, or (v, dv) of it
        const bool second = T == 1 ? i == 1 : i >= T && (i - T) % 2 == 1;
        const int j = T == 1 ? 0 : i < T ? i : (i - T) / 2, row = base + j * NK;
        const int s = kv % S;
        unsigned char* H = smem + L::KV_OFF + s * L::HALF;
        mbar_wait(&empty[s], ((kv / S) & 1) ^ 1);
        win_fill(&full[s], L::HALF, tma, [&] {
          if (second) {
            win_load<NK, NBOX>(H, &mv, v, row, R, d, &full[s], tma, tid);
            win_load<NK, NBOX>(H + L::KTILE, &mdv, dv, row, R, d, &full[s], tma, tid);
          } else {
            win_load<NK, NBOX>(H, &mk, k, row, R, d, &full[s], tma, tid);
            win_load<NK, NBOX>(H + L::KTILE, &mdk, dk, row, R, d, &full[s], tma, tid);
          }
        });
      }
    }
    return;
  }
  setmaxnreg_inc<208>();  // the consumers
  const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, q4 = tid % 4;
  unsigned char* Qs = smem + c * L::SLOT;
  const unsigned char* DQs = Qs + L::TILE;
  int kv = 0, qn = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, kv += halves) {
    const int wh = item / P, qt = 2 * (item % P) + c;
    const bool have = qt < QT;
    if (have) mbar_wait(&q_full[c], qn & 1);
    auto half = [&](int i) {  // the ring's i-th half of this item, once it has landed
      const int s = (kv + i) % S;
      mbar_wait(&full[s], ((kv + i) / S) & 1);
      return smem + L::KV_OFF + s * L::HALF;
    };
    auto release = [&](int i) { win_release(&empty[(kv + i) % S]); };
    // o starts at 0: the wgmma asm reads its accumulator, and a value left
    // from the last item would stay live across the walks
    float oc[NO / 2];
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) oc[i] = 0.f;
    // each group of products is issued and waited for within one block: a
    // wgmma in flight across a branch sends its registers to local memory
    if (T == 1) {  // one walk: whole rows of S and dS, both halves at once
      const unsigned char* Kt = half(0);
      const unsigned char* Vt = half(1);
      if (have) {
        float sc[NK / 2], ds[NK / 2];
        wgmma_fence();
        win_tan_logits<DP, NK>(sc, ds, Qs, DQs, L::BOX, Kt, Kt + L::KTILE, L::KBOX);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(ds);
        if (n < NK) {
          const int lo[2] = {0, 0}, hi[2] = {n, n};
          win_mask<NK>(sc, lo, hi, q4);
        }
        uint32_t pf[NK / 16][4], df[NK / 16][4];
        win_tan_whole<NK>(sc, ds, pf, df);
        wgmma_fence();
        win_tan_out<NK, NO>(oc, pf, df, Vt, Vt + L::KTILE, L::KBOX, true);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(oc);
      }
      release(0);
      release(1);
    } else {
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, x[2] = {0.f, 0.f};
      for (int j = 0; j < T; ++j) {  // the statistics
        const unsigned char* Kt = half(j);
        if (have) {
          float sc[NK / 2], ds[NK / 2];
          wgmma_fence();
          win_tan_logits<DP, NK>(sc, ds, Qs, DQs, L::BOX, Kt, Kt + L::KTILE, L::KBOX);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(ds);
          if (j * NK + NK > n) {  // keys past the window-head
            const int lo[2] = {0, 0}, hi[2] = {n - j * NK, n - j * NK};
            win_mask<NK>(sc, lo, hi, q4);
          }
          win_stats<NK>(sc, ds, m, l, x);
        }
        release(j);
      }
      float il[2], E[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sum = quad_sum(l[h]);
        il[h] = 1.0f / sum;
        E[h] = quad_sum(x[h]) / sum;
      }
      for (int j = 0; j < T; ++j) {  // p, dP and do
        const unsigned char* Kt = half(T + 2 * j);
        const unsigned char* Vt = half(T + 2 * j + 1);
        if (have) {
          float sc[NK / 2], ds[NK / 2];
          wgmma_fence();
          win_tan_logits<DP, NK>(sc, ds, Qs, DQs, L::BOX, Kt, Kt + L::KTILE, L::KBOX);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(ds);
          uint32_t pf[NK / 16][4], df[NK / 16][4];
          win_tan_slice<NK>(sc, ds, m, il, E, n - j * NK, q4, pf, df);
          wgmma_fence();
          win_tan_out<NK, NO>(oc, pf, df, Vt, Vt + L::KTILE, L::KBOX, true);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(oc);
        }
        release(T + 2 * j);
        release(T + 2 * j + 1);
      }
    }
    if (!have) continue;
    win_store<NO>(oc, reinterpret_cast<bf16*>(Qs), tout, (size_t)wh * n + 64 * qt,
                  min(64, n - 64 * qt), d, tma, c, tid);
    if (!tma) named_barrier_sync(1 + c, 128);
    if (tid == 0) {
      tma_store_wait_read<0>();  // the copy has read the slot
      mbar_arrive(&q_empty[c]);
    }
    ++qn;
  }
  if (tid == 0) tma_store_wait_all();
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

// Kernel 22b's launch: the packed form for n <= 64 at DP <= 128, else the
// query pass then the key pass; four tensor maps of the (BW·h·n, d)
// matrices where d % 8 == 0 (k̂ and v in boxes of the query pass's NK rows,
// then 64 for the key pass), each kernel persistent.
static int win_bwd_sms[3][9][64];

template <int DP>
int launch_win_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, void* stats, int bh, int n, int d, cudaStream_t st) {
  constexpr int ID = win_dp_index(DP), NK = WinBwdQ<DP>::NK;
  const long long rows = (long long)bh * n;
  if (rows > INT_MAX) return (int)cudaErrorInvalidValue;
  const int R = (int)rows;
  const bool tma = d % 8 == 0;
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v,
             *ob = (const bf16*)dout;
  bf16 *dqb = (bf16*)dq, *dkb = (bf16*)dk, *dvb = (bf16*)dv;
  CUtensorMap mq = {}, mk = {}, mv = {}, mdo = {};
  auto maps = [&](int key_rows) {
    return tensor_map_bf16(&mq, q, R, d, 64, 64) && tensor_map_bf16(&mdo, dout, R, d, 64, 64) &&
           tensor_map_bf16(&mk, k, R, d, key_rows, 64) &&
           tensor_map_bf16(&mv, v, R, d, key_rows, 64);
  };
  if constexpr (DP <= 128) {
    if (n <= 64) {
      if (tma && !maps(64)) return kTensorMapError;
      const int g = 64 / n, tiles = (bh + g - 1) / g;
      return launch_persistent(win_bwd_packed_kernel<DP>, win_bwd_sms[0][ID], kWinFwdThreads,
                               WinBwdPacked<DP>::SMEM, tiles, st, mq, mk, mv, mdo, qb, kb, vb,
                               ob, dqb, dkb, dvb, R, n, d, g * n, tiles);
    }
  }
  if (tma && !maps(NK)) return kTensorMapError;
  const int passes = ((n + 63) / 64 + 1) / 2;
  int err = launch_persistent(win_bwd_q_kernel<DP>, win_bwd_sms[1][ID], kWinFwdThreads,
                              WinBwdQ<DP>::SMEM, bh * passes, st, mq, mk, mv, mdo, qb, kb, vb,
                              ob, dqb, (float*)stats, R, n, d, bh);
  if (err != cudaSuccess) return err;
  if (tma && NK != 64 && !maps(64)) return kTensorMapError;
  const int groups = (n + WinBwdKV<DP>::KEYS - 1) / WinBwdKV<DP>::KEYS;
  return launch_persistent(win_bwd_kv_kernel<DP>, win_bwd_sms[2][ID], kWinFwdThreads,
                           WinBwdKV<DP>::SMEM, bh * groups, st, mq, mk, mv, mdo, qb, kb, vb, ob,
                           (const float*)stats, dkb, dvb, R, n, d, bh);
}

// Kernel 22t's launch: the packed form for n <= 64 at DP <= 128, else the
// row form; six tensor maps of the (BW·h·n, d) matrices where d % 8 == 0
// (k̂, dk̂, v and dv in boxes of the form's key rows), persistent.
static int win_tan_sms[2][9][64];

template <int DP>
int launch_win_tangent(const void* q, const void* k, const void* v, const void* tq,
                       const void* tk, const void* tv, void* tout, int bh, int n, int d,
                       cudaStream_t st) {
  constexpr int ID = win_dp_index(DP), NK = WinTanRows<DP>::NK;
  const long long rows = (long long)bh * n;
  if (rows > INT_MAX) return (int)cudaErrorInvalidValue;
  const int R = (int)rows;
  const bool tma = d % 8 == 0, packed = DP <= 128 && n <= 64;
  const int key_rows = packed ? 64 : NK;
  CUtensorMap mq = {}, mk = {}, mv = {}, mdq = {}, mdk = {}, mdv = {};
  if (tma && !(tensor_map_bf16(&mq, q, R, d, 64, 64) && tensor_map_bf16(&mdq, tq, R, d, 64, 64) &&
               tensor_map_bf16(&mk, k, R, d, key_rows, 64) &&
               tensor_map_bf16(&mdk, tk, R, d, key_rows, 64) &&
               tensor_map_bf16(&mv, v, R, d, key_rows, 64) &&
               tensor_map_bf16(&mdv, tv, R, d, key_rows, 64)))
    return kTensorMapError;
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v,
             *tqb = (const bf16*)tq, *tkb = (const bf16*)tk, *tvb = (const bf16*)tv;
  bf16* ob = (bf16*)tout;
  if constexpr (DP <= 128) {
    if (packed) {
      const int g = 64 / n, tiles = (bh + g - 1) / g;
      return launch_persistent(win_tan_packed_kernel<DP>, win_tan_sms[0][ID], kWinFwdThreads,
                               WinPacked<DP, 6>::SMEM, tiles, st, mq, mk, mv, mdq, mdk, mdv, qb,
                               kb, vb, tqb, tkb, tvb, ob, R, n, d, g * n, tiles);
    }
  }
  const int passes = ((n + 63) / 64 + 1) / 2;
  return launch_persistent(win_tan_rows_kernel<DP>, win_tan_sms[1][ID], kWinFwdThreads,
                           WinTanRows<DP>::SMEM, bh * passes, st, mq, mk, mv, mdq, mdk, mdv, qb,
                           kb, vb, tqb, tkb, tvb, ob, R, n, d, bh);
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
// dout, all (bh, n, d) bf16, and stats fp32 scratch of bh * ceil(n / 64) *
// 192 elements where n > 64 or d > 128 (each query row's max, 1 / sum and
// Σ p·dp, 64 rows a query tile), unused otherwise.
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
