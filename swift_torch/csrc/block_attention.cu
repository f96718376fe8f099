// Shifted-window cosine attention on Hopper, straight from the qkv
// projection's (B, gh, gw, heads*3*d) layout.
//
// Replaces swift_tpu/ops/pallas_block_attention.py::_fwd_call (kernel body
// _fwd_kernel). Per (sample, window, head): q and k are L2-normalised in
// fp32 (eps 1e-12) and rounded to bf16, q carries the learned logit scale,
// the 256 x 256 logits are accumulated in fp32, softmax runs in fp32, p is
// rounded to bf16 before p . v, and the output is written back in the same
// shifted coordinates it was read from.
//
// What bounds it on the H100: not the FLOPs (~23 MFLOP a window-head) but
// on-chip capacity -- 256 x 256 fp32 logits are 256 KB, more than the 227 KB
// a block may hold. Design: one block per (sample, window, head, 64 query
// rows). It keeps its 64 normalised query rows, all 256 key rows (then the
// 256 value rows, in the same buffer) and a 64 x 256 fp32 logit tile
// (66.5 KB) in shared memory; p is rounded to bf16 in place inside the logit
// rows. The odd-block cyclic shift is folded into the index math: token t
// of window (wi, wj) lives at ((wi*wh + sh + t/ww) mod gh, (wj*ww + sw +
// t%ww) mod gw), exactly the wrapped coordinates _gather_window and
// _scatter_window use, so there is no roll pass. q/k/v of head h are read at
// feature offsets h*3d + {0, d, 2d}; d (88 at the flagship) is zero-padded
// to DP, a multiple of 32, in shared memory only.
#include "tile_mma.cuh"

namespace swift {

constexpr int kWinTokens = 256, kQB = 64, kAttnNT = 256;
constexpr int kSLD = kWinTokens + 4;  // fp32 logit row stride

template <int DP>
__host__ __device__ constexpr int attn_smem() {
  return (kQB + kWinTokens) * (DP + 8) * 2 + kQB * kSLD * 4;
}

// Row t of the window as bf16 in smem (zero-padded to DP), optionally
// L2-normalised and multiplied by ``mul``. One warp per row.
template <int DP>
__device__ __forceinline__ void load_row(bf16* dst, const bf16* src, int d, bool normalise,
                                         float mul, int lane) {
  float v[8];
  const bool live = lane * 8 < d;
  if (live) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + lane * 8);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.0f;
  }
  if (normalise) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += v[i] * v[i];
    const float inv = rsqrtf(warp_sum(ss) + 1e-12f);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = v[i] * inv * mul;
  }
  if (lane * 8 < DP) *reinterpret_cast<uint4*>(dst + lane * 8) = pack8(v);
}

template <int DP>
__global__ void __launch_bounds__(kAttnNT)
    block_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ scale,
                      bf16* __restrict__ out, int gh, int gw, int heads, int d, int wh, int ww,
                      int sh, int sw) {
  constexpr int LDQ = DP + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KVs = Qs + kQB * LDQ;
  float* Ss = reinterpret_cast<float*>(KVs + kWinTokens * LDQ);
  bf16* Ps = reinterpret_cast<bf16*>(Ss);  // p row r overwrites the front of logit row r
  constexpr int kPLD = 2 * kSLD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z / heads, h = blockIdx.z % heads;
  const int wi = blockIdx.y / (gw / ww), wj = blockIdx.y % (gw / ww);
  const int i0 = wi * wh + sh, j0 = wj * ww + sw;
  const int q0 = blockIdx.x * kQB;
  const size_t feat = (size_t)heads * 3 * d;
  auto token = [&](int t) -> size_t {
    const int row = (i0 + t / ww) % gh, col = (j0 + t % ww) % gw;
    return ((size_t)b * gh + row) * gw + col;
  };
  const bf16* head = qkv + (size_t)h * 3 * d;
  const float s = scale[h];

  for (int r = warp; r < kQB; r += kAttnNT / 32)
    load_row<DP>(Qs + r * LDQ, head + token(q0 + r) * feat, d, true, s, lane);
  for (int r = warp; r < kWinTokens; r += kAttnNT / 32)
    load_row<DP>(KVs + r * LDQ, head + token(r) * feat + d, d, true, 1.0f, lane);
  __syncthreads();

  // logits: 64 x 256 = 4 x 16 fragments, warp w owns row tile w/2 and
  // column tiles (w%2)*8 .. +8
  {
    const int rt = warp / 2, ct0 = (warp % 2) * 8;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + (rt * 16) * LDQ + kk, LDQ);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, KVs + ((ct0 + j) * 16) * LDQ + kk, LDQ);
        wmma::mma_sync(acc[j], a, kb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wmma::store_matrix_sync(Ss + (rt * 16) * kSLD + (ct0 + j) * 16, acc[j], kSLD,
                              wmma::mem_row_major);
  }
  __syncthreads();

  // v replaces k; softmax rows meanwhile (disjoint buffers)
  for (int r = warp; r < kWinTokens; r += kAttnNT / 32)
    load_row<DP>(KVs + r * LDQ, head + token(r) * feat + 2 * d, d, false, 1.0f, lane);
  for (int r = warp; r < kQB; r += kAttnNT / 32) {
    float v[kWinTokens / 32];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i) {
      v[i] = Ss[r * kSLD + lane + 32 * i];
      m = fmaxf(m, v[i]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i) {
      v[i] = expf(v[i] - m);
      sum += v[i];
    }
    sum = warp_sum(sum);
    __syncwarp();  // every lane has read its logits before any p overwrites them
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i)
      Ps[r * kPLD + lane + 32 * i] = __float2bfloat16_rn(v[i] / sum);
  }
  __syncthreads();

  // o = p . v: 64 x DP = 4 x DP/16 fragments, warp w owns row tile w/2 and
  // column tiles (w%2)*DP/32 .. +DP/32
  constexpr int CT = DP / 32;
  {
    const int rt = warp / 2, ct0 = (warp % 2) * CT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll 4
    for (int kk = 0; kk < kWinTokens; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Ps + (rt * 16) * kPLD + kk, kPLD);
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, KVs + kk * LDQ + (ct0 + j) * 16, LDQ);
        wmma::mma_sync(acc[j], a, vb, acc[j]);
      }
    }
    __syncthreads();  // all p reads are done: the logit buffer takes o
    constexpr int LDO = DP + 4;
#pragma unroll
    for (int j = 0; j < CT; ++j)
      wmma::store_matrix_sync(Ss + (rt * 16) * LDO + (ct0 + j) * 16, acc[j], LDO,
                              wmma::mem_row_major);
    __syncthreads();
    const size_t ofeat = (size_t)heads * d;
    for (int r = warp; r < kQB; r += kAttnNT / 32) {
      if (lane * 8 < d)
        *reinterpret_cast<uint4*>(out + token(q0 + r) * ofeat + (size_t)h * d + lane * 8) =
            pack8(Ss + r * LDO + lane * 8);
    }
  }
}

template <int DP>
int launch_block_attn(const void* qkv, const void* scale, void* out, int B, int gh, int gw,
                      int heads, int d, int wh, int ww, int sh, int sw, cudaStream_t stream) {
  constexpr int smem = attn_smem<DP>();
  cudaFuncSetAttribute(block_attn_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(kWinTokens / kQB, (gh / wh) * (gw / ww), B * heads);
  block_attn_kernel<DP><<<grid, kAttnNT, smem, stream>>>(
      (const bf16*)qkv, (const float*)scale, (bf16*)out, gh, gw, heads, d, wh, ww, sh, sw);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward -- replaces swift_tpu/ops/pallas_block_attention.py::_bwd_call
// (kernel body _bwd_kernel). Per (sample, window, head) it recomputes the
// softmax and forms, at the TPU kernel's rounding points (q̂·s, k̂, p and dS
// rounded to bf16 before the products that consume them, fp32 sums):
//   dv = pᵀ·do, dp = do·vᵀ, dS = p (dp − Σ p dp), dq̂ = s dS·k̂, dk̂ = dSᵀ·(q̂ s),
//   dq = (dq̂ − q̂ (q̂·dq̂)) / |q|, dk likewise, and Σ dS·logits / s for the
//   logit scale -- written into dqkv in the [q|k|v] interleave, at the same
//   shifted coordinates the forward reads.
//
// What bounds it: like the forward, on-chip capacity. A block holds the
// logits and dp of its query rows (two QB x 256 fp32 tiles), q̂s and do of
// those rows and one 256-row key (then value, then key) buffer: 208 KB at
// QB = 64 and d <= 96, so d = 128 takes QB = 32. dk and dv sum over all
// 256 query rows of a window, which no block holds at once, so each block
// writes fp32 partials of dk̂ and dv for the whole window, and a second
// kernel sums the 256/QB partials in a fixed order, applies the k̂
// normalisation backward and writes dk and dv. The scale partials are
// summed, also in a fixed order, by a third, one-block kernel. No atomics.
template <int DP>
struct AttnBwd {
  static constexpr int QB = DP <= 96 ? 64 : 32;
  static constexpr int NQB = kWinTokens / QB;
  static constexpr int LDQ = DP + 8;
  static constexpr int PLD = 2 * kSLD;  // bf16 stride of p / dS written over fp32 rows
  static constexpr int SMEM = (2 * QB + kWinTokens) * LDQ * 2 + 2 * QB * kSLD * 4;
};

template <int DP>
__global__ void __launch_bounds__(kAttnNT)
    block_attn_bwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ scale,
                          const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                          float* __restrict__ part_k, float* __restrict__ part_v,
                          float* __restrict__ part_s, int gh, int gw, int heads, int d, int wh,
                          int ww, int sh, int sw) {
  using C = AttnBwd<DP>;
  constexpr int QB = C::QB, LDQ = C::LDQ, PLD = C::PLD, NW = kAttnNT / 32, CT = DP / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // bf16(q̂ s)
  bf16* dOs = Qs + QB * LDQ;                     // do
  bf16* KVs = dOs + QB * LDQ;                    // k̂, then v, then k̂ again
  float* Ss = reinterpret_cast<float*>(KVs + kWinTokens * LDQ);  // logits -> p -> dq̂
  float* dPs = Ss + QB * kSLD;                                    // dp -> dS
  bf16* Ps = reinterpret_cast<bf16*>(Ss);
  bf16* dSs = reinterpret_cast<bf16*>(dPs);
  __shared__ float red[NW];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bz = blockIdx.z, b = bz / heads, h = bz % heads;
  const int nW = gridDim.y, w = blockIdx.y, qb = blockIdx.x;
  const int wi = w / (gw / ww), wj = w % (gw / ww);
  const int i0 = wi * wh + sh, j0 = wj * ww + sw;
  const int q0 = qb * QB;
  const size_t feat = (size_t)heads * 3 * d, ofeat = (size_t)heads * d;
  auto token = [&](int t) -> size_t {
    const int row = (i0 + t / ww) % gh, col = (j0 + t % ww) % gw;
    return ((size_t)b * gh + row) * gw + col;
  };
  const bf16* head = qkv + (size_t)h * 3 * d;
  const float s = scale[h];

  for (int r = warp; r < QB; r += NW) {
    load_row<DP>(Qs + r * LDQ, head + token(q0 + r) * feat, d, true, s, lane);
    load_row<DP>(dOs + r * LDQ, dout + token(q0 + r) * ofeat + (size_t)h * d, d, false, 1.0f,
                 lane);
  }
  for (int r = warp; r < kWinTokens; r += NW)
    load_row<DP>(KVs + r * LDQ, head + token(r) * feat + d, d, true, 1.0f, lane);
  __syncthreads();

  // C[QB x 256] (fp32, stride kSLD) = A[QB x DP] . B[256 x DP]^T
  auto rows_x_window = [&](const bf16* A, float* Cm) {
    for (int f = warp; f < (QB / 16) * (kWinTokens / 16); f += NW) {
      const int rt = f / (kWinTokens / 16), ct = f % (kWinTokens / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(a, A + rt * 16 * LDQ + kk, LDQ);
        wmma::load_matrix_sync(kb, KVs + ct * 16 * LDQ + kk, LDQ);
        wmma::mma_sync(acc, a, kb, acc);
      }
      wmma::store_matrix_sync(Cm + rt * 16 * kSLD + ct * 16, acc, kSLD, wmma::mem_row_major);
    }
  };
  rows_x_window(Qs, Ss);  // logits
  __syncthreads();
  for (int r = warp; r < kWinTokens; r += NW)
    load_row<DP>(KVs + r * LDQ, head + token(r) * feat + 2 * d, d, false, 1.0f, lane);
  __syncthreads();
  rows_x_window(dOs, dPs);  // dp = do . vᵀ
  __syncthreads();

  // one warp per query row: p, dS, and Σ dS·logits; p and dS are rounded to
  // bf16 in place over the fronts of their fp32 rows
  float dsum = 0.f;
  for (int r = warp; r < QB; r += NW) {
    float lg[kWinTokens / 32], dp[kWinTokens / 32];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i) {
      lg[i] = Ss[r * kSLD + lane + 32 * i];
      dp[i] = dPs[r * kSLD + lane + 32 * i];
      m = fmaxf(m, lg[i]);
    }
    m = warp_max(m);
    float e[kWinTokens / 32], l = 0.f;
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i) {
      e[i] = expf(lg[i] - m);
      l += e[i];
    }
    l = warp_sum(l);
    float pdp = 0.f;
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i) {
      e[i] = e[i] / l;  // p
      pdp += e[i] * dp[i];
    }
    pdp = warp_sum(pdp);
    __syncwarp();  // every lane has read its row before any bf16 overwrites it
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i) {
      const float dS = e[i] * (dp[i] - pdp);
      dsum += dS * lg[i];
      Ps[r * PLD + lane + 32 * i] = __float2bfloat16_rn(e[i]);
      dSs[r * PLD + lane + 32 * i] = __float2bfloat16_rn(dS);
    }
  }
  dsum = warp_sum(dsum);
  if (lane == 0) red[warp] = dsum;
  __syncthreads();  // p, dS and the scale partials are complete; v is done with

  // the k̂ buffer comes back for dq̂, beside the two window-wide products
  for (int r = warp; r < kWinTokens; r += NW)
    load_row<DP>(KVs + r * LDQ, head + token(r) * feat + d, d, true, 1.0f, lane);
  // dv partial = pᵀ . do and dk̂ partial = dSᵀ . (q̂ s), both [256 x DP] fp32,
  // stored straight to this block's slot of the workspace
  const size_t slot = (((size_t)bz * nW + w) * C::NQB + qb) * kWinTokens * DP;
  for (int f = warp; f < 2 * (kWinTokens / 16) * CT; f += NW) {
    const int which = f / ((kWinTokens / 16) * CT), g = f % ((kWinTokens / 16) * CT);
    const int mt = g / CT, nt = g % CT;
    const bf16* At = which ? dSs : Ps;
    const bf16* Bt = which ? Qs : dOs;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < QB; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bb;
      wmma::load_matrix_sync(a, At + kk * PLD + mt * 16, PLD);
      wmma::load_matrix_sync(bb, Bt + kk * LDQ + nt * 16, LDQ);
      wmma::mma_sync(acc, a, bb, acc);
    }
    float* dst = (which ? part_k : part_v) + slot + (size_t)mt * 16 * DP + nt * 16;
    wmma::store_matrix_sync(dst, acc, DP, wmma::mem_row_major);
  }
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int i = 0; i < NW; ++i) tot += red[i];
    part_s[((size_t)bz * nW + w) * C::NQB + qb] = tot;
  }
  __syncthreads();  // k̂ is back; p is read for the last time

  // dq̂ [QB x DP] = dS . k̂, into the logit buffer (fp32, stride DP + 4)
  constexpr int LDO = DP + 4;
  for (int f = warp; f < (QB / 16) * CT; f += NW) {
    const int mt = f / CT, nt = f % CT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
    for (int kk = 0; kk < kWinTokens; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bb;
      wmma::load_matrix_sync(a, dSs + mt * 16 * PLD + kk, PLD);
      wmma::load_matrix_sync(bb, KVs + kk * LDQ + nt * 16, LDQ);
      wmma::mma_sync(acc, a, bb, acc);
    }
    wmma::store_matrix_sync(Ss + mt * 16 * LDO + nt * 16, acc, LDO, wmma::mem_row_major);
  }
  __syncthreads();

  // dq = (s dq̂ − q̂ (q̂ · s dq̂)) / |q| from the raw q row, 8 features a lane
  for (int r = warp; r < QB; r += NW) {
    const size_t tk = token(q0 + r);
    float q[8], g[8];
    const bool live = lane * 8 < d;
    float ss = 0.f;
    if (live) {
      const uint4 raw = *reinterpret_cast<const uint4*>(head + tk * feat + lane * 8);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f2 = __bfloat1622float2(h2[i]);
        q[2 * i] = f2.x;
        q[2 * i + 1] = f2.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += q[i] * q[i];
    const float rq = rsqrtf(warp_sum(ss) + 1e-12f);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      q[i] *= rq;                                             // q̂
      g[i] = live ? Ss[r * LDO + lane * 8 + i] * s : 0.f;     // dq̂ s
      dot += g[i] * q[i];
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int i = 0; i < 8; ++i) g[i] = (g[i] - q[i] * dot) * rq;
    if (live)
      *reinterpret_cast<uint4*>(dqkv + tk * feat + (size_t)h * 3 * d + lane * 8) = pack8(g);
  }
}

// Per (sample, window, head): dk̂ and dv summed over the query-block partials
// in order, dk = (dk̂ − k̂ (k̂·dk̂)) / |k|, both written into dqkv.
template <int DP>
__global__ void __launch_bounds__(kAttnNT)
    block_attn_bwd_kv_kernel(const bf16* __restrict__ qkv, const float* __restrict__ part_k,
                             const float* __restrict__ part_v, bf16* __restrict__ dqkv, int gh,
                             int gw, int heads, int d, int wh, int ww, int sh, int sw) {
  constexpr int NQB = AttnBwd<DP>::NQB, NW = kAttnNT / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bz = blockIdx.y, b = bz / heads, h = bz % heads, w = blockIdx.x;
  const int wi = w / (gw / ww), wj = w % (gw / ww);
  const int i0 = wi * wh + sh, j0 = wj * ww + sw;
  const size_t feat = (size_t)heads * 3 * d;
  const size_t base = ((size_t)bz * gridDim.x + w) * NQB * kWinTokens * DP;
  const size_t pstride = (size_t)kWinTokens * DP;
  const bool live = lane * 8 < d;
  for (int t = warp; t < kWinTokens; t += NW) {
    const int row = (i0 + t / ww) % gh, col = (j0 + t % ww) % gw;
    const size_t tk = ((size_t)b * gh + row) * gw + col;
    bf16* dst = dqkv + tk * feat + (size_t)h * 3 * d;
    float k[8], dk[8], dv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = dk[i] = dv[i] = 0.f;
    if (live) {
      const uint4 raw = *reinterpret_cast<const uint4*>(qkv + tk * feat + (size_t)h * 3 * d + d +
                                                        lane * 8);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f2 = __bfloat1622float2(h2[i]);
        k[2 * i] = f2.x;
        k[2 * i + 1] = f2.y;
      }
      for (int p = 0; p < NQB; ++p) {
        const float* pk = part_k + base + p * pstride + (size_t)t * DP + lane * 8;
        const float* pv = part_v + base + p * pstride + (size_t)t * DP + lane * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dk[i] += pk[i];
          dv[i] += pv[i];
        }
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += k[i] * k[i];
    const float rk = rsqrtf(warp_sum(ss) + 1e-12f);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      k[i] *= rk;  // k̂
      dot += dk[i] * k[i];
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int i = 0; i < 8; ++i) dk[i] = (dk[i] - k[i] * dot) * rk;
    if (live) {
      *reinterpret_cast<uint4*>(dst + d + lane * 8) = pack8(dk);
      *reinterpret_cast<uint4*>(dst + 2 * d + lane * 8) = pack8(dv);
    }
  }
}

// dscale[h] = Σ over samples, windows and query blocks (in that order) of
// the Σ dS·logits partials, / scale[h].
__global__ void block_attn_dscale_kernel(const float* __restrict__ part_s,
                                         const float* __restrict__ scale, float* __restrict__ ds,
                                         int B, int heads, int per_head) {
  const int h = threadIdx.x;
  if (h >= heads) return;
  float tot = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = part_s + ((size_t)b * heads + h) * per_head;
    for (int i = 0; i < per_head; ++i) tot += p[i];
  }
  ds[h] = tot / scale[h];
}

template <int DP>
int launch_block_attn_bwd(const void* qkv, const void* scale, const void* dout, void* dqkv,
                          void* dscale, void* part_k, void* part_v, void* part_s, int B, int gh,
                          int gw, int heads, int d, int wh, int ww, int sh, int sw,
                          cudaStream_t st) {
  using C = AttnBwd<DP>;
  cudaFuncSetAttribute(block_attn_bwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM);
  const int nW = (gh / wh) * (gw / ww);
  dim3 grid(C::NQB, nW, B * heads);
  block_attn_bwd_kernel<DP><<<grid, kAttnNT, C::SMEM, st>>>(
      (const bf16*)qkv, (const float*)scale, (const bf16*)dout, (bf16*)dqkv, (float*)part_k,
      (float*)part_v, (float*)part_s, gh, gw, heads, d, wh, ww, sh, sw);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  block_attn_bwd_kv_kernel<DP><<<dim3(nW, B * heads), kAttnNT, 0, st>>>(
      (const bf16*)qkv, (const float*)part_k, (const float*)part_v, (bf16*)dqkv, gh, gw, heads,
      d, wh, ww, sh, sw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  block_attn_dscale_kernel<<<1, 1024, 0, st>>>((const float*)part_s, (const float*)scale,
                                               (float*)dscale, B, heads, nW * C::NQB);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tangent -- replaces swift_tpu/ops/pallas_block_attention.py::_tangent_call
// (kernel body _tangent_kernel): the forward-mode tangent of the attention
// along dqkv, the logit scale fixed (the sCM jvp forward). Per (sample,
// window, head): dq̂ = (dq − q̂ (q̂·dq)) / |q| and dk̂ likewise, dS = s dq̂·k̂ᵀ
// + s q̂·dk̂ᵀ, dp = p (dS − Σ p dS) and dout = dp·v + p·dv, with q̂s, dq̂s,
// k̂, dk̂, p and dp rounded to bf16 before the products that consume them (the
// TPU kernel's rounding points) and fp32 sums.
//
// What bounds it: on-chip capacity, as for the backward. All 256 keys of a
// window fit one tile, so the softmax needs no online rescaling, but a block
// holds the logits and dS of its query rows (two QB x 256 fp32 tiles), q̂s
// and dq̂s of those rows and one 256-row buffer that takes k̂, dk̂, v and dv
// in turn: kernel 6's budget, 208 KB at QB = 64 and d <= 96, QB = 32 at
// d = 128. Against k̂ it forms the logits and s dq̂·k̂ᵀ, against dk̂ it adds
// s q̂·dk̂ᵀ into dS, then p and dp are rounded to bf16 in place over their
// fp32 rows, and the output fragments stay in registers while v is swapped
// for dv (dp·v, then + p·dv). No partials: every output row is a query row
// of this block.

// dst = mul · (ds − â (â·ds)) / |a| for the row a = src, ds = dsrc (bf16,
// zero-padded to DP): the tangent of mul · a / |a|. One warp per row.
template <int DP>
__device__ __forceinline__ void load_tangent_row(bf16* dst, const bf16* src, const bf16* dsrc,
                                                 int d, float mul, int lane) {
  float a[8], da[8];
  const bool live = lane * 8 < d;
  const uint4 ra = live ? *reinterpret_cast<const uint4*>(src + lane * 8) : make_uint4(0, 0, 0, 0);
  const uint4 rd = live ? *reinterpret_cast<const uint4*>(dsrc + lane * 8) : make_uint4(0, 0, 0, 0);
  const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&ra);
  const __nv_bfloat162* hd = reinterpret_cast<const __nv_bfloat162*>(&rd);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(ha[i]), fd = __bfloat1622float2(hd[i]);
    a[2 * i] = fa.x;
    a[2 * i + 1] = fa.y;
    da[2 * i] = fd.x;
    da[2 * i + 1] = fd.y;
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) ss += a[i] * a[i];
  const float inv = rsqrtf(warp_sum(ss) + 1e-12f);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] *= inv;  // â
    dot += a[i] * da[i];
  }
  dot = warp_sum(dot);
#pragma unroll
  for (int i = 0; i < 8; ++i) da[i] = (da[i] - a[i] * dot) * inv * mul;
  if (lane * 8 < DP) *reinterpret_cast<uint4*>(dst + lane * 8) = pack8(da);
}

template <int DP>
__global__ void __launch_bounds__(kAttnNT)
    block_attn_tangent_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dqkv,
                              const float* __restrict__ scale, bf16* __restrict__ dout, int gh,
                              int gw, int heads, int d, int wh, int ww, int sh, int sw) {
  using C = AttnBwd<DP>;  // the same query block, strides and shared-memory budget
  constexpr int QB = C::QB, LDQ = C::LDQ, PLD = C::PLD, NW = kAttnNT / 32, CT = DP / 16;
  constexpr int NF = (QB / 16) * CT, MAXF = (NF + NW - 1) / NW;  // output fragments
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // bf16(q̂ s)
  bf16* dQs = Qs + QB * LDQ;                     // bf16(dq̂ s)
  bf16* KVs = dQs + QB * LDQ;                    // k̂, then dk̂, then v, then dv
  float* Ss = reinterpret_cast<float*>(KVs + kWinTokens * LDQ);  // logits -> p
  float* dSs = Ss + QB * kSLD;                                    // dS -> dp -> dout
  bf16* Ps = reinterpret_cast<bf16*>(Ss);
  bf16* dPs = reinterpret_cast<bf16*>(dSs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z / heads, h = blockIdx.z % heads;
  const int wi = blockIdx.y / (gw / ww), wj = blockIdx.y % (gw / ww);
  const int i0 = wi * wh + sh, j0 = wj * ww + sw;
  const int q0 = blockIdx.x * QB;
  const size_t feat = (size_t)heads * 3 * d;
  auto token = [&](int t) -> size_t {
    const int row = (i0 + t / ww) % gh, col = (j0 + t % ww) % gw;
    return ((size_t)b * gh + row) * gw + col;
  };
  const bf16* head = qkv + (size_t)h * 3 * d;
  const bf16* dhead = dqkv + (size_t)h * 3 * d;
  const float s = scale[h];

  for (int r = warp; r < QB; r += NW) {
    const size_t tk = token(q0 + r) * feat;
    load_row<DP>(Qs + r * LDQ, head + tk, d, true, s, lane);
    load_tangent_row<DP>(dQs + r * LDQ, head + tk, dhead + tk, d, s, lane);
  }
  for (int r = warp; r < kWinTokens; r += NW)
    load_row<DP>(KVs + r * LDQ, head + token(r) * feat + d, d, true, 1.0f, lane);
  __syncthreads();

  // C[QB x 256] (fp32, stride kSLD) (+)= A[QB x DP] . KVs[256 x DP]^T
  auto rows_x_window = [&](const bf16* A, float* Cm, bool accumulate) {
    for (int f = warp; f < (QB / 16) * (kWinTokens / 16); f += NW) {
      const int rt = f / (kWinTokens / 16), ct = f % (kWinTokens / 16);
      float* cp = Cm + rt * 16 * kSLD + ct * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (accumulate)
        wmma::load_matrix_sync(acc, cp, kSLD, wmma::mem_row_major);
      else
        wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(a, A + rt * 16 * LDQ + kk, LDQ);
        wmma::load_matrix_sync(kb, KVs + ct * 16 * LDQ + kk, LDQ);
        wmma::mma_sync(acc, a, kb, acc);
      }
      wmma::store_matrix_sync(cp, acc, kSLD, wmma::mem_row_major);
    }
  };
  rows_x_window(Qs, Ss, false);   // logits = q̂s . k̂ᵀ
  rows_x_window(dQs, dSs, false); // dS = dq̂s . k̂ᵀ
  __syncthreads();
  for (int r = warp; r < kWinTokens; r += NW) {
    const size_t tk = token(r) * feat + d;
    load_tangent_row<DP>(KVs + r * LDQ, head + tk, dhead + tk, d, 1.0f, lane);
  }
  __syncthreads();
  rows_x_window(Qs, dSs, true);  // dS += q̂s . dk̂ᵀ
  __syncthreads();

  // one warp per query row: p and dp, rounded to bf16 in place over the
  // fronts of their fp32 rows
  for (int r = warp; r < QB; r += NW) {
    float lg[kWinTokens / 32], ds[kWinTokens / 32];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i) {
      lg[i] = Ss[r * kSLD + lane + 32 * i];
      ds[i] = dSs[r * kSLD + lane + 32 * i];
      m = fmaxf(m, lg[i]);
    }
    m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i) {
      lg[i] = expf(lg[i] - m);
      l += lg[i];
    }
    l = warp_sum(l);
    float pds = 0.f;
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i) {
      lg[i] = lg[i] / l;  // p
      pds += lg[i] * ds[i];
    }
    pds = warp_sum(pds);
    __syncwarp();  // every lane has read its row before any bf16 overwrites it
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i) {
      Ps[r * PLD + lane + 32 * i] = __float2bfloat16_rn(lg[i]);
      dPs[r * PLD + lane + 32 * i] = __float2bfloat16_rn(lg[i] * (ds[i] - pds));
    }
  }
  __syncthreads();  // p and dp are complete; dk̂ is done with

  // dout [QB x DP] = dp . v + p . dv, fragment f = warp + i*NW held in acc[i]
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXF];
  auto rows_x_values = [&](const bf16* A) {
#pragma unroll
    for (int i = 0; i < MAXF; ++i) {
      const int f = warp + i * NW;
      if (f >= NF) continue;
      const int mt = f / CT, nt = f % CT;
#pragma unroll 4
      for (int kk = 0; kk < kWinTokens; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(a, A + mt * 16 * PLD + kk, PLD);
        wmma::load_matrix_sync(vb, KVs + kk * LDQ + nt * 16, LDQ);
        wmma::mma_sync(acc[i], a, vb, acc[i]);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < MAXF; ++i) wmma::fill_fragment(acc[i], 0.0f);
  for (int r = warp; r < kWinTokens; r += NW)
    load_row<DP>(KVs + r * LDQ, head + token(r) * feat + 2 * d, d, false, 1.0f, lane);
  __syncthreads();
  rows_x_values(dPs);  // dp . v
  __syncthreads();
  for (int r = warp; r < kWinTokens; r += NW)
    load_row<DP>(KVs + r * LDQ, dhead + token(r) * feat + 2 * d, d, false, 1.0f, lane);
  __syncthreads();
  rows_x_values(Ps);  // + p . dv

  // dp is read for the last time above the previous barrier: its buffer
  // takes the fp32 output
  constexpr int LDO = DP + 4;
  float* Os = dSs;
#pragma unroll
  for (int i = 0; i < MAXF; ++i) {
    const int f = warp + i * NW;
    if (f < NF)
      wmma::store_matrix_sync(Os + (f / CT) * 16 * LDO + (f % CT) * 16, acc[i], LDO,
                              wmma::mem_row_major);
  }
  __syncthreads();
  const size_t ofeat = (size_t)heads * d;
  for (int r = warp; r < QB; r += NW) {
    if (lane * 8 < d)
      *reinterpret_cast<uint4*>(dout + token(q0 + r) * ofeat + (size_t)h * d + lane * 8) =
          pack8(Os + r * LDO + lane * 8);
  }
}

template <int DP>
int launch_block_attn_tangent(const void* qkv, const void* dqkv, const void* scale, void* dout,
                              int B, int gh, int gw, int heads, int d, int wh, int ww, int sh,
                              int sw, cudaStream_t st) {
  using C = AttnBwd<DP>;
  cudaFuncSetAttribute(block_attn_tangent_kernel<DP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  dim3 grid(C::NQB, (gh / wh) * (gw / ww), B * heads);
  block_attn_tangent_kernel<DP><<<grid, kAttnNT, C::SMEM, st>>>(
      (const bf16*)qkv, (const bf16*)dqkv, (const float*)scale, (bf16*)dout, gh, gw, heads, d,
      wh, ww, sh, sw);
  return (int)cudaGetLastError();
}

}  // namespace swift

// Requires wh*ww == 256, gh % wh == gw % ww == 0, d % 8 == 0, d <= 128 and
// 0 <= sh < gh, 0 <= sw < gw (the wrapper checks). Returns a cudaError_t.
extern "C" int swift_block_attention(const void* qkv, const void* scale, void* out, int B,
                                     int gh, int gw, int heads, int d, int wh, int ww, int sh,
                                     int sw, void* stream) {
  const int dp = (d + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dp) {
    case 32: return swift::launch_block_attn<32>(qkv, scale, out, B, gh, gw, heads, d, wh, ww, sh, sw, st);
    case 64: return swift::launch_block_attn<64>(qkv, scale, out, B, gh, gw, heads, d, wh, ww, sh, sw, st);
    case 96: return swift::launch_block_attn<96>(qkv, scale, out, B, gh, gw, heads, d, wh, ww, sh, sw, st);
    case 128: return swift::launch_block_attn<128>(qkv, scale, out, B, gh, gw, heads, d, wh, ww, sh, sw, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Query rows a backward block holds (the number of scale partials per
// window and head is 256 / this).
extern "C" int swift_block_attention_bwd_qb(int d) { return (d + 31) / 32 * 32 <= 96 ? 64 : 32; }

// qkv (B, gh, gw, heads*3d), dout (B, gh, gw, heads*d) bf16, scale (heads,)
// fp32 -> dqkv like qkv, dscale (heads,) fp32. Workspace: part_k and part_v
// fp32 of B*heads*nW*256*dp elements each (dp = d rounded up to 32), part_s
// fp32 of B*heads*nW*(256/qb). Same shape rules as swift_block_attention.
extern "C" int swift_block_attention_bwd(const void* qkv, const void* scale, const void* dout,
                                         void* dqkv, void* dscale, void* part_k, void* part_v,
                                         void* part_s, int B, int gh, int gw, int heads, int d,
                                         int wh, int ww, int sh, int sw, void* stream) {
  const int dp = (d + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
#define SWIFT_BWD(DP)                                                                          \
  return swift::launch_block_attn_bwd<DP>(qkv, scale, dout, dqkv, dscale, part_k, part_v,     \
                                          part_s, B, gh, gw, heads, d, wh, ww, sh, sw, st)
  switch (dp) {
    case 32: SWIFT_BWD(32);
    case 64: SWIFT_BWD(64);
    case 96: SWIFT_BWD(96);
    case 128: SWIFT_BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SWIFT_BWD
}

// qkv, dqkv (B, gh, gw, heads*3d) bf16, scale (heads,) fp32 -> dout (B, gh,
// gw, heads*d) bf16, the tangent of swift_block_attention along dqkv. Same
// shape rules as swift_block_attention.
extern "C" int swift_block_attention_tangent(const void* qkv, const void* dqkv,
                                             const void* scale, void* dout, int B, int gh,
                                             int gw, int heads, int d, int wh, int ww, int sh,
                                             int sw, void* stream) {
  const int dp = (d + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
#define SWIFT_TAN(DP)                                                                          \
  return swift::launch_block_attn_tangent<DP>(qkv, dqkv, scale, dout, B, gh, gw, heads, d, wh, \
                                              ww, sh, sw, st)
  switch (dp) {
    case 32: SWIFT_TAN(32);
    case 64: SWIFT_TAN(64);
    case 96: SWIFT_TAN(96);
    case 128: SWIFT_TAN(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SWIFT_TAN
}
