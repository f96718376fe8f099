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
