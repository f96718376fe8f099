// SwiGLU feed-forward on Hopper: y = (silu(x . Wg^T) * (x . Wu^T)) . W2^T.
//
// Replaces swift_tpu/ops/pallas_ffn.py::_ffn_call (kernel body
// _ffn_kernel). At the flagship (D=1056, H=2816) this is two thirds of the
// block's FLOPs, and left to separate GEMMs it would write and re-read a
// (T, 2*2816) gate/up intermediate -- 11 KB a token, more than the rest of
// the block moves. Bound: the tensor cores, once that intermediate stays on
// chip. Design: a block owns 32 token rows and walks the hidden dimension in
// chunks of 64. For each chunk it computes gate and up (fp32 accumulation,
// one 32 x 128 WMMA tile whose rows of W1 are gathered from the gate and up
// halves of the (2H, D) weight), forms h = silu(g) * u, rounds h to bf16 in
// shared memory, and adds h . W2[:, chunk]^T into a 32 x D fp32 accumulator
// that lives in shared memory (135 KB at D=1056). Nothing of width H ever
// reaches device memory; the output is written once, in bf16.
//
// With G and U given, the same kernel is the forward that saves gate and up
// for the backward -- replaces swift_tpu/ops/pallas_ffn.py::
// _ffn_fwd_save_call (kernel body _ffn_fwd_save_kernel). Each chunk's fp32
// gate and up are rounded to bf16 and written from the staging tile as it
// stands (2 x T x H x 2 bytes more traffic, ~0.18 GB at B = 2); h is still
// formed from the unrounded fp32 values, as on the TPU.
//
// With the modnorm epilogue (MN), the same kernel is x + modnorm(FFN(x)) --
// replaces swift_tpu/ops/pallas_ffn.py::_ffn_mn_call (kernel body
// _ffn_mn_kernel). The block's y rows already sit in the fp32 accumulator,
// so each warp takes a row: mean and mean square over D, var = E[y²] − E[y]²,
// (y − mu)·rsqrt(var + eps)·g + b, times (1 + scale) plus shift from the
// sample's bf16 AdaLN rows, plus the residual x, rounded to bf16 once. y
// never reaches device memory in any precision.
#include "tile_mma.cuh"

namespace swift {

constexpr int kFfnBM = 32, kFfnHC = 64, kFfnBK = 32, kFfnBN2 = 128;
using GateUpMma = TileMma<kFfnBM, 2 * kFfnHC, kFfnBK, 2, 4>;
constexpr int kStageLD = 2 * kFfnHC + 4;  // fp32 gate|up tile
constexpr int kHLD = kFfnHC + 8;          // bf16 h tile
constexpr int kW2LD = kFfnHC + 8;         // bf16 W2 tile [128 out][64 hidden]
constexpr int kW2Tile = kFfnBN2 * kW2LD;
constexpr int kTileBytes =
    GateUpMma::SMEM > 2 * kW2Tile * 2 ? GateUpMma::SMEM : 2 * kW2Tile * 2;

__host__ __device__ constexpr int ffn_smem(int D) {
  return kFfnBM * (D + 4) * 4 + kTileBytes + kFfnBM * kStageLD * 4 + kFfnBM * kHLD * 2;
}

// The modnorm epilogue's operands (MN only): LN affine g, b (D,) fp32,
// AdaLN rows scale, shift (B, D) bf16, tokens per sample, eps.
struct ModNormArgs {
  const float* g;
  const float* b;
  const bf16* scale;
  const bf16* shift;
  int tps;
  float eps;
};

template <bool PT, bool MN = false>
__global__ void __launch_bounds__(GateUpMma::NT)
    ffn_kernel(const bf16* __restrict__ X, const bf16* __restrict__ DX,
               const bf16* __restrict__ W1, const bf16* __restrict__ W2, bf16* __restrict__ Y,
               bf16* __restrict__ DY, bf16* __restrict__ G, bf16* __restrict__ U, int M, int D,
               int H, ModNormArgs mn) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NT = GateUpMma::NT;
  constexpr int ROWS = PT ? kFfnBM / 2 : kFfnBM;  // token rows a block owns
  const int lda = D + 4;
  float* accS = reinterpret_cast<float*>(smem_raw);
  unsigned char* p = smem_raw + kFfnBM * lda * 4;
  // the gate/up main-loop tiles and the W2 tiles are used in turn: one buffer
  bf16* tiles = reinterpret_cast<bf16*>(p);
  float* stage = reinterpret_cast<float*>(p + kTileBytes);
  bf16* hS = reinterpret_cast<bf16*>(p + kTileBytes + kFfnBM * kStageLD * 4);

  const int tid = threadIdx.x, warp = tid / 32, wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * ROWS;
  // tile row r -> token row; with PT rows ROWS.. are the tangent's
  auto token = [=](int r) { return m0 + (PT ? r % ROWS : r); };
  for (int i = tid; i < kFfnBM * lda; i += NT) accS[i] = 0.0f;

  const int n_out_tiles = (D + kFfnBN2 - 1) / kFfnBN2;
  for (int c0 = 0; c0 < H; c0 += kFfnHC) {
    // gate (tile rows 0..63) and up (rows 64..127) for hidden units c0..c0+63
    GateUpMma::Acc acc[GateUpMma::FM][GateUpMma::FN];
    GateUpMma::run_rows(
        acc, tiles,
        [=](int r) -> const bf16* {
          const int m = token(r);
          return m < M ? (PT && r >= ROWS ? DX : X) + (size_t)m * D : nullptr;
        },
        X,
        [=](int r) -> const bf16* {
          const int j = c0 + (r < kFfnHC ? r : r - kFfnHC);
          return j < H ? W1 + (size_t)(r < kFfnHC ? j : H + j) * D : nullptr;
        },
        W1, D);
#pragma unroll
    for (int j = 0; j < GateUpMma::FN; ++j)
      wmma::store_matrix_sync(stage + (wm * 16) * kStageLD + wn * GateUpMma::FN * 16 + j * 16,
                              acc[0][j], kStageLD, wmma::mem_row_major);
    __syncthreads();
    if (!PT && G != nullptr) {  // the saved gate and up, 8 columns a thread
      for (int e = tid; e < 2 * kFfnBM * (kFfnHC / 8); e += NT) {
        const int half = e / (kFfnBM * (kFfnHC / 8)), q = e % (kFfnBM * (kFfnHC / 8));
        const int r = q / (kFfnHC / 8), c = (q % (kFfnHC / 8)) * 8;
        if (m0 + r < M && c0 + c < H)
          *reinterpret_cast<uint4*>((half ? U : G) + (size_t)(m0 + r) * H + c0 + c) =
              pack8(stage + r * kStageLD + half * kFfnHC + c);
      }
    }
    for (int e = tid; e < kFfnBM * kFfnHC; e += NT) {
      const int r = e / kFfnHC, c = e % kFfnHC;
      const int rx = PT ? r % ROWS : r;  // the row holding this token's g and u
      const float gt = stage[rx * kStageLD + c], up = stage[rx * kStageLD + kFfnHC + c];
      float h = gt / (1.0f + expf(-gt)) * up;
      if (PT && r >= ROWS) {  // dh = s(g)(1 + g(1 - s(g))) dg u + silu(g) du
        const float sig = 1.0f / (1.0f + expf(-gt));
        const float dg = stage[r * kStageLD + c], du = stage[r * kStageLD + kFfnHC + c];
        h = sig * (1.0f + gt * (1.0f - sig)) * dg * up + gt * sig * du;
      }
      hS[r * kHLD + c] = __float2bfloat16_rn(h);
    }
    __syncthreads();

    // accS[:, n0:n0+128] += h . W2[n0:n0+128, c0:c0+64]^T, W2 tiles double-buffered
    bf16* w2s[2] = {tiles, tiles + kW2Tile};
    auto load_w2 = [&](bf16* dst, int n0) {
      load_tile<kFfnBN2, kFfnHC, kW2LD, NT>(
          dst, W2, H, [=](int r) { return n0 + r < D ? n0 + r : -1; }, c0, H, tid);
    };
    load_w2(w2s[0], 0);
    cp_async_commit();
    for (int t = 0; t < n_out_tiles; ++t) {
      if (t + 1 < n_out_tiles) load_w2(w2s[(t + 1) & 1], (t + 1) * kFfnBN2);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* ws = w2s[t & 1];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = t * kFfnBN2 + wn * 32 + j * 16;
        if (col >= D) continue;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        float* cp = accS + (wm * 16) * lda + col;
        wmma::load_matrix_sync(c, cp, lda, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kFfnHC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
          wmma::load_matrix_sync(a, hS + (wm * 16) * kHLD + kk, kHLD);
          wmma::load_matrix_sync(bw, ws + (wn * 32 + j * 16) * kW2LD + kk, kW2LD);
          wmma::mma_sync(c, a, bw, c);
        }
        wmma::store_matrix_sync(cp, c, lda, wmma::mem_row_major);
      }
      __syncthreads();
    }
  }

  if (MN) {  // one warp a token row: x + modnorm(y), rounded once
    const int lane = tid % 32;
    for (int r = warp; r < kFfnBM; r += NT / 32) {
      const int m = m0 + r;
      if (m >= M) continue;
      const float* yr = accS + r * lda;
      float s = 0.0f, ss = 0.0f;
      for (int c = lane; c < D; c += 32) {
        s += yr[c];
        ss += yr[c] * yr[c];
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      const float mu = s / D, inv = rsqrtf(ss / D - mu * mu + mn.eps);
      const bf16* sc = mn.scale + (size_t)(m / mn.tps) * D;
      const bf16* sf = mn.shift + (size_t)(m / mn.tps) * D;
      const bf16* xr = X + (size_t)m * D;
      for (int c = lane; c < D; c += 32) {
        const float ln = (yr[c] - mu) * inv * mn.g[c] + mn.b[c];
        const float o = ln * (1.0f + __bfloat162float(sc[c])) + __bfloat162float(sf[c]) +
                        __bfloat162float(xr[c]);
        Y[(size_t)m * D + c] = __float2bfloat16_rn(o);
      }
    }
    return;
  }
  for (int c = tid; c < kFfnBM * (D / 8); c += NT) {
    const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
    if (token(r) < M)
      *reinterpret_cast<uint4*>((PT && r >= ROWS ? DY : Y) + (size_t)token(r) * D + cc) =
          pack8(accS + r * lda + cc);
  }
}

}  // namespace swift

using namespace swift;

extern "C" int swift_ffn_smem(int D) { return ffn_smem(D); }

// g, u: null for the plain forward, else (M, H) bf16 outputs of gate and up.
extern "C" int swift_ffn(const void* x, const void* w1, const void* w2, void* y, void* g, void* u,
                         int M, int D, int H, void* stream) {
  const int smem = ffn_smem(D);
  cudaFuncSetAttribute(ffn_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ffn_kernel<false><<<(M + kFfnBM - 1) / kFfnBM, GateUpMma::NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, nullptr, (const bf16*)w1, (const bf16*)w2, (bf16*)y, nullptr, (bf16*)g,
      (bf16*)u, M, D, H, ModNormArgs{});
  return (int)cudaGetLastError();
}

// x, dx (M, D) -> y, dy (M, D), all bf16; w1 (2H, D), w2 (D, H).
extern "C" int swift_ffn_pt(const void* x, const void* dx, const void* w1, const void* w2, void* y,
                            void* dy, int M, int D, int H, void* stream) {
  const int smem = ffn_smem(D);
  constexpr int rows = kFfnBM / 2;
  cudaFuncSetAttribute(ffn_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ffn_kernel<true><<<(M + rows - 1) / rows, GateUpMma::NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)dx, (const bf16*)w1, (const bf16*)w2, (bf16*)y, (bf16*)dy,
      nullptr, nullptr, M, D, H, ModNormArgs{});
  return (int)cudaGetLastError();
}

// Kernel 20: y = x + modnorm(FFN(x)); x, y (M, D) bf16 with M = B·tps
// tokens; g, b (D,) fp32; scale, shift (B, D) bf16. Kernel 5's shape rules.
extern "C" int swift_ffn_mn(const void* x, const void* w1, const void* w2, const void* g,
                            const void* b, const void* scale, const void* shift, void* y, int M,
                            int D, int H, int tps, float eps, void* stream) {
  const int smem = ffn_smem(D);
  cudaFuncSetAttribute(ffn_kernel<false, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const ModNormArgs mn{(const float*)g, (const float*)b, (const bf16*)scale, (const bf16*)shift,
                       tps, eps};
  ffn_kernel<false, true><<<(M + kFfnBM - 1) / kFfnBM, GateUpMma::NT, smem,
                            (cudaStream_t)stream>>>((const bf16*)x, nullptr, (const bf16*)w1,
                                                    (const bf16*)w2, (bf16*)y, nullptr, nullptr,
                                                    nullptr, M, D, H, mn);
  return (int)cudaGetLastError();
}
