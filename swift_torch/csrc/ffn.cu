// SwiGLU feed-forward on Hopper: y = (silu(x . Wg^T) * (x . Wu^T)) . W2^T.
//
// swift_swiglu_hidden -- pass 1 of kernel 5, which replaces
//   swift_tpu/ops/pallas_ffn.py::_ffn_call (kernel body _ffn_kernel). At
//   the flagship (T = 16,384 at B = 2, D = 1056, H = 2816) the FFN is two
//   thirds of the block's FLOPs and bound by the tensor cores: 292 GFLOP
//   against ~0.09 GB it must move. Its 1056-wide output row summed over all
//   of H does not fit a register accumulator, so the FFN is cut where the
//   TPU kernel itself rounds: h = bf16(silu(g) * u). Pass 1 (here) computes
//   h with gate and up in fp32 on kernel 1's wgmma + TMA ring (wgmma.cuh)
//   and writes it to device memory; pass 2 is kernel 1, h . W2^T
//   (gemm.cu::swift_linear with K = H). h costs T x H x 2 bytes a chunk of
//   tokens, written once and read once: 92 MB at B = 2, 0.055 ms at the
//   card's memory rate, under the products. Each tile pairs gate units
//   j..j+127 with up units j..j+127 in one 256-row W box: the two blocks
//   of a cluster load the gate and the up half, each through its own
//   tensor map over w1[:H] and w1[H:] (zero fill past H), and multicast it.
//   In the m64n256 accumulator a thread then holds gate column c at
//   acc[i] and up column c at acc[i + 64], so the SwiGLU epilogue is local
//   to each thread; h is rounded to bf16 and stored in 64 x 64 TMA boxes.
//
// swift_swiglu_hidden_pt -- pass 1 of kernel 11, which replaces
//   swift_tpu/ops/pallas_ffn.py::_ffn_pt_call (kernel body _ffn_pt_kernel):
//   h and dh = s(g)(1 + g(1 - s(g))) dg u + silu(g) du. Kernel 14's
//   arrangement: consumer 0 takes 64 rows of x and consumer 1 the same
//   rows of dx against one staged W box, so W1 is fetched once for both.
//   Consumer 1 needs consumer 0's g and u: they are handed over through
//   shared memory in fp32 (as the TPU kernel keeps them in fp32 VMEM),
//   64 KB that cost the ring one of its four stages. Pass 2 is kernel 14
//   on (h, dh). Both passes run the same wgmmas in the same k order for a
//   row as kernel 5's and share its h expression, so kernel 11's y equals
//   kernel 5's bit for bit.
//
// With G and U given, swift_ffn is the forward that saves gate and up for
// the backward -- replaces swift_tpu/ops/pallas_ffn.py::_ffn_fwd_save_call
// (kernel body _ffn_fwd_save_kernel), kernel 8. One pass on the WMMA loop
// of tile_mma.cuh: a block owns 32 token rows and walks the hidden
// dimension in chunks of 64. For each chunk it computes gate and up (fp32
// accumulation, one 32 x 128 WMMA tile whose rows of W1 are gathered from
// the gate and up halves of the (2H, D) weight), writes them rounded to
// bf16, forms h = silu(g) * u from the unrounded fp32 values, rounds h to
// bf16 in shared memory, and adds h . W2[:, chunk]^T into a 32 x D fp32
// accumulator that lives in shared memory (135 KB at D = 1056); the output
// is written once, in bf16.
//
// With the modnorm epilogue (MN), the same kernel is x + modnorm(FFN(x)) --
// replaces swift_tpu/ops/pallas_ffn.py::_ffn_mn_call (kernel body
// _ffn_mn_kernel), kernel 20. The block's y rows already sit in the fp32
// accumulator, so each warp takes a row: mean and mean square over D, var =
// E[y²] − E[y]², (y − mu)·rsqrt(var + eps)·g + b, times (1 + scale) plus
// shift from the sample's bf16 AdaLN rows, plus the residual x, rounded to
// bf16 once. y never reaches device memory in any precision.
#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace swift {

// h = silu(g) * u and its tangent dh = s(g)(1 + g(1 - s(g))) dg u + silu(g) du,
// in fp32: the one expression of kernels 5, 8, 11 and 20.
__device__ __forceinline__ float swiglu(float g, float u) { return g / (1.0f + expf(-g)) * u; }

__device__ __forceinline__ float swiglu_tangent(float g, float u, float dg, float du) {
  const float sig = 1.0f / (1.0f + expf(-g));
  return sig * (1.0f + g * (1.0f - sig)) * dg * u + g * sig * du;
}

// Pass 1 of kernels 5 and 11 (see the top of this file). A tile is 128
// hidden units: the W box's rows 0-127 are gate units j0.., rows 128-255 the
// up units j0.. beside them. Kernel 5 (PAIR false): consumer c takes rows
// m0 + 64 c of x, four stages, two output boxes a consumer in turn. Kernel
// 11 (PAIR true): consumers 0 and 1 take rows m0 of x and of dx; consumer 0
// writes its fp32 accumulator into ``hand`` (thread-major, 128 x 128 fp32,
// no bank conflicts) for consumer 1, which reads g and u there; three
// stages and one box a consumer leave room for it. Named barriers
// kHandFull (consumer 0 has written) and kHandEmpty (consumer 1 has read)
// order the handover, 256 threads each.
constexpr int kHidBN = kLinBN / 2;
constexpr int kHandBytes = 128 * 128 * 4;
constexpr int kHandFull = 3, kHandEmpty = 4;  // 1 and 2: the consumers' own box barriers
constexpr int kHidStages = (kMaxSmem - ring_smem(0, 4, 0) - 256) / kLinStageBytes;
constexpr int kHidPairStages = (kMaxSmem - ring_smem(0, 2, kHandBytes) - 256) / kLinStageBytes;

__host__ __device__ constexpr int hidden_smem(bool pair) {
  return pair ? ring_smem(kHidPairStages, 2, kHandBytes) : ring_smem(kHidStages, 4, 0);
}
static_assert(kHidStages >= 4 && hidden_smem(false) <= kMaxSmem, "pass 1's ring does not fit");
static_assert(kHidPairStages >= 3 && hidden_smem(true) <= kMaxSmem,
              "pass 1's ring and handover do not fit");

template <bool PAIR>
__global__ void __launch_bounds__(kLinThreads, 1)
    swiglu_hidden_wgmma_kernel(const __grid_constant__ CUtensorMap mA0,
                               const __grid_constant__ CUtensorMap mA1,
                               const __grid_constant__ CUtensorMap mWg,
                               const __grid_constant__ CUtensorMap mWu,
                               const __grid_constant__ CUtensorMap mH0,
                               const __grid_constant__ CUtensorMap mH1, int M, int H, int K) {
  constexpr int S = PAIR ? kHidPairStages : kHidStages;
  constexpr int NB = PAIR ? 1 : 2;  // output boxes a consumer
  constexpr int tile_rows = PAIR ? kLinRows : 2 * kLinRows, row1 = PAIR ? 0 : kLinRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* cbox = smem + S * kLinStageBytes;  // [consumer][NB] output boxes
  float* hand = reinterpret_cast<float*>(cbox + 2 * NB * kLinCBox);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(cbox + 2 * NB * kLinCBox + (PAIR ? kHandBytes : 0));
  uint64_t* empty = full + S;

  const int rank = (int)cluster_rank();
  const int n_tiles = (H + kHidBN - 1) / kHidBN;
  const int m_pairs = ((M + tile_rows - 1) / tile_rows + kLinCluster - 1) / kLinCluster;
  const int pairs = m_pairs * n_tiles;
  const int cluster = blockIdx.x / kLinCluster, clusters = gridDim.x / kLinCluster;
  const int k_blocks = (K + kLinBK - 1) / kLinBK;
  ring_init<S>(full, empty);

  if (threadIdx.x < 128) {  // the producer: rank 0 loads the gate half, rank 1 the up half
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      RingPos<S> pos;
      for (int p = cluster; p < pairs; p += clusters) {
        const int m0 = (p / n_tiles * kLinCluster + rank) * tile_rows;
        const int j0 = p % n_tiles * kHidBN;
        const bool a0 = m0 < M, a1 = m0 + row1 < M;
        const uint32_t bytes =
            (a0 ? kLinABytes : 0) + (a1 ? kLinABytes : 0) + kLinCluster * kLinWBytes;
        produce_tile(smem, full, empty, pos, &mA0, m0, a0, &mA1, m0 + row1, a1,
                     rank ? &mWu : &mWg, j0, true, bytes, k_blocks);
      }
      drain(empty, pos);
    }
  } else {  // the consumers
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const CUtensorMap* mH = c ? &mH1 : &mH0;
    float acc[kLinBN / 2];  // acc[i]: gate unit j0 + col(i); acc[i + 64]: the up unit beside it
    RingPos<S> pos;
    int boxes = 0;
    for (int p = cluster; p < pairs; p += clusters) {
      const int m0 = (p / n_tiles * kLinCluster + rank) * tile_rows + c * row1;
      const int j0 = p % n_tiles * kHidBN;
      consume_tile(acc, smem, full, empty, pos, c, k_blocks);
      if (PAIR && c == 0) {  // g and u to consumer 1, once it has read the last tile's
        if (p != cluster) named_barrier_sync(kHandEmpty, 256);
#pragma unroll
        for (int i = 0; i < 128; ++i) hand[i * 128 + tid] = acc[i];
        named_barrier_arrive(kHandFull, 256);
      }
      if (PAIR && c == 1) named_barrier_sync(kHandFull, 256);
#pragma unroll
      for (int q = 0; q < kHidBN / 64; ++q) {
        if (j0 + 64 * q >= H) break;
        unsigned char* box = cbox + (NB * c + boxes++ % NB) * kLinCBox;
        if (PAIR && c == 1) {
          const float* gu = hand + tid;  // consumer 0's acc[i] at gu[128 i]
          store_box<NB>(box, mH, j0 + 64 * q, m0, m0 < M, c, q, [&](int i) {
            return pack_bf16x2(
                swiglu_tangent(gu[i * 128], gu[(i + 64) * 128], acc[i], acc[i + 64]),
                swiglu_tangent(gu[(i + 1) * 128], gu[(i + 65) * 128], acc[i + 1], acc[i + 65]));
          });
        } else {
          store_box<NB>(box, mH, j0 + 64 * q, m0, m0 < M, c, q, [&](int i) {
            return pack_bf16x2(swiglu(acc[i], acc[i + 64]), swiglu(acc[i + 1], acc[i + 65]));
          });
        }
      }
      if (PAIR && c == 1 && p + clusters < pairs) named_barrier_arrive(kHandEmpty, 256);
    }
    if (tid == 0) tma_store_wait_all();
  }
}

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

template <bool MN>
__global__ void __launch_bounds__(GateUpMma::NT)
    ffn_kernel(const bf16* __restrict__ X, const bf16* __restrict__ W1,
               const bf16* __restrict__ W2, bf16* __restrict__ Y, bf16* __restrict__ G,
               bf16* __restrict__ U, int M, int D, int H, ModNormArgs mn) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NT = GateUpMma::NT;
  const int lda = D + 4;
  float* accS = reinterpret_cast<float*>(smem_raw);
  unsigned char* p = smem_raw + kFfnBM * lda * 4;
  // the gate/up main-loop tiles and the W2 tiles are used in turn: one buffer
  bf16* tiles = reinterpret_cast<bf16*>(p);
  float* stage = reinterpret_cast<float*>(p + kTileBytes);
  bf16* hS = reinterpret_cast<bf16*>(p + kTileBytes + kFfnBM * kStageLD * 4);

  const int tid = threadIdx.x, warp = tid / 32, wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * kFfnBM;
  for (int i = tid; i < kFfnBM * lda; i += NT) accS[i] = 0.0f;

  const int n_out_tiles = (D + kFfnBN2 - 1) / kFfnBN2;
  for (int c0 = 0; c0 < H; c0 += kFfnHC) {
    // gate (tile rows 0..63) and up (rows 64..127) for hidden units c0..c0+63
    GateUpMma::Acc acc[GateUpMma::FM][GateUpMma::FN];
    GateUpMma::run_rows(
        acc, tiles,
        [=](int r) -> const bf16* { return m0 + r < M ? X + (size_t)(m0 + r) * D : nullptr; },
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
    if (G != nullptr) {  // the saved gate and up, 8 columns a thread
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
      hS[r * kHLD + c] =
          __float2bfloat16_rn(swiglu(stage[r * kStageLD + c], stage[r * kStageLD + kFfnHC + c]));
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
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(Y + (size_t)(m0 + r) * D + cc) = pack8(accS + r * lda + cc);
  }
}

}  // namespace swift

using namespace swift;

// Pass 1 of kernels 5 and 11: tensor maps for the A sources (x, and dx or x
// again), the gate and up halves of w1 and the outputs, then the clusters.
static int hidden_resident[2][64];

template <bool PAIR>
static int launch_hidden(const void* x, const void* dx, const void* w1, void* h, void* dh, int M,
                         int D, int H, cudaStream_t stream) {
  CUtensorMap mA0, mA1, mWg, mWu, mH0, mH1;
  if (!tensor_map_bf16(&mA0, x, M, D, kLinRows, kLinBK) ||
      !tensor_map_bf16(&mA1, dx, M, D, kLinRows, kLinBK) ||
      !tensor_map_bf16(&mWg, w1, H, D, kLinWHalf, kLinBK) ||
      !tensor_map_bf16(&mWu, (const bf16*)w1 + (size_t)H * D, H, D, kLinWHalf, kLinBK) ||
      !tensor_map_bf16(&mH0, h, M, H, 64, 64) || !tensor_map_bf16(&mH1, dh, M, H, 64, 64))
    return kTensorMapError;
  const int tile_rows = PAIR ? kLinRows : 2 * kLinRows;
  const int m_pairs = ((M + tile_rows - 1) / tile_rows + kLinCluster - 1) / kLinCluster;
  return launch_clusters(swiglu_hidden_wgmma_kernel<PAIR>, hidden_resident[PAIR],
                         hidden_smem(PAIR), m_pairs * ((H + kHidBN - 1) / kHidBN), kLinCluster,
                         stream, mA0, mA1, mWg, mWu, mH0, mH1, M, H, D);
}

// x (M, D) -> h (M, H), all bf16; w1 (2H, D), gate rows then up rows. D % 8
// == 0, H % 8 == 0, 16-byte aligned bases.
extern "C" int swift_swiglu_hidden(const void* x, const void* w1, void* h, int M, int D, int H,
                                   void* stream) {
  return launch_hidden<false>(x, x, w1, h, h, M, D, H, (cudaStream_t)stream);
}

// x, dx (M, D) -> h, dh (M, H), all bf16; w1 as swift_swiglu_hidden.
extern "C" int swift_swiglu_hidden_pt(const void* x, const void* dx, const void* w1, void* h,
                                      void* dh, int M, int D, int H, void* stream) {
  return launch_hidden<true>(x, dx, w1, h, dh, M, D, H, (cudaStream_t)stream);
}

extern "C" int swift_ffn_smem(int D) { return ffn_smem(D); }

// Kernel 8: x (M, D) -> y (M, D) and the gate and up g, u (M, H), all bf16;
// w1 (2H, D), w2 (D, H).
extern "C" int swift_ffn(const void* x, const void* w1, const void* w2, void* y, void* g, void* u,
                         int M, int D, int H, void* stream) {
  const int smem = ffn_smem(D);
  cudaFuncSetAttribute(ffn_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ffn_kernel<false><<<(M + kFfnBM - 1) / kFfnBM, GateUpMma::NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w1, (const bf16*)w2, (bf16*)y, (bf16*)g, (bf16*)u, M, D, H,
      ModNormArgs{});
  return (int)cudaGetLastError();
}

// Kernel 20: y = x + modnorm(FFN(x)); x, y (M, D) bf16 with M = B·tps
// tokens; g, b (D,) fp32; scale, shift (B, D) bf16. Kernel 8's shape rules.
extern "C" int swift_ffn_mn(const void* x, const void* w1, const void* w2, const void* g,
                            const void* b, const void* scale, const void* shift, void* y, int M,
                            int D, int H, int tps, float eps, void* stream) {
  const int smem = ffn_smem(D);
  cudaFuncSetAttribute(ffn_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const ModNormArgs mn{(const float*)g, (const float*)b, (const bf16*)scale, (const bf16*)shift,
                       tps, eps};
  ffn_kernel<true><<<(M + kFfnBM - 1) / kFfnBM, GateUpMma::NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w1, (const bf16*)w2, (bf16*)y, nullptr, nullptr, M, D, H, mn);
  return (int)cudaGetLastError();
}
