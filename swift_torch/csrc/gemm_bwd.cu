// The backward GEMMs of the SwinV2 block on Hopper: the linear backward
// (kernel 13) and the SwiGLU FFN backward from saved gate/up (kernel 9).
//
// swift_linear_bwd -- replaces swift_tpu/ops/pallas_linear.py::_lin_bwd_call
//   (kernel body _lin_bwd_kernel): dx = dy . W and dW = dy^T . x summed over
//   every token. At the flagship ((T, 3168) x (3168, 1056)) it is 2 x 2TKN
//   FLOP against ~T * 8.4 KB moved: the tensor cores bound it. Two launches
//   of bwd_wgmma_kernel (dx; dW split over the tokens), then the fixed-order
//   sum of the splits.
// swift_ffn_bwd_saved -- replaces swift_tpu/ops/pallas_ffn.py::
//   _ffn_bwd_saved_call (kernel body _ffn_bwd_saved_kernel): dh = dy . W2,
//   dg = dh * u * silu'(g), du = dh * silu(g) (both rounded to bf16, as the
//   TPU kernel rounds them), dx = [dg|du] . W1, dW1 = [dg|du]^T . x and
//   dW2 = dy^T . h with h = bf16(silu(g) * u). Six products, ~12 T D H FLOP:
//   tensor-core bound. Four launches of bwd_wgmma_kernel: dh with the
//   SwiGLU backward in its epilogue (it reads the saved g and u and writes
//   dg | du and h, bf16, 277 MB of scratch at T = 16,384, H = 2816), dx, and
//   the two weight gradients split over the tokens, then their sums.
// swift_ffn_bwd_recompute -- replaces swift_tpu/ops/pallas_ffn.py::
//   _ffn_bwd_call (kernel body _ffn_bwd_kernel), the backward above
//   SWIFT_FFN_BWD_SAVE_MAX_TOKENS (the 0.25-degree grid): the same outputs
//   with g = x . Wg and u = x . Wu recomputed in fp32 from x, never saved.
//   Eight products, ~16 T D H FLOP: tensor-core bound. The TPU kernel's
//   point is that nothing (tokens, hidden)-shaped reaches HBM; g and u alone
//   would be 2.98 GB in bf16 at 264,960 tokens. Here one block forms the
//   128 x 128 tiles of g, u and dh of the same tokens and hidden columns one
//   after another, keeps g and u in shared memory as fp32 (they never leave
//   the block) and writes only dg, du and h, in bf16, for one chunk of
//   tokens at a time (kBwdChunk): the chunk's dx and its share of dW1 and
//   dW2 follow, the weight gradients summed over the chunks in fp32 in
//   chunk order. The scratch is bounded by the chunk, not by the tokens.
//
// The torch weights are (out, in) row-major, so the backward needs the two
// operand layouts the forward never reads: dy . W, where the reduction runs
// along W's rows, and x^T . dy, where it runs along the token dimension of
// both operands. No transposed copy of a weight or an activation is ever
// made in device memory. Two main loops serve them:
//   kernels 9 and 13 run every product on the wgmma + TMA ring of
//   wgmma.cuh (bwd_wgmma_kernel): each stage holds plain 64 x 64 TMA boxes
//   of the tensors as they lie, and the transpose lives only in the
//   shared-memory descriptors (wgmma_desc_mn, wgmma_desc_mn_a) and the
//   instruction's transpose flags;
//   kernel 10 keeps the WMMA loop below (gemm_kernel, gemm_mainloop): each
//   operand tile staged in its natural global layout by cp.async and handed
//   to the tensor cores as a row- or column-major WMMA fragment.
//
#include <type_traits>

#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace swift {

constexpr int GBM = 128, GBN = 128, GBK = 32, GWM = 2, GWN = 4, GNT = GWM * GWN * 32;
constexpr int GFM = GBM / GWM / 16, GFN = GBN / GWN / 16;
constexpr int GLDC = GBN + 4;  // fp32 staging stride of the output tile
constexpr int kGemmSmem = GBM * GLDC * 4;  // >= the two double-buffered operand tiles
constexpr int kWaveBlocks = 4 * 132;       // split-K target: about four blocks per SM

// Operand layouts of C[m][n] = sum_k A(m, k) B(k, n).
//   A: kAK -> A[m * lda + k] (K contiguous);  kAM -> A[k * lda + m] (M contiguous)
//   B: kBK -> B[n * ldb + k] (K contiguous, the nn.Linear weight);
//      kBN -> B[k * ldb + n] (N contiguous)
enum { kAK = 0, kAM = 1 };
enum { kBK = 0, kBN = 1 };
// What the block does with its fp32 tile.
enum { kEpiBf16 = 0, kEpiPartial = 1 };

// Elements of one staged operand tile: EXT x BK when K is contiguous, else
// BK x EXT (8 bf16 of padding a row against bank conflicts).
template <bool KCONT, int EXT>
__host__ __device__ constexpr int op_tile() {
  return KCONT ? EXT * (GBK + 8) : GBK * (EXT + 8);
}
static_assert(2 * (op_tile<true, GBM>() + op_tile<true, GBN>()) * 2 <= kGemmSmem, "smem");
static_assert(2 * (op_tile<false, GBM>() + op_tile<false, GBN>()) * 2 <= kGemmSmem, "smem");

// Stage rows [e0, e0+EXT) x reduction [k0, k0+BK) of an operand. Extents
// and the reduction end are multiples of 8 (the wrappers check), so each
// 16-byte chunk lies wholly inside or wholly outside; outside is zero-filled.
template <bool KCONT, int EXT>
__device__ __forceinline__ void load_op(bf16* s, const bf16* g, int ld, int e0, int E, int k0,
                                        int kend, int tid) {
  if (KCONT) {
    constexpr int LD = GBK + 8, CPR = GBK / 8;
    for (int c = tid; c < EXT * CPR; c += GNT) {
      const int r = c / CPR, kc = (c % CPR) * 8, e = e0 + r, k = k0 + kc;
      const bool ok = e < E && k < kend;
      cp_async16(s + r * LD + kc, ok ? g + (size_t)e * ld + k : g, ok);
    }
  } else {
    constexpr int LD = EXT + 8, CPR = EXT / 8;
    for (int c = tid; c < GBK * CPR; c += GNT) {
      const int r = c / CPR, ec = (c % CPR) * 8, k = k0 + r, e = e0 + ec;
      const bool ok = k < kend && e < E;
      cp_async16(s + r * LD + ec, ok ? g + (size_t)k * ld + e : g, ok);
    }
  }
}

using GAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc (this warp's GFM x GFN fragments of the block's GBM x GBN tile at
// (m0, n0)) = sum over k in [kb, ke) of A(m, k) B(k, n), the operand tiles
// double-buffered in smem (kGemmSmem bytes). Ends with a barrier, so the
// caller may reuse smem at once.
template <int AL, int BL>
__device__ __forceinline__ void gemm_mainloop(GAcc (&acc)[GFM][GFN], unsigned char* smem_raw,
                                              const bf16* __restrict__ A, int lda,
                                              const bf16* __restrict__ B, int ldb, int m0,
                                              int n0, int M, int N, int kb, int ke) {
  constexpr bool AK = AL == kAK, BK_ = BL == kBK;
  constexpr int AT = op_tile<AK, GBM>(), BT = op_tile<BK_, GBN>();
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                               typename std::conditional<AK, wmma::row_major, wmma::col_major>::type>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                               typename std::conditional<BK_, wmma::col_major, wmma::row_major>::type>;
  bf16* As[2] = {reinterpret_cast<bf16*>(smem_raw), reinterpret_cast<bf16*>(smem_raw) + AT};
  bf16* Bs[2] = {As[1] + AT, As[1] + AT + BT};
  const int tid = threadIdx.x, warp = tid / 32, wm = warp / GWN, wn = warp % GWN;
#pragma unroll
  for (int i = 0; i < GFM; ++i)
#pragma unroll
    for (int j = 0; j < GFN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (ke - kb + GBK - 1) / GBK;
  load_op<AK, GBM>(As[0], A, lda, m0, M, kb, ke, tid);
  load_op<BK_, GBN>(Bs[0], B, ldb, n0, N, kb, ke, tid);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_op<AK, GBM>(As[cur ^ 1], A, lda, m0, M, kb + (kt + 1) * GBK, ke, tid);
      load_op<BK_, GBN>(Bs[cur ^ 1], B, ldb, n0, N, kb + (kt + 1) * GBK, ke, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      FragA a[GFM];
      FragB b[GFN];
#pragma unroll
      for (int i = 0; i < GFM; ++i) {
        const int mo = wm * GFM * 16 + i * 16;
        if constexpr (AK)
          wmma::load_matrix_sync(a[i], As[cur] + mo * (GBK + 8) + kk, GBK + 8);
        else
          wmma::load_matrix_sync(a[i], As[cur] + kk * (GBM + 8) + mo, GBM + 8);
      }
#pragma unroll
      for (int j = 0; j < GFN; ++j) {
        const int no = wn * GFN * 16 + j * 16;
        if constexpr (BK_)
          wmma::load_matrix_sync(b[j], Bs[cur] + no * (GBK + 8) + kk, GBK + 8);
        else
          wmma::load_matrix_sync(b[j], Bs[cur] + kk * (GBN + 8) + no, GBN + 8);
      }
#pragma unroll
      for (int i = 0; i < GFM; ++i)
#pragma unroll
        for (int j = 0; j < GFN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Cs[GBM x GBN] (fp32, stride GLDC) = this block's tile, from every warp's
// fragments. No barrier.
__device__ __forceinline__ void store_tile(float* Cs, GAcc (&acc)[GFM][GFN]) {
  const int warp = threadIdx.x / 32, wm = warp / GWN, wn = warp % GWN;
#pragma unroll
  for (int i = 0; i < GFM; ++i)
#pragma unroll
    for (int j = 0; j < GFN; ++j)
      wmma::store_matrix_sync(Cs + (wm * GFM * 16 + i * 16) * GLDC + wn * GFN * 16 + j * 16,
                              acc[i][j], GLDC, wmma::mem_row_major);
}

template <int AL, int BL, int EPI>
__global__ void __launch_bounds__(GNT)
    gemm_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb, int M,
                int N, int K, int k_per_split, void* out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int kb = blockIdx.z * k_per_split, ke = min(K, kb + k_per_split);
  GAcc acc[GFM][GFN];
  gemm_mainloop<AL, BL>(acc, smem_raw, A, lda, B, ldb, m0, n0, M, N, kb, ke);

  // the main loop ended with a barrier: its tiles are free for the fp32 C tile
  float* Cs = reinterpret_cast<float*>(smem_raw);
  store_tile(Cs, acc);
  __syncthreads();
  for (int c = tid; c < GBM * (GBN / 8); c += GNT) {
    const int r = c / (GBN / 8), cc = (c % (GBN / 8)) * 8, gr = m0 + r, gc = n0 + cc;
    if (gr >= M || gc >= N) continue;
    const float* v = Cs + r * GLDC + cc;
    const size_t o = (size_t)gr * N + gc;
    if constexpr (EPI == kEpiBf16) {
      *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + o) = pack8(v);
    } else {
      float* p = static_cast<float*>(out) + (size_t)blockIdx.z * M * N + o;
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// Kernel 10's first pass over one chunk of tokens: for the block's GBM
// tokens and GBN hidden columns, g = x . Wg^T and u = x . Wu^T into shared
// memory as fp32, then dh = dy . W2 and the SwiGLU backward in the epilogue:
// dg = dh * u * silu'(g), du = dh * silu(g) and h = silu(g) * u, rounded to
// bf16 (the TPU kernel's rounding points; g and u themselves never are).
constexpr int kRecomputeSmem = 3 * kGemmSmem;  // operand tiles then dh | g | u
static_assert(kRecomputeSmem <= kMaxSmem, "smem");

__global__ void __launch_bounds__(GNT)
    swiglu_bwd_recompute_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                                const bf16* __restrict__ w1, const bf16* __restrict__ w2, int T,
                                int D, int H, bf16* __restrict__ dgu, bf16* __restrict__ h) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Cs = reinterpret_cast<float*>(smem_raw);
  float* Gs = reinterpret_cast<float*>(smem_raw + kGemmSmem);
  float* Us = reinterpret_cast<float*>(smem_raw + 2 * kGemmSmem);
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  GAcc acc[GFM][GFN];
  gemm_mainloop<kAK, kBK>(acc, smem_raw, x, D, w1, D, m0, n0, T, H, 0, D);  // g
  store_tile(Gs, acc);
  gemm_mainloop<kAK, kBK>(acc, smem_raw, x, D, w1 + (size_t)H * D, D, m0, n0, T, H, 0, D);  // u
  store_tile(Us, acc);
  gemm_mainloop<kAK, kBN>(acc, smem_raw, dy, D, w2, H, m0, n0, T, H, 0, D);  // dh
  store_tile(Cs, acc);
  __syncthreads();
  for (int c = threadIdx.x; c < GBM * (GBN / 8); c += GNT) {
    const int r = c / (GBN / 8), cc = (c % (GBN / 8)) * 8, gr = m0 + r, gc = n0 + cc;
    if (gr >= T || gc >= H) continue;
    float dg[8], du[8], hh[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = r * GLDC + cc + i;
      const float g = Gs[o], u = Us[o], v = Cs[o];
      const float sig = 1.0f / (1.0f + expf(-g)), sg = g * sig;
      dg[i] = v * u * (sig * (1.0f + g * (1.0f - sig)));
      du[i] = v * sg;
      hh[i] = sg * u;
    }
    const size_t og = (size_t)gr * 2 * H + gc;
    *reinterpret_cast<uint4*>(dgu + og) = pack8(dg);
    *reinterpret_cast<uint4*>(dgu + og + H) = pack8(du);
    *reinterpret_cast<uint4*>(h + (size_t)gr * H + gc) = pack8(hh);
  }
}

// acc[i] = (first ? 0 : acc[i]) + sum over splits of part[s][i], in order.
__global__ void splitk_accumulate_kernel(const float* __restrict__ part, int splits, size_t n,
                                         float* __restrict__ acc, int first) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= n) return;
  float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float4* out = reinterpret_cast<float4*>(acc + i);
  if (!first) {
    const float4 x = out[0], y = out[1];
    a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
    a[4] = y.x; a[5] = y.y; a[6] = y.z; a[7] = y.w;
  }
  for (int s = 0; s < splits; ++s) {
    const float4* p = reinterpret_cast<const float4*>(part + (size_t)s * n + i);
    const float4 x = p[0], y = p[1];
    a[0] += x.x; a[1] += x.y; a[2] += x.z; a[3] += x.w;
    a[4] += y.x; a[5] += y.y; a[6] += y.z; a[7] += y.w;
  }
  out[0] = make_float4(a[0], a[1], a[2], a[3]);
  out[1] = make_float4(a[4], a[5], a[6], a[7]);
}

// out[i] = bf16(sum over splits of part[s][i]), the splits summed in order.
__global__ void splitk_reduce_kernel(const float* __restrict__ part, int splits, size_t n,
                                     bf16* __restrict__ out) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= n) return;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    const float4* p = reinterpret_cast<const float4*>(part + (size_t)s * n + i);
    const float4 a = p[0], b = p[1];
    acc[0] += a.x; acc[1] += a.y; acc[2] += a.z; acc[3] += a.w;
    acc[4] += b.x; acc[5] += b.y; acc[6] += b.z; acc[7] += b.w;
  }
  *reinterpret_cast<uint4*>(out + i) = pack8(acc);
}

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Splits of the reduction for an (M, N, K) weight-gradient GEMM: enough
// blocks for about four per SM, each split at least 8 BK-steps long.
static int splitk_count(int M, int N, int K) {
  const int tiles = ceil_div(M, GBM) * ceil_div(N, GBN);
  int s = ceil_div(kWaveBlocks, tiles);
  s = s < 1 ? 1 : (s > 16 ? 16 : s);
  while (s > 1 && K / s < 8 * GBK) --s;
  return s;
}

template <int AL, int BL, int EPI>
static cudaError_t gemm(const void* a, int lda, const void* b, int ldb, int M, int N, int K,
                        int splits, void* out, cudaStream_t st) {
  auto kern = gemm_kernel<AL, BL, EPI>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  const int kps = ceil_div(ceil_div(K, splits), GBK) * GBK;
  dim3 grid(ceil_div(N, GBN), ceil_div(M, GBM), splits);
  kern<<<grid, GNT, kGemmSmem, st>>>((const bf16*)a, lda, (const bf16*)b, ldb, M, N, K, kps, out);
  return cudaGetLastError();
}

// dW (M, N) = sum over K tokens, split-K into ws (splits, M, N) then reduced
// to bf16 into out, or, with acc given, added in fp32 to acc (set when
// first) -- kernel 10's running sum over its token chunks.
static cudaError_t weight_grad(const void* a, int lda, const void* b, int ldb, int M, int N, int K,
                               float* ws, void* out, cudaStream_t st, float* acc = nullptr,
                               bool first = true) {
  const int splits = splitk_count(M, N, K);
  cudaError_t e = gemm<kAM, kBN, kEpiPartial>(a, lda, b, ldb, M, N, K, splits, ws, st);
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)M * N;
  const unsigned blocks = (unsigned)((n / 8 + 255) / 256);
  if (acc)
    splitk_accumulate_kernel<<<blocks, 256, 0, st>>>(ws, splits, n, acc, first);
  else
    splitk_reduce_kernel<<<blocks, 256, 0, st>>>(ws, splits, n, (bf16*)out);
  return cudaGetLastError();
}

// -- kernels 9 and 13: the backward's products on the wgmma + TMA ring ------
//
// C (M x N) = A . B with fp32 accumulation, every operand read by TMA as it
// lies in device memory: A (M x K) stored M rows of K (dy, [dg|du]: the
// products that reduce along a weight's rows) or, where A_MN, K rows of M
// (dy^T, [dg|du]^T: the weight gradients, which reduce over the tokens); B
// (K x N) always stored K rows of N (a weight W read along its rows, or the
// tokens of x and h). Each stage holds two 64 x 64 A boxes (one a consumer)
// and four 64 x 64 B boxes, plain boxes of the tensors with TMA's 128-byte
// swizzle, and wgmma reads them through K-major or MN-major descriptors
// with its transpose flags (``produce_tile_mn``, ``consume_tile<S, A_MN,
// true>``): nothing is transposed in device memory. Kernel 1's arrangement
// otherwise: 384 threads a block, a producer warpgroup and two consumer
// warpgroups with 64 x 256 fp32 accumulators in registers, 128 x 256
// output tiles, clusters of two blocks on two row tiles against one column
// tile, each block loading two of the four B boxes and multicasting them
// into both (the L2's feed holds one block alone to about half the tensor
// cores' rate: gemm.cu, kernels 1 and 14), persistent clusters walking
// (split, row pair, column tile) items, column tiles fastest.
//
// Three epilogues:
//   kOutBf16: C rounded to bf16 in registers and stored through two
//     swizzled 64 x 64 boxes a consumer by TMA (``store_box``), which clips
//     at M and N: dx of 9 and 13, and a weight gradient of one split;
//   kOutPartial: the weight gradients split over the tokens. Split s sums
//     the 64-deep stages [s sb, s sb + sb) and writes its fp32 partial to
//     part[s], float2 stores in the accumulator's layout (32 contiguous
//     bytes a row a warp store); ``splitk_reduce_kernel`` then sums the
//     splits in order 0, 1, ... and rounds to bf16. No float atomics: two
//     calls give the same bits. A split's tokens start on a stage boundary,
//     so TMA's zero fill past the tensor's end (the last split's ragged
//     tail) is the only edge a split meets;
//   kOutSwiglu: C is dh = dy . W2. Each consumer walks its tile in 64-column
//     steps with five 64 x 64 boxes of its own: two pairs for the saved
//     bf16 g and u, which its thread 0 loads by TMA one step ahead (the
//     next tile's first step during that tile's products), and one for h.
//     In one pass each thread reads its elements' g and u in the
//     accumulator's layout (the swizzled offsets store_box writes), forms
//     the TPU kernel's fp32 formulas once (pallas_ffn.py:151-177): dg = dh
//     u s(g) (1 + g (1 - s(g))), du = dh silu(g) and h = silu(g) u, and
//     writes them, rounded to bf16, over g and u in place and into the h
//     box; thread 0 stores the three boxes by TMA into the two halves of
//     the (T, 2H) scratch [dg|du] (two tensor maps with row stride 2H, so
//     that a box clipped at H never spills into the other half) and into
//     h, and waits for the previous step's stores to have read their boxes
//     before it reloads that pair. The boxes cost the ring its fourth
//     stage. The sigmoid is formed once an element, as the consumers' math
//     is latency-bound (two warps a scheduler, no products meanwhile).
// Rows past M and columns past N are zero-filled or never loaded, their
// products never stored; K's tail past the tensor is zero-filled.
enum { kOutBf16 = 0, kOutPartial = 1, kOutSwiglu = 2 };

// 64 x 64 bf16 boxes beside the ring, both consumers: two output boxes each,
// or (kOutSwiglu) two g/u pairs and an h box each
__host__ __device__ constexpr int bwd_boxes(int out) { return out == kOutSwiglu ? 10 : 4; }
__host__ __device__ constexpr int bwd_stages(int out) {
  return (kMaxSmem - ring_smem(0, bwd_boxes(out), 0) - 256) / kLinStageBytes;
}
__host__ __device__ constexpr int bwd_smem(int out) {  // four g/u barriers beside the ring's
  return ring_smem(bwd_stages(out), bwd_boxes(out), 0) + 32;
}
static_assert(bwd_stages(kOutBf16) >= 4 && bwd_smem(kOutBf16) <= kMaxSmem,
              "the backward's ring does not fit");
static_assert(bwd_stages(kOutSwiglu) >= 3 && bwd_smem(kOutSwiglu) <= kMaxSmem,
              "the backward's ring and the g, u and h boxes do not fit");
constexpr int kBwdTileRows = 2 * kLinRows;

struct BwdArgs {
  float* part;    // kOutPartial: (splits, M, N)
  int M, N, K;    // C (M x N) summed over K
  int split_blocks, splits;  // 64-deep stages a split, and the splits
};

// The SwiGLU backward at one element (the TPU kernel's formulas, fp32): dh
// the fp32 product, g and u the saved gate and up.
struct SwigluGrad {
  float dg, du, h;
};
__device__ __forceinline__ SwigluGrad swiglu_grad(float dh, float g, float u) {
  const float sig = 1.0f / (1.0f + expf(-g)), sg = g * sig;
  return {dh * u * (sig * (1.0f + g * (1.0f - sig))), dh * sg, sg * u};
}

__host__ __device__ inline int bwd_pairs(int M, int N) {
  return ceil_div(ceil_div(M, kBwdTileRows), kLinCluster) * ceil_div(N, kLinBN);
}

// mY0..2: the bf16 output (kOutBf16), or dg, du and h (kOutSwiglu, with
// the saved g and u read through mG, mU).
template <bool A_MN, int OUT>
__global__ void __launch_bounds__(kLinThreads, 1)
    bwd_wgmma_kernel(const __grid_constant__ CUtensorMap mA,
                     const __grid_constant__ CUtensorMap mB,
                     const __grid_constant__ CUtensorMap mY0,
                     const __grid_constant__ CUtensorMap mY1,
                     const __grid_constant__ CUtensorMap mY2,
                     const __grid_constant__ CUtensorMap mG,
                     const __grid_constant__ CUtensorMap mU, BwdArgs args) {
  constexpr int S = bwd_stages(OUT);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* cbox = smem + S * kLinStageBytes;  // [consumer][bwd_boxes / 2] boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(cbox + bwd_boxes(OUT) * kLinCBox);
  uint64_t* empty = full + S;
  uint64_t* gu_full = empty + S;  // [consumer][pair] (kOutSwiglu)

  const int M = args.M, N = args.N;
  const int rank = (int)cluster_rank();
  const int n_tiles = ceil_div(N, kLinBN), pairs = bwd_pairs(M, N);
  const int items = pairs * args.splits;
  const int cluster = blockIdx.x / kLinCluster, clusters = gridDim.x / kLinCluster;
  const int k_blocks = ceil_div(args.K, kLinBK);
  // item p: split p / pairs, row pair (p % pairs) / n_tiles, column tile (p % pairs) % n_tiles
  auto tile = [&](int p, int& m0, int& n0, int& kb0, int& nk) {
    const int s = p / pairs, q = p % pairs;
    m0 = (q / n_tiles * kLinCluster + rank) * kBwdTileRows;
    n0 = q % n_tiles * kLinBN;
    kb0 = s * args.split_blocks;
    nk = min(args.split_blocks, k_blocks - kb0);
  };
  if (OUT == kOutSwiglu && threadIdx.x == 0)
    for (int i = 0; i < 4; ++i) mbar_init(&gu_full[i], 1);
  ring_init<S>(full, empty);  // its fence and cluster barrier cover gu_full too

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      RingPos<S> pos;
      for (int p = cluster; p < items; p += clusters) {
        int m0, n0, kb0, nk;
        tile(p, m0, n0, kb0, nk);
        const bool a0 = m0 < M, a1 = m0 + kLinRows < M;
        uint32_t bytes = (a0 ? kLinABytes : 0) + (a1 ? kLinABytes : 0);
        for (int j = 0; j < 4; ++j) bytes += n0 + 64 * j < N ? kMnBBox : 0;
        produce_tile_mn<S, A_MN>(smem, full, empty, pos, &mA, m0, a0, a1, &mB, n0, N, bytes,
                                 kb0, nk);
      }
      drain(empty, pos);
    }
  } else {  // the consumers
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid % 32;
    float acc[kLinBN / 2];
    RingPos<S> pos;
    int boxes = 0;
    unsigned char* own = cbox + c * (bwd_boxes(OUT) / 2) * kLinCBox;
    // kOutSwiglu: step t's g and u in pair t % 2 (g box, then u box), loaded
    // where the consumer's rows start before M; the waits pair with the
    // loads in order. The h box follows the two pairs.
    int step = 0;
    uint32_t gu_phase = 0;  // bit k: the parity pair k's barrier waits for
    auto load_gu = [&](int t, int row, int col) {
      if (row < M) {
        unsigned char* pair = own + 2 * (t & 1) * kLinCBox;
        uint64_t* bar = &gu_full[2 * c + (t & 1)];
        mbar_expect_tx(bar, 2 * kLinCBox);
        tma_load_2d(pair, &mG, bar, col, row);
        tma_load_2d(pair + kLinCBox, &mU, bar, col, row);
      }
    };
    if (OUT == kOutSwiglu && tid == 0 && cluster < items) {
      int m0, n0, kb0, nk;
      tile(cluster, m0, n0, kb0, nk);
      load_gu(0, m0 + c * kLinRows, n0);
    }
    for (int p = cluster; p < items; p += clusters) {
      int m0, n0, kb0, nk;
      tile(p, m0, n0, kb0, nk);
      m0 += c * kLinRows;
      consume_tile<S, A_MN, true>(acc, smem, full, empty, pos, c, nk);
      // this thread's rows r, r + 8 of C; accumulator index i holds column
      // n0 + 8 (i / 4) + 2 (lane % 4) + i % 2 of row r + 8 ((i / 2) % 2)
      const int r = m0 + tid / 32 * 16 + lane / 4;
      if constexpr (OUT == kOutPartial) {
        float* part = args.part + (size_t)(p / pairs) * M * N;
#pragma unroll
        for (int j = 0; j < kLinBN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (r + 8 * h < M && col < N)
              *reinterpret_cast<float2*>(part + (size_t)(r + 8 * h) * N + col) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < kLinBN / 64; ++q) {
          if (n0 + 64 * q >= N) break;
          const int col = n0 + 64 * q;
          if constexpr (OUT == kOutBf16) {
            store_box<2>(own + (boxes++ & 1) * kLinCBox, &mY0, col, m0, m0 < M, c, q,
                         [&](int i) { return pack_bf16x2(acc[i], acc[i + 1]); });
          } else {
            const int t = step++;
            unsigned char* gb = own + 2 * (t & 1) * kLinCBox;
            unsigned char* ub = gb + kLinCBox;
            unsigned char* hb = own + 4 * kLinCBox;
            if (m0 < M) {
              mbar_wait(&gu_full[2 * c + (t & 1)], (gu_phase >> (t & 1)) & 1);
              gu_phase ^= 1u << (t & 1);
            }
            if (tid == 0) {
              // the last step's stores have read their boxes: its pair takes
              // the next step's g and u, the next tile's first after the last
              tma_store_wait_read<0>();
              if (q + 1 < kLinBN / 64 && col + 64 < N) {
                load_gu(t + 1, m0, col + 64);
              } else if (p + clusters < items) {
                int m1, n1, kb1, nk1;
                tile(p + clusters, m1, n1, kb1, nk1);
                load_gu(t + 1, m1 + c * kLinRows, n1);
              }
            }
            named_barrier_sync(1 + c, 128);  // the h box is free
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int i = 4 * (8 * q + j) + 2 * h;
                const int at = (tid / 32 * 16 + lane / 4 + 8 * h) * 128 +
                               ((j ^ (lane / 4)) << 4) + (lane % 4) * 4;
                const float2 g = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(gb + at));
                const float2 u = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(ub + at));
                const SwigluGrad lo = swiglu_grad(acc[i], g.x, u.x);
                const SwigluGrad hi = swiglu_grad(acc[i + 1], g.y, u.y);
                *reinterpret_cast<uint32_t*>(gb + at) = pack_bf16x2(lo.dg, hi.dg);
                *reinterpret_cast<uint32_t*>(ub + at) = pack_bf16x2(lo.du, hi.du);
                *reinterpret_cast<uint32_t*>(hb + at) = pack_bf16x2(lo.h, hi.h);
              }
            fence_async_smem();
            named_barrier_sync(1 + c, 128);
            if (tid == 0 && m0 < M) {
              tma_store_2d(&mY0, gb, col, m0);
              tma_store_2d(&mY1, ub, col, m0);
              tma_store_2d(&mY2, hb, col, m0);
              tma_store_commit();
            }
          }
        }
      }
    }
    if (tid == 0) tma_store_wait_all();
  }
}

// Launches one product on persistent clusters, as many as the card holds
// (asked once a device for each form, kept in the function's own cache).
// ``m``: the tensor maps of bwd_wgmma_kernel's parameters in order, those a
// form does not read set to any map.
template <bool A_MN, int OUT>
static int launch_bwd(const CUtensorMap (&m)[7], const BwdArgs& args, cudaStream_t st) {
  static int resident[64];
  return launch_clusters(bwd_wgmma_kernel<A_MN, OUT>, resident, bwd_smem(OUT),
                         bwd_pairs(args.M, args.N) * args.splits, kLinCluster, st, m[0], m[1],
                         m[2], m[3], m[4], m[5], m[6], args);
}

// The splits of a weight gradient (M x N) over K tokens on the ring: the
// count that makes a cluster's longest walk shortest, in 64-deep stages,
// with each split's fp32 partial written and read back costed at about
// M N / 300,000 stages (8 bytes an element at ~3 TB/s against ~0.8 us a
// stage); ties go to fewer splits, a split spans at least 4 stages, and the
// count is the one that results (every split non-empty).
static int bwd_splits(int M, int N, int K) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int clusters = sms / kLinCluster > 0 ? sms / kLinCluster : 1;
  const long long blocks = ceil_div(K, kLinBK), pairs = bwd_pairs(M, N);
  int best = 1;
  double best_cost = (double)((pairs + clusters - 1) / clusters) * blocks;
  for (int s = 2; s <= 16; ++s) {
    const long long sb = (blocks + s - 1) / s;
    if (sb < 4) break;
    const long long eff = (blocks + sb - 1) / sb;
    const double cost = (double)((pairs * eff + clusters - 1) / clusters) * sb +
                        (double)eff * M * N / 3e5;
    if (cost < best_cost) best = (int)eff, best_cost = cost;
  }
  return best;
}

// C (M x N) = A (M x K) . B (K x N), all row-major bf16 as they lie, into
// bf16 out: dx = dy . W, dh = dy . W2 (with ``g``: the SwiGLU epilogue from
// the saved g and u (M, N) into dgu (M, 2N) and h (M, N) in place of out).
static int bwd_dgrad(const void* a, const void* b, void* out, int M, int N, int K,
                     cudaStream_t st, const void* g = nullptr, const void* u = nullptr,
                     void* h = nullptr) {
  CUtensorMap m[7];  // A, B, then dx or dg, du, h, then g, u
  if (!tensor_map_bf16(&m[0], a, M, K, kLinRows, kLinBK) ||
      !tensor_map_bf16(&m[1], b, K, N, kLinBK, 64))
    return kTensorMapError;
  const BwdArgs args{nullptr, M, N, K, ceil_div(K, kLinBK), 1};
  if (g == nullptr) {
    if (!tensor_map_bf16(&m[2], out, M, N, 64, 64)) return kTensorMapError;
    m[3] = m[4] = m[5] = m[6] = m[2];
    return launch_bwd<false, kOutBf16>(m, args, st);
  }
  if (!tensor_map_bf16(&m[2], out, M, N, 64, 64, true, 2 * (uint64_t)N) ||
      !tensor_map_bf16(&m[3], (const bf16*)out + N, M, N, 64, 64, true, 2 * (uint64_t)N) ||
      !tensor_map_bf16(&m[4], h, M, N, 64, 64) || !tensor_map_bf16(&m[5], g, M, N, 64, 64) ||
      !tensor_map_bf16(&m[6], u, M, N, 64, 64))
    return kTensorMapError;
  return launch_bwd<false, kOutSwiglu>(m, args, st);
}

// dW (M x N) = A^T . B summed over K tokens, A (K x M) and B (K x N)
// row-major as they lie: one split straight to bf16, else fp32 partials in
// ws (splits, M, N) summed in order into out.
static int bwd_wgrad(const void* a, const void* b, void* out, float* ws, int M, int N, int K,
                     cudaStream_t st) {
  const int splits = bwd_splits(M, N, K);
  CUtensorMap m[7];  // A, B, dW
  if (!tensor_map_bf16(&m[0], a, K, M, kLinBK, 64) ||
      !tensor_map_bf16(&m[1], b, K, N, kLinBK, 64) || !tensor_map_bf16(&m[2], out, M, N, 64, 64))
    return kTensorMapError;
  m[3] = m[4] = m[5] = m[6] = m[2];
  const BwdArgs args{ws, M, N, K, ceil_div(ceil_div(K, kLinBK), splits), splits};
  if (splits == 1) return launch_bwd<true, kOutBf16>(m, args, st);
  const int e = launch_bwd<true, kOutPartial>(m, args, st);
  if (e != 0) return e;
  const size_t n = (size_t)M * N;
  splitk_reduce_kernel<<<(unsigned)((n / 8 + 255) / 256), 256, 0, st>>>(ws, splits, n,
                                                                         (bf16*)out);
  return (int)cudaGetLastError();
}

}  // namespace swift

using namespace swift;

// fp32 elements of split-K workspace a weight gradient of (M, N) over K
// tokens needs: enough for the splits of kernels 9 and 13 (``bwd_splits``)
// and for kernel 10's (``splitk_count``).
extern "C" long long swift_splitk_workspace(int M, int N, int K) {
  const int s = splitk_count(M, N, K), t = bwd_splits(M, N, K);
  return (long long)(s > t ? s : t) * M * N;
}

// dy (T, N), x (T, K), w (N, K) bf16 -> dx (T, K), dw (N, K) bf16; ws fp32
// of swift_splitk_workspace(N, K, T) elements. T, N, K multiples of 8.
extern "C" int swift_linear_bwd(const void* dy, const void* x, const void* w, void* dx, void* dw,
                                void* ws, int T, int N, int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int e = bwd_dgrad(dy, w, dx, T, K, N, st);  // dx = dy . W
  if (e != 0) return e;
  return bwd_wgrad(dy, x, dw, (float*)ws, N, K, T, st);  // dW = dy^T . x
}

// x, dy (T, D), g, u (T, H), w1 (2H, D), w2 (D, H) bf16 -> dx (T, D),
// dw1 (2H, D), dw2 (D, H) bf16. Scratch: dgu (T, 2H) and h (T, H) bf16;
// ws1, ws2 fp32 of swift_splitk_workspace(2H, D, T) and (D, H, T) elements.
// T, D, H multiples of 8.
extern "C" int swift_ffn_bwd_saved(const void* x, const void* dy, const void* g, const void* u,
                                   const void* w1, const void* w2, void* dx, void* dw1, void* dw2,
                                   void* dgu, void* h, void* ws1, void* ws2, int T, int D, int H,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // dh = dy . W2 with the SwiGLU backward in the epilogue -> dg | du, h
  int e = bwd_dgrad(dy, w2, dgu, T, H, D, st, g, u, h);
  if (e != 0) return e;
  e = bwd_dgrad(dgu, w1, dx, T, D, 2 * H, st);  // dx = [dg | du] . W1
  if (e != 0) return e;
  e = bwd_wgrad(dgu, x, dw1, (float*)ws1, 2 * H, D, T, st);  // dW1 = [dg | du]^T . x
  if (e != 0) return e;
  return bwd_wgrad(dy, h, dw2, (float*)ws2, D, H, T, st);  // dW2 = dy^T . h
}

// Tokens kernel 10 takes at a time: its bf16 scratch is 3H of them a token
// (277 MB at H = 2816).
extern "C" int swift_ffn_bwd_chunk() { return 16384; }

// x, dy (T, D), w1 (2H, D), w2 (D, H) bf16 -> dx (T, D), dw1 (2H, D),
// dw2 (D, H) bf16, gate and up recomputed from x. Scratch, for c =
// min(T, swift_ffn_bwd_chunk()) tokens: dgu (c, 2H) and h (c, H) bf16; ws1,
// ws2 fp32 of swift_splitk_workspace(2H, D, c) and (D, H, c) elements; acc1,
// acc2 fp32 of 2H*D and D*H elements (the running weight gradients).
extern "C" int swift_ffn_bwd_recompute(const void* x, const void* dy, const void* w1,
                                       const void* w2, void* dx, void* dw1, void* dw2, void* dgu,
                                       void* h, void* ws1, void* ws2, void* acc1, void* acc2,
                                       int T, int D, int H, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int chunk = swift_ffn_bwd_chunk();
  cudaError_t e = cudaFuncSetAttribute(swiglu_bwd_recompute_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kRecomputeSmem);
  if (e != cudaSuccess) return (int)e;
  for (int c0 = 0; c0 < T; c0 += chunk) {
    const int tc = T - c0 < chunk ? T - c0 : chunk;
    const bf16* xc = (const bf16*)x + (size_t)c0 * D;
    const bf16* dyc = (const bf16*)dy + (size_t)c0 * D;
    // g, u, dh -> dg | du, h for this chunk's tokens
    swiglu_bwd_recompute_kernel<<<dim3(ceil_div(H, GBN), ceil_div(tc, GBM)), GNT,
                                  kRecomputeSmem, st>>>(xc, dyc, (const bf16*)w1,
                                                        (const bf16*)w2, tc, D, H, (bf16*)dgu,
                                                        (bf16*)h);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // dx = [dg | du] . W1
    e = gemm<kAK, kBN, kEpiBf16>(dgu, 2 * H, w1, D, tc, D, 2 * H, 1, (bf16*)dx + (size_t)c0 * D,
                                 st);
    if (e != cudaSuccess) return (int)e;
    // dW1 += [dg | du]^T . x ;  dW2 += dy^T . h
    e = weight_grad(dgu, 2 * H, xc, D, 2 * H, D, tc, (float*)ws1, nullptr, st, (float*)acc1,
                    c0 == 0);
    if (e != cudaSuccess) return (int)e;
    e = weight_grad(dyc, D, h, H, D, H, tc, (float*)ws2, nullptr, st, (float*)acc2, c0 == 0);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t n1 = (size_t)2 * H * D, n2 = (size_t)D * H;
  splitk_reduce_kernel<<<(unsigned)((n1 / 8 + 255) / 256), 256, 0, st>>>((const float*)acc1, 1,
                                                                          n1, (bf16*)dw1);
  splitk_reduce_kernel<<<(unsigned)((n2 / 8 + 255) / 256), 256, 0, st>>>((const float*)acc2, 1,
                                                                          n2, (bf16*)dw2);
  return (int)cudaGetLastError();
}
