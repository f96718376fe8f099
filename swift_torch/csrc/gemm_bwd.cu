// The backward GEMMs of the SwinV2 block on Hopper: the linear backward
// (kernel 13) and the SwiGLU FFN backward from saved gate/up (kernel 9) or
// with them recomputed (kernel 10).
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
// swift_ffn_bwd_recompute -- one token chunk of kernel 10, which replaces
//   swift_tpu/ops/pallas_ffn.py::_ffn_bwd_call (kernel body
//   _ffn_bwd_kernel), the backward above SWIFT_FFN_BWD_SAVE_MAX_TOKENS (the
//   0.25-degree grid): kernel 9's outputs with g = x . Wg and u = x . Wu
//   recomputed in fp32 from x, never saved. Eight products, 16 T D H FLOP:
//   tensor-core bound. The TPU kernel's point is that nothing (tokens,
//   hidden)-shaped reaches HBM; g and u alone would be 2.98 GB in bf16 at
//   264,960 tokens. A recompute pass (swiglu_bwd_recompute_wgmma_kernel)
//   forms dh = dy . W2 and g | u in fp32 for each tile of 128 tokens x 128
//   hidden units and writes only dg, du and h, in bf16, to the chunk's
//   scratch: g, u and dh never reach device memory. Then kernel 9's three
//   other products on bwd_wgmma_kernel: dx = [dg|du] . W1, and the weight
//   gradients' fp32 partials over the chunk's tokens, summed in a fixed
//   order (chunk by chunk, split by split) onto fp32 running sums, rounded
//   to bf16 once after the last chunk. The caller plans the chunks
//   (ops/ffn.py), so the scratch is bounded by a chunk, not by the tokens.
//
// The torch weights are (out, in) row-major, so the backward needs the two
// operand layouts the forward never reads: dy . W, where the reduction runs
// along W's rows, and x^T . dy, where it runs along the token dimension of
// both operands. No transposed copy of a weight or an activation is ever
// made in device memory: every product runs on the wgmma + TMA ring of
// wgmma.cuh, each stage holding plain 64 x 64 TMA boxes of the tensors as
// they lie, and the transpose lives only in the shared-memory descriptors
// (wgmma_desc_mn, wgmma_desc_mn_a) and the instruction's transpose flags.
//
#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace swift {

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
//     splits in order 0, 1, ... and rounds to bf16 (kernel 10:
//     ``splitk_accumulate_kernel`` adds them in that order onto its fp32
//     running sums, rounded after the last chunk). No float atomics: two
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
// the fp32 product, g and u the gate and up (kernel 9's saved bf16 ones, or
// kernel 10's fp32 accumulators).
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
// stage); ties go to fewer splits, a split spans at least 4 stages, at most
// ``most`` splits are tried, and the count is the one that results (every
// split non-empty).
static int bwd_splits(int M, int N, int K, int most = 16) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int clusters = sms / kLinCluster > 0 ? sms / kLinCluster : 1;
  const long long blocks = ceil_div(K, kLinBK), pairs = bwd_pairs(M, N);
  int best = 1;
  double best_cost = (double)((pairs + clusters - 1) / clusters) * blocks;
  for (int s = 2; s <= most; ++s) {
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

// out (n elements, bf16) = the splits' fp32 partials in ws summed in order.
static int reduce_splits(const float* ws, int splits, size_t n, void* out, cudaStream_t st) {
  splitk_reduce_kernel<<<(unsigned)((n / 8 + 255) / 256), 256, 0, st>>>(ws, splits, n,
                                                                         (bf16*)out);
  return (int)cudaGetLastError();
}

// dW (M x N) = A^T . B summed over K tokens, A (K x M) and B (K x N)
// row-major as they lie, in at most ``max_splits`` splits: one split
// straight to bf16, else fp32 partials in ws (splits, M, N) summed in order
// into out; with ``acc`` (kernel 10's token chunks), the partials summed in
// order onto the fp32 running sum acc (set where ``first``), nothing rounded.
static int bwd_wgrad(const void* a, const void* b, void* out, float* ws, int M, int N, int K,
                     cudaStream_t st, float* acc = nullptr, bool first = true,
                     int max_splits = 16) {
  const int splits = bwd_splits(M, N, K, max_splits);
  CUtensorMap m[7];  // A, B, dW
  if (!tensor_map_bf16(&m[0], a, K, M, kLinBK, 64) ||
      !tensor_map_bf16(&m[1], b, K, N, kLinBK, 64) || !tensor_map_bf16(&m[2], out, M, N, 64, 64))
    return kTensorMapError;
  m[3] = m[4] = m[5] = m[6] = m[2];
  const BwdArgs args{ws, M, N, K, ceil_div(ceil_div(K, kLinBK), splits), splits};
  if (splits == 1 && acc == nullptr) return launch_bwd<true, kOutBf16>(m, args, st);
  const int e = launch_bwd<true, kOutPartial>(m, args, st);
  if (e != 0) return e;
  const size_t n = (size_t)M * N;
  if (acc == nullptr) return reduce_splits(ws, splits, n, out, st);
  splitk_accumulate_kernel<<<(unsigned)((n / 8 + 255) / 256), 256, 0, st>>>(ws, splits, n, acc,
                                                                             first);
  return (int)cudaGetLastError();
}

// -- kernel 10's recompute pass -----------------------------------------------
//
// For each tile of 128 tokens m0.. and 128 hidden units j0.. of a chunk,
// two walks of K = D on the ring above, in kernel 5's pass-1 arrangement
// (384 threads: a producer warpgroup and two consumers of 64 token rows
// each; clusters of two blocks on two row tiles against one hidden tile;
// persistent clusters walking (row pair, hidden tile) items, hidden tiles
// fastest):
//   walk 1: dh = dy . W2[:, j0:j0+128], an m64n128 fp32 accumulator a
//     consumer. W2 (D, H) is read as it lies, as kernel 9's dh reads it:
//     the tile's two 64-column boxes of 64 K rows, MN-major
//     (``wgmma_desc_mn``), one a cluster block, multicast into both;
//   walk 2: g | u = x . [Wg; Wu]^T, kernel 5's m64n256 walk: the gate rows
//     j0.. and the up rows j0.. in one 256-row W1 box whose halves the two
//     blocks load through two tensor maps and multicast, so that a thread
//     holds gate unit c at acc[i] and up unit c at acc[i + 64], the same
//     token and unit as dh[i].
// Both walks share one ring of kernel 5's 48-KB stages; walk 1 fills 32 KB
// of each. Between them each consumer parks dh in fp32 in 32 KB of shared
// memory in its own accumulator order (park[i * 128 + tid], no bank
// conflicts), so that walk 2's 128 accumulator floats stand alone in
// registers. Keeping dh in registers beside them instead (192 accumulator
// floats, three boxes of their own for a step's outputs) ran within the
// spread of this form on the card (``scripts/probe_ffn_bwd_recompute.py``,
// variant ``dh_in_registers``) and spilled.
// The epilogue walks the tile in two 64-column steps. Each element goes
// once through swiglu_grad (the TPU kernel's fp32 formulas, the sigmoid
// formed once): dg and du overwrite g and u in the accumulator and h,
// rounded to bf16, goes straight into a swizzled 64 x 64 box; then dg and
// du, rounded to bf16, are written into two such boxes laid over the half
// of the park that the step has just read. Thread 0 stores the three boxes
// by TMA into the chunk's (c, 2H) [dg|du] scratch (two tensor maps of row
// stride 2H, so that a box clipped at H never spills into the other half)
// and its (c, H) h scratch. g, u and dh never reach device memory, in any
// precision. The park and one h box a consumer leave room for three stages.
constexpr int kRecBN = kLinBN / 2;         // hidden units a tile
constexpr int kDhBytes = 64 * kRecBN * 4;  // one consumer's parked dh
// a consumer's shared memory beside the ring: the park, then an h box
constexpr int kRecRegion = kDhBytes + kLinCBox;
constexpr int kRecStages =
    (kMaxSmem - ring_smem(0, 0, 2 * kRecRegion) - 256) / kLinStageBytes;
constexpr int kRecSmem = ring_smem(kRecStages, 0, 2 * kRecRegion);
static_assert(kRecStages >= 3 && kRecSmem <= kMaxSmem,
              "the recompute pass's ring and its park do not fit");

// Byte offset of a thread's bf16 pair (columns 8 j + 2 (lane % 4) + {0, 1},
// row r + 8 h of the consumer's 64) in a 64 x 64 box with the 128-byte
// swizzle, r % 8 == lane / 4: accumulator indices 4 (8 q + j) + 2 h + {0, 1}
// of 64-column step q (``store_box``'s layout).
__device__ __forceinline__ int box_at(int r, int j, int h, int lane) {
  return (r + 8 * h) * 128 + ((j ^ (lane / 4)) << 4) + (lane % 4) * 4;
}

// x, dy: the chunk's M rows (tensor maps mX, mDy, boxes of 64 rows x 64);
// w1 through mWg, mWu (its gate and up halves, boxes of 128 rows x 64); w2
// through mW2 (D rows of H, boxes of 64 x 64); dg, du, h stored through
// mDg, mDu (row stride 2H) and mH.
__global__ void __launch_bounds__(kLinThreads, 1)
    swiglu_bwd_recompute_wgmma_kernel(const __grid_constant__ CUtensorMap mDy,
                                      const __grid_constant__ CUtensorMap mW2,
                                      const __grid_constant__ CUtensorMap mX,
                                      const __grid_constant__ CUtensorMap mWg,
                                      const __grid_constant__ CUtensorMap mWu,
                                      const __grid_constant__ CUtensorMap mDg,
                                      const __grid_constant__ CUtensorMap mDu,
                                      const __grid_constant__ CUtensorMap mH, int M, int H,
                                      int D) {
  constexpr int S = kRecStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* regions = smem + S * kLinStageBytes;  // [consumer] kRecRegion bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(regions + 2 * kRecRegion);
  uint64_t* empty = full + S;

  const int rank = (int)cluster_rank();
  const int n_tiles = ceil_div(H, kRecBN);
  const int pairs = ceil_div(ceil_div(M, kBwdTileRows), kLinCluster) * n_tiles;
  const int cluster = blockIdx.x / kLinCluster, clusters = gridDim.x / kLinCluster;
  const int k_blocks = ceil_div(D, kLinBK);
  ring_init<S>(full, empty);

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      RingPos<S> pos;
      for (int p = cluster; p < pairs; p += clusters) {
        const int m0 = (p / n_tiles * kLinCluster + rank) * kBwdTileRows;
        const int j0 = p % n_tiles * kRecBN;
        const bool a0 = m0 < M, a1 = m0 + kLinRows < M;
        const uint32_t a_bytes = (a0 ? kLinABytes : 0) + (a1 ? kLinABytes : 0);
        uint32_t w2_bytes = 0;
        for (int j = 0; j < 2; ++j) w2_bytes += j0 + 64 * j < H ? kMnBBox : 0;
        produce_tile_mn<S, false, 2>(smem, full, empty, pos, &mDy, m0, a0, a1, &mW2, j0, H,
                                     a_bytes + w2_bytes, 0, k_blocks);
        produce_tile(smem, full, empty, pos, &mX, m0, a0, &mX, m0 + kLinRows, a1,
                     rank ? &mWu : &mWg, j0, true, a_bytes + kLinCluster * kLinWBytes, k_blocks);
      }
      drain(empty, pos);
    }
  } else {  // the consumers
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid % 32;
    const int r = tid / 32 * 16 + lane / 4;  // this thread's rows r, r + 8 of the 64
    unsigned char* region = regions + c * kRecRegion;
    float* park = reinterpret_cast<float*>(region);
    unsigned char* hb = region + kRecRegion - kLinCBox;
    float dh[kRecBN / 2], acc[kLinBN / 2];
    RingPos<S> pos;
    for (int p = cluster; p < pairs; p += clusters) {
      const int m0 = (p / n_tiles * kLinCluster + rank) * kBwdTileRows + c * kLinRows;
      const int j0 = p % n_tiles * kRecBN;
      const bool valid = m0 < M;
      // the wgmmas read their accumulator: zeros tell the compiler that the
      // last tile's are dead (dh across walk 2 and the epilogue, acc across walk 1)
#pragma unroll
      for (int i = 0; i < kRecBN / 2; ++i) dh[i] = 0.0f;
      consume_tile<S, false, true>(dh, smem, full, empty, pos, c, k_blocks);
      if (tid == 0) tma_store_wait_read<0>();  // the last tile's boxes in the park are read
      named_barrier_sync(1 + c, 128);
#pragma unroll
      for (int i = 0; i < kRecBN / 2; ++i) park[i * 128 + tid] = dh[i];
#pragma unroll
      for (int i = 0; i < kLinBN / 2; ++i) acc[i] = 0.0f;
      consume_tile(acc, smem, full, empty, pos, c, k_blocks);
#pragma unroll
      for (int q = 0; q < kRecBN / 64; ++q) {
        const int col = j0 + 64 * q;
        if (col >= H) break;
        unsigned char* gb = region + q * 2 * kLinCBox;  // dg, du: the park's half this step reads
        if (tid == 0) tma_store_wait_read<1>();  // the last step's h store has read its box
        named_barrier_sync(1 + c, 128);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * (8 * q + j) + 2 * h;
            const SwigluGrad lo = swiglu_grad(park[i * 128 + tid], acc[i], acc[i + 64]);
            const SwigluGrad hi = swiglu_grad(park[(i + 1) * 128 + tid], acc[i + 1], acc[i + 65]);
            acc[i] = lo.dg, acc[i + 1] = hi.dg, acc[i + 64] = lo.du, acc[i + 65] = hi.du;
            *reinterpret_cast<uint32_t*>(hb + box_at(r, j, h, lane)) = pack_bf16x2(lo.h, hi.h);
          }
        fence_async_smem();
        named_barrier_sync(1 + c, 128);  // the h box is whole, this step's park is read
        if (tid == 0 && valid) {
          tma_store_2d(&mH, hb, col, m0);
          tma_store_commit();
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * (8 * q + j) + 2 * h, at = box_at(r, j, h, lane);
            *reinterpret_cast<uint32_t*>(gb + at) = pack_bf16x2(acc[i], acc[i + 1]);
            *reinterpret_cast<uint32_t*>(gb + kLinCBox + at) =
                pack_bf16x2(acc[i + 64], acc[i + 65]);
          }
        fence_async_smem();
        named_barrier_sync(1 + c, 128);
        if (tid == 0 && valid) {
          tma_store_2d(&mDg, gb, col, m0);
          tma_store_2d(&mDu, gb + kLinCBox, col, m0);
          tma_store_commit();
        }
      }
    }
    if (tid == 0) tma_store_wait_all();
  }
}

// The recompute pass over one chunk of M tokens: x, dy (M, D), w1 (2H, D),
// w2 (D, H) -> dgu (M, 2H) and h (M, H), bf16.
static int launch_recompute(const void* x, const void* dy, const void* w1, const void* w2,
                            void* dgu, void* h, int M, int D, int H, cudaStream_t st) {
  static int resident[64];
  CUtensorMap m[8];  // dy, W2, x, Wg, Wu, dg, du, h
  if (!tensor_map_bf16(&m[0], dy, M, D, kLinRows, kLinBK) ||
      !tensor_map_bf16(&m[1], w2, D, H, kLinBK, 64) ||
      !tensor_map_bf16(&m[2], x, M, D, kLinRows, kLinBK) ||
      !tensor_map_bf16(&m[3], w1, H, D, kLinWHalf, kLinBK) ||
      !tensor_map_bf16(&m[4], (const bf16*)w1 + (size_t)H * D, H, D, kLinWHalf, kLinBK) ||
      !tensor_map_bf16(&m[5], dgu, M, H, 64, 64, true, 2 * (uint64_t)H) ||
      !tensor_map_bf16(&m[6], (const bf16*)dgu + H, M, H, 64, 64, true, 2 * (uint64_t)H) ||
      !tensor_map_bf16(&m[7], h, M, H, 64, 64))
    return kTensorMapError;
  const int pairs = ceil_div(ceil_div(M, kBwdTileRows), kLinCluster) * ceil_div(H, kRecBN);
  return launch_clusters(swiglu_bwd_recompute_wgmma_kernel, resident, kRecSmem, pairs,
                         kLinCluster, st, m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], M, H,
                         D);
}

}  // namespace swift

using namespace swift;

// fp32 elements of split-K workspace a weight gradient of (M, N) over K
// tokens needs on kernels 9 and 13 (``bwd_splits``).
extern "C" long long swift_splitk_workspace(int M, int N, int K) {
  return (long long)bwd_splits(M, N, K) * M * N;
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

// One token chunk of kernel 10: x, dy, dx (T, D) are the chunk's rows, w1
// (2H, D), w2 (D, H), all bf16. Scratch: dgu (T, 2H) and h (T, H) bf16;
// ws1, ws2 fp32 of max_splits x 2H x D and x D x H elements. Where
// ``first`` and ``last`` (the only chunk) the weight gradients go straight
// to bf16 dw1 (2H, D) and dw2 (D, H), as kernel 9's do; else the chunk's
// are summed onto the fp32 running sums acc1 (2H x D) and acc2 (D x H),
// set at ``first``, which ``last`` rounds into dw1 and dw2. T, D, H
// multiples of 8.
extern "C" int swift_ffn_bwd_recompute(const void* x, const void* dy, const void* w1,
                                       const void* w2, void* dx, void* dw1, void* dw2, void* dgu,
                                       void* h, void* ws1, void* ws2, void* acc1, void* acc2,
                                       int T, int D, int H, int max_splits, int first, int last,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool one = first && last;
  float* sum1 = one ? nullptr : (float*)acc1;
  float* sum2 = one ? nullptr : (float*)acc2;
  // g, u and dh per tile, never stored -> dg | du, h
  int e = launch_recompute(x, dy, w1, w2, dgu, h, T, D, H, st);
  if (e != 0) return e;
  e = bwd_dgrad(dgu, w1, dx, T, D, 2 * H, st);  // dx = [dg | du] . W1
  if (e != 0) return e;
  // dW1 (+)= [dg | du]^T . x ;  dW2 (+)= dy^T . h
  e = bwd_wgrad(dgu, x, dw1, (float*)ws1, 2 * H, D, T, st, sum1, first, max_splits);
  if (e != 0) return e;
  e = bwd_wgrad(dy, h, dw2, (float*)ws2, D, H, T, st, sum2, first, max_splits);
  if (e != 0 || one || !last) return e;
  e = reduce_splits(sum1, 1, (size_t)2 * H * D, dw1, st);
  if (e != 0) return e;
  return reduce_splits(sum2, 1, (size_t)D * H, dw2, st);
}
