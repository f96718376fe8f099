// The SwinV2 block's two projection GEMMs on Hopper, bf16 in, fp32
// accumulation, bf16 out.
//
// swift_linear -- replaces swift_tpu/ops/pallas_linear.py::_lin_call
//   (kernel body _lin_kernel): the qkv projection y = x . W^T,
//   (T, 1056) x (3168, 1056)^T at the 12x88 flagship. Compute-bound
//   (~2*T*1056*3168 FLOP against ~T*8.4 KB moved), so it runs on Hopper's
//   own path to the tensor cores: wgmma fed by TMA through an mbarrier
//   ring, a producer warp and two consumer warpgroups, accumulators in
//   registers (see linear_wgmma_kernel; the pieces are in wgmma.cuh). The
//   TPU zero-padded d=88 heads to 128 lanes; here N=3168 is taken as it is
//   and TMA clips the ragged last column tile.
//
// swift_linear_pt -- replaces swift_tpu/ops/pallas_linear.py::_lin_pt_call
//   (kernel body _lin_pt_kernel): y = x . W^T and dy = dx . W^T, the qkv
//   projection's primal and tangent in the sCM jvp forward. The same kernel,
//   one consumer on 64 rows of x and the other on the same 64 rows of dx,
//   read in place (no stacked copy in device memory), both against every
//   staged W tile, so W is fetched as often as for kernel 1 over T rows.
//   Compute-bound (4*T*1056*3168 FLOP).
//
// The two are also pass 2 of the SwiGLU FFN's kernels 5 and 11 (ffn.cu):
// y = h . W2^T with K = H = 2816 and N = D = 1056, and dy = dh . W2^T.
//
// swift_mm_modnorm -- replaces swift_tpu/ops/pallas_modnorm.py::_mm_mn_call
//   (kernel body _mm_mn_kernel): out = r + (LN(x . Wo^T) g + b)(1 + sc) + sh
//   with the per-sample AdaLN rows sc/sh. LayerNorm needs whole rows of all
//   D=1056 columns, which a register accumulator cannot hold, so a block
//   owns 32 token rows, walks D in 128-column tiles, parks each fp32 tile in
//   a 32 x 1056 shared-memory accumulator (135 KB) and runs the LN/AdaLN/
//   residual epilogue from there: the (T, D) product never reaches device
//   memory. Bound by the tensor cores on the product; the epilogue is one
//   read of r and one write of out.
//
// swift_mm_modnorm_int8 -- replaces swift_tpu/ops/pallas_modnorm.py::
//   fused_matmul_modnorm_residual_int8 (kernel body _mm_mn_q_kernel), kernel
//   19 of the int8 forecast: swift_mm_modnorm with y = (int8(x) . Wq^T) * sx *
//   sw, x quantized per token inside the block (see mm_modnorm_i8_kernel).
//   Bound by the bytes it moves (2 * T * 1056 * 2 + T * inner * 2), ~0.03 ms
//   at T = 16,384: the int8 product is cheap at 1979 TOP/s.
#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace swift {

// Kernels 1 and 14: Y = A . W^T on one wgmma + TMA main loop.
//
// One block alone is held back by the L2's feed to the SMs, not by the
// tensor cores: its 128 x 256 output tile loads 48 KB a 64-deep stage for
// 4.2 MFLOP, 1.39 GB a launch at T = 16,384, N = 3168, and it was fed no
// faster than about 6 TB/s. So two blocks on neighbouring SMs form a
// cluster that works on two row tiles against one column tile, and each
// block loads half of the stage's W box and multicasts it to both: 32 KB a
// stage a block. (A release at cluster scope on the remote arrivals made
// the ring twice as slow; the plain arrive, as CUTLASS's, suffices: a
// stage is released only after the wgmmas that read it have completed.)
// The blocks are persistent (one an SM), walking tile pairs column tiles
// fastest, so the clusters in flight share a few row blocks of A while all
// of W (6.7 MB at 3168 x 1056) stays in L2. Warp specialisation, 384
// threads a block:
//   warpgroup 0, the producer: one thread keeps TMA loads in flight through
//     a ring of kLinStages stages (64 deep in K: two 64-row A boxes and the
//     kLinBN-row W box a stage) and gives its registers to the consumers;
//   warpgroups 1 and 2, the consumers: each multiplies its 64-row A box by
//     the stage's W box with four m64n256k16 wgmmas a stage, keeping the
//     next stage's loads and its own previous wgmma group in flight, and
//     releases each stage in both blocks of the cluster. Each holds its
//     64 x kLinBN fp32 accumulator in registers. The epilogue rounds it to
//     bf16 in registers, writes it into two swizzled 64 x 64 shared-memory
//     boxes in turn and stores each with TMA, which clips the ragged edges;
//     meanwhile the producer fills the ring for the next tile.
// Kernel 1 gives consumer c rows [m0 + 64 c, m0 + 64 c + 64) of x. Kernel 14
// gives consumer 0 rows [m0, m0 + 64) of x and consumer 1 the same rows of
// dx, each read in place through its own tensor map, against the one
// staged W box: W is fetched once for both products, as the TPU kernel's
// one W block serves x and dx. Both run the same wgmmas in the same k
// order for a row, so kernel 14's outputs equal kernel 1's bit for bit.
// TMA zero-fills the ragged K tail (K = 1056 is 16.5 boxes; K = 32 is half
// of one), rows past M and columns past N; a box wholly past the edge is
// not loaded (its consumer's products are never stored).
constexpr int kLinStages = (kMaxSmem - ring_smem(0, 4, 0) - 256) / kLinStageBytes;
constexpr int kLinSmem = ring_smem(kLinStages, 4, 0);
static_assert(kLinStages >= 4 && kLinSmem <= kMaxSmem, "kernel 1's ring does not fit");

// Consumer c's rows of row tile mt start at mt * tile_rows + c * row1: 128
// and 64 for kernel 1, 64 and 0 for kernel 14. Launched in clusters of
// kLinCluster blocks along x.
__global__ void __launch_bounds__(kLinThreads, 1)
    linear_wgmma_kernel(const __grid_constant__ CUtensorMap mA0,
                        const __grid_constant__ CUtensorMap mA1,
                        const __grid_constant__ CUtensorMap mW,
                        const __grid_constant__ CUtensorMap mY0,
                        const __grid_constant__ CUtensorMap mY1, int M, int N, int K,
                        int tile_rows, int row1) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* cbox = smem + kLinStages * kLinStageBytes;  // [consumer][2] output boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(cbox + 4 * kLinCBox);
  uint64_t* empty = full + kLinStages;

  const int rank = (int)cluster_rank();
  const int n_tiles = (N + kLinBN - 1) / kLinBN;
  const int m_pairs = ((M + tile_rows - 1) / tile_rows + kLinCluster - 1) / kLinCluster;
  const int pairs = m_pairs * n_tiles;
  const int cluster = blockIdx.x / kLinCluster, clusters = gridDim.x / kLinCluster;
  const int k_blocks = (K + kLinBK - 1) / kLinBK;
  ring_init<kLinStages>(full, empty);

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      RingPos<kLinStages> pos;
      for (int p = cluster; p < pairs; p += clusters) {
        const int m0 = (p / n_tiles * kLinCluster + rank) * tile_rows;
        const int n0 = p % n_tiles * kLinBN;
        const bool a0 = m0 < M, a1 = m0 + row1 < M;
        uint32_t bytes = (a0 ? kLinABytes : 0) + (a1 ? kLinABytes : 0);
        for (int r = 0; r < kLinCluster; ++r) bytes += n0 + r * kLinWHalf < N ? kLinWBytes : 0;
        const int wrow = n0 + rank * kLinWHalf;
        produce_tile(smem, full, empty, pos, &mA0, m0, a0, &mA1, m0 + row1, a1, &mW, wrow,
                     wrow < N, bytes, k_blocks);
      }
      drain(empty, pos);
    }
  } else {  // the consumers
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const CUtensorMap* mY = c ? &mY1 : &mY0;
    float acc[kLinBN / 2];
    RingPos<kLinStages> pos;
    int boxes = 0;
    for (int p = cluster; p < pairs; p += clusters) {
      const int m0 = (p / n_tiles * kLinCluster + rank) * tile_rows + c * row1;
      const int n0 = p % n_tiles * kLinBN;
      consume_tile(acc, smem, full, empty, pos, c, k_blocks);
      // epilogue: 64 columns at a time through the consumer's two boxes in turn
#pragma unroll
      for (int q = 0; q < kLinBN / 64; ++q) {
        if (n0 + 64 * q >= N) break;
        store_box<2>(cbox + (2 * c + (boxes++ & 1)) * kLinCBox, mY, n0 + 64 * q, m0, m0 < M, c,
                     q, [&](int i) { return pack_bf16x2(acc[i], acc[i + 1]); });
      }
    }
    if (threadIdx.x % 128 == 0) tma_store_wait_all();
  }
}

constexpr int kBK = 32, kMnBM = 32, kMnBN = 128;
using MnMma = TileMma<kMnBM, kMnBN, kBK, 2, 4>;

__host__ __device__ constexpr int mm_modnorm_smem(int D) {
  return kMnBM * (D + 4) * 4 + MnMma::SMEM;
}

__global__ void __launch_bounds__(MnMma::NT)
    mm_modnorm_kernel(const bf16* __restrict__ X, const bf16* __restrict__ W,
                      const bf16* __restrict__ R, const float* __restrict__ g,
                      const float* __restrict__ b, const bf16* __restrict__ msc,
                      const bf16* __restrict__ msh, bf16* __restrict__ out, int M, int K, int D,
                      int tps, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lda = D + 4;
  float* accS = reinterpret_cast<float*>(smem_raw);
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw + kMnBM * lda * 4);
  const int m0 = blockIdx.x * kMnBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wm = warp / 4, wn = warp % 4;

  for (int n0 = 0; n0 < D; n0 += kMnBN) {
    MnMma::Acc acc[MnMma::FM][MnMma::FN];
    MnMma::run(
        acc, tiles, X, K, [=](int r) { return m0 + r < M ? m0 + r : -1; }, W, K,
        [=](int r) { return n0 + r < D ? n0 + r : -1; }, K);
#pragma unroll
    for (int j = 0; j < MnMma::FN; ++j) {
      const int col = n0 + wn * MnMma::FN * 16 + j * 16;
      if (col < D)
        wmma::store_matrix_sync(accS + (wm * 16) * lda + col, acc[0][j], lda,
                                wmma::mem_row_major);
    }
  }
  __syncthreads();

  // epilogue, one warp per row: fp32 statistics with var = E[y^2] - mu^2 as
  // the TPU kernel computes it, then LN affine, AdaLN and the residual.
  const float inv_d = 1.0f / (float)D;
  for (int r = warp; r < kMnBM; r += MnMma::NT / 32) {
    const int gr = m0 + r;
    if (gr >= M) break;
    const float* y = accS + r * lda;
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = y[c];
      s += v;
      ss += v * v;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s * inv_d;
    const float rs = rsqrtf(ss * inv_d - mu * mu + eps);
    const size_t bi = (size_t)(gr / tps) * D;
    const size_t ro = (size_t)gr * D;
    for (int c = lane; c < D; c += 32) {
      const float ln = (y[c] - mu) * rs * g[c] + b[c];
      float o = ln * (1.0f + __bfloat162float(msc[bi + c])) + __bfloat162float(msh[bi + c]);
      o = o + __bfloat162float(R[ro + c]);
      out[ro + c] = __float2bfloat16_rn(o);
    }
  }
}

// Kernel 19: int8 wo + modnorm. Kernel 3's design with the int8 main loop:
// the block quantizes its 32 x rows whole (all K = inner columns, the row
// abs-max before any product) into a resident k-chunk-major int8 tile, walks
// D in 128-column tiles of the int8 weight, parks each int32 tile in the
// 32 x D accumulator (135 KB at D = 1056) and rescales y = (acc * sx) * sw in
// fp32 in the epilogue. The TPU kernel pads the 12 x 88 attention output to
// 12 x 128 lanes with zeros; here it is 1056 wide: zero lanes change neither
// a row's abs-max nor the products.
constexpr int kMnQBK = 64;
using MnQMma = TileMmaI8<kMnBM, kMnBN, kMnQBK, 2, 4>;

__host__ __device__ constexpr int mm_modnorm_i8_smem(int K, int D) {
  return kMnBM * (D + 4) * 4 + round128(kMnBM * K) + MnQMma::SMEM + kMnBM * 4;
}

__global__ void __launch_bounds__(MnQMma::NT)
    mm_modnorm_i8_kernel(const bf16* __restrict__ X, const signed char* __restrict__ Wq,
                         const float* __restrict__ sw, const bf16* __restrict__ R,
                         const float* __restrict__ g, const float* __restrict__ b,
                         const bf16* __restrict__ msc, const bf16* __restrict__ msh,
                         bf16* __restrict__ out, int M, int K, int D, int tps, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lda = D + 4;
  int* accS = reinterpret_cast<int*>(smem_raw);
  signed char* xq = reinterpret_cast<signed char*>(smem_raw + kMnBM * lda * 4);
  signed char* bs = xq + round128(kMnBM * K);
  float* sx = reinterpret_cast<float*>(bs + MnQMma::SMEM);
  const int m0 = blockIdx.x * kMnBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wm = warp / 4, wn = warp % 4;

  quantize_rows<kMnBM, MnQMma::NT>(xq, sx, X, m0, M, K);
  __syncthreads();
  for (int n0 = 0; n0 < D; n0 += kMnBN) {
    MnQMma::Acc acc[MnQMma::FM][MnQMma::FN];
    MnQMma::run(
        acc, xq, bs,
        [=](int r) -> const signed char* {
          return n0 + r < D ? Wq + (size_t)(n0 + r) * K : nullptr;
        },
        Wq, K);
#pragma unroll
    for (int j = 0; j < MnQMma::FN; ++j) {
      const int col = n0 + wn * MnQMma::FN * 16 + j * 16;
      if (col < D)
        wmma::store_matrix_sync(accS + (wm * 16) * lda + col, acc[0][j], lda, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // epilogue, one warp per row, as kernel 3's with y = (acc * sx) * sw
  const float inv_d = 1.0f / (float)D;
  for (int r = warp; r < kMnBM; r += MnQMma::NT / 32) {
    const int gr = m0 + r;
    if (gr >= M) break;
    const int* yi = accS + r * lda;
    const float s_x = sx[r];
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = ((float)yi[c] * s_x) * sw[c];
      s += v;
      ss += v * v;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s * inv_d;
    const float rs = rsqrtf(ss * inv_d - mu * mu + eps);
    const size_t bi = (size_t)(gr / tps) * D;
    const size_t ro = (size_t)gr * D;
    for (int c = lane; c < D; c += 32) {
      const float y = ((float)yi[c] * s_x) * sw[c];
      const float ln = (y - mu) * rs * g[c] + b[c];
      float o = ln * (1.0f + __bfloat162float(msc[bi + c])) + __bfloat162float(msh[bi + c]);
      o = o + __bfloat162float(R[ro + c]);
      out[ro + c] = __float2bfloat16_rn(o);
    }
  }
}

}  // namespace swift

using namespace swift;

// Kernels 1 and 14 share this launcher: tensor maps for the two A sources,
// W and the two outputs, then as many clusters of two blocks as the card
// holds at once (fewer for a small problem).
static int linear_resident[64];

static int launch_linear(const void* a0, const void* a1, const void* w, void* y0, void* y1,
                         int M, int N, int K, int tile_rows, int row1, cudaStream_t stream) {
  CUtensorMap mA0, mA1, mW, mY0, mY1;
  if (!tensor_map_bf16(&mA0, a0, M, K, kLinRows, kLinBK) ||
      !tensor_map_bf16(&mA1, a1, M, K, kLinRows, kLinBK) ||
      !tensor_map_bf16(&mW, w, N, K, kLinWHalf, kLinBK) ||
      !tensor_map_bf16(&mY0, y0, M, N, 64, 64) || !tensor_map_bf16(&mY1, y1, M, N, 64, 64))
    return kTensorMapError;
  const int m_pairs = ((M + tile_rows - 1) / tile_rows + kLinCluster - 1) / kLinCluster;
  return launch_clusters(linear_wgmma_kernel, linear_resident, kLinSmem,
                         m_pairs * ((N + kLinBN - 1) / kLinBN), stream, mA0, mA1, mW, mY0, mY1,
                         M, N, K, tile_rows, row1);
}

// x (M, K) -> y (M, N), all bf16; w (N, K). K % 8 == 0, N % 8 == 0, 16-byte
// aligned bases.
extern "C" int swift_linear(const void* x, const void* w, void* y, int M, int N, int K,
                            void* stream) {
  return launch_linear(x, x, w, y, y, M, N, K, 2 * kLinRows, kLinRows, (cudaStream_t)stream);
}

// x, dx (M, K) -> y, dy (M, N), all bf16; w (N, K). K % 8 == 0, N % 8 == 0.
extern "C" int swift_linear_pt(const void* x, const void* dx, const void* w, void* y, void* dy,
                               int M, int N, int K, void* stream) {
  return launch_linear(x, dx, w, y, dy, M, N, K, kLinRows, 0, (cudaStream_t)stream);
}

extern "C" int swift_mm_modnorm_smem(int D) { return mm_modnorm_smem(D); }

extern "C" int swift_mm_modnorm(const void* x, const void* w, const void* r, const void* g,
                                const void* b, const void* msc, const void* msh, void* out,
                                int M, int K, int D, int tps, float eps, void* stream) {
  const int smem = mm_modnorm_smem(D);
  cudaFuncSetAttribute(mm_modnorm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  mm_modnorm_kernel<<<(M + kMnBM - 1) / kMnBM, MnMma::NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)r, (const float*)g, (const float*)b,
      (const bf16*)msc, (const bf16*)msh, (bf16*)out, M, K, D, tps, eps);
  return (int)cudaGetLastError();
}

extern "C" int swift_mm_modnorm_int8_smem(int K, int D) { return mm_modnorm_i8_smem(K, D); }

// x (M, K) bf16; wq (D, K) int8 with per-row fp32 scales sw (D,); the rest
// as swift_mm_modnorm. K % 16 == 0, D % 16 == 0.
extern "C" int swift_mm_modnorm_int8(const void* x, const void* wq, const void* sw, const void* r,
                                     const void* g, const void* b, const void* msc,
                                     const void* msh, void* out, int M, int K, int D, int tps,
                                     float eps, void* stream) {
  const int smem = mm_modnorm_i8_smem(K, D);
  cudaFuncSetAttribute(mm_modnorm_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  mm_modnorm_i8_kernel<<<(M + kMnBM - 1) / kMnBM, MnQMma::NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const signed char*)wq, (const float*)sw, (const bf16*)r, (const float*)g,
      (const float*)b, (const bf16*)msc, (const bf16*)msh, (bf16*)out, M, K, D, tps, eps);
  return (int)cudaGetLastError();
}

extern "C" int swift_max_smem() { return kMaxSmem; }

extern "C" const char* swift_error_string(int code) {
  if (code == kTensorMapError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}
