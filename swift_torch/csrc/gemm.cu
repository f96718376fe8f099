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
//   D=1056 columns, more than one SM holds at wgmma's 64 rows, so a
//   thread-block cluster splits each row's columns and exchanges the rows'
//   partial sums through distributed shared memory (mm_modnorm_wgmma_kernel):
//   the fp32 product stays in registers and never reaches device memory.
//   Bound by the tensor cores on the product (2*T*K*1056 FLOP); the
//   epilogue is one read of r and one write of out.
//
// swift_mm_modnorm_int8 -- replaces swift_tpu/ops/pallas_modnorm.py::
//   fused_matmul_modnorm_residual_int8 (kernel body _mm_mn_q_kernel), kernel
//   19 of the int8 forecast: swift_mm_modnorm with y = ((float)(xq . Wq^T) *
//   sx) * sw. Two launches: x quantized per token into int8 scratch
//   (quantize.cuh, kernel 18's pass 0), then kernel 3's cluster kernel on s8
//   operands (mm_modnorm_wgmma_kernel<BN, true>). Bound by the bytes it moves
//   (2 * T * 1056 * 2 + T * inner * 2), ~0.03 ms at T = 16,384: the int8
//   product is cheap at 1979 TOP/s.
#include "quantize.cuh"
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

// Kernel 3: out = r + (LN(x . Wo^T) g + b)(1 + sc) + sh on the wgmma + TMA
// ring, the rows of a tile split across a thread-block cluster.
//
// LayerNorm needs a whole row of y before any column of it can be written.
// A 64-row wgmma tile of all D = 1056 fp32 columns (270 KB) fits neither an
// SM's registers nor its shared memory, so a cluster of C blocks owns 128
// rows x all D columns: block ``rank`` holds columns [rank BN, rank BN + BN)
// (BN = 176, C = 6 at D = 1056). Its two consumer warpgroups keep their
// 64 x BN fp32 accumulators in registers, reduce each row's sum and sum of
// squares over their columns, and write the two floats into slot ``rank``
// of every cluster block's shared memory (distributed shared memory), then
// arrive on that block's statistics barrier with release semantics. Each
// block waits for all C slots and adds them in rank order 0 ... C - 1, so
// every block holds the same mean and rsqrt(var + eps) for a row, bit for
// bit; y never reaches device memory. The slots are double-buffered by tile
// parity: a block writes a tile's partials into a slot only after every
// peer has sent the next tile's, so after it has read the slot.
//
// Warp specialisation, 384 threads a block, persistent clusters walking
// 128-row tiles:
//   warpgroup 0, the producer: one thread keeps a ring of 64-deep stages in
//     flight (the tile's 128 x 64 A box and the block's BN x 64 W box) and,
//     once a ring's worth of a tile's stages is issued, loads the tile's
//     128 x BN slice of r into the epilogue box, after the previous tile's
//     output has left it;
//   warpgroups 1 and 2, the consumers: rows [0, 64) and [64, 128) of the
//     tile, four m64nBNk16 wgmmas a stage; then the statistics, and the
//     epilogue from registers: ln = (y - mu) rs g + b, ln (1 + sc) + sh,
//     plus r read from the box, rounded to bf16 into the box, which TMA
//     stores (clipping rows past M and columns past D). g, b and the AdaLN
//     rows are read from shared memory, where the consumers put the block's
//     columns of them once: read from L2 in the epilogue they took a quarter
//     of the kernel's time.
// Columns past D are W rows that TMA zero-fills: their y is 0 and adds
// nothing to the sums, which are divided by D. Rows past M are zero-filled
// too; their statistics are computed and never stored. The sample of row i
// is i / tps, taken per row. Bound by the tensor cores (2 M K D FLOP). Every
// block of a cluster loads the same A box: multicasting its halves from two
// blocks to all was no faster (PERF.md), so each block loads its own.
//
// Kernel 19 (S8) is this body on s8 operands: x quantized per token
// beforehand (xq, sx), Wo per output feature (Wq, sw). A stage is 128 int8
// deep (kS8BK), the bytes of a 64-deep bf16 stage in the same 128-byte box
// rows, so the ring, its descriptors and its layout are kernel 3's; a stage
// is four m64nBNk32 s8 wgmmas into an int accumulator. Once the last stage is
// consumed each value becomes y = ((float)acc * sx[row]) * sw[col], the
// plain version's order, in place (the float's bits kept in the int
// register); from there on it is kernel 3's code. The block's columns of sw
// wait in shared memory beside g and b; a row past M reads row M - 1's sx
// (its y is zero and never stored).
constexpr int kMnRows = 128, kMnMaxCluster = 8;
constexpr int kMnABytes = kMnRows * kLinBK * 2;
static_assert(kMnABytes == kMnRows * kS8BK, "an s8 stage holds the bytes of a bf16 one");
// The column slices a block may hold; the host takes the narrowest that
// covers D in at most kMnMaxCluster blocks. s8 wgmma takes N in steps of 16
// past 32, so kernel 19 has 224 where kernel 3 has 216.
constexpr int kMnWidths[] = {32, 64, 128, 176, 216};
constexpr int kMnS8Widths[] = {32, 64, 128, 176, 224};
constexpr int kMnKinds = sizeof(kMnWidths) / sizeof(kMnWidths[0]);
static_assert(sizeof(kMnS8Widths) == sizeof(kMnWidths), "one s8 width a kind");
constexpr int kMnMaxD = kMnMaxCluster * kMnWidths[kMnKinds - 1];
static_assert(kMnMaxD == 1728, "ops/modnorm.py's MATMUL_MODNORM_MAX_D");
constexpr int kMnS8MaxD = kMnMaxCluster * kMnS8Widths[kMnKinds - 1];
static_assert(kMnS8MaxD == 1792, "ops/modnorm.py's MATMUL_MODNORM_INT8_MAX_D");

template <int BN, bool S8>
struct MnLayout {
  static constexpr int W_BYTES = BN * kLinBK * 2;
  static constexpr int STAGE = kMnABytes + W_BYTES;
  static constexpr int BOX = kMnRows * BN * 2;  // r in, out back, rows of BN bf16
  static constexpr int SLOTS = 2 * kMnMaxCluster * kMnRows * 8;
  static constexpr int GB = BN * (S8 ? 12 : 8);  // the block's columns of g, b (and sw), fp32
  static constexpr int FIXED = 1024 + BOX + SLOTS + GB + 256;  // alignment pad, barriers
  static constexpr int STAGES = (kMaxSmem - FIXED) / STAGE < 8 ? (kMaxSmem - FIXED) / STAGE : 8;
  // what room is left holds the block's columns of the AdaLN rows of up to
  // SAMPLES samples (sc, then sh, bf16)
  static constexpr int LEFT = (kMaxSmem - FIXED - STAGES * STAGE) / (BN * 4);
  static constexpr int SAMPLES = LEFT < 32 ? LEFT : 32;
  static constexpr int SMEM = FIXED + STAGES * STAGE + SAMPLES * BN * 4;
  static_assert(STAGES >= 3 && SMEM <= kMaxSmem, "kernel 3's ring does not fit");
};

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int BN, bool S8>
__global__ void __launch_bounds__(kLinThreads, 1)
    mm_modnorm_wgmma_kernel(const __grid_constant__ CUtensorMap mA,
                            const __grid_constant__ CUtensorMap mW,
                            const __grid_constant__ CUtensorMap mR,
                            const __grid_constant__ CUtensorMap mOut, const float* __restrict__ g,
                            const float* __restrict__ b, const bf16* __restrict__ msc,
                            const bf16* __restrict__ msh, const float* __restrict__ sx,
                            const float* __restrict__ sw, int M, int K, int D, int tps,
                            float eps) {
  using L = MnLayout<BN, S8>;
  constexpr int S = L::STAGES, BK = S8 ? kS8BK : kLinBK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* box = smem + S * L::STAGE;
  float2* slots = reinterpret_cast<float2*>(box + L::BOX);  // [parity][rank][row]
  float* gs = reinterpret_cast<float*>(box + L::BOX + L::SLOTS);
  float* bs = gs + BN;
  float* sws = bs + BN;  // kernel 19's sw
  bf16* scs = reinterpret_cast<bf16*>(gs + L::GB / 4);  // [sample][BN]
  bf16* shs = scs + L::SAMPLES * BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(shs + L::SAMPLES * BN);
  uint64_t* empty = full + S;
  uint64_t* stat = empty + S;  // [parity]
  uint64_t* rfull = stat + 2;
  uint64_t* rempty = rfull + 1;

  const int C = (int)cluster_blocks(), rank = (int)cluster_rank();
  const int tiles = (M + kMnRows - 1) / kMnRows;
  const int cluster = blockIdx.x / C, clusters = gridDim.x / C;
  const int k_blocks = (K + BK - 1) / BK;
  const int n0 = rank * BN;
  if (threadIdx.x == 0) {
    mbar_init(&stat[0], 8 * C);  // each consumer warp of the cluster
    mbar_init(&stat[1], 8 * C);
    mbar_init(rfull, 1);
    mbar_init(rempty, 2);  // each consumer's store
  }
  ring_init<S>(full, empty, 1);

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      RingPos<S> pos;
      const int r_at = (k_blocks < S ? k_blocks : S) - 1;
      int it = 0;
      for (int t = cluster; t < tiles; t += clusters, ++it) {
        const int m0 = t * kMnRows;
        for (int kb = 0; kb < k_blocks; ++kb) {
          unsigned char* stage = smem + pos.s * L::STAGE;
          mbar_wait(&empty[pos.s], pos.phase ^ 1);
          mbar_expect_tx(&full[pos.s], L::STAGE);
          tma_load_2d(stage, &mA, &full[pos.s], kb * BK, m0);
          tma_load_2d(stage + kMnABytes, &mW, &full[pos.s], kb * BK, n0);
          pos.next();
          if (kb == r_at) {  // the ring is full of this tile: its r next
            mbar_wait(rempty, (it & 1) ^ 1);
            mbar_expect_tx(rfull, L::BOX);
            tma_load_2d(box, &mR, rfull, n0, m0);
          }
        }
      }
    }
  } else {  // the consumers
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid % 32;
    const int lr = 64 * c + tid / 32 * 16 + lane / 4;  // this thread's rows of the tile: lr, lr + 8
    const float inv_d = 1.0f / (float)D;
    // the block's columns of g, b (and sw) and, where they fit, of every
    // sample's AdaLN rows, into shared memory once (zeros past D): the
    // epilogue reads them there, not from L2
    const int ct = threadIdx.x - 128, samples = (M - 1) / tps + 1;
    const bool staged = samples <= L::SAMPLES;
    for (int i = ct; i < BN; i += 256) {
      gs[i] = n0 + i < D ? g[n0 + i] : 0.f;
      bs[i] = n0 + i < D ? b[n0 + i] : 0.f;
      if constexpr (S8) sws[i] = n0 + i < D ? sw[n0 + i] : 0.f;
    }
    for (int i = ct; staged && i < samples * BN; i += 256) {
      const int col = n0 + i % BN;
      const size_t at = (size_t)(i / BN) * D + col;
      scs[i] = col < D ? msc[at] : __float2bfloat16(0.f);
      shs[i] = col < D ? msh[at] : __float2bfloat16(0.f);
    }
    named_barrier_sync(3, 256);
    const bf16* sc_rows = staged ? scs : msc + n0;  // row s of sample s at s * stride
    const bf16* sh_rows = staged ? shs : msh + n0;
    const int stride = staged ? BN : D;
    std::conditional_t<S8, int, float> acc[BN / 2];
    RingPos<S> pos;
    int it = 0;
    for (int t = cluster; t < tiles; t += clusters, ++it) {
      const int m0 = t * kMnRows, par = it & 1;
      float s_row[2] = {0.f, 0.f};  // kernel 19: the rows' sx
      if constexpr (S8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + lr + 8 * h;
          s_row[h] = sx[row < M ? row : M - 1];
        }
      }
      // the products
      int prev = 0;
      auto release = [&](int stage) {
        if (lane == 0) mbar_arrive(&empty[stage]);
      };
      fence_regs(acc);
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(&full[pos.s], pos.phase);
        wgmma_fence();
        unsigned char* stage = smem + pos.s * L::STAGE;
        const uint64_t da = wgmma_desc(stage + c * (kMnABytes / 2));
        const uint64_t dw = wgmma_desc(stage + kMnABytes);
#pragma unroll
        for (int k = 0; k < kLinBK / 16; ++k) {  // 32-byte slices of a 128-byte box row
          if constexpr (S8)
            wgmma_m64nNk32_s8<BN>(acc, da + 2 * k, dw + 2 * k, kb > 0 || k > 0);
          else
            wgmma_m64nNk16<BN>(acc, da + 2 * k, dw + 2 * k, kb > 0 || k > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kb > 0) release(prev);
        prev = pos.s;
        pos.next();
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(prev);
      if constexpr (S8) {  // y = ((float)acc sx) sw, in place
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 w = *reinterpret_cast<const float2*>(sws + 8 * j + 2 * (lane % 4));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h;
            acc[i] = __float_as_int(((float)acc[i] * s_row[h]) * w.x);
            acc[i + 1] = __float_as_int(((float)acc[i + 1] * s_row[h]) * w.y);
          }
        }
      }
      auto y = [&](int i) -> float {  // y in fp32
        if constexpr (S8)
          return __int_as_float(acc[i]);
        else
          return acc[i];
      };

      // the rows' partial sums over this block's columns, to every block
      float s[2] = {0.f, 0.f}, ss[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = y(4 * j + 2 * h + e);
            s[h] += v;
            ss[h] += v * v;
          }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 1; x < 4; x <<= 1) {
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], x);
          ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], x);
        }
      float2* mine = slots + (par * kMnMaxCluster + rank) * kMnRows;
      if (lane % 4 == 0) {
        for (int p = 0; p < C; ++p) {
          st_cluster_f32x2(&mine[lr], p, s[0], ss[0]);
          st_cluster_f32x2(&mine[lr + 8], p, s[1], ss[1]);
        }
        fence_cluster();
      }
      __syncwarp();
      if (lane < C) mbar_arrive_cluster_release(&stat[par], lane);
      mbar_wait_cluster(&stat[par], (it >> 1) & 1);
      float mu[2], rs[2];
      int srow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float S1 = 0.f, S2 = 0.f;
        for (int p = 0; p < C; ++p) {  // rank order: the same sums in every block
          const float2 v = slots[(par * kMnMaxCluster + p) * kMnRows + lr + 8 * h];
          S1 += v.x;
          S2 += v.y;
        }
        mu[h] = S1 * inv_d;
        rs[h] = rsqrtf(S2 * inv_d - mu[h] * mu[h] + eps);
        const int row = m0 + lr + 8 * h;
        srow[h] = ((row < M ? row : M - 1) / tps) * stride;
      }

      // the epilogue: LN affine, AdaLN, + r, in place in the box; the AdaLN
      // rows are loaded once where both of the thread's rows are of one sample
      const bool one_sample = srow[0] == srow[1];
      mbar_wait(rfull, it & 1);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int lc = 8 * j + 2 * (lane % 4), col = n0 + lc;
        if (col < D) {  // D is even: col + 1 < D too
          const float2 gg = *reinterpret_cast<const float2*>(gs + lc);
          const float2 bb = *reinterpret_cast<const float2*>(bs + lc);
          float2 sc[2], sh[2];
          sc[0] = ld_bf16x2(sc_rows + srow[0] + lc);
          sh[0] = ld_bf16x2(sh_rows + srow[0] + lc);
          sc[1] = one_sample ? sc[0] : ld_bf16x2(sc_rows + srow[1] + lc);
          sh[1] = one_sample ? sh[0] : ld_bf16x2(sh_rows + srow[1] + lc);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162* rp =
                reinterpret_cast<__nv_bfloat162*>(box + ((lr + 8 * h) * BN + lc) * 2);
            const float2 rv = __bfloat1622float2(*rp);
            const float y0 = y(4 * j + 2 * h), y1 = y(4 * j + 2 * h + 1);
            const float o0 = ((y0 - mu[h]) * rs[h] * gg.x + bb.x) * (1.0f + sc[h].x) + sh[h].x;
            const float o1 = ((y1 - mu[h]) * rs[h] * gg.y + bb.y) * (1.0f + sc[h].y) + sh[h].y;
            *rp = __floats2bfloat162_rn(o0 + rv.x, o1 + rv.y);
          }
        }
      }
      fence_async_smem();
      named_barrier_sync(1 + c, 128);
      if (tid == 0) {
        if (m0 + 64 * c < M) {
          tma_store_2d(&mOut, box + c * 64 * BN * 2, n0, m0 + 64 * c);
          tma_store_commit();
          tma_store_wait_read<0>();
        }
        mbar_arrive(rempty);
      }
    }
    if (tid == 0) tma_store_wait_all();
  }
  __syncwarp();
  cluster_sync();  // no block leaves while a peer may still write into it
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
                         m_pairs * ((N + kLinBN - 1) / kLinBN), kLinCluster, stream, mA0, mA1,
                         mW, mY0, mY1, M, N, K, tile_rows, row1);
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

// The launcher of kernels 3 and 19 (S8): the column slice BN = the kind's
// width, C = ceil(D / BN) blocks a cluster, tensor maps for x and Wo
// (swizzled operand boxes, bf16 or int8), r and out (dense 128 x BN and
// 64 x BN boxes), then as many clusters as the card holds at once, asked
// once for each operand type, width, C and device.
struct MnArgs {
  const void *x, *w, *r, *g, *b, *msc, *msh;
  void* out;
  const void *sx, *sw;  // kernel 19's scales
  int M, K, D, tps;
  float eps;
  cudaStream_t stream;
};

static int mm_modnorm_resident[2][kMnKinds][kMnMaxCluster + 1][64];

template <bool S8>
constexpr int mm_modnorm_width(int kind) {
  return S8 ? kMnS8Widths[kind] : kMnWidths[kind];
}

// The narrowest width that covers D in at most kMnMaxCluster blocks, or -1.
template <bool S8>
static int mm_modnorm_kind(int D) {
  for (int i = 0; i < kMnKinds; ++i)
    if ((D + mm_modnorm_width<S8>(i) - 1) / mm_modnorm_width<S8>(i) <= kMnMaxCluster) return i;
  return -1;
}

template <bool S8, int I = 0>
static int launch_mm_modnorm(int kind, const MnArgs& a) {
  if constexpr (I < kMnKinds) {
    if (kind != I) return launch_mm_modnorm<S8, I + 1>(kind, a);
    constexpr int BN = mm_modnorm_width<S8>(I);
    const int C = (a.D + BN - 1) / BN;
    CUtensorMap mA, mW, mR, mOut;
    const bool operands = S8 ? tensor_map_i8(&mA, a.x, a.M, a.K, kMnRows, kS8BK) &&
                                   tensor_map_i8(&mW, a.w, a.D, a.K, BN, kS8BK)
                             : tensor_map_bf16(&mA, a.x, a.M, a.K, kMnRows, kLinBK) &&
                                   tensor_map_bf16(&mW, a.w, a.D, a.K, BN, kLinBK);
    if (!operands || !tensor_map_bf16(&mR, a.r, a.M, a.D, kMnRows, BN, false) ||
        !tensor_map_bf16(&mOut, a.out, a.M, a.D, kMnRows / 2, BN, false))
      return kTensorMapError;
    return launch_clusters(mm_modnorm_wgmma_kernel<BN, S8>, mm_modnorm_resident[S8][I][C],
                           MnLayout<BN, S8>::SMEM, (a.M + kMnRows - 1) / kMnRows, C, a.stream, mA,
                           mW, mR, mOut, (const float*)a.g, (const float*)a.b, (const bf16*)a.msc,
                           (const bf16*)a.msh, (const float*)a.sx, (const float*)a.sw, a.M, a.K,
                           a.D, a.tps, a.eps);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool S8, int I = 0>
static int mm_modnorm_smem(int kind) {
  if constexpr (I < kMnKinds)
    return kind == I ? MnLayout<mm_modnorm_width<S8>(I), S8>::SMEM
                     : mm_modnorm_smem<S8, I + 1>(kind);
  return 0;
}

// The cluster plan at width D: plan[0] = blocks a cluster, plan[1] = columns
// a block, plan[2] = shared memory a block, plan[3] = the clusters the card
// holds at once (0 until a launch at this width and cluster size has asked).
// Returns -1 for a D wider than the widest plan.
template <bool S8>
static int mm_modnorm_plan(int D, int* plan) {
  const int kind = mm_modnorm_kind<S8>(D);
  if (kind < 0) return -1;
  int device = 0;
  cudaGetDevice(&device);
  plan[1] = mm_modnorm_width<S8>(kind);
  plan[0] = (D + plan[1] - 1) / plan[1];
  plan[2] = mm_modnorm_smem<S8>(kind);
  plan[3] = mm_modnorm_resident[S8][kind][plan[0]][device % 64];
  return 0;
}

// x (M, K), w (D, K), r and out (M, D) bf16; g, b (D,) fp32; msc, msh (M /
// tps, D) bf16. K % 8 == 0, D % 16 == 0, D <= kMnMaxD, 16-byte aligned bases.
extern "C" int swift_mm_modnorm(const void* x, const void* w, const void* r, const void* g,
                                const void* b, const void* msc, const void* msh, void* out,
                                int M, int K, int D, int tps, float eps, void* stream) {
  return launch_mm_modnorm<false>(
      mm_modnorm_kind<false>(D), MnArgs{x, w, r, g, b, msc, msh, out, nullptr, nullptr, M, K, D,
                                        tps, eps, (cudaStream_t)stream});
}

// Kernel 3's plan at width D (mm_modnorm_plan); -1 past kMnMaxD.
extern "C" int swift_mm_modnorm_plan(int D, int* plan) { return mm_modnorm_plan<false>(D, plan); }

// Kernel 19's plan at width D (mm_modnorm_plan); -1 past kMnS8MaxD.
extern "C" int swift_mm_modnorm_int8_plan(int D, int* plan) {
  return mm_modnorm_plan<true>(D, plan);
}

// Kernel 19: x (M, K) bf16; wq (D, K) int8 with per-row fp32 scales sw (D,);
// the rest as swift_mm_modnorm. Scratch the caller allocates: xq (M, K) int8
// and sx (M,) fp32. K % 16 == 0, D % 16 == 0, D <= kMnS8MaxD, 16-byte aligned
// bases. Two launches, x quantized per token, then the s8 cluster kernel;
// returns the first launch's error.
extern "C" int swift_mm_modnorm_int8(const void* x, const void* wq, const void* sw, const void* r,
                                     const void* g, const void* b, const void* msc,
                                     const void* msh, void* out, void* xq, void* sx, int M, int K,
                                     int D, int tps, float eps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = quantize_rows((const bf16*)x, nullptr, 0, (signed char*)xq, (float*)sx, M, K, st);
  if (err) return err;
  return launch_mm_modnorm<true>(mm_modnorm_kind<true>(D), MnArgs{xq, wq, r, g, b, msc, msh, out,
                                                                  sx, sw, M, K, D, tps, eps, st});
}

extern "C" int swift_max_smem() { return kMaxSmem; }

extern "C" const char* swift_error_string(int code) {
  if (code == kTensorMapError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}
