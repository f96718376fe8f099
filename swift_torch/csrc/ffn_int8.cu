// Kernel 18: the int8 SwiGLU feed-forward of the inference path,
// y = int8(h) . W2q^T with h = silu(g) * u, g and u = int8(x) . W1q^T.
//
// Replaces swift_tpu/ops/pallas_ffn.py::fused_swiglu_ffn_int8 (kernel body
// _ffn_q_kernel). Dynamic symmetric quantization: one scale per token for x
// and for h; one scale per output feature for the weights, computed by the
// caller (swift_torch/ops/ffn.py) from the fp32 parameters. Bound: the int8
// tensor cores, 2·T·D·H·3 operations at 1979 TOP/s (0.148 ms at T = 16,384,
// D = 1056, H = 2816).
//
// The hard part is h's scale: its abs-max runs over all H hidden units
// before any of h can multiply W2, so h cannot stream into the W2 product
// as kernel 5's pass 2 reads it; and h must be quantized from fp32, never
// from a rounded copy. So kernel 5's cut holds, with h in fp32 and a
// reduction between the passes: four launches over a chunk of tokens
// (ops/ffn.py::ffn_chunks), the products on kernel 5's wgmma + TMA ring
// (wgmma.cuh) with the s8 x s8 -> s32 wgmma (m64n256k32) in place of bf16's:
//   0. quantize_rows_kernel<bf16> (quantize.cuh, kernel 19's pass 0 too):
//      xq = int8(x) and sx, one warp a token;
//   1. s8_gemm_kernel<kS8Hidden>: kernel 5's pass 1 on xq. A 128-row tile
//      pairs gate units j..j+127 with up units j..j+127 in one 256-row W
//      box whose halves the two blocks of a cluster load and multicast; a
//      stage is 128 int8 deep, four 32-deep wgmmas. The epilogue rescales
//      g = ((float)acc·sx)·s1[j] and u = ((float)acc·sx)·s1[H + j], forms
//      h = g·sigmoid(g)·u in fp32, stores it by TMA in fp32 boxes, and each
//      row's abs-max over the tile's 128 units into a (rows, ceil(H/128))
//      array: a max does not depend on order, so no atomics;
//   2. quantize_rows_kernel<float>: sh = the scale of a row's largest partial,
//      hq = int8(h) from the fp32 h, one warp a token;
//   3. s8_gemm_kernel<kS8Out>: kernel 1's loop on hq . W2q^T, the epilogue
//      y = ((float)acc·sh)·s2[c] rounded to bf16 and stored by TMA.
// The device traffic is larger than the bound's: x, xq, the fp32 h written
// and read, hq, y and the weights, ~0.57 GB at T = 16,384 (0.17 ms at 3.35
// TB/s). The rounding points are the plain version's
// (ops/ffn.py::reference_swiglu_ffn_int8) and the TPU kernel's.
#include "quantize.cuh"
#include "wgmma.cuh"

namespace swift {

enum S8Mode { kS8Hidden, kS8Out };
constexpr int kS8HidBN = kLinBN / 2;      // hidden units a pass-1 tile (gate and up beside them)
constexpr int kS8HBox = 64 * 32 * 4;      // one 64-row x 32-column fp32 box of h
static_assert(kS8HBox == kLinCBox, "h's fp32 boxes take the bf16 output boxes' room");
constexpr int kS8Boxes = 2;               // output boxes a consumer, in turn
// Three stages of the four that fit: 2% faster at the flagship's B = 2 and
// MB = 4 (scripts/probe_ffn_int8.py's four_stages).
constexpr int kS8Stages = 3;
constexpr int kS8Smem = ring_smem(kS8Stages, 2 * kS8Boxes, 0);
static_assert(kS8Smem <= kMaxSmem, "the s8 ring does not fit");

__device__ __forceinline__ float2 ldg_f2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// Consumer c's 64 rows x 32 columns of fp32 output through a swizzled
// shared-memory box to (col, row) of ``map`` by TMA (clipped at the edges),
// stored only where ``valid``: store_box's protocol for fp32, a box row of
// 32 values. ``val(i)`` gives the two values of accumulator indices i,
// i + 1 with i = 4 (4 q + j) + 2 h: columns 8 j + 2 (lane % 4) + {0, 1} of
// the box, row r + 8 h. Call it with q a constant.
template <int NB, class Val>
__device__ __forceinline__ void store_box_f32(unsigned char* box, const CUtensorMap* map, int col,
                                              int row, bool valid, int c, int q, Val val) {
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int r = tid / 32 * 16 + lane / 4;  // and r + 8; r % 8 == lane / 4
  if (tid == 0) tma_store_wait_read<NB - 1>();
  named_barrier_sync(1 + c, 128);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int chunk = 2 * j + (lane % 4) / 2;  // 16-byte chunk of the 128-byte row
      *reinterpret_cast<float2*>(box + (r + 8 * h) * 128 + ((chunk ^ (lane / 4)) << 4) +
                                 (lane % 2) * 8) = val(4 * (4 * q + j) + 2 * h);
    }
  fence_async_smem();
  named_barrier_sync(1 + c, 128);
  if (tid == 0 && valid) {
    tma_store_2d(map, box, col, row);
    tma_store_commit();
  }
}

// Passes 1 and 3 (see the top of this file): C = A . W^T with A (M x K) and
// W int8, both K-major, on kernel 1's ring: 384 threads a block, a producer
// warpgroup, two consumers of 64 rows each, persistent clusters of two
// walking (row-tile pair, column tile) items, column tiles fastest. Pass 1
// (kS8Hidden): N = H hidden units, 128 a tile, the W box the gate rows of
// mW0 (rank 0) beside the up rows of mW1 (rank 1); ``sa`` = sx, ``sw`` = s1
// (2H), ``amax`` the rows' partial maxima. Pass 3 (kS8Out): N = D output
// columns, 256 a tile, rank r loading W rows n0 + 128 r of mW0; ``sa`` = sh,
// ``sw`` = s2.
template <int MODE>
__global__ void __launch_bounds__(kLinThreads, 1)
    s8_gemm_kernel(const __grid_constant__ CUtensorMap mA, const __grid_constant__ CUtensorMap mW0,
                   const __grid_constant__ CUtensorMap mW1,
                   const __grid_constant__ CUtensorMap mOut, const float* __restrict__ sa,
                   const float* __restrict__ sw, float* __restrict__ amax, int M, int N, int K) {
  constexpr bool HID = MODE == kS8Hidden;
  constexpr int S = kS8Stages, BN = HID ? kS8HidBN : kLinBN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* cbox = smem + S * kLinStageBytes;  // [consumer][kS8Boxes] output boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(cbox + 2 * kS8Boxes * kLinCBox);
  uint64_t* empty = full + S;

  const int rank = (int)cluster_rank();
  const int n_tiles = (N + BN - 1) / BN;
  const int m_pairs = ((M + 2 * kLinRows - 1) / (2 * kLinRows) + kLinCluster - 1) / kLinCluster;
  const int pairs = m_pairs * n_tiles;
  const int cluster = blockIdx.x / kLinCluster, clusters = gridDim.x / kLinCluster;
  const int k_blocks = (K + kS8BK - 1) / kS8BK;
  ring_init<S>(full, empty);

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      RingPos<S> pos;
      for (int p = cluster; p < pairs; p += clusters) {
        const int m0 = (p / n_tiles * kLinCluster + rank) * 2 * kLinRows;
        const int n0 = p % n_tiles * BN;
        const bool a0 = m0 < M, a1 = m0 + kLinRows < M;
        uint32_t bytes = (a0 ? kLinABytes : 0) + (a1 ? kLinABytes : 0);
        int wrow = n0;
        if (HID) {
          bytes += kLinCluster * kLinWBytes;  // TMA zero-fills the units past H
        } else {
          for (int r = 0; r < kLinCluster; ++r) bytes += n0 + r * kLinWHalf < N ? kLinWBytes : 0;
          wrow += rank * kLinWHalf;
        }
        produce_tile(smem, full, empty, pos, &mA, m0, a0, &mA, m0 + kLinRows, a1,
                     HID && rank ? &mW1 : &mW0, wrow, wrow < N, bytes, k_blocks, kS8BK);
      }
      drain(empty, pos);
    }
  } else {  // the consumers
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid % 32;
    const int r = tid / 32 * 16 + lane / 4;  // this thread's rows of the consumer's 64: r, r + 8
    const int col = 2 * (lane % 4);          // + 8 j: its columns of the tile
    int acc[kLinBN / 2];  // pass 1: acc[i] gate unit n0 + col(i), acc[i + 64] the up unit beside it
    RingPos<S> pos;
    int boxes = 0;
    auto next_box = [&] { return cbox + (kS8Boxes * c + boxes++ % kS8Boxes) * kLinCBox; };
    for (int p = cluster; p < pairs; p += clusters) {
      const int m0 = (p / n_tiles * kLinCluster + rank) * 2 * kLinRows + c * kLinRows;
      const int n0 = p % n_tiles * BN;
      consume_tile(acc, smem, full, empty, pos, c, k_blocks);
      float s_row[2];  // the rows' scales; 0 past M
#pragma unroll
      for (int h = 0; h < 2; ++h) s_row[h] = m0 + r + 8 * h < M ? sa[m0 + r + 8 * h] : 0.0f;
      if constexpr (HID) {
        float top[2] = {0.0f, 0.0f};  // the rows' abs-max over the tile's units
#pragma unroll
        for (int q = 0; q < kS8HidBN / 32; ++q) {
          if (n0 + 32 * q >= N) break;
          store_box_f32<kS8Boxes>(next_box(), &mOut, n0 + 32 * q, m0, m0 < M, c, q, [&](int i) {
            const int j = n0 + 8 * (i / 4) + col, h = (i / 2) % 2;  // N even: j + 1 < N too
            const float2 sg = j < N ? ldg_f2(sw + j) : make_float2(0.0f, 0.0f);
            const float2 su = j < N ? ldg_f2(sw + N + j) : make_float2(0.0f, 0.0f);
            float out[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float g = ((float)acc[i + e] * s_row[h]) * (e ? sg.y : sg.x);
              const float u = ((float)acc[i + 64 + e] * s_row[h]) * (e ? su.y : su.x);
              out[e] = g * (1.0f / (1.0f + expf(-g))) * u;
              top[h] = fmaxf(top[h], fabsf(out[e]));
            }
            return make_float2(out[0], out[1]);
          });
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 1));
          top[h] = fmaxf(top[h], __shfl_xor_sync(0xffffffffu, top[h], 2));
          if (lane % 4 == 0 && m0 + r + 8 * h < M)
            amax[(size_t)(m0 + r + 8 * h) * n_tiles + n0 / kS8HidBN] = top[h];
        }
      } else {
#pragma unroll
        for (int q = 0; q < kLinBN / 64; ++q) {
          if (n0 + 64 * q >= N) break;
          store_box<kS8Boxes>(next_box(), &mOut, n0 + 64 * q, m0, m0 < M, c, q, [&](int i) {
            const int j = n0 + 8 * (i / 4) + col, h = (i / 2) % 2;
            const float2 s = j < N ? ldg_f2(sw + j) : make_float2(0.0f, 0.0f);
            return pack_bf16x2(((float)acc[i] * s_row[h]) * s.x,
                               ((float)acc[i + 1] * s_row[h]) * s.y);
          });
        }
      }
    }
    if (tid == 0) tma_store_wait_all();
  }
}

}  // namespace swift

using namespace swift;

static int s8_resident[2][64];

// Kernel 18 over one chunk of M tokens: x (M, D) bf16 -> y (M, D) bf16;
// w1q (2H, D) int8, gate rows then up rows, with per-row fp32 scales s1
// (2H,); w2q (D, H) int8 with s2 (D,). Scratch the caller allocates: xq
// (M, D) int8, sx (M,) fp32, h (M, H) fp32, amax (M, ceil(H / 128)) fp32,
// hq (M, H) int8, sh (M,) fp32. D % 16 == 0, H % 16 == 0, 16-byte aligned
// bases. Returns the first launch's error.
extern "C" int swift_ffn_int8(const void* x, const void* w1q, const void* s1, const void* w2q,
                              const void* s2, void* y, void* xq, void* sx, void* h, void* amax,
                              void* hq, void* sh, int M, int D, int H, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (H + kS8HidBN - 1) / kS8HidBN;
  CUtensorMap mX, mWg, mWu, mH, mHq, mW2, mY;
  if (!tensor_map_i8(&mX, xq, M, D, kLinRows, kS8BK) ||
      !tensor_map_i8(&mWg, w1q, H, D, kLinWHalf, kS8BK) ||
      !tensor_map_i8(&mWu, (const signed char*)w1q + (size_t)H * D, H, D, kLinWHalf, kS8BK) ||
      !tensor_map_f32(&mH, h, M, H, 64, 32) || !tensor_map_i8(&mHq, hq, M, H, kLinRows, kS8BK) ||
      !tensor_map_i8(&mW2, w2q, D, H, kLinWHalf, kS8BK) || !tensor_map_bf16(&mY, y, M, D, 64, 64))
    return kTensorMapError;
  const int m_pairs = ((M + 2 * kLinRows - 1) / (2 * kLinRows) + kLinCluster - 1) / kLinCluster;
  int err = quantize_rows((const bf16*)x, nullptr, 0, (signed char*)xq, (float*)sx, M, D, st);
  if (err == 0)
    err = launch_clusters(s8_gemm_kernel<kS8Hidden>, s8_resident[kS8Hidden], kS8Smem,
                          m_pairs * tiles, kLinCluster, st, mX, mWg, mWu, mH, (const float*)sx,
                          (const float*)s1, (float*)amax, M, H, D);
  if (err == 0)
    err = quantize_rows((const float*)h, (const float*)amax, tiles, (signed char*)hq, (float*)sh,
                        M, H, st);
  if (err == 0)
    err = launch_clusters(s8_gemm_kernel<kS8Out>, s8_resident[kS8Out], kS8Smem,
                          m_pairs * ((D + kLinBN - 1) / kLinBN), kLinCluster, st, mHq, mW2, mW2,
                          mY, (const float*)sh, (const float*)s2, (float*)nullptr, M, D, H);
  return err;
}
