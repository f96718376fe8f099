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
// swift_swiglu_hidden_save -- pass 1 of kernel 8, which replaces
//   swift_tpu/ops/pallas_ffn.py::_ffn_fwd_save_call (kernel body
//   _ffn_fwd_save_kernel): kernel 5's pass 1 whose epilogue also stores
//   gate and up, g = bf16(x . Wg^T) and u = bf16(x . Wu^T), for the
//   backward (kernel 9). Each consumer already holds gate unit c and up
//   unit c of a row in its fp32 accumulator (acc[i], acc[i + 64]), so for
//   each 64-column step it writes three 64 x 64 bf16 boxes by TMA: h, from
//   the unrounded values as in kernel 5, g and u. The two (T, H) outputs
//   add 2 x T x H x 2 bytes to pass 1's stores (185 MB at B = 2, 0.055 ms
//   at the card's memory rate), under the products. h, g and u cycle
//   through kSaveBoxes boxes a consumer (two: the ring keeps kernel 5's
//   four stages). Pass 2 is kernel 1 on h, as for kernel 5, so kernel 8's
//   y equals kernel 5's bit for bit.
//
// Kernel 20, x + modnorm(FFN(x)), which replaces
//   swift_tpu/ops/pallas_ffn.py::_ffn_mn_call (kernel body _ffn_mn_kernel),
//   has no body of its own: its wrapper (ops/ffn.py) runs
//   swift_swiglu_hidden, then kernel 3 (gemm.cu::swift_mm_modnorm) on (h,
//   W2) with K = H and the residual x. Kernel 3's cluster keeps y = h . W2^T
//   in fp32 registers for the post-norm, so y is never rounded, the TPU
//   kernel's rounding point (kernel 5 then kernel 4 would round y to bf16).
#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace swift {

// h = silu(g) * u and its tangent dh = s(g)(1 + g(1 - s(g))) dg u + silu(g) du,
// in fp32: the one expression of kernels 5, 8 and 11 (and 20, whose first
// pass is kernel 5's).
__device__ __forceinline__ float swiglu(float g, float u) { return g / (1.0f + expf(-g)) * u; }

__device__ __forceinline__ float swiglu_tangent(float g, float u, float dg, float du) {
  const float sig = 1.0f / (1.0f + expf(-g));
  return sig * (1.0f + g * (1.0f - sig)) * dg * u + g * sig * du;
}

// Pass 1 of kernels 5, 11 and 8 (see the top of this file). A tile is 128
// hidden units: the W box's rows 0-127 are gate units j0.., rows 128-255 the
// up units j0.. beside them. Kernel 5 (kHidPlain): consumer c takes rows
// m0 + 64 c of x, four stages, two output boxes a consumer in turn. Kernel
// 11 (kHidPair): consumers 0 and 1 take rows m0 of x and of dx; consumer 0
// writes its fp32 accumulator into ``hand`` (thread-major, 128 x 128 fp32,
// no bank conflicts) for consumer 1, which reads g and u there; three
// stages and one box a consumer leave room for it. Named barriers
// kHandFull (consumer 0 has written) and kHandEmpty (consumer 1 has read)
// order the handover, 256 threads each. Kernel 8 (kHidSave): kernel 5's
// rows, and each 64-column step stores h, g and u through kSaveBoxes boxes
// a consumer in turn; the ring takes as many stages as then fit.
enum HiddenMode { kHidPlain, kHidPair, kHidSave };
constexpr int kHidBN = kLinBN / 2;
constexpr int kHandBytes = 128 * 128 * 4;
constexpr int kHandFull = 3, kHandEmpty = 4;  // 1 and 2: the consumers' own box barriers
constexpr int kSaveBoxes = 2;

__host__ __device__ constexpr int hidden_boxes(int mode) {  // output boxes a consumer
  return mode == kHidPair ? 1 : mode == kHidSave ? kSaveBoxes : 2;
}
__host__ __device__ constexpr int hidden_extra(int mode) {
  return mode == kHidPair ? kHandBytes : 0;
}
__host__ __device__ constexpr int hidden_stages(int mode) {
  return (kMaxSmem - ring_smem(0, 2 * hidden_boxes(mode), hidden_extra(mode)) - 256) /
         kLinStageBytes;
}
__host__ __device__ constexpr int hidden_smem(int mode) {
  return ring_smem(hidden_stages(mode), 2 * hidden_boxes(mode), hidden_extra(mode));
}
static_assert(hidden_stages(kHidPlain) >= 4 && hidden_smem(kHidPlain) <= kMaxSmem,
              "pass 1's ring does not fit");
static_assert(hidden_stages(kHidPair) >= 3 && hidden_smem(kHidPair) <= kMaxSmem,
              "pass 1's ring and handover do not fit");
static_assert(hidden_stages(kHidSave) >= 3 && hidden_smem(kHidSave) <= kMaxSmem,
              "pass 1's ring and its save boxes do not fit");

template <int MODE>
__global__ void __launch_bounds__(kLinThreads, 1)
    swiglu_hidden_wgmma_kernel(const __grid_constant__ CUtensorMap mA0,
                               const __grid_constant__ CUtensorMap mA1,
                               const __grid_constant__ CUtensorMap mWg,
                               const __grid_constant__ CUtensorMap mWu,
                               const __grid_constant__ CUtensorMap mH0,
                               const __grid_constant__ CUtensorMap mH1,
                               const __grid_constant__ CUtensorMap mG,
                               const __grid_constant__ CUtensorMap mU, int M, int H, int K) {
  constexpr bool PAIR = MODE == kHidPair, SAVE = MODE == kHidSave;
  constexpr int S = hidden_stages(MODE), NB = hidden_boxes(MODE);
  constexpr int tile_rows = PAIR ? kLinRows : 2 * kLinRows, row1 = PAIR ? 0 : kLinRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* cbox = smem + S * kLinStageBytes;  // [consumer][NB] output boxes
  float* hand = reinterpret_cast<float*>(cbox + 2 * NB * kLinCBox);
  uint64_t* full = reinterpret_cast<uint64_t*>(cbox + 2 * NB * kLinCBox + hidden_extra(MODE));
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
    auto next_box = [&] { return cbox + (NB * c + boxes++ % NB) * kLinCBox; };
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
        const int col = j0 + 64 * q;
        if (PAIR && c == 1) {
          const float* gu = hand + tid;  // consumer 0's acc[i] at gu[128 i]
          store_box<NB>(next_box(), mH, col, m0, m0 < M, c, q, [&](int i) {
            return pack_bf16x2(
                swiglu_tangent(gu[i * 128], gu[(i + 64) * 128], acc[i], acc[i + 64]),
                swiglu_tangent(gu[(i + 1) * 128], gu[(i + 65) * 128], acc[i + 1], acc[i + 65]));
          });
        } else {
          store_box<NB>(next_box(), mH, col, m0, m0 < M, c, q, [&](int i) {
            return pack_bf16x2(swiglu(acc[i], acc[i + 64]), swiglu(acc[i + 1], acc[i + 65]));
          });
        }
        if (SAVE) {  // gate and up themselves, rounded to bf16
          store_box<NB>(next_box(), &mG, col, m0, m0 < M, c, q,
                        [&](int i) { return pack_bf16x2(acc[i], acc[i + 1]); });
          store_box<NB>(next_box(), &mU, col, m0, m0 < M, c, q,
                        [&](int i) { return pack_bf16x2(acc[i + 64], acc[i + 65]); });
        }
      }
      if (PAIR && c == 1 && p + clusters < pairs) named_barrier_arrive(kHandEmpty, 256);
    }
    if (tid == 0) tma_store_wait_all();
  }
}

}  // namespace swift

using namespace swift;

// Pass 1 of kernels 5, 11 and 8: tensor maps for the A sources (x, and dx
// or x again), the gate and up halves of w1 and the outputs (h, and dh or h
// again; for kernel 8 g and u, else h again), then the clusters.
static int hidden_resident[3][64];

template <int MODE>
static int launch_hidden(const void* x, const void* dx, const void* w1, void* h, void* dh,
                         void* g, void* u, int M, int D, int H, cudaStream_t stream) {
  CUtensorMap mA0, mA1, mWg, mWu, mH0, mH1, mG, mU;
  if (!tensor_map_bf16(&mA0, x, M, D, kLinRows, kLinBK) ||
      !tensor_map_bf16(&mA1, dx, M, D, kLinRows, kLinBK) ||
      !tensor_map_bf16(&mWg, w1, H, D, kLinWHalf, kLinBK) ||
      !tensor_map_bf16(&mWu, (const bf16*)w1 + (size_t)H * D, H, D, kLinWHalf, kLinBK) ||
      !tensor_map_bf16(&mH0, h, M, H, 64, 64) || !tensor_map_bf16(&mH1, dh, M, H, 64, 64) ||
      !tensor_map_bf16(&mG, g, M, H, 64, 64) || !tensor_map_bf16(&mU, u, M, H, 64, 64))
    return kTensorMapError;
  const int tile_rows = MODE == kHidPair ? kLinRows : 2 * kLinRows;
  const int m_pairs = ((M + tile_rows - 1) / tile_rows + kLinCluster - 1) / kLinCluster;
  return launch_clusters(swiglu_hidden_wgmma_kernel<MODE>, hidden_resident[MODE],
                         hidden_smem(MODE), m_pairs * ((H + kHidBN - 1) / kHidBN), kLinCluster,
                         stream, mA0, mA1, mWg, mWu, mH0, mH1, mG, mU, M, H, D);
}

// x (M, D) -> h (M, H), all bf16; w1 (2H, D), gate rows then up rows. D % 8
// == 0, H % 8 == 0, 16-byte aligned bases.
extern "C" int swift_swiglu_hidden(const void* x, const void* w1, void* h, int M, int D, int H,
                                   void* stream) {
  return launch_hidden<kHidPlain>(x, x, w1, h, h, h, h, M, D, H, (cudaStream_t)stream);
}

// x, dx (M, D) -> h, dh (M, H), all bf16; w1 as swift_swiglu_hidden.
extern "C" int swift_swiglu_hidden_pt(const void* x, const void* dx, const void* w1, void* h,
                                      void* dh, int M, int D, int H, void* stream) {
  return launch_hidden<kHidPair>(x, dx, w1, h, dh, h, h, M, D, H, (cudaStream_t)stream);
}

// x (M, D) -> h and the gate and up g = bf16(x . Wg^T), u = bf16(x . Wu^T),
// each (M, H), all bf16; w1 and the shape rules as swift_swiglu_hidden.
extern "C" int swift_swiglu_hidden_save(const void* x, const void* w1, void* h, void* g, void* u,
                                        int M, int D, int H, void* stream) {
  return launch_hidden<kHidSave>(x, x, w1, h, h, g, u, M, D, H, (cudaStream_t)stream);
}
