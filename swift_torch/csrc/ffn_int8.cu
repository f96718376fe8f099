// Kernel 18: the int8 SwiGLU feed-forward of the inference path,
// y = int8(h) . W2q^T with h = silu(g) * u, g and u = int8(x) . W1q^T.
//
// Replaces swift_tpu/ops/pallas_ffn.py::fused_swiglu_ffn_int8 (kernel body
// _ffn_q_kernel). Dynamic symmetric quantization: one scale per token for x
// and for h, computed here over the whole row; one scale per output feature
// for the weights, computed by the caller (swift_torch/ops/ffn.py) from the
// fp32 parameters. Bound: the int8 tensor cores (2·T·D·H·3 operations at
// 1979 TOP/s) once the (T, H) intermediate stays on chip.
//
// The hard part is h's scale: its abs-max runs over all H = 2816 hidden
// units before any of h can multiply W2, so kernel 5's way (stream 64-column
// chunks of h straight into the W2 product) cannot work. Design: a block
// owns 16 token rows and keeps their whole fp32 h in shared memory
// (16 x 2816 x 4 = 176 KB), no scratch in device memory:
//   0. quantize the block's x rows (all of D) into a resident int8 tile;
//   1. for 64 hidden units at a time, gate and up as one 16 x 128 int8 x
//      int8 -> int32 tile (the rows of W1q gathered from its gate and up
//      halves), g = (acc·sx)·sg, u = (acc·sx)·su, h = g·sigmoid(g)·u in fp32;
//   2. each row's abs-max over h, then h quantized from fp32 (never from a
//      bf16 copy) into a resident int8 tile laid over phase 1's buffers;
//   3. y = (acc·sh)·s2 per 128 output columns, streaming W2q, out in bf16.
// Shared memory: 45 KB for x's int8 tile, the streamed weight stages and
// an int32 staging tile (phase 1), then h's int8 tile; 176 KB for fp32 h,
// then the W2 stages; 220 KB in all at D = 1056, H = 2816, one block an SM.
#include "tile_mma.cuh"

namespace swift {

constexpr int kQfBM = 16, kQfHC = 64, kQfBK = 64, kQfBN2 = 128;
using QfMma = TileMmaI8<kQfBM, 2 * kQfHC, kQfBK, 1, 8>;  // gate|up and W2 tiles: 128 rows
constexpr int kQfLDS = 2 * kQfHC + 4;                    // int32 staging row stride
constexpr int kQfStage = kQfBM * kQfLDS * 4;

// region 1: x's int8 tile + weight stages + staging (phase 1), then h's int8 tile
__host__ __device__ constexpr int ffn_i8_r1(int D, int H) {
  return cmax(round128(kQfBM * H), round128(kQfBM * D) + QfMma::SMEM + kQfStage);
}
// region 2: fp32 h (phases 1-2), then the W2 stages + staging (phase 3)
__host__ __device__ constexpr int ffn_i8_r2(int H) {
  return cmax(round128(kQfBM * H * 4), QfMma::SMEM + kQfStage);
}
__host__ __device__ constexpr int ffn_i8_smem(int D, int H) {
  return ffn_i8_r1(D, H) + ffn_i8_r2(H) + 2 * kQfBM * 4;
}

__global__ void __launch_bounds__(QfMma::NT)
    ffn_i8_kernel(const bf16* __restrict__ X, const signed char* __restrict__ W1q,
                  const float* __restrict__ s1, const signed char* __restrict__ W2q,
                  const float* __restrict__ s2, bf16* __restrict__ Y, int M, int D, int H) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NT = QfMma::NT;
  const int r1 = ffn_i8_r1(D, H);
  signed char* xq = reinterpret_cast<signed char*>(smem_raw);
  signed char* bs1 = xq + round128(kQfBM * D);
  int* stage1 = reinterpret_cast<int*>(bs1 + QfMma::SMEM);
  signed char* hq = reinterpret_cast<signed char*>(smem_raw);  // over xq, bs1, stage1
  float* hS = reinterpret_cast<float*>(smem_raw + r1);
  signed char* bs2 = reinterpret_cast<signed char*>(smem_raw + r1);  // over hS
  int* stage2 = reinterpret_cast<int*>(bs2 + QfMma::SMEM);
  float* sx = reinterpret_cast<float*>(smem_raw + r1 + ffn_i8_r2(H));
  float* sh = sx + kQfBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kQfBM;

  // 0. the block's x rows, quantized whole
  quantize_rows<kQfBM, NT>(xq, sx, X, m0, M, D);
  __syncthreads();

  // 1. h = silu(g) * u in fp32, 64 hidden units at a time; warps 0-3 hold
  //    gate columns, warps 4-7 the same columns of up
  for (int c0 = 0; c0 < H; c0 += kQfHC) {
    QfMma::Acc acc[1][1];
    QfMma::run(
        acc, xq, bs1,
        [=](int r) -> const signed char* {
          const int j = c0 + (r < kQfHC ? r : r - kQfHC);
          return j < H ? W1q + (size_t)(r < kQfHC ? j : H + j) * D : nullptr;
        },
        W1q, D);
    wmma::store_matrix_sync(stage1 + warp * 16, acc[0][0], kQfLDS, wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < kQfBM * kQfHC; e += NT) {
      const int r = e / kQfHC, c = e % kQfHC, j = c0 + c;
      if (j < H) {
        const float gt = ((float)stage1[r * kQfLDS + c] * sx[r]) * s1[j];
        const float up = ((float)stage1[r * kQfLDS + kQfHC + c] * sx[r]) * s1[H + j];
        hS[r * H + j] = gt * (1.0f / (1.0f + expf(-gt))) * up;
      }
    }
    // the next chunk's main loop passes a barrier before it rewrites stage1
  }
  __syncthreads();

  // 2. each row's abs-max over all H, then h quantized from fp32
  for (int r = warp; r < kQfBM; r += NT / 32) {
    const float* h = hS + r * H;
    float amax = 0.0f;
    for (int j = lane; j < H; j += 32) amax = fmaxf(amax, fabsf(h[j]));
    const float s = quant_scale(warp_max(amax));
    if (lane == 0) sh[r] = s;
    for (int j = lane; j < H; j += 32) hq[((j >> 4) * kQfBM + r) * 16 + (j & 15)] = quant8(h[j], s);
  }
  __syncthreads();

  // 3. y = (hq . W2q^T) * sh * s2, 128 output columns at a time
  for (int n0 = 0; n0 < D; n0 += kQfBN2) {
    QfMma::Acc acc[1][1];
    QfMma::run(
        acc, hq, bs2,
        [=](int r) -> const signed char* {
          return n0 + r < D ? W2q + (size_t)(n0 + r) * H : nullptr;
        },
        W2q, H);
    wmma::store_matrix_sync(stage2 + warp * 16, acc[0][0], kQfLDS, wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < kQfBM * (kQfBN2 / 8); e += NT) {
      const int r = e / (kQfBN2 / 8), c = (e % (kQfBN2 / 8)) * 8;
      if (m0 + r < M && n0 + c < D) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = ((float)stage2[r * kQfLDS + c + i] * sh[r]) * s2[n0 + c + i];
        *reinterpret_cast<uint4*>(Y + (size_t)(m0 + r) * D + n0 + c) = pack8(v);
      }
    }
  }
}

}  // namespace swift

using namespace swift;

extern "C" int swift_ffn_int8_smem(int D, int H) { return ffn_i8_smem(D, H); }

// x (M, D) bf16 -> y (M, D) bf16; w1q (2H, D) int8, gate rows then up rows,
// with per-row fp32 scales s1 (2H,); w2q (D, H) int8 with s2 (D,).
// D % 16 == 0, H % 16 == 0.
extern "C" int swift_ffn_int8(const void* x, const void* w1q, const void* s1, const void* w2q,
                              const void* s2, void* y, int M, int D, int H, void* stream) {
  const int smem = ffn_i8_smem(D, H);
  cudaFuncSetAttribute(ffn_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ffn_i8_kernel<<<(M + kQfBM - 1) / kQfBM, QfMma::NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const signed char*)w1q, (const float*)s1, (const signed char*)w2q,
      (const float*)s2, (bf16*)y, M, D, H);
  return (int)cudaGetLastError();
}
