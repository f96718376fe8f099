// The SwinV2 block's two projection GEMMs on Hopper, bf16 in, fp32
// accumulation, bf16 out.
//
// swift_linear -- replaces swift_tpu/ops/pallas_linear.py::_lin_call
//   (kernel body _lin_kernel): the qkv projection y = x . W^T,
//   (T, 1056) x (3168, 1056)^T at the 12x88 flagship. Compute-bound
//   (~2*T*1056*3168 FLOP against ~T*8.4 KB moved). Design: 128x128 output
//   tiles over 8 warps, BK=32 tiles double-buffered with cp.async, WMMA
//   bf16 tensor-core products, fp32 tile staged in shared memory for
//   16-byte bf16 stores. The TPU zero-padded d=88 heads to 128 lanes; here
//   N=3168 is taken as it is and the ragged last column tile is masked.
//
// swift_linear_pt -- replaces swift_tpu/ops/pallas_linear.py::_lin_pt_call
//   (kernel body _lin_pt_kernel): y = x . W^T and dy = dx . W^T, the qkv
//   projection's primal and tangent in the sCM jvp forward. The same kernel
//   over a 2T-row problem: a block's 128 A rows are 64 rows of x and the same
//   64 rows of dx, read in place (no stacked copy in device memory), so both
//   products run against every staged W tile and W is fetched as often as
//   for kernel 1 over T rows. Compute-bound (4*T*1056*3168 FLOP).
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

namespace swift {

constexpr int kLinBM = 128, kLinBN = 128, kBK = 32;
using LinMma = TileMma<kLinBM, kLinBN, kBK, 2, 4>;
constexpr int kLinLDC = kLinBN + 4;
constexpr int kLinSmem =
    LinMma::SMEM > kLinBM * kLinLDC * 4 ? LinMma::SMEM : kLinBM * kLinLDC * 4;

// PT = false: Y = X . W^T over M rows. PT = true: Y = X . W^T and
// DY = DX . W^T, half of each block's rows from X and half from DX.
template <bool PT>
__global__ void __launch_bounds__(LinMma::NT)
    linear_kernel(const bf16* __restrict__ X, const bf16* __restrict__ DX,
                  const bf16* __restrict__ W, bf16* __restrict__ Y, bf16* __restrict__ DY, int M,
                  int N, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int ROWS = PT ? kLinBM / 2 : kLinBM;  // token rows a block owns
  const int m0 = blockIdx.y * ROWS, n0 = blockIdx.x * kLinBN;
  // tile row r -> (token row, whether it is the tangent's)
  auto token = [=](int r) { return m0 + (PT ? r % ROWS : r); };
  auto is_dx = [=](int r) { return PT && r >= ROWS; };
  LinMma::Acc acc[LinMma::FM][LinMma::FN];
  LinMma::run_rows(
      acc, reinterpret_cast<bf16*>(smem_raw),
      [=](int r) -> const bf16* {
        const int m = token(r);
        return m < M ? (is_dx(r) ? DX : X) + (size_t)m * K : nullptr;
      },
      X,
      [=](int r) -> const bf16* { return n0 + r < N ? W + (size_t)(n0 + r) * K : nullptr; }, W,
      K);

  // the main loop ended with a barrier: its tiles are free for the fp32 C tile
  float* Cs = reinterpret_cast<float*>(smem_raw);
  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int i = 0; i < LinMma::FM; ++i)
#pragma unroll
    for (int j = 0; j < LinMma::FN; ++j)
      wmma::store_matrix_sync(
          Cs + (wm * LinMma::FM * 16 + i * 16) * kLinLDC + wn * LinMma::FN * 16 + j * 16,
          acc[i][j], kLinLDC, wmma::mem_row_major);
  __syncthreads();
  for (int c = threadIdx.x; c < kLinBM * (kLinBN / 8); c += LinMma::NT) {
    const int r = c / (kLinBN / 8), cc = (c % (kLinBN / 8)) * 8;
    const int gr = token(r), gc = n0 + cc;
    if (gr < M && gc < N)
      *reinterpret_cast<uint4*>((is_dx(r) ? DY : Y) + (size_t)gr * N + gc) =
          pack8(Cs + r * kLinLDC + cc);
  }
}

constexpr int kMnBM = 32, kMnBN = 128;
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

extern "C" int swift_linear(const void* x, const void* w, void* y, int M, int N, int K,
                            void* stream) {
  cudaFuncSetAttribute(linear_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kLinSmem);
  dim3 grid((N + kLinBN - 1) / kLinBN, (M + kLinBM - 1) / kLinBM);
  linear_kernel<false><<<grid, LinMma::NT, kLinSmem, (cudaStream_t)stream>>>(
      (const bf16*)x, nullptr, (const bf16*)w, (bf16*)y, nullptr, M, N, K);
  return (int)cudaGetLastError();
}

// x, dx (M, K) -> y, dy (M, N), all bf16; w (N, K). K % 8 == 0, N % 8 == 0.
extern "C" int swift_linear_pt(const void* x, const void* dx, const void* w, void* y, void* dy,
                               int M, int N, int K, void* stream) {
  cudaFuncSetAttribute(linear_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kLinSmem);
  dim3 grid((N + kLinBN - 1) / kLinBN, (M + kLinBM / 2 - 1) / (kLinBM / 2));
  linear_kernel<true><<<grid, LinMma::NT, kLinSmem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)dx, (const bf16*)w, (bf16*)y, (bf16*)dy, M, N, K);
  return (int)cudaGetLastError();
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
  return cudaGetErrorString((cudaError_t)code);
}
