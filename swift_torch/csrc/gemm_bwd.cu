// The backward GEMMs of the SwinV2 block on Hopper: the linear backward
// (kernel 13) and the SwiGLU FFN backward from saved gate/up (kernel 9).
//
// swift_linear_bwd -- replaces swift_tpu/ops/pallas_linear.py::_lin_bwd_call
//   (kernel body _lin_bwd_kernel): dx = dy . W and dW = dy^T . x summed over
//   every token. At the flagship ((T, 3168) x (3168, 1056)) it is 2 x 2TKN
//   FLOP against ~T * 8.4 KB moved: the tensor cores bound it.
// swift_ffn_bwd_saved -- replaces swift_tpu/ops/pallas_ffn.py::
//   _ffn_bwd_saved_call (kernel body _ffn_bwd_saved_kernel): dh = dy . W2,
//   dg = dh * u * silu'(g), du = dh * silu(g) (both rounded to bf16, as the
//   TPU kernel rounds them), dx = [dg|du] . W1, dW1 = [dg|du]^T . x and
//   dW2 = dy^T . h with h = bf16(silu(g) * u). Six products, ~12 T D H FLOP:
//   tensor-core bound.
//
// The torch weights are (out, in) row-major, so the backward needs the two
// operand layouts the forward never reads: dy . W, where the reduction runs
// along W's rows, and x^T . dy, where it runs along the token dimension of
// both operands. One main loop serves all of them: each operand tile is
// staged in shared memory in its natural global layout (cp.async, 16-byte
// chunks, double-buffered) and handed to the tensor cores as a row- or
// column-major WMMA fragment, so no transposed copy of a weight or an
// activation is ever made in device memory.
//
// The TPU accumulated the weight gradients in VMEM over a sequential token
// grid. A GPU grid is parallel, so a weight gradient is a split-K GEMM over
// the tokens: each split writes an fp32 partial (no float atomics), and a
// second pass sums the partials in a fixed order and rounds to bf16, the
// weight's dtype (the TPU kernel's dw.astype(w.dtype)). Both passes together
// are the port of the one TPU kernel.
#include <type_traits>

#include "tile_mma.cuh"

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
enum { kEpiBf16 = 0, kEpiPartial = 1, kEpiSwigluBwd = 2 };

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

struct EpiArgs {
  void* c;          // bf16 (M, N) or fp32 partials (splits, M, N)
  const bf16* g;    // kEpiSwigluBwd: saved gate and up, (M, N) each
  const bf16* u;
  bf16* dgu;        // (M, 2N): dg in columns [0, N), du in [N, 2N)
  bf16* h;          // (M, N): bf16(silu(g) * u)
};

__device__ __forceinline__ void unpack8(uint4 raw, float* v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <int AL, int BL, int EPI>
__global__ void __launch_bounds__(GNT)
    gemm_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb, int M,
                int N, int K, int k_per_split, EpiArgs ep) {
  constexpr bool AK = AL == kAK, BK_ = BL == kBK;
  constexpr int AT = op_tile<AK, GBM>(), BT = op_tile<BK_, GBN>();
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                               typename std::conditional<AK, wmma::row_major, wmma::col_major>::type>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                               typename std::conditional<BK_, wmma::col_major, wmma::row_major>::type>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As[2] = {reinterpret_cast<bf16*>(smem_raw), reinterpret_cast<bf16*>(smem_raw) + AT};
  bf16* Bs[2] = {As[1] + AT, As[1] + AT + BT};

  const int tid = threadIdx.x, warp = tid / 32, wm = warp / GWN, wn = warp % GWN;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int kb = blockIdx.z * k_per_split, ke = min(K, kb + k_per_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[GFM][GFN];
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

  // the main loop ended with a barrier: its tiles are free for the fp32 C tile
  float* Cs = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < GFM; ++i)
#pragma unroll
    for (int j = 0; j < GFN; ++j)
      wmma::store_matrix_sync(Cs + (wm * GFM * 16 + i * 16) * GLDC + wn * GFN * 16 + j * 16,
                              acc[i][j], GLDC, wmma::mem_row_major);
  __syncthreads();
  for (int c = tid; c < GBM * (GBN / 8); c += GNT) {
    const int r = c / (GBN / 8), cc = (c % (GBN / 8)) * 8, gr = m0 + r, gc = n0 + cc;
    if (gr >= M || gc >= N) continue;
    const float* v = Cs + r * GLDC + cc;
    const size_t o = (size_t)gr * N + gc;
    if constexpr (EPI == kEpiBf16) {
      *reinterpret_cast<uint4*>(static_cast<bf16*>(ep.c) + o) = pack8(v);
    } else if constexpr (EPI == kEpiPartial) {
      float* p = static_cast<float*>(ep.c) + (size_t)blockIdx.z * M * N + o;
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      // v is dh; the TPU kernel's formulas with g, u re-expanded to fp32
      float g[8], u[8], dg[8], du[8], hh[8];
      unpack8(*reinterpret_cast<const uint4*>(ep.g + o), g);
      unpack8(*reinterpret_cast<const uint4*>(ep.u + o), u);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float sig = 1.0f / (1.0f + expf(-g[i])), sg = g[i] * sig;
        dg[i] = v[i] * u[i] * (sig * (1.0f + g[i] * (1.0f - sig)));
        du[i] = v[i] * sg;
        hh[i] = sg * u[i];
      }
      const size_t og = (size_t)gr * 2 * N + gc;
      *reinterpret_cast<uint4*>(ep.dgu + og) = pack8(dg);
      *reinterpret_cast<uint4*>(ep.dgu + og + N) = pack8(du);
      *reinterpret_cast<uint4*>(ep.h + o) = pack8(hh);
    }
  }
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

static inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

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
static cudaError_t gemm(const void* a, int lda, const void* b, int ldb, int M, int N, int K, int splits,
                 EpiArgs ep, cudaStream_t st) {
  auto kern = gemm_kernel<AL, BL, EPI>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  const int kps = ceil_div(ceil_div(K, splits), GBK) * GBK;
  dim3 grid(ceil_div(N, GBN), ceil_div(M, GBM), splits);
  kern<<<grid, GNT, kGemmSmem, st>>>((const bf16*)a, lda, (const bf16*)b, ldb, M, N, K, kps, ep);
  return cudaGetLastError();
}

// dW (M, N) = sum over K tokens, split-K into ws (splits, M, N) then reduced.
static cudaError_t weight_grad(const void* a, int lda, const void* b, int ldb, int M, int N, int K,
                        float* ws, void* out, cudaStream_t st) {
  const int splits = splitk_count(M, N, K);
  EpiArgs ep{ws, nullptr, nullptr, nullptr, nullptr};
  cudaError_t e = gemm<kAM, kBN, kEpiPartial>(a, lda, b, ldb, M, N, K, splits, ep, st);
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)M * N;
  splitk_reduce_kernel<<<(unsigned)((n / 8 + 255) / 256), 256, 0, st>>>(ws, splits, n,
                                                                         (bf16*)out);
  return cudaGetLastError();
}

}  // namespace swift

using namespace swift;

// fp32 elements of split-K workspace a weight gradient of (M, N) over K
// tokens needs.
extern "C" long long swift_splitk_workspace(int M, int N, int K) {
  return (long long)splitk_count(M, N, K) * M * N;
}

// dy (T, N), x (T, K), w (N, K) bf16 -> dx (T, K), dw (N, K) bf16; ws fp32
// of swift_splitk_workspace(N, K, T) elements. T, N, K multiples of 8.
extern "C" int swift_linear_bwd(const void* dy, const void* x, const void* w, void* dx, void* dw,
                                void* ws, int T, int N, int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  EpiArgs ep{dx, nullptr, nullptr, nullptr, nullptr};
  cudaError_t e = gemm<kAK, kBN, kEpiBf16>(dy, N, w, K, T, K, N, 1, ep, st);  // dx = dy . W
  if (e != cudaSuccess) return (int)e;
  return (int)weight_grad(dy, N, x, K, N, K, T, (float*)ws, dw, st);  // dW = dy^T . x
}

// x, dy (T, D), g, u (T, H), w1 (2H, D), w2 (D, H) bf16 -> dx (T, D),
// dw1 (2H, D), dw2 (D, H) bf16. Scratch: dgu (T, 2H) and h (T, H) bf16;
// ws1, ws2 fp32 of swift_splitk_workspace(2H, D, T) and (D, H, T) elements.
extern "C" int swift_ffn_bwd_saved(const void* x, const void* dy, const void* g, const void* u,
                                   const void* w1, const void* w2, void* dx, void* dw1, void* dw2,
                                   void* dgu, void* h, void* ws1, void* ws2, int T, int D, int H,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // dh = dy . W2 with the SwiGLU backward in the epilogue -> dg | du, h
  EpiArgs ep{nullptr, (const bf16*)g, (const bf16*)u, (bf16*)dgu, (bf16*)h};
  cudaError_t e = gemm<kAK, kBN, kEpiSwigluBwd>(dy, D, w2, H, T, H, D, 1, ep, st);
  if (e != cudaSuccess) return (int)e;
  // dx = [dg | du] . W1
  EpiArgs epx{dx, nullptr, nullptr, nullptr, nullptr};
  e = gemm<kAK, kBN, kEpiBf16>(dgu, 2 * H, w1, D, T, D, 2 * H, 1, epx, st);
  if (e != cudaSuccess) return (int)e;
  // dW1 = [dg | du]^T . x ;  dW2 = dy^T . h
  e = weight_grad(dgu, 2 * H, x, D, 2 * H, D, T, (float*)ws1, dw1, st);
  if (e != cudaSuccess) return (int)e;
  return (int)weight_grad(dy, D, h, H, D, H, T, (float*)ws2, dw2, st);
}
