// The post-FFN AdaLN post-norm with the residual add (kernel 4) and its
// forward-mode tangent (kernel 12) on Hopper: one row-streaming body,
// modnorm_rows_kernel<TANGENT>.
//
// swift_modnorm_residual -- replaces swift_tpu/ops/pallas_modnorm.py::_call
//   (kernel body _fused_kernel): out = r + (LN(y) g + b)(1 + ms) + mb, with
//   fp32 statistics, the variance taken as E[y^2] - mu^2, the AdaLN rows
//   ms, mb of the row's sample (row / tps), the residual added in fp32 and
//   one rounding to bf16.
// swift_modnorm_residual_tangent -- replaces pallas_modnorm.py::
//   _tangent_call (body _tangent_kernel): the tangent of that epilogue
//   along (dy, dr, dms, dmb), two more row sums (of dy and of y dy) and
//   out = dyn g (1 + ms) + (yn g + b) dms + dmb + dr, where
//   dyn = rs (dy - dmu) - yn k with k = rs^2 dvar / 2: the TPU kernel's
//   0.5 yn rs^2 dvar with its three factors grouped per row (the one
//   re-association of the fp32 epilogue).
//
// What bounds them on the H100: device memory. Kernel 4 does about 10 flops
// for the 6 bytes an element moves (y and r read, out written), kernel 12
// about 18 for 8 (y, dy, dr, out), far below the ~295 flops a byte at which
// the tensor cores would set the pace. The bound is those bytes at 3.35
// TB/s; the design keeps enough of them in flight and moves each once:
//
// * A persistent grid: one block an SM (no more than the work), each
//   walking groups of R consecutive rows, group i of block k for i = k,
//   k + grid, ...
// * A producer warp whose one thread copies a group's rows of each
//   streamed tensor (y, r; or y, dy, dr) into a stage of an S-stage ring in
//   shared memory by cp.async.bulk, Hopper's 1-D TMA copy: the group's rows
//   of a tensor are contiguous, so one copy a tensor a stage, completing on
//   the stage's full mbarrier with expect_tx. Rows are 16-byte aligned
//   (D % 16 == 0, bases 16-byte aligned: the wrapper checks both).
// * R consumer warps, one row of the stage each: lanes read consecutive
//   16-byte chunks of the row from shared memory (conflict-free), sum the
//   row's statistics (two sums for 4, four for 12) in fp32, reduce them with
//   one warp-shuffle tree, read the row again from shared memory for the
//   epilogue, write the output by 16-byte stores, and release the stage on
//   its empty mbarrier.
// * Per-block constants, copied once a block by the same producer thread
//   (one bulk copy each, on a barrier of their own): g and b in fp32 and,
//   where they take at most 64 KB (B <= 15 for 4 and <= 10 for 12 at D =
//   1056), the AdaLN rows of all samples, so that no row's epilogue reads
//   L2 or device memory but for its own stage. Past that they are read
//   through L1 and L2 (on the H100 that path took kernel 4 0.77 ms at the
//   0.25 deg shape against 0.59 from shared memory).
//
// R, S and the launch are chosen from D and the samples by
// ops/modnorm.py::modnorm_plan (pure Python; modnorm_smem here is its byte
// count): 8 rows in 3 stages at D = 1056 (2, 4 and 6 stages and 4 to 16 rows
// were no faster: scripts/probe_modnorm.py), fewer rows
// for wide D, one row and one stage at the widest (D = 19,360 for 4, 16,592
// for 12). A group that ends past T, and one whose rows belong to two
// samples, are handled row by row. No atomics and one fixed order of every
// sum: two calls give the same bits.
#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace swift {
namespace {

constexpr int kRowsMax = 16;  // the most rows a stage: one consumer warp each

// Dynamic shared memory of a plan: a full and an empty barrier a stage and
// one for the constants, g and b in fp32, the AdaLN rows where the plan
// keeps them here (`ada_rows` rows of D bf16: each AdaLN tensor's row of
// every sample), then the stages, each `rows` rows of each of `tensors`
// streamed bf16 tensors (a tensor's rows contiguous).
__host__ __device__ constexpr long long modnorm_smem(int D, int tensors, int rows, int stages,
                                                     int ada_rows) {
  return 16LL * stages + 16 + 8LL * D + 2LL * ada_rows * D +
         (long long)stages * rows * tensors * 2 * D;
}

struct RowArgs {
  const bf16* src[3];  // streamed: y, r (4); y, dy, dr (12)
  const bf16* ada[3];  // AdaLN rows (B, D): ms, mb (4); ms, dms, dmb (12)
  const float* g;
  const float* b;
  bf16* out;
  int T, D, tps, rows, stages;
  int ada_smem;  // 1: the AdaLN rows copied into shared memory; 0: read through L1/L2
  float eps;
};

// Eight bf16 (a 16-byte chunk) of shared or device memory as floats.
__device__ __forceinline__ void ld8(const bf16* p, float f[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(e[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

// Eight fp32 of shared memory.
__device__ __forceinline__ void ld8(const float* p, float f[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// A stage's ring position: its index and the phase parity a waiter waits for.
struct Ring {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

// One row of kernel 4: the row's y and r in shared memory, its sample's
// AdaLN rows at ada[0], ada[1] (shared memory or device memory).
__device__ __forceinline__ void modnorm_row(const RowArgs& a, const bf16* ys, const bf16* rs_,
                                            const float* gs, const float* bs,
                                            const bf16* const* ada, int row, int lane) {
  const int chunks = a.D / 8;
  const float inv_d = 1.0f / (float)a.D;
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = lane; c < chunks; c += 32) {
    float y[8];
    ld8(ys + 8 * c, y);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s1 += y[k];
      s2 = fmaf(y[k], y[k], s2);
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mu = s1 * inv_d;
  const float rs = rsqrtf(s2 * inv_d - mu * mu + a.eps);
  const size_t smp = (size_t)(row / a.tps) * a.D;
  const bf16* ms = ada[0] + smp;
  const bf16* mb = ada[1] + smp;
  bf16* out = a.out + (size_t)row * a.D;
  for (int c = lane; c < chunks; c += 32) {
    float y[8], r[8], g[8], b[8], sc[8], sh[8], v[8];
    ld8(ys + 8 * c, y);
    ld8(rs_ + 8 * c, r);
    ld8(gs + 8 * c, g);
    ld8(bs + 8 * c, b);
    ld8(ms + 8 * c, sc);
    ld8(mb + 8 * c, sh);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float ln = (y[k] - mu) * rs * g[k] + b[k];
      v[k] = ln * (1.0f + sc[k]) + sh[k] + r[k];
    }
    *reinterpret_cast<uint4*>(out + 8 * c) = pack8(v);
  }
}

// One row of kernel 12: the row's y, dy, dr in shared memory, its sample's
// AdaLN rows and their tangents at ada[0..2].
__device__ __forceinline__ void tangent_row(const RowArgs& a, const bf16* ys, const bf16* dys,
                                            const bf16* drs, const float* gs, const float* bs,
                                            const bf16* const* ada, int row, int lane) {
  const int chunks = a.D / 8;
  const float inv_d = 1.0f / (float)a.D;
  float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, s4 = 0.0f;
  for (int c = lane; c < chunks; c += 32) {
    float y[8], dy[8];
    ld8(ys + 8 * c, y);
    ld8(dys + 8 * c, dy);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s1 += y[k];
      s2 = fmaf(y[k], y[k], s2);
      s3 += dy[k];
      s4 = fmaf(y[k], dy[k], s4);
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  s3 = warp_sum(s3);
  s4 = warp_sum(s4);
  const float mu = s1 * inv_d;
  const float rs = rsqrtf(s2 * inv_d - mu * mu + a.eps);
  const float dmu = s3 * inv_d;
  const float dvar = 2.0f * (s4 * inv_d - mu * dmu);
  const float kk = 0.5f * (rs * rs) * dvar;
  const size_t smp = (size_t)(row / a.tps) * a.D;
  const bf16* ms = ada[0] + smp;
  const bf16* dms = ada[1] + smp;
  const bf16* dmb = ada[2] + smp;
  bf16* out = a.out + (size_t)row * a.D;
  for (int c = lane; c < chunks; c += 32) {
    float y[8], dy[8], dr[8], g[8], b[8], sc[8], dsc[8], dsh[8], v[8];
    ld8(ys + 8 * c, y);
    ld8(dys + 8 * c, dy);
    ld8(drs + 8 * c, dr);
    ld8(gs + 8 * c, g);
    ld8(bs + 8 * c, b);
    ld8(ms + 8 * c, sc);
    ld8(dms + 8 * c, dsc);
    ld8(dmb + 8 * c, dsh);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float yn = (y[k] - mu) * rs;
      const float dyn = rs * (dy[k] - dmu) - yn * kk;
      v[k] = dyn * g[k] * (1.0f + sc[k]) + (yn * g[k] + b[k]) * dsc[k] + dsh[k] + dr[k];
    }
    *reinterpret_cast<uint4*>(out + 8 * c) = pack8(v);
  }
}

// 32 (rows + 1) threads: warps 0 .. rows - 1 consume, warp `rows` produces.
template <bool TANGENT>
__global__ void __launch_bounds__(32 * (kRowsMax + 1), 1) modnorm_rows_kernel(const RowArgs a) {
  constexpr int NT = TANGENT ? 3 : 2;  // streamed tensors, and AdaLN rows a sample
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + a.stages;
  uint64_t* consts = empty + a.stages;
  float* gs = reinterpret_cast<float*>(smem + 16 * a.stages + 16);
  float* bs = gs + a.D;
  const int samples = (a.T + a.tps - 1) / a.tps;
  const size_t ada_elems = a.ada_smem ? (size_t)samples * a.D : 0;  // a tensor's, in smem
  bf16* ada_s = reinterpret_cast<bf16*>(bs + a.D);
  bf16* ring = ada_s + NT * ada_elems;
  const size_t tensor_elems = (size_t)a.rows * a.D;  // a tensor's rows in a stage
  const size_t stage_elems = NT * tensor_elems;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = (a.T + a.rows - 1) / a.rows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], a.rows);  // each consumer warp
    }
    mbar_init(consts, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == a.rows) {  // the producer
    if (lane == 0) {
      // the constants once a block: g, b and (where the plan keeps them here)
      // the AdaLN rows, each one contiguous copy
      const uint32_t ada_bytes = (uint32_t)(ada_elems * 2);
      mbar_expect_tx(consts, 8 * a.D + NT * ada_bytes);
      bulk_load(gs, a.g, 4 * a.D, consts);
      bulk_load(bs, a.b, 4 * a.D, consts);
      if (ada_bytes) {
#pragma unroll
        for (int t = 0; t < NT; ++t) bulk_load(ada_s + t * ada_elems, a.ada[t], ada_bytes, consts);
      }
      Ring pos;
      for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
        mbar_wait(&empty[pos.s], pos.phase ^ 1);
        const int row0 = grp * a.rows;
        const uint32_t bytes = (uint32_t)min(a.rows, a.T - row0) * a.D * 2;
        mbar_expect_tx(&full[pos.s], NT * bytes);
        bf16* stage = ring + pos.s * stage_elems;
#pragma unroll
        for (int t = 0; t < NT; ++t)
          bulk_load(stage + t * tensor_elems, a.src[t] + (size_t)row0 * a.D, bytes,
                    &full[pos.s]);
        pos.next(a.stages);
      }
    }
    return;
  }

  const bf16* ada[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) ada[t] = a.ada_smem ? ada_s + t * ada_elems : a.ada[t];
  mbar_wait(consts, 0);
  Ring pos;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int row = grp * a.rows + warp;
    mbar_wait(&full[pos.s], pos.phase);
    if (row < a.T) {
      const bf16* x = ring + pos.s * stage_elems + (size_t)warp * a.D;
      if constexpr (TANGENT)
        tangent_row(a, x, x + tensor_elems, x + 2 * tensor_elems, gs, bs, ada, row, lane);
      else
        modnorm_row(a, x, x + tensor_elems, gs, bs, ada, row, lane);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[pos.s]);
    pos.next(a.stages);
  }
}

// The SMs of each device, read once, and the shared-memory attribute set
// once a device and instantiation.
static int rows_sms[2][64];

template <bool TANGENT>
int launch_rows(const RowArgs& a, cudaStream_t stream) {
  constexpr int NT = TANGENT ? 3 : 2;
  const int samples = a.tps > 0 ? (a.T + a.tps - 1) / a.tps : 0;
  const long long smem = modnorm_smem(a.D, NT, a.rows, a.stages, a.ada_smem ? NT * samples : 0);
  if (a.rows < 1 || a.rows > kRowsMax || a.stages < 1 || a.D < 16 || a.D % 16 || a.T < 0 ||
      a.tps < 1 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (a.T == 0) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int& n_sm = rows_sms[TANGENT][device % 64];
  if (n_sm == 0) {
    err = cudaFuncSetAttribute(modnorm_rows_kernel<TANGENT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = (a.T + a.rows - 1) / a.rows;
  modnorm_rows_kernel<TANGENT>
      <<<groups < n_sm ? groups : n_sm, 32 * (a.rows + 1), (int)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace swift

using swift::bf16;

// Kernel 4: y, r, out (T, D) bf16; g, b (D,) fp32; ms, mb (T / tps, D)
// bf16; D % 16 == 0, 16-byte aligned bases; rows, stages and whether the
// AdaLN rows go to shared memory (ada_smem) from modnorm_plan(D). Returns the
// launch's error.
extern "C" int swift_modnorm_residual(const void* y, const void* r, const void* g, const void* b,
                                      const void* ms, const void* mb, void* out, int T, int D,
                                      int tps, int rows, int stages, int ada_smem, float eps,
                                      void* stream) {
  swift::RowArgs a{{(const bf16*)y, (const bf16*)r, nullptr},
                   {(const bf16*)ms, (const bf16*)mb, nullptr},
                   (const float*)g, (const float*)b, (bf16*)out, T, D, tps, rows, stages,
                   ada_smem, eps};
  return swift::launch_rows<false>(a, (cudaStream_t)stream);
}

// Kernel 12: y, dy, dr, out (T, D) bf16; g, b (D,) fp32; ms, dms, dmb
// (T / tps, D) bf16; the rest as swift_modnorm_residual, rows and stages from
// modnorm_plan(D, tangent=True).
extern "C" int swift_modnorm_residual_tangent(const void* y, const void* dy, const void* dr,
                                              const void* g, const void* b, const void* ms,
                                              const void* dms, const void* dmb, void* out, int T,
                                              int D, int tps, int rows, int stages,
                                              int ada_smem, float eps, void* stream) {
  swift::RowArgs a{{(const bf16*)y, (const bf16*)dy, (const bf16*)dr},
                   {(const bf16*)ms, (const bf16*)dms, (const bf16*)dmb},
                   (const float*)g, (const float*)b, (bf16*)out, T, D, tps, rows, stages,
                   ada_smem, eps};
  return swift::launch_rows<true>(a, (cudaStream_t)stream);
}
