// Shifted-window cosine attention on Hopper, straight from the qkv
// projection's (B, gh, gw, heads*3*d) layout.
//
// The forward, kernels 2 and 15 (swift_block_attention,
// swift_tiled_attention), replaces swift_tpu/ops/pallas_block_attention.py::
// _fwd_call and _tiled_fwd_call (kernel body _fwd_kernel). Per (sample,
// window, head): q and k are L2-normalised in fp32 (eps 1e-12) and rounded
// to bf16, q carries the learned logit scale, the 256 x 256 logits are
// accumulated in fp32, softmax runs in fp32, p = e / sum(e) is normalised
// before it is rounded to bf16, p . v accumulates in fp32, and the output
// is written back in the same shifted coordinates it was read from. The
// odd-block cyclic shift is folded into the index math: token t of window
// (wi, wj) lives at ((wi*wh + sh + t/ww) mod gh, (wj*ww + sw + t%ww) mod
// gw), exactly the wrapped coordinates _gather_window and _scatter_window
// use, so there is no roll pass. q/k/v of head h are read at feature
// offsets h*3d + {0, d, 2d}; d (88 at the flagship) is zero-padded to DP,
// a multiple of 32, in shared memory only.
//
// What bounds it on the H100: the bytes. A window-head reads 3 x 256 x d
// and writes 256 x d bf16 for 4 x 256 x 256 x DP flops, about 140 flops a
// byte at d = 88, under the ~295 at which the tensor cores would set the
// pace. So the design moves each byte once and overlaps the products with
// the loads (see attn_fwd_kernel below).
//
// The window-tiled kernels 15, 16 and 17 (swift_tiled_attention*) replace
// pallas_block_attention.py::_tiled_fwd_call, _tiled_bwd_call and
// _tiled_tangent_call, the grids too large for the whole-grid TPU kernel
// (0.25 degrees: 368 x 720 tokens). Their qkv is rolled before the call, so
// a window is an aligned block of rows and columns: the same bodies run
// with the wrap arithmetic compiled out (TILED), in the same key order, so
// kernel 15 on rolled qkv equals kernel 2 bit for bit. Kernel 16 replaces
// kernel 6's per-query-block fp32 dk/dv partials, which at 0.25 degrees
// would be 17.4 GB a layer, by a second pass over key blocks (see below).
#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace swift {

constexpr int kWinTokens = 256, kQB = 64, kAttnNT = 256;
constexpr int kSLD = kWinTokens + 4;  // fp32 logit row stride

// Device-memory token of row t of window w of sample b: the window starts
// at (wi*wh + sh, wj*ww + sw) and wraps around the grid (the shifted
// whole-grid kernels), or, TILED, starts at (wi*wh, wj*ww) and never wraps.
template <bool TILED>
struct WindowIndex {
  int b, gh, gw, ww, i0, j0;
  __device__ __forceinline__ WindowIndex(int b_, int w, int gh_, int gw_, int wh, int ww_,
                                         int sh, int sw)
      : b(b_), gh(gh_), gw(gw_), ww(ww_),
        i0((w / (gw_ / ww_)) * wh + sh), j0((w % (gw_ / ww_)) * ww_ + sw) {}
  __device__ __forceinline__ size_t operator()(int t) const {
    int row = i0 + t / ww, col = j0 + t % ww;
    if (!TILED) {
      row %= gh;
      col %= gw;
    }
    return ((size_t)b * gh + row) * gw + col;
  }
};

// Row t of the window as bf16 in smem (zero-padded to DP), optionally
// L2-normalised and multiplied by ``mul``. One warp per row.
template <int DP>
__device__ __forceinline__ void load_row(bf16* dst, const bf16* src, int d, bool normalise,
                                         float mul, int lane) {
  float v[8];
  const bool live = lane * 8 < d;
  if (live) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + lane * 8);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.0f;
  }
  if (normalise) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += v[i] * v[i];
    const float inv = rsqrtf(warp_sum(ss) + 1e-12f);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = v[i] * inv * mul;
  }
  if (lane * 8 < DP) *reinterpret_cast<uint4*>(dst + lane * 8) = pack8(v);
}

// ---------------------------------------------------------------------------
// The forward of kernels 2 and 15 on wgmma.
//
// One block of 384 threads an SM (persistent: it walks window-heads, heads
// fastest, so the blocks in flight read neighbouring feature slices of the
// same token rows). A window-head's k and v are loaded and k normalised
// once, and serve all four of its 64-row query blocks; q goes through two
// 64-row stages. Warp specialisation:
//   warpgroup 0, the producer: gathers rows through WindowIndex with
//     cp.async (16 bytes a thread, no registers held) into shared memory
//     laid out for wgmma -- 64-column boxes of 128-byte rows with the
//     128-byte swizzle, as TMA would write them (TMA cannot gather the
//     wrapped rows nor normalise) -- and L2-normalises k in place in fp32
//     (eight threads a row), rounding it to bf16; columns d..DP are zero.
//     Its order per window-head: q blocks 0, 1 and k in four 64-row groups,
//     each group normalised as it lands (once the previous window-head's
//     last q̂·k̂ᵀ has retired), v (once its last p·v has), q blocks 2, 3. So
//     the next window-head's k lands while the consumers finish this one's
//     softmax and p·v.
//   warpgroups 1 and 2, the consumers: consumer c takes query blocks c and
//     c + 2, each in turn: it normalises its q block in place (times the
//     logit scale; the normalise was the longest task on the producer's
//     critical path), S = q̂·k̂ᵀ by DP/16 m64n256k16 wgmmas (all 256 keys in
//     one fp32 accumulator of 128 registers, so the softmax needs no online
//     rescaling), the row max and sum by quad shuffles, p = e / sum rounded
//     to bf16 in registers -- the m64n256 accumulator's layout is the
//     A-fragment layout of k16 slices -- then O = p·v by 16 m64nDPk16
//     wgmmas with p from registers and v read MN-major (the transpose-B
//     form; v's rows stay as loaded). O is rounded to bf16, staged in the
//     consumer's shared-memory rows and copied to the token each query came
//     from by bulk copies, one a row.
// mbarriers, each with a full and an empty one for k, v and the two q
// stages: the producer's 128 threads arrive on a full barrier once their
// copies have landed (and, for k, after the normalise and a proxy fence);
// each consumer warp arrives on an empty barrier once the wgmmas that read
// the buffer have completed. Registers (setmaxnreg): 80 a producer thread,
// 208 a consumer thread. ptxas compiles the consumers within the launch
// bound's 168 and the producer within its 80; below 80 it spills there.
constexpr int kFwdThreads = 384;

template <int DP>
struct AttnFwd {
  static constexpr int NBOX = (DP + 63) / 64;        // 64-column boxes of a padded row
  static constexpr int SLOTS = DP / 8;               // 16-byte chunks of a padded row
  static constexpr int KV_BOX = kWinTokens * 128;    // one box of 256 rows
  static constexpr int Q_BOX = kQB * 128;            // one box of 64 rows
  static constexpr int LDO = DP + 8;                 // bf16 stride of the output staging rows
  static constexpr int V_OFF = NBOX * KV_BOX;        // k at 0
  static constexpr int Q_OFF = 2 * NBOX * KV_BOX;    // two q stages
  static constexpr int O_OFF = Q_OFF + 2 * NBOX * Q_BOX;  // two consumers' output rows
  static constexpr int ROW_OFF = O_OFF + 2 * kQB * LDO * 2;  // the producer's row offsets
  static constexpr int BAR_OFF = ROW_OFF + 2 * kWinTokens * 8;  // two window-heads' worth
  enum { K_FULL, K_EMPTY, V_FULL, V_EMPTY, Q_FULL, Q_EMPTY = Q_FULL + 2, N_BARS = Q_EMPTY + 2 };
  static constexpr int SMEM = 1024 + BAR_OFF + N_BARS * 8;  // with the alignment pad
  static_assert(SMEM <= kMaxSmem, "the forward's buffers do not fit");
};

// The producer's cp.asyncs of ``rows`` rows starting at window row ``row0``,
// feature column ``col``, by THREADS threads (tid < THREADS): chunk c of row
// r to box c / 8, row r, 16-byte slot (c % 8) ^ (r % 8); chunks d/8 .. DP/8
// zero-filled.
template <int DP, int THREADS = 128>
__device__ __forceinline__ void fwd_load(unsigned char* tile, int box_bytes, int rows,
                                         const bf16* qkv, const size_t* row_off, int row0,
                                         int col, int chunks, int tid) {
  constexpr int SLOTS = AttnFwd<DP>::SLOTS;
  for (int i = tid; i < rows * SLOTS; i += THREADS) {
    const int r = i / SLOTS, c = i % SLOTS;
    const bool live = c < chunks;
    cp_async16(tile + (c / 8) * box_bytes + r * 128 + (((c % 8) ^ (r % 8)) << 4),
               live ? qkv + row_off[row0 + r] + col + c * 8 : qkv, live);
  }
}

// L2-normalise ``rows`` rows of a swizzled tile in place in fp32, multiply
// by ``mul`` where SCALED (q by the logit scale) and round to bf16 (the
// chunks past d written as zeros): eight of a warpgroup's threads a row,
// chunks sub and sub + 8.
template <int DP, bool SCALED>
__device__ __forceinline__ void fwd_normalise(unsigned char* tile, int box_bytes, int rows,
                                              int chunks, float mul, int tid) {
  constexpr int NBOX = AttnFwd<DP>::NBOX, SLOTS = AttnFwd<DP>::SLOTS;
  const int sub = tid % 8;
  for (int r = tid / 8; r < rows; r += 16) {
    uint4 raw[NBOX];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NBOX; ++j) {
      raw[j] = make_uint4(0u, 0u, 0u, 0u);
      if (sub + 8 * j < chunks)
        raw[j] = *reinterpret_cast<const uint4*>(tile + j * box_bytes + r * 128 +
                                                 ((sub ^ (r % 8)) << 4));
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        ss += f.x * f.x + f.y * f.y;
      }
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    ss += __shfl_xor_sync(0xffffffffu, ss, 4);
    const float inv = rsqrtf(ss + 1e-12f);
#pragma unroll
    for (int j = 0; j < NBOX; ++j) {
      if (sub + 8 * j >= SLOTS) continue;
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw[j]);
      float v[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        v[2 * i] = SCALED ? f.x * inv * mul : f.x * inv;
        v[2 * i + 1] = SCALED ? f.y * inv * mul : f.y * inv;
      }
      *reinterpret_cast<uint4*>(tile + j * box_bytes + r * 128 + ((sub ^ (r % 8)) << 4)) =
          pack8(v);
    }
  }
}

// The producer's normalise of k rows [64 g, 64 g + 64), the g-th of its
// cp.async groups, once at most PENDING of this thread's groups are in
// flight and every producer thread's copies of them have landed.
template <int DP, int PENDING>
__device__ __forceinline__ void fwd_normalise_k_rows(unsigned char* Ks, int g, int chunks,
                                                     int tid) {
  cp_async_wait<PENDING>();
  named_barrier_sync(3, 128);
  fwd_normalise<DP, false>(Ks + g * kQB * 128, AttnFwd<DP>::KV_BOX, kQB, chunks, 1.0f, tid);
}

// The softmax of a consumer's 64 x 256 logits in place, rounded to bf16 as
// the A fragments of the 16 k16 slices of p·v: thread t holds rows
// (t % 32) / 4 + {0, 8} of its warp's 16, s[4 j + 2 h + e] in row h.
__device__ __forceinline__ void fwd_softmax(float (&s)[128], uint32_t (&p)[16][4]) {
  constexpr float kLog2e = 1.4426950408889634f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 128; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    s[i] = exp2f((s[i] - m[(i >> 1) & 1]) * kLog2e);
    l[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = 1.0f / l[h];
  }
#pragma unroll
  for (int k = 0; k < 16; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      p[k][q] = pack_bf16x2(s[8 * k + 2 * q] * l[q & 1], s[8 * k + 2 * q + 1] * l[q & 1]);
}

// Consumer c's 64 output rows of query block qb: rounded to bf16 into its
// staging rows, then each row (d bf16) to its token by one bulk copy,
// issued by thread ``row`` (tid < 64), which the consumer does not wait for
// until it next writes the rows.
template <int DP, bool TILED>
__device__ __forceinline__ void fwd_store(const float (&o)[DP / 2], bf16* rows, bf16* out,
                                          const WindowIndex<TILED>& token, int qb, size_t ofeat,
                                          int col, int d, int c, int tid) {
  constexpr int LDO = AttnFwd<DP>::LDO;
  const int lane = tid % 32, r = tid / 32 * 16 + lane / 4;
  if (tid < kQB) tma_store_wait_read<0>();  // the previous block's copies have read the rows
  named_barrier_sync(1 + c, 128);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(rows + (r + 8 * h) * LDO + 8 * j + 2 * (lane % 4)) =
          pack_bf16x2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
  fence_async_smem();
  named_barrier_sync(1 + c, 128);
  if (tid < kQB) {
    bulk_store(out + token(qb * kQB + tid) * ofeat + col, rows + tid * LDO, d * 2);
    tma_store_commit();
  }
}

template <int DP, bool TILED>
__global__ void __launch_bounds__(kFwdThreads, 1)
    attn_fwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ scale,
                    bf16* __restrict__ out, int B, int gh, int gw, int heads, int d, int wh,
                    int ww, int sh, int sw) {
  using L = AttnFwd<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + L::V_OFF;
  unsigned char* Qs = smem + L::Q_OFF;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  const int nW = (gh / wh) * (gw / ww), items = B * nW * heads, chunks = d / 8;
  const size_t feat = (size_t)heads * 3 * d;
  if (threadIdx.x == 0) {
    const int counts[L::N_BARS] = {128, 8, 128, 8, 128, 128, 4, 4};
    for (int i = 0; i < L::N_BARS; ++i) mbar_init(&bar[i], counts[i]);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<80>();
    const int tid = threadIdx.x;
    uint32_t it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int h = item % heads, w = item / heads % nW, b = item / heads / nW;
      const WindowIndex<TILED> token(b, w, gh, gw, wh, ww, sh, sw);
      // two tables in turn: a thread may write this window-head's while another still
      // issues the previous one's last copies from the other
      size_t* row_off = reinterpret_cast<size_t*>(smem + L::ROW_OFF) + (it & 1) * kWinTokens;
      for (int t = tid; t < kWinTokens; t += 128) row_off[t] = token(t) * feat + (size_t)h * 3 * d;
      named_barrier_sync(3, 128);
      // k and q blocks 0, 1
      mbar_wait(&bar[L::K_EMPTY], (it & 1) ^ 1);
      mbar_wait(&bar[L::Q_EMPTY], 1);
      mbar_wait(&bar[L::Q_EMPTY + 1], 1);
      fwd_load<DP>(Qs, L::Q_BOX, kQB, qkv, row_off, 0, 0, chunks, tid);
      fwd_load<DP>(Qs + L::NBOX * L::Q_BOX, L::Q_BOX, kQB, qkv, row_off, kQB, 0, chunks, tid);
      cp_async_commit();
      for (int g = 0; g < kWinTokens / kQB; ++g) {  // k in four groups of 64 rows
        fwd_load<DP>(Ks + g * kQB * 128, L::KV_BOX, kQB, qkv, row_off, g * kQB, d, chunks, tid);
        cp_async_commit();
      }
      cp_async_wait<4>();
      mbar_arrive(&bar[L::Q_FULL]);  // raw: each consumer normalises its own q
      mbar_arrive(&bar[L::Q_FULL + 1]);
      fwd_normalise_k_rows<DP, 3>(Ks, 0, chunks, tid);  // each group as it lands
      fwd_normalise_k_rows<DP, 2>(Ks, 1, chunks, tid);
      fwd_normalise_k_rows<DP, 1>(Ks, 2, chunks, tid);
      fwd_normalise_k_rows<DP, 0>(Ks, 3, chunks, tid);
      fence_async_smem();
      mbar_arrive(&bar[L::K_FULL]);
      // v
      mbar_wait(&bar[L::V_EMPTY], (it & 1) ^ 1);
      fwd_load<DP>(Vs, L::KV_BOX, kWinTokens, qkv, row_off, 0, 2 * d, chunks, tid);
      cp_async_commit();
      cp_async_wait<0>();
      fence_async_smem();
      mbar_arrive(&bar[L::V_FULL]);
      // q blocks 2, 3
      mbar_wait(&bar[L::Q_EMPTY], 0);
      mbar_wait(&bar[L::Q_EMPTY + 1], 0);
      fwd_load<DP>(Qs, L::Q_BOX, kQB, qkv, row_off, 2 * kQB, 0, chunks, tid);
      fwd_load<DP>(Qs + L::NBOX * L::Q_BOX, L::Q_BOX, kQB, qkv, row_off, 3 * kQB, 0, chunks,
                   tid);
      cp_async_commit();
      cp_async_wait<0>();
      mbar_arrive(&bar[L::Q_FULL]);
      mbar_arrive(&bar[L::Q_FULL + 1]);
    }
  } else {  // the consumers
    setmaxnreg_inc<208>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid % 32;
    unsigned char* Qc = Qs + c * L::NBOX * L::Q_BOX;
    bf16* rows = reinterpret_cast<bf16*>(smem + L::O_OFF) + c * kQB * L::LDO;
    const size_t ofeat = (size_t)heads * d;
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar[i]);
    };
    uint32_t it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int h = item % heads, w = item / heads % nW, b = item / heads / nW;
      const WindowIndex<TILED> token(b, w, gh, gw, wh, ww, sh, sw);
      const float scale_h = scale[h];
#pragma unroll 1
      for (int j = 0; j < 2; ++j) {
        mbar_wait(&bar[L::Q_FULL + c], j);
        fwd_normalise<DP, true>(Qc, L::Q_BOX, kQB, chunks, scale_h, tid);
        fence_async_smem();
        named_barrier_sync(1 + c, 128);
        float s[128];
        mbar_wait(&bar[L::K_FULL], it & 1);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < DP / 16; ++k)
          wgmma_m64nNk16<256>(s, wgmma_desc(Qc + (k / 4) * L::Q_BOX) + 2 * (k % 4),
                              wgmma_desc(Ks + (k / 4) * L::KV_BOX) + 2 * (k % 4), k > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        release(L::Q_EMPTY + c);
        if (j == 1) release(L::K_EMPTY);

        uint32_t p[16][4];
        fwd_softmax(s, p);
        float o[DP / 2];
        mbar_wait(&bar[L::V_FULL], it & 1);
        wgmma_fence();
        const uint64_t dv = wgmma_desc_mn(Vs, L::KV_BOX);
#pragma unroll
        for (int k = 0; k < 16; ++k) wgmma_m64nNk16_rs<DP>(o, p[k], dv + 128 * k, k > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        if (j == 1) release(L::V_EMPTY);
        fwd_store<DP, TILED>(o, rows, out, token, 2 * j + c, ofeat, h * d, d, c, tid);
      }
    }
    if (tid < kQB) tma_store_wait_all();  // the rows stay until the last copies have read them
  }
}

// Kernels 2 (shifted, wrapping) and 15 (TILED, on pre-rolled qkv): one
// launch, as many blocks as SMs (at most one a window-head). The shared-
// memory attribute is set and the SM count read once a device and
// instantiation, kept in a table of this file (a static local of the
// template would be one symbol shared by every library that defines it).
static int attn_fwd_sms[8][64];

template <int DP, bool TILED>
int launch_attn_fwd(const void* qkv, const void* scale, void* out, int B, int gh, int gw,
                    int heads, int d, int wh, int ww, int sh, int sw, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int& n_sm = attn_fwd_sms[(DP / 32 - 1) * 2 + TILED][device % 64];
  if (n_sm == 0) {
    err = cudaFuncSetAttribute(attn_fwd_kernel<DP, TILED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, AttnFwd<DP>::SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  const int items = B * heads * (gh / wh) * (gw / ww);
  attn_fwd_kernel<DP, TILED><<<items < n_sm ? items : n_sm, kFwdThreads, AttnFwd<DP>::SMEM,
                               stream>>>((const bf16*)qkv, (const float*)scale, (bf16*)out, B, gh,
                                         gw, heads, d, wh, ww, sh, sw);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward -- replaces swift_tpu/ops/pallas_block_attention.py::_bwd_call
// (kernel body _bwd_kernel). Per (sample, window, head) it recomputes the
// softmax and forms, at the TPU kernel's rounding points (q̂·s, k̂, p and dS
// rounded to bf16 before the products that consume them, fp32 sums):
//   dv = pᵀ·do, dp = do·vᵀ, dS = p (dp − Σ p dp), dq̂ = s dS·k̂, dk̂ = dSᵀ·(q̂ s),
//   dq = (dq̂ − q̂ (q̂·dq̂)) / |q|, dk likewise, and Σ dS·logits / s for the
//   logit scale -- written into dqkv in the [q|k|v] interleave, at the same
//   shifted coordinates the forward reads.
//
// What bounds it: like the forward, on-chip capacity. A block holds the
// logits and dp of its query rows (two QB x 256 fp32 tiles), q̂s and do of
// those rows and one 256-row key (then value, then key) buffer: 208 KB at
// QB = 64 and d <= 96, so d = 128 takes QB = 32. dk and dv sum over all
// 256 query rows of a window, which no block holds at once, so each block
// writes fp32 partials of dk̂ and dv for the whole window, and a second
// kernel sums the 256/QB partials in a fixed order, applies the k̂
// normalisation backward and writes dk and dv. The scale partials are
// summed, also in a fixed order, by a third, one-block kernel. No atomics.
template <int DP>
struct AttnBwd {
  static constexpr int QB = DP <= 96 ? 64 : 32;
  static constexpr int NQB = kWinTokens / QB;
  static constexpr int LDQ = DP + 8;
  static constexpr int PLD = 2 * kSLD;  // bf16 stride of p / dS written over fp32 rows
  static constexpr int SMEM = (2 * QB + kWinTokens) * LDQ * 2 + 2 * QB * kSLD * 4;
};

//
// Kernel 16 (TILED) runs the same query pass but writes no dk̂/dv partials:
// it keeps each query row's softmax statistics (max m, sum l and
// D = Σ p·dp, 12 bytes a row) for the key pass below.
template <int DP, bool TILED>
__device__ __forceinline__ void attn_bwd_q(unsigned char* smem_raw, const bf16* __restrict__ qkv,
                                           const float* __restrict__ scale,
                                           const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                                           float* __restrict__ part_k, float* __restrict__ part_v,
                                           float* __restrict__ part_s, float* __restrict__ stats,
                                           int gh, int gw, int heads, int d, int wh, int ww,
                                           int sh, int sw) {
  using C = AttnBwd<DP>;
  constexpr int QB = C::QB, LDQ = C::LDQ, PLD = C::PLD, NW = kAttnNT / 32, CT = DP / 16;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // bf16(q̂ s)
  bf16* dOs = Qs + QB * LDQ;                     // do
  bf16* KVs = dOs + QB * LDQ;                    // k̂, then v, then k̂ again
  float* Ss = reinterpret_cast<float*>(KVs + kWinTokens * LDQ);  // logits -> p -> dq̂
  float* dPs = Ss + QB * kSLD;                                    // dp -> dS
  bf16* Ps = reinterpret_cast<bf16*>(Ss);
  bf16* dSs = reinterpret_cast<bf16*>(dPs);
  __shared__ float red[NW];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bz = blockIdx.z, b = bz / heads, h = bz % heads;
  const int nW = gridDim.y, w = blockIdx.y, qb = blockIdx.x;
  const int q0 = qb * QB;
  const size_t feat = (size_t)heads * 3 * d, ofeat = (size_t)heads * d;
  const WindowIndex<TILED> token(b, w, gh, gw, wh, ww, sh, sw);
  const bf16* head = qkv + (size_t)h * 3 * d;
  const float s = scale[h];

  for (int r = warp; r < QB; r += NW) {
    load_row<DP>(Qs + r * LDQ, head + token(q0 + r) * feat, d, true, s, lane);
    load_row<DP>(dOs + r * LDQ, dout + token(q0 + r) * ofeat + (size_t)h * d, d, false, 1.0f,
                 lane);
  }
  for (int r = warp; r < kWinTokens; r += NW)
    load_row<DP>(KVs + r * LDQ, head + token(r) * feat + d, d, true, 1.0f, lane);
  __syncthreads();

  // C[QB x 256] (fp32, stride kSLD) = A[QB x DP] . B[256 x DP]^T
  auto rows_x_window = [&](const bf16* A, float* Cm) {
    for (int f = warp; f < (QB / 16) * (kWinTokens / 16); f += NW) {
      const int rt = f / (kWinTokens / 16), ct = f % (kWinTokens / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(a, A + rt * 16 * LDQ + kk, LDQ);
        wmma::load_matrix_sync(kb, KVs + ct * 16 * LDQ + kk, LDQ);
        wmma::mma_sync(acc, a, kb, acc);
      }
      wmma::store_matrix_sync(Cm + rt * 16 * kSLD + ct * 16, acc, kSLD, wmma::mem_row_major);
    }
  };
  rows_x_window(Qs, Ss);  // logits
  __syncthreads();
  for (int r = warp; r < kWinTokens; r += NW)
    load_row<DP>(KVs + r * LDQ, head + token(r) * feat + 2 * d, d, false, 1.0f, lane);
  __syncthreads();
  rows_x_window(dOs, dPs);  // dp = do . vᵀ
  __syncthreads();

  // one warp per query row: p, dS, and Σ dS·logits; p and dS are rounded to
  // bf16 in place over the fronts of their fp32 rows
  float dsum = 0.f;
  for (int r = warp; r < QB; r += NW) {
    float lg[kWinTokens / 32], dp[kWinTokens / 32];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i) {
      lg[i] = Ss[r * kSLD + lane + 32 * i];
      dp[i] = dPs[r * kSLD + lane + 32 * i];
      m = fmaxf(m, lg[i]);
    }
    m = warp_max(m);
    float e[kWinTokens / 32], l = 0.f;
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i) {
      e[i] = expf(lg[i] - m);
      l += e[i];
    }
    l = warp_sum(l);
    float pdp = 0.f;
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i) {
      e[i] = e[i] / l;  // p
      pdp += e[i] * dp[i];
    }
    pdp = warp_sum(pdp);
    if (TILED && lane == 0) {  // this row's softmax statistics, for the key pass
      float* st = stats + ((size_t)bz * nW + w) * 3 * kWinTokens + q0 + r;
      st[0] = m;
      st[kWinTokens] = l;
      st[2 * kWinTokens] = pdp;
    }
    __syncwarp();  // every lane has read its row before any bf16 overwrites it
#pragma unroll
    for (int i = 0; i < kWinTokens / 32; ++i) {
      const float dS = e[i] * (dp[i] - pdp);
      dsum += dS * lg[i];
      Ps[r * PLD + lane + 32 * i] = __float2bfloat16_rn(e[i]);
      dSs[r * PLD + lane + 32 * i] = __float2bfloat16_rn(dS);
    }
  }
  dsum = warp_sum(dsum);
  if (lane == 0) red[warp] = dsum;
  __syncthreads();  // p, dS and the scale partials are complete; v is done with

  // the k̂ buffer comes back for dq̂, beside the two window-wide products
  for (int r = warp; r < kWinTokens; r += NW)
    load_row<DP>(KVs + r * LDQ, head + token(r) * feat + d, d, true, 1.0f, lane);
  // dv partial = pᵀ . do and dk̂ partial = dSᵀ . (q̂ s), both [256 x DP] fp32,
  // stored straight to this block's slot of the workspace
  const size_t slot = (((size_t)bz * nW + w) * C::NQB + qb) * kWinTokens * DP;
  for (int f = warp; f < (TILED ? 0 : 2 * (kWinTokens / 16) * CT); f += NW) {
    const int which = f / ((kWinTokens / 16) * CT), g = f % ((kWinTokens / 16) * CT);
    const int mt = g / CT, nt = g % CT;
    const bf16* At = which ? dSs : Ps;
    const bf16* Bt = which ? Qs : dOs;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < QB; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bb;
      wmma::load_matrix_sync(a, At + kk * PLD + mt * 16, PLD);
      wmma::load_matrix_sync(bb, Bt + kk * LDQ + nt * 16, LDQ);
      wmma::mma_sync(acc, a, bb, acc);
    }
    float* dst = (which ? part_k : part_v) + slot + (size_t)mt * 16 * DP + nt * 16;
    wmma::store_matrix_sync(dst, acc, DP, wmma::mem_row_major);
  }
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int i = 0; i < NW; ++i) tot += red[i];
    part_s[((size_t)bz * nW + w) * C::NQB + qb] = tot;
  }
  __syncthreads();  // k̂ is back; p is read for the last time

  // dq̂ [QB x DP] = dS . k̂, into the logit buffer (fp32, stride DP + 4)
  constexpr int LDO = DP + 4;
  for (int f = warp; f < (QB / 16) * CT; f += NW) {
    const int mt = f / CT, nt = f % CT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
    for (int kk = 0; kk < kWinTokens; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bb;
      wmma::load_matrix_sync(a, dSs + mt * 16 * PLD + kk, PLD);
      wmma::load_matrix_sync(bb, KVs + kk * LDQ + nt * 16, LDQ);
      wmma::mma_sync(acc, a, bb, acc);
    }
    wmma::store_matrix_sync(Ss + mt * 16 * LDO + nt * 16, acc, LDO, wmma::mem_row_major);
  }
  __syncthreads();

  // dq = (s dq̂ − q̂ (q̂ · s dq̂)) / |q| from the raw q row, 8 features a lane
  for (int r = warp; r < QB; r += NW) {
    const size_t tk = token(q0 + r);
    float q[8], g[8];
    const bool live = lane * 8 < d;
    float ss = 0.f;
    if (live) {
      const uint4 raw = *reinterpret_cast<const uint4*>(head + tk * feat + lane * 8);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f2 = __bfloat1622float2(h2[i]);
        q[2 * i] = f2.x;
        q[2 * i + 1] = f2.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += q[i] * q[i];
    const float rq = rsqrtf(warp_sum(ss) + 1e-12f);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      q[i] *= rq;                                             // q̂
      g[i] = live ? Ss[r * LDO + lane * 8 + i] * s : 0.f;     // dq̂ s
      dot += g[i] * q[i];
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int i = 0; i < 8; ++i) g[i] = (g[i] - q[i] * dot) * rq;
    if (live)
      *reinterpret_cast<uint4*>(dqkv + tk * feat + (size_t)h * 3 * d + lane * 8) = pack8(g);
  }
}

// kernel 6's query pass (shifted whole grid, dk̂/dv partials)
template <int DP>
__global__ void __launch_bounds__(kAttnNT)
    block_attn_bwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ scale,
                          const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                          float* __restrict__ part_k, float* __restrict__ part_v,
                          float* __restrict__ part_s, float* __restrict__ stats, int gh, int gw,
                          int heads, int d, int wh, int ww, int sh, int sw) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  attn_bwd_q<DP, false>(smem_raw, qkv, scale, dout, dqkv, part_k, part_v, part_s, stats, gh, gw,
                        heads, d, wh, ww, sh, sw);
}

// kernel 16's query pass (pre-rolled qkv, row statistics)
template <int DP>
__global__ void __launch_bounds__(kAttnNT)
    tiled_attn_bwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ scale,
                          const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                          float* __restrict__ part_k, float* __restrict__ part_v,
                          float* __restrict__ part_s, float* __restrict__ stats, int gh, int gw,
                          int heads, int d, int wh, int ww, int, int) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  attn_bwd_q<DP, true>(smem_raw, qkv, scale, dout, dqkv, part_k, part_v, part_s, stats, gh, gw,
                       heads, d, wh, ww, 0, 0);
}

// Per (sample, window, head): dk̂ and dv summed over the query-block partials
// in order, dk = (dk̂ − k̂ (k̂·dk̂)) / |k|, both written into dqkv.
template <int DP>
__global__ void __launch_bounds__(kAttnNT)
    block_attn_bwd_kv_kernel(const bf16* __restrict__ qkv, const float* __restrict__ part_k,
                             const float* __restrict__ part_v, bf16* __restrict__ dqkv, int gh,
                             int gw, int heads, int d, int wh, int ww, int sh, int sw) {
  constexpr int NQB = AttnBwd<DP>::NQB, NW = kAttnNT / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bz = blockIdx.y, b = bz / heads, h = bz % heads, w = blockIdx.x;
  const int wi = w / (gw / ww), wj = w % (gw / ww);
  const int i0 = wi * wh + sh, j0 = wj * ww + sw;
  const size_t feat = (size_t)heads * 3 * d;
  const size_t base = ((size_t)bz * gridDim.x + w) * NQB * kWinTokens * DP;
  const size_t pstride = (size_t)kWinTokens * DP;
  const bool live = lane * 8 < d;
  for (int t = warp; t < kWinTokens; t += NW) {
    const int row = (i0 + t / ww) % gh, col = (j0 + t % ww) % gw;
    const size_t tk = ((size_t)b * gh + row) * gw + col;
    bf16* dst = dqkv + tk * feat + (size_t)h * 3 * d;
    float k[8], dk[8], dv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = dk[i] = dv[i] = 0.f;
    if (live) {
      const uint4 raw = *reinterpret_cast<const uint4*>(qkv + tk * feat + (size_t)h * 3 * d + d +
                                                        lane * 8);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f2 = __bfloat1622float2(h2[i]);
        k[2 * i] = f2.x;
        k[2 * i + 1] = f2.y;
      }
      for (int p = 0; p < NQB; ++p) {
        const float* pk = part_k + base + p * pstride + (size_t)t * DP + lane * 8;
        const float* pv = part_v + base + p * pstride + (size_t)t * DP + lane * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dk[i] += pk[i];
          dv[i] += pv[i];
        }
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += k[i] * k[i];
    const float rk = rsqrtf(warp_sum(ss) + 1e-12f);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      k[i] *= rk;  // k̂
      dot += dk[i] * k[i];
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int i = 0; i < 8; ++i) dk[i] = (dk[i] - k[i] * dot) * rk;
    if (live) {
      *reinterpret_cast<uint4*>(dst + d + lane * 8) = pack8(dk);
      *reinterpret_cast<uint4*>(dst + 2 * d + lane * 8) = pack8(dv);
    }
  }
}

// dscale[h] = Σ over samples, windows and query blocks (in that order) of
// the Σ dS·logits partials, / scale[h].
__global__ void block_attn_dscale_kernel(const float* __restrict__ part_s,
                                         const float* __restrict__ scale, float* __restrict__ ds,
                                         int B, int heads, int per_head) {
  const int h = threadIdx.x;
  if (h >= heads) return;
  float tot = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = part_s + ((size_t)b * heads + h) * per_head;
    for (int i = 0; i < per_head; ++i) tot += p[i];
  }
  ds[h] = tot / scale[h];
}

template <int DP>
int launch_block_attn_bwd(const void* qkv, const void* scale, const void* dout, void* dqkv,
                          void* dscale, void* part_k, void* part_v, void* part_s, int B, int gh,
                          int gw, int heads, int d, int wh, int ww, int sh, int sw,
                          cudaStream_t st) {
  using C = AttnBwd<DP>;
  cudaFuncSetAttribute(block_attn_bwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM);
  const int nW = (gh / wh) * (gw / ww);
  dim3 grid(C::NQB, nW, B * heads);
  block_attn_bwd_kernel<DP><<<grid, kAttnNT, C::SMEM, st>>>(
      (const bf16*)qkv, (const float*)scale, (const bf16*)dout, (bf16*)dqkv, (float*)part_k,
      (float*)part_v, (float*)part_s, nullptr, gh, gw, heads, d, wh, ww, sh, sw);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  block_attn_bwd_kv_kernel<DP><<<dim3(nW, B * heads), kAttnNT, 0, st>>>(
      (const bf16*)qkv, (const float*)part_k, (const float*)part_v, (bf16*)dqkv, gh, gw, heads,
      d, wh, ww, sh, sw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  block_attn_dscale_kernel<<<1, 1024, 0, st>>>((const float*)part_s, (const float*)scale,
                                               (float*)dscale, B, heads, nW * C::NQB);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel 16's key pass -- with the query pass above, replaces
// swift_tpu/ops/pallas_block_attention.py::_tiled_bwd_call (kernel body
// _tiled_bwd_kernel).
//
// The TPU kernel holds a whole window's 256 x 256 fp32 logits (256 KB) in
// VMEM and writes dqkv straight out. A Hopper block may hold 227 KB, so no
// block holds the window, and kernel 6's way around that (each query block
// writes fp32 dk̂/dv partials for the whole window) costs 2 x 256 x d x 4
// bytes per window, head and query block: 17.4 GB a layer at 0.25 degrees,
// ten times the qkv it differentiates. Here, as in FlashAttention-2's
// backward, dk̂ and dv are summed by the block that owns the keys: one
// block per (sample, window, head, 64 key rows) walks the window's 256
// query rows 64 at a time, recomputes their logits against its keys and
// their dp = do·vᵀ, rebuilds p = exp(logit − m) / l and dS = p (dp − D)
// from the statistics the query pass kept (the same fp32 values that pass
// formed, so p and dS are bit for bit kernel 6's), and accumulates
// dv += pᵀ·do and dk̂ += dSᵀ·(q̂ s) in registers. Scratch is the 12-byte
// statistics of each query row (25 MB a layer at 0.25 degrees) and one
// scale partial per query block; every sum runs in a fixed order, so the
// result is the same bits run to run. The logits and dp are formed twice
// (7 window products against the TPU kernel's 5); the kernel is bound by
// on-chip capacity and latency long before the tensor cores.
constexpr int kKB = 64, kQC = 64;  // key rows a block owns, query rows a step

template <int DP>
struct TiledKV {
  static constexpr int LDQ = DP + 8;
  static constexpr int SLD = kKB + 4;  // fp32 stride of a step's logits and dp
  static constexpr int PLD = 2 * SLD;  // bf16 stride of p and dS written over them
  static constexpr int LDO = DP + 4;   // fp32 stride of the output rows
  static constexpr int SMEM = (2 * kKB + 2 * kQC) * LDQ * 2 + 2 * kQC * SLD * 4;
  static_assert(kKB * LDO <= 2 * kQC * SLD, "the output rows fit the two logit tiles");
};

template <int DP>
__global__ void __launch_bounds__(kAttnNT)
    tiled_attn_bwd_kv_kernel(const bf16* __restrict__ qkv, const float* __restrict__ scale,
                             const bf16* __restrict__ dout, const float* __restrict__ stats,
                             bf16* __restrict__ dqkv, int gh, int gw, int heads, int d, int wh,
                             int ww) {
  using C = TiledKV<DP>;
  constexpr int LDQ = C::LDQ, SLD = C::SLD, PLD = C::PLD, LDO = C::LDO, NW = kAttnNT / 32;
  constexpr int CT = DP / 16, NF = (kKB / 16) * CT, MAXF = (NF + NW - 1) / NW;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // k̂ of this block's keys
  bf16* Vs = Ks + kKB * LDQ;                     // v of this block's keys
  bf16* Qs = Vs + kKB * LDQ;                     // bf16(q̂ s) of the step's queries
  bf16* dOs = Qs + kQC * LDQ;                    // do of the step's queries
  float* Ss = reinterpret_cast<float*>(dOs + kQC * LDQ);  // logits -> p
  float* dPs = Ss + kQC * SLD;                            // dp -> dS
  bf16* Ps = reinterpret_cast<bf16*>(Ss);
  bf16* dSs = reinterpret_cast<bf16*>(dPs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bz = blockIdx.z, b = bz / heads, h = bz % heads, w = blockIdx.y;
  const int k0 = blockIdx.x * kKB;
  const size_t feat = (size_t)heads * 3 * d, ofeat = (size_t)heads * d;
  const WindowIndex<true> token(b, w, gh, gw, wh, ww, 0, 0);
  const bf16* head = qkv + (size_t)h * 3 * d;
  const float s = scale[h];
  const float* st = stats + ((size_t)bz * gridDim.y + w) * 3 * kWinTokens;

  for (int r = warp; r < kKB; r += NW) {
    const size_t tk = token(k0 + r) * feat;
    load_row<DP>(Ks + r * LDQ, head + tk + d, d, true, 1.0f, lane);
    load_row<DP>(Vs + r * LDQ, head + tk + 2 * d, d, false, 1.0f, lane);
  }

  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  Acc dv[MAXF], dk[MAXF];  // fragment f = warp + i*NW of the [kKB x DP] sums
#pragma unroll
  for (int i = 0; i < MAXF; ++i) {
    wmma::fill_fragment(dv[i], 0.0f);
    wmma::fill_fragment(dk[i], 0.0f);
  }
  // Cm[kQC x kKB] (fp32, stride SLD) = A[kQC x DP] . Bm[kKB x DP]^T
  auto step_x_keys = [&](const bf16* A, const bf16* Bm, float* Cm) {
    for (int f = warp; f < (kQC / 16) * (kKB / 16); f += NW) {
      const int rt = f / (kKB / 16), ct = f % (kKB / 16);
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(a, A + rt * 16 * LDQ + kk, LDQ);
        wmma::load_matrix_sync(kb, Bm + ct * 16 * LDQ + kk, LDQ);
        wmma::mma_sync(acc, a, kb, acc);
      }
      wmma::store_matrix_sync(Cm + rt * 16 * SLD + ct * 16, acc, SLD, wmma::mem_row_major);
    }
  };
  // acc += A^T[kKB x kQC] . Bm[kQC x DP], A given as kQC bf16 rows (stride PLD)
  auto keys_x_step = [&](Acc(&acc)[MAXF], const bf16* A, const bf16* Bm) {
#pragma unroll
    for (int i = 0; i < MAXF; ++i) {
      const int f = warp + i * NW;
      if (f >= NF) continue;
      const int mt = f / CT, nt = f % CT;
#pragma unroll
      for (int kk = 0; kk < kQC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bb;
        wmma::load_matrix_sync(a, A + kk * PLD + mt * 16, PLD);
        wmma::load_matrix_sync(bb, Bm + kk * LDQ + nt * 16, LDQ);
        wmma::mma_sync(acc[i], a, bb, acc[i]);
      }
    }
  };

  for (int c0 = 0; c0 < kWinTokens; c0 += kQC) {
    for (int r = warp; r < kQC; r += NW) {
      const size_t tq = token(c0 + r);
      load_row<DP>(Qs + r * LDQ, head + tq * feat, d, true, s, lane);
      load_row<DP>(dOs + r * LDQ, dout + tq * ofeat + (size_t)h * d, d, false, 1.0f, lane);
    }
    __syncthreads();
    step_x_keys(Qs, Ks, Ss);    // logits
    step_x_keys(dOs, Vs, dPs);  // dp = do . vᵀ
    __syncthreads();
    // one warp per query row: p and dS, rounded to bf16 in place over the
    // fronts of their fp32 rows
    for (int r = warp; r < kQC; r += NW) {
      const float m = st[c0 + r], l = st[kWinTokens + c0 + r], D = st[2 * kWinTokens + c0 + r];
      float p[kKB / 32], dS[kKB / 32];
#pragma unroll
      for (int i = 0; i < kKB / 32; ++i) {
        p[i] = expf(Ss[r * SLD + lane + 32 * i] - m) / l;
        dS[i] = p[i] * (dPs[r * SLD + lane + 32 * i] - D);
      }
      __syncwarp();  // every lane has read its row before any bf16 overwrites it
#pragma unroll
      for (int i = 0; i < kKB / 32; ++i) {
        Ps[r * PLD + lane + 32 * i] = __float2bfloat16_rn(p[i]);
        dSs[r * PLD + lane + 32 * i] = __float2bfloat16_rn(dS[i]);
      }
    }
    __syncthreads();
    keys_x_step(dv, Ps, dOs);  // dv += pᵀ . do
    keys_x_step(dk, dSs, Qs);  // dk̂ += dSᵀ . (q̂ s)
    __syncthreads();           // the next step overwrites the queries, p and dS
  }

  // dv, then dk̂, through the logit tiles as fp32 rows
  float* Os = Ss;
#pragma unroll
  for (int i = 0; i < MAXF; ++i) {
    const int f = warp + i * NW;
    if (f < NF)
      wmma::store_matrix_sync(Os + (f / CT) * 16 * LDO + (f % CT) * 16, dv[i], LDO,
                              wmma::mem_row_major);
  }
  __syncthreads();
  const bool live = lane * 8 < d;
  for (int r = warp; r < kKB; r += NW)
    if (live)
      *reinterpret_cast<uint4*>(dqkv + token(k0 + r) * feat + (size_t)h * 3 * d + 2 * d +
                                lane * 8) = pack8(Os + r * LDO + lane * 8);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MAXF; ++i) {
    const int f = warp + i * NW;
    if (f < NF)
      wmma::store_matrix_sync(Os + (f / CT) * 16 * LDO + (f % CT) * 16, dk[i], LDO,
                              wmma::mem_row_major);
  }
  __syncthreads();
  // dk = (dk̂ − k̂ (k̂·dk̂)) / |k| from the raw k row, 8 features a lane
  for (int r = warp; r < kKB; r += NW) {
    const size_t tk = token(k0 + r) * feat + (size_t)h * 3 * d + d;
    float k[8], g[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = g[i] = 0.f;
    if (live) {
      const uint4 raw = *reinterpret_cast<const uint4*>(qkv + tk + lane * 8);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f2 = __bfloat1622float2(h2[i]);
        k[2 * i] = f2.x;
        k[2 * i + 1] = f2.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) g[i] = Os[r * LDO + lane * 8 + i];
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += k[i] * k[i];
    const float rk = rsqrtf(warp_sum(ss) + 1e-12f);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      k[i] *= rk;  // k̂
      dot += g[i] * k[i];
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int i = 0; i < 8; ++i) g[i] = (g[i] - k[i] * dot) * rk;
    if (live) *reinterpret_cast<uint4*>(dqkv + tk + lane * 8) = pack8(g);
  }
}

template <int DP>
int launch_tiled_attn_bwd(const void* qkv, const void* scale, const void* dout, void* dqkv,
                          void* dscale, void* stats, void* part_s, int B, int gh, int gw,
                          int heads, int d, int wh, int ww, cudaStream_t st) {
  using C = AttnBwd<DP>;
  const int nW = (gh / wh) * (gw / ww);
  cudaFuncSetAttribute(tiled_attn_bwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM);
  tiled_attn_bwd_kernel<DP><<<dim3(C::NQB, nW, B * heads), kAttnNT, C::SMEM, st>>>(
      (const bf16*)qkv, (const float*)scale, (const bf16*)dout, (bf16*)dqkv, nullptr, nullptr,
      (float*)part_s, (float*)stats, gh, gw, heads, d, wh, ww, 0, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaFuncSetAttribute(tiled_attn_bwd_kv_kernel<DP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, TiledKV<DP>::SMEM);
  tiled_attn_bwd_kv_kernel<DP><<<dim3(kWinTokens / kKB, nW, B * heads), kAttnNT,
                                 TiledKV<DP>::SMEM, st>>>(
      (const bf16*)qkv, (const float*)scale, (const bf16*)dout, (const float*)stats,
      (bf16*)dqkv, gh, gw, heads, d, wh, ww);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  block_attn_dscale_kernel<<<1, 1024, 0, st>>>((const float*)part_s, (const float*)scale,
                                               (float*)dscale, B, heads, nW * C::NQB);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tangent, kernels 7 and 17 (swift_block_attention_tangent,
// swift_tiled_attention_tangent) -- replaces swift_tpu/ops/
// pallas_block_attention.py::_tangent_call and _tiled_tangent_call (kernel
// body _tangent_kernel): the forward-mode tangent of the attention along
// dqkv, the logit scale fixed (the sCM jvp forward). Per (sample, window,
// head): q̂ = q/|q| and dq̂ = (dq − q̂ (q̂·dq))/|q|, k̂ and dk̂ likewise (fp32,
// eps 1e-12), S = (q̂s)·k̂ᵀ, dS = (dq̂s)·k̂ᵀ + (q̂s)·dk̂ᵀ, p = softmax(S),
// dp = p (dS − Σ p·dS) and dout = dp·v + p·dv, with q̂s, dq̂s, k̂, dk̂, p and
// dp rounded to bf16 before the products that consume them (the TPU
// kernel's rounding points) and every sum in fp32. Kernel 17 is the same
// body on qkv and dqkv rolled by the shift (TILED, the wrap compiled out of
// WindowIndex), in the same key order, so on rolled inputs it equals
// kernel 7 bit for bit.
//
// What bounds it: the bytes, as for the forward -- five window products of
// 256 x 256 x d on 6 x 256 x d bf16 read and 256 x d written, about 180
// flops a byte at d = 88, under the ~295 where the tensor cores would set
// the pace. Two budgets shape the design. Registers: a 64-row query block
// against all 256 keys is an fp32 accumulator of 128 registers a thread;
// S and dS together (256) pass the 255 a thread may have, and a block of
// 384 threads caps a thread at 168. Shared memory: k̂, dk̂, v and dv of 256
// keys in the forward's layout are 4 x 64 KB at DP = 128, over the 227 KB
// a block may have.
//
// So a window-head is split over a cluster of two blocks: block r owns keys
// [128 r, 128 r + 128) and keeps its halves of k̂, dk̂, v and dv resident
// (4 x 32 KB at DP = 128); both blocks take all 256 query rows (the second
// read of q and dq comes from L2). For a 64-row query block a consumer
// holds S and dS over the block's keys as two m64n128 accumulators (64 + 64
// registers), so p stays fp32 until it is rounded for its product. The
// softmax statistics cross the cluster once, through distributed shared
// memory: each block forms, per row and over its keys, the max m_r,
// e = exp(S − m_r), l_r = Σ e and a_r = Σ e·dS, and sends (m_r, l_r, a_r)
// to the peer. Then, with m = max(m_0, m_1) and c_r = exp(m_r − m), in rank
// order so that both blocks hold the same bits: l = l_0 c_0 + l_1 c_1,
// p = e c_r / l and Σ p·dS = (a_0 c_0 + a_1 c_1) / l, all fp32 (the TPU's
// p = exp(S − m) / l and Σ p·dS up to fp32 rounding). p and dp become bf16
// A fragments in registers, and the block's partial of dout over its keys
// is 2 x 8 wgmma_m64nNk16_rs: dp·v, then p·dv, v and dv read MN-major as
// the forward reads v. The partials are added across the cluster: block r
// finishes columns [r DP/2, r DP/2 + DP/2), receives the peer's partial of
// them in fp32 (into the query block's q̂s stage, whose products have
// retired), and stores o_own + o_peer -- one fp32 addition, the same bits
// whichever block makes it. No float atomics: two calls give the same bits.
//
// Warp specialisation, 384 threads a block, persistent clusters walking
// window-heads with heads fastest (as the forward):
//   warpgroup 0, the producer, gathers rows through WindowIndex with
//     cp.async into the forward's swizzled 64-column boxes, its warps on
//     their own: warp c loads q and dq of consumer c's query blocks into
//     its stage, each once the previous block has left it; warps 2 and 3
//     load k and dk once the previous window-head's last S and dS have
//     retired, form k̂ and dk̂ in place in fp32 (the tangent of the normalise
//     needs the k row and the dk row together; eight threads a row), then
//     load v and dv once the last products with them have retired.
//   warpgroups 1 and 2, the consumers: consumer c takes query blocks c and
//     c + 2. For each it forms q̂s and dq̂s in place, S and dS by 3 DP/16
//     m64n128k16 wgmmas, the statistics and their exchange, p and dp, its
//     partial output, the output exchange, and stores its columns as the
//     forward stores (bf16 staging rows, one bulk copy a row).
// mbarriers: full and empty ones for k̂/dk̂, v/dv and the two stages (the
// producer's 128 threads arrive on a full one once their copies have
// landed; each consumer warp on an empty one once it is done with the
// buffer), and one each of cluster scope for the statistics and the
// output partial of each consumer (each of the peer's 128 threads arrives
// with release semantics after its own stores into this block, which
// needs no fence: 2% faster than a fence.acq_rel.cluster a writer and one
// arrival a warp). Each exchange
// buffer is written again only after the peer has passed the next
// exchange, so after it has read the buffer. Shared memory at DP = 128:
// the keys 128 KB, the stages 64 KB, the staging rows 18 KB, the row
// tables, the exchange slots and barriers: 215 KB. A stage stays the
// consumer's until the peer's partial has been read from it; handing it
// back once S and dS have retired (the partial elsewhere, which does not
// fit at DP = 128) gained 4% (scripts/probe_attention_tangent.py).
// Registers (setmaxnreg): 80 a producer thread, 208 a consumer thread
// (the 64,512 of a block launched at 168 a thread: a producer at 96 would
// leave the consumers' increase waiting forever); ptxas holds the whole
// kernel to the launch bound's 168 (28 bytes spilled at DP = 96 and 128).
constexpr int kTanKeys = kWinTokens / 2;  // the keys a block of the cluster owns

template <int DP>
struct AttnTan {
  static constexpr int NBOX = AttnFwd<DP>::NBOX;     // the forward's boxes and chunks
  static constexpr int SLOTS = AttnFwd<DP>::SLOTS;
  static constexpr int Q_BOX = AttnFwd<DP>::Q_BOX;   // one box of 64 query rows
  static constexpr int KEY_BOX = kTanKeys * 128;     // one box of the block's key rows
  static constexpr int KEYS = NBOX * KEY_BOX;        // one of k̂, dk̂, v and dv
  static constexpr int STAGE = 2 * NBOX * Q_BOX;     // a consumer's q̂s, then dq̂s
  static constexpr int HALF = DP / 2;                // the output columns a block finishes
  static constexpr int LDO = HALF + 8;               // bf16 stride of the staging rows
  static constexpr int Q_OFF = 4 * KEYS;             // k̂, dk̂, v, dv at 0, 1, 2, 3 KEYS
  static constexpr int O_OFF = Q_OFF + 2 * STAGE;    // two consumers' staging rows
  static constexpr int X_OFF = O_OFF + 2 * kQB * LDO * 2;  // statistics slots [c][m, l, a][32]
  static constexpr int ROW_OFF = X_OFF + 2 * 3 * 32 * 8;  // the producer's row offsets:
  static constexpr int BAR_OFF = ROW_OFF + (2 * kQB + kTanKeys) * 8;  // two q blocks, the keys
  enum {
    KD_FULL, KD_EMPTY, VD_FULL, VD_EMPTY, Q_FULL, Q_EMPTY = Q_FULL + 2, STAT = Q_EMPTY + 2,
    OUT = STAT + 2, N_BARS = OUT + 2
  };
  static constexpr int SMEM = 1024 + BAR_OFF + N_BARS * 8;  // with the alignment pad
  static_assert(SMEM <= kMaxSmem, "the tangent's buffers do not fit");
  // the peer's partial: DP / 8 float pairs for each of 128 threads
  static_assert(128 * DP <= STAGE, "the peer's partial output does not fit a stage");
};

// a and its tangent da, ROWS rows of two swizzled tiles, in place:
// â = a / |a| and dâ = (da − â (â·da)) / |a|, both times ``mul``, in fp32,
// rounded to bf16 (the chunks past d written as zeros); eight of THREADS
// threads a row (tid < THREADS), chunks sub and sub + 8.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void tan_normalise(unsigned char* a, unsigned char* da, int box_bytes,
                                              int chunks, float mul, int tid) {
  constexpr int NBOX = AttnTan<DP>::NBOX, SLOTS = AttnTan<DP>::SLOTS;
  const int sub = tid % 8;
  for (int r = tid / 8; r < ROWS; r += THREADS / 8) {
    const int at = r * 128 + ((sub ^ (r % 8)) << 4);
    float x[NBOX][8], dx[NBOX][8];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NBOX; ++j) {
      uint4 ra = make_uint4(0u, 0u, 0u, 0u), rd = ra;
      if (sub + 8 * j < chunks) {
        ra = *reinterpret_cast<const uint4*>(a + j * box_bytes + at);
        rd = *reinterpret_cast<const uint4*>(da + j * box_bytes + at);
      }
      const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&ra);
      const __nv_bfloat162* hd = reinterpret_cast<const __nv_bfloat162*>(&rd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fa = __bfloat1622float2(ha[i]), fd = __bfloat1622float2(hd[i]);
        x[j][2 * i] = fa.x;
        x[j][2 * i + 1] = fa.y;
        dx[j][2 * i] = fd.x;
        dx[j][2 * i + 1] = fd.y;
        ss += fa.x * fa.x + fa.y * fa.y;
      }
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    ss += __shfl_xor_sync(0xffffffffu, ss, 4);
    const float inv = rsqrtf(ss + 1e-12f);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < NBOX; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[j][i] *= inv;  // â
        dot += x[j][i] * dx[j][i];
      }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    dot += __shfl_xor_sync(0xffffffffu, dot, 4);
#pragma unroll
    for (int j = 0; j < NBOX; ++j) {
      if (sub + 8 * j >= SLOTS) continue;
      float v[8], dv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = x[j][i] * mul;
        dv[i] = (dx[j][i] - x[j][i] * dot) * inv * mul;
      }
      *reinterpret_cast<uint4*>(a + j * box_bytes + at) = pack8(v);
      *reinterpret_cast<uint4*>(da + j * box_bytes + at) = pack8(dv);
    }
  }
}

// Block RANK's end of consumer c's query block qb: the peer's columns of
// the partial output ``o`` into the peer's slots at ``xo`` (the query
// block's stage there, [pair][thread]), the peer's partial of this block's
// columns added in, the stage released to the producer, and this block's
// columns rounded to bf16 into the staging rows and copied to the token
// each query came from, one bulk copy a row by thread ``row`` (tid < 64).
template <int DP, int RANK, bool TILED>
__device__ __forceinline__ void tan_finish(float (&o)[DP / 2], float2* xo, bf16* rows,
                                           uint64_t* bar, bf16* out,
                                           const WindowIndex<TILED>& token, int qb, size_t ofeat,
                                           int col, int ncols, int c, int j, int tid) {
  using L = AttnTan<DP>;
  constexpr int NJ = DP / 16;  // the 8-column groups a block finishes
  constexpr int OWN = RANK * NJ, PEER = (1 - RANK) * NJ;
  const int lane = tid % 32, r = tid / 32 * 16 + lane / 4;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      st_cluster_f32x2(&xo[(2 * jj + hh) * 128 + tid], 1 - RANK, o[4 * (PEER + jj) + 2 * hh],
                       o[4 * (PEER + jj) + 2 * hh + 1]);
  mbar_arrive_cluster_release(&bar[L::OUT + c], 1 - RANK);
  mbar_wait_cluster(&bar[L::OUT + c], j);
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 x = xo[(2 * jj + hh) * 128 + tid];
      o[4 * (OWN + jj) + 2 * hh] += x.x;
      o[4 * (OWN + jj) + 2 * hh + 1] += x.y;
    }
  __syncwarp();
  if (lane == 0) mbar_arrive(&bar[L::Q_EMPTY + c]);  // the stage may take the next query block
  if (tid < kQB) tma_store_wait_read<0>();  // the previous block's copies have read the rows
  named_barrier_sync(1 + c, 128);
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(rows + (r + 8 * hh) * L::LDO + 8 * jj + 2 * (lane % 4)) =
          pack_bf16x2(o[4 * (OWN + jj) + 2 * hh], o[4 * (OWN + jj) + 2 * hh + 1]);
  fence_async_smem();
  named_barrier_sync(1 + c, 128);
  if (tid < kQB && ncols > 0) {
    bulk_store(out + token(qb * kQB + tid) * ofeat + col, rows + tid * L::LDO, ncols * 2);
    tma_store_commit();
  }
}

template <int DP, bool TILED>
__global__ void __launch_bounds__(kFwdThreads, 1)
    attn_tangent_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dqkv,
                        const float* __restrict__ scale, bf16* __restrict__ out, int B, int gh,
                        int gw, int heads, int d, int wh, int ww, int sh, int sw) {
  using L = AttnTan<DP>;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Ks = smem;  // k̂, dk̂, v and dv of the block's keys
  unsigned char* dKs = smem + L::KEYS;
  unsigned char* Vs = smem + 2 * L::KEYS;
  unsigned char* dVs = smem + 3 * L::KEYS;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  const int rank = (int)cluster_rank(), peer = rank ^ 1;
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;
  const int nW = (gh / wh) * (gw / ww), items = B * nW * heads, chunks = d / 8;
  const size_t feat = (size_t)heads * 3 * d;
  if (threadIdx.x == 0) {
    const int counts[L::N_BARS] = {64, 8, 64, 8, 32, 32, 4, 4, 128, 128, 128, 128};
    for (int i = 0; i < L::N_BARS; ++i) mbar_init(&bar[i], counts[i]);
    mbar_fence_init();
  }
  cluster_sync();  // the peer's barriers exist before any arrival on them

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<80>();
    const int pw = threadIdx.x / 32;
    size_t* row_off = reinterpret_cast<size_t*>(smem + L::ROW_OFF);  // [q warp][64], [keys]
    uint32_t it = 0;
    for (int item = cluster; item < items; item += clusters, ++it) {
      const int h = item % heads, w = item / heads % nW, b = item / heads / nW;
      const WindowIndex<TILED> token(b, w, gh, gw, wh, ww, sh, sw);
      const int head = h * 3 * d;
      if (pw < 2) {  // warp c: q and dq of consumer c's query blocks c and c + 2
        const int lane = threadIdx.x % 32;
        size_t* rows = row_off + pw * kQB;
        unsigned char* stage = smem + L::Q_OFF + pw * L::STAGE;
        for (int j = 0; j < 2; ++j) {
          const int q0 = (2 * j + pw) * kQB;
          __syncwarp();  // every lane has issued the previous block's copies
          for (int t = lane; t < kQB; t += 32) rows[t] = token(q0 + t) * feat;
          __syncwarp();
          mbar_wait(&bar[L::Q_EMPTY + pw], j ^ 1);
          fwd_load<DP, 32>(stage, L::Q_BOX, kQB, qkv, rows, 0, head, chunks, lane);
          fwd_load<DP, 32>(stage + L::NBOX * L::Q_BOX, L::Q_BOX, kQB, dqkv, rows, 0, head, chunks,
                           lane);
          cp_async_commit();
          cp_async_wait<0>();
          mbar_arrive(&bar[L::Q_FULL + pw]);  // raw: the consumer normalises its own
        }
      } else {  // warps 2 and 3: k, dk, v and dv of the block's keys
        const int tid = threadIdx.x - 64;
        size_t* rows = row_off + 2 * kQB;
        named_barrier_sync(3, 64);  // both warps have issued the previous window-head's copies
        for (int t = tid; t < kTanKeys; t += 64) rows[t] = token(rank * kTanKeys + t) * feat;
        named_barrier_sync(3, 64);
        // k and dk, normalised together once the previous window-head's last S
        // and dS have retired
        mbar_wait(&bar[L::KD_EMPTY], (it & 1) ^ 1);
        fwd_load<DP, 64>(Ks, L::KEY_BOX, kTanKeys, qkv, rows, 0, head + d, chunks, tid);
        fwd_load<DP, 64>(dKs, L::KEY_BOX, kTanKeys, dqkv, rows, 0, head + d, chunks, tid);
        cp_async_commit();
        cp_async_wait<0>();
        named_barrier_sync(3, 64);
        tan_normalise<DP, kTanKeys, 64>(Ks, dKs, L::KEY_BOX, chunks, 1.0f, tid);
        fence_async_smem();
        mbar_arrive(&bar[L::KD_FULL]);
        // v and dv, once the previous window-head's last products with them have retired
        mbar_wait(&bar[L::VD_EMPTY], (it & 1) ^ 1);
        fwd_load<DP, 64>(Vs, L::KEY_BOX, kTanKeys, qkv, rows, 0, head + 2 * d, chunks, tid);
        fwd_load<DP, 64>(dVs, L::KEY_BOX, kTanKeys, dqkv, rows, 0, head + 2 * d, chunks, tid);
        cp_async_commit();
        cp_async_wait<0>();
        fence_async_smem();
        mbar_arrive(&bar[L::VD_FULL]);
      }
    }
  } else {  // the consumers
    setmaxnreg_inc<208>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid % 32;
    unsigned char* Qc = smem + L::Q_OFF + c * L::STAGE;  // q̂s, then dq̂s
    unsigned char* dQc = Qc + L::NBOX * L::Q_BOX;
    float2* xo = reinterpret_cast<float2*>(Qc);  // the peer's partial, once S and dS are done
    float2* xs = reinterpret_cast<float2*>(smem + L::X_OFF) + c * 3 * 32;  // the peer's m, l, a
    bf16* rows = reinterpret_cast<bf16*>(smem + L::O_OFF) + c * kQB * L::LDO;
    const size_t ofeat = (size_t)heads * d;
    const int col = rank * L::HALF;
    const int ncols = d - col < 0 ? 0 : (d - col < L::HALF ? d - col : L::HALF);
    const int slot = tid / 32 * 8 + lane / 4, q4 = lane % 4;  // the thread's rows: 2 slot, + 8
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar[i]);
    };
    uint32_t it = 0;
    for (int item = cluster; item < items; item += clusters, ++it) {
      const int h = item % heads, w = item / heads % nW, b = item / heads / nW;
      const WindowIndex<TILED> token(b, w, gh, gw, wh, ww, sh, sw);
      const float scale_h = scale[h];
#pragma unroll 1
      for (int j = 0; j < 2; ++j) {
        mbar_wait(&bar[L::Q_FULL + c], j);
        tan_normalise<DP, kQB, 128>(Qc, dQc, L::Q_BOX, chunks, scale_h, tid);
        fence_async_smem();
        named_barrier_sync(1 + c, 128);
        // S = q̂s·k̂ᵀ and dS = dq̂s·k̂ᵀ + q̂s·dk̂ᵀ over the block's keys
        float s[64], ds[64];
        mbar_wait(&bar[L::KD_FULL], it & 1);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < DP / 16; ++k)
          wgmma_m64nNk16<128>(s, wgmma_desc(Qc + (k / 4) * L::Q_BOX) + 2 * (k % 4),
                              wgmma_desc(Ks + (k / 4) * L::KEY_BOX) + 2 * (k % 4), k > 0);
#pragma unroll
        for (int k = 0; k < DP / 16; ++k)
          wgmma_m64nNk16<128>(ds, wgmma_desc(dQc + (k / 4) * L::Q_BOX) + 2 * (k % 4),
                              wgmma_desc(Ks + (k / 4) * L::KEY_BOX) + 2 * (k % 4), k > 0);
#pragma unroll
        for (int k = 0; k < DP / 16; ++k)
          wgmma_m64nNk16<128>(ds, wgmma_desc(Qc + (k / 4) * L::Q_BOX) + 2 * (k % 4),
                              wgmma_desc(dKs + (k / 4) * L::KEY_BOX) + 2 * (k % 4), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(ds);
        if (j == 1) release(L::KD_EMPTY);

        // the rows' max, Σ e and Σ e·dS over the block's keys (row hh of the
        // thread's two in s[4 j + 2 hh + e]), to the peer
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 64; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
          m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int hh = (i >> 1) & 1;
          s[i] = exp2f((s[i] - m[hh]) * kLog2e);
          l[hh] += s[i];
          a[hh] += s[i] * ds[i];
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int x = 1; x < 4; x <<= 1) {
            l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], x);
            a[hh] += __shfl_xor_sync(0xffffffffu, a[hh], x);
          }
        if (q4 < 3) {  // lanes 0, 1, 2 of a quad send m, l, a of its two rows
          st_cluster_f32x2(&xs[q4 * 32 + slot], peer, q4 == 0 ? m[0] : q4 == 1 ? l[0] : a[0],
                           q4 == 0 ? m[1] : q4 == 1 ? l[1] : a[1]);
        }
        mbar_arrive_cluster_release(&bar[L::STAT + c], peer);
        mbar_wait_cluster(&bar[L::STAT + c], j);
        const float2 pm = xs[slot], pl = xs[32 + slot], pa = xs[64 + slot];
        float f[2], pds[2];  // p = e f, and Σ p·dS
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float mp = hh ? pm.y : pm.x, lp = hh ? pl.y : pl.x, ap = hh ? pa.y : pa.x;
          // rank order: the same statistics in both blocks
          const float m0 = rank ? mp : m[hh], m1 = rank ? m[hh] : mp;
          const float l0 = rank ? lp : l[hh], l1 = rank ? l[hh] : lp;
          const float a0 = rank ? ap : a[hh], a1 = rank ? a[hh] : ap;
          const float mx = fmaxf(m0, m1);
          const float c0 = exp2f((m0 - mx) * kLog2e), c1 = exp2f((m1 - mx) * kLog2e);
          const float inv_l = 1.0f / (l0 * c0 + l1 * c1);
          pds[hh] = (a0 * c0 + a1 * c1) * inv_l;
          f[hh] = (rank ? c1 : c0) * inv_l;
        }
        // p and dp rounded to bf16 as the A fragments of the 8 k16 slices
        uint32_t p[8][4], dp[8][4];
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 8 * k + 2 * q, hh = q & 1;
            const float p0 = s[i] * f[hh], p1 = s[i + 1] * f[hh];
            p[k][q] = pack_bf16x2(p0, p1);
            dp[k][q] = pack_bf16x2(p0 * (ds[i] - pds[hh]), p1 * (ds[i + 1] - pds[hh]));
          }
        // the block's partial of dout = dp·v + p·dv
        float o[DP / 2];
        mbar_wait(&bar[L::VD_FULL], it & 1);
        wgmma_fence();
        const uint64_t vd = wgmma_desc_mn(Vs, L::KEY_BOX), dvd = wgmma_desc_mn(dVs, L::KEY_BOX);
#pragma unroll
        for (int k = 0; k < 8; ++k) wgmma_m64nNk16_rs<DP>(o, dp[k], vd + 128 * k, k > 0);
#pragma unroll
        for (int k = 0; k < 8; ++k) wgmma_m64nNk16_rs<DP>(o, p[k], dvd + 128 * k, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        if (j == 1) release(L::VD_EMPTY);
        if (rank == 0)
          tan_finish<DP, 0, TILED>(o, xo, rows, bar, out, token, 2 * j + c, ofeat, h * d + col,
                                   ncols, c, j, tid);
        else
          tan_finish<DP, 1, TILED>(o, xo, rows, bar, out, token, 2 * j + c, ofeat, h * d + col,
                                   ncols, c, j, tid);
      }
    }
    if (tid < kQB) tma_store_wait_all();  // the rows stay until the last copies have read them
  }
  __syncwarp();
  cluster_sync();  // no block leaves while its peer may still write into it
}

// Kernels 7 (shifted, wrapping) and 17 (TILED, on pre-rolled qkv and dqkv):
// one launch in clusters of two, as many clusters as the card holds at once
// (at most one a window-head), through launch_clusters, which sets the
// shared-memory attribute and asks the occupancy once a device and
// instantiation.
static int attn_tangent_resident[8][64];

template <int DP, bool TILED>
int launch_attn_tangent(const void* qkv, const void* dqkv, const void* scale, void* dout, int B,
                        int gh, int gw, int heads, int d, int wh, int ww, int sh, int sw,
                        cudaStream_t stream) {
  const int items = B * heads * (gh / wh) * (gw / ww);
  return launch_clusters(attn_tangent_kernel<DP, TILED>,
                         attn_tangent_resident[(DP / 32 - 1) * 2 + TILED], AttnTan<DP>::SMEM,
                         items, 2, stream, (const bf16*)qkv, (const bf16*)dqkv,
                         (const float*)scale, (bf16*)dout, B, gh, gw, heads, d, wh, ww, sh, sw);
}

}  // namespace swift

// Requires wh*ww == 256, gh % wh == gw % ww == 0, d % 8 == 0, d <= 128 and
// 0 <= sh < gh, 0 <= sw < gw (the wrapper checks). Returns a cudaError_t.
extern "C" int swift_block_attention(const void* qkv, const void* scale, void* out, int B,
                                     int gh, int gw, int heads, int d, int wh, int ww, int sh,
                                     int sw, void* stream) {
  const int dp = (d + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
#define SWIFT_FWD(DP)                                                                          \
  return swift::launch_attn_fwd<DP, false>(qkv, scale, out, B, gh, gw, heads, d, wh, ww,  \
                                            sh, sw, st)
  switch (dp) {
    case 32: SWIFT_FWD(32);
    case 64: SWIFT_FWD(64);
    case 96: SWIFT_FWD(96);
    case 128: SWIFT_FWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SWIFT_FWD
}

// Kernel 15: swift_block_attention on qkv already rolled by the window
// shift, so that no window wraps (the grids of any size that tile by the
// window). Same shape rules otherwise.
extern "C" int swift_tiled_attention(const void* qkv, const void* scale, void* out, int B, int gh,
                                     int gw, int heads, int d, int wh, int ww, void* stream) {
  const int dp = (d + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
#define SWIFT_FWD(DP)                                                                          \
  return swift::launch_attn_fwd<DP, true>(qkv, scale, out, B, gh, gw, heads, d, wh, ww, 0, \
                                           0, st)
  switch (dp) {
    case 32: SWIFT_FWD(32);
    case 64: SWIFT_FWD(64);
    case 96: SWIFT_FWD(96);
    case 128: SWIFT_FWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SWIFT_FWD
}

// Query rows a backward block holds (the number of scale partials per
// window and head is 256 / this).
extern "C" int swift_block_attention_bwd_qb(int d) { return (d + 31) / 32 * 32 <= 96 ? 64 : 32; }

// qkv (B, gh, gw, heads*3d), dout (B, gh, gw, heads*d) bf16, scale (heads,)
// fp32 -> dqkv like qkv, dscale (heads,) fp32. Workspace: part_k and part_v
// fp32 of B*heads*nW*256*dp elements each (dp = d rounded up to 32), part_s
// fp32 of B*heads*nW*(256/qb). Same shape rules as swift_block_attention.
extern "C" int swift_block_attention_bwd(const void* qkv, const void* scale, const void* dout,
                                         void* dqkv, void* dscale, void* part_k, void* part_v,
                                         void* part_s, int B, int gh, int gw, int heads, int d,
                                         int wh, int ww, int sh, int sw, void* stream) {
  const int dp = (d + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
#define SWIFT_BWD(DP)                                                                          \
  return swift::launch_block_attn_bwd<DP>(qkv, scale, dout, dqkv, dscale, part_k, part_v,     \
                                          part_s, B, gh, gw, heads, d, wh, ww, sh, sw, st)
  switch (dp) {
    case 32: SWIFT_BWD(32);
    case 64: SWIFT_BWD(64);
    case 96: SWIFT_BWD(96);
    case 128: SWIFT_BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SWIFT_BWD
}

// qkv, dqkv (B, gh, gw, heads*3d) bf16, scale (heads,) fp32 -> dout (B, gh,
// gw, heads*d) bf16, the tangent of swift_block_attention along dqkv. Same
// shape rules as swift_block_attention.
extern "C" int swift_block_attention_tangent(const void* qkv, const void* dqkv,
                                             const void* scale, void* dout, int B, int gh,
                                             int gw, int heads, int d, int wh, int ww, int sh,
                                             int sw, void* stream) {
  const int dp = (d + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
#define SWIFT_TAN(DP)                                                                          \
  return swift::launch_attn_tangent<DP, false>(qkv, dqkv, scale, dout, B, gh, gw, heads, d, wh, \
                                               ww, sh, sw, st)
  switch (dp) {
    case 32: SWIFT_TAN(32);
    case 64: SWIFT_TAN(64);
    case 96: SWIFT_TAN(96);
    case 128: SWIFT_TAN(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SWIFT_TAN
}

// Kernel 16: (dqkv, dscale) of swift_tiled_attention. Scratch: stats fp32 of
// B*heads*nW*3*256 elements (each query row's max, sum and Σ p·dp), part_s
// fp32 of B*heads*nW*(256/qb). Same shape rules as swift_tiled_attention.
extern "C" int swift_tiled_attention_bwd(const void* qkv, const void* scale, const void* dout,
                                         void* dqkv, void* dscale, void* stats, void* part_s,
                                         int B, int gh, int gw, int heads, int d, int wh, int ww,
                                         void* stream) {
  const int dp = (d + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
#define SWIFT_BWD(DP)                                                                          \
  return swift::launch_tiled_attn_bwd<DP>(qkv, scale, dout, dqkv, dscale, stats, part_s, B, gh, \
                                          gw, heads, d, wh, ww, st)
  switch (dp) {
    case 32: SWIFT_BWD(32);
    case 64: SWIFT_BWD(64);
    case 96: SWIFT_BWD(96);
    case 128: SWIFT_BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SWIFT_BWD
}

// Kernel 17: the tangent of swift_tiled_attention along dqkv (bf16, like
// qkv). Same shape rules as swift_tiled_attention.
extern "C" int swift_tiled_attention_tangent(const void* qkv, const void* dqkv, const void* scale,
                                             void* dout, int B, int gh, int gw, int heads, int d,
                                             int wh, int ww, void* stream) {
  const int dp = (d + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
#define SWIFT_TAN(DP)                                                                          \
  return swift::launch_attn_tangent<DP, true>(qkv, dqkv, scale, dout, B, gh, gw, heads, d, wh, \
                                              ww, 0, 0, st)
  switch (dp) {
    case 32: SWIFT_TAN(32);
    case 64: SWIFT_TAN(64);
    case 96: SWIFT_TAN(96);
    case 128: SWIFT_TAN(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SWIFT_TAN
}
