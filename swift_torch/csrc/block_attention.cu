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
// kernel 15 on rolled qkv equals kernel 2 bit for bit, 16 equals 6 and 17
// equals 7. The backward (6, 16) is a query pass and a key pass (see
// below).
#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace swift {

constexpr int kWinTokens = 256, kQB = 64;

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
// zero-filled. Row r starts at row_off[row0 + r] * stride elements.
template <int DP, int THREADS = 128>
__device__ __forceinline__ void fwd_load(unsigned char* tile, int box_bytes, int rows,
                                         const bf16* qkv, const size_t* row_off, int row0,
                                         int col, int chunks, int tid, size_t stride = 1) {
  constexpr int SLOTS = AttnFwd<DP>::SLOTS;
  for (int i = tid; i < rows * SLOTS; i += THREADS) {
    const int r = i / SLOTS, c = i % SLOTS;
    const bool live = c < chunks;
    cp_async16(tile + (c / 8) * box_bytes + r * 128 + (((c % 8) ^ (r % 8)) << 4),
               live ? qkv + row_off[row0 + r] * stride + col + c * 8 : qkv, live);
  }
}

// L2-normalise ``rows`` rows of a swizzled tile in place in fp32, multiply
// by ``mul`` where SCALED (q by the logit scale) and round to bf16 (the
// chunks past d written as zeros): eight of THREADS threads a row (tid <
// THREADS), chunks sub and sub + 8. Row r's 1/|row| goes to inv[r] where
// ``inv`` is given.
template <int DP, bool SCALED, int THREADS = 128>
__device__ __forceinline__ void fwd_normalise(unsigned char* tile, int box_bytes, int rows,
                                              int chunks, float mul, int tid,
                                              float* inv_out = nullptr) {
  constexpr int NBOX = AttnFwd<DP>::NBOX, SLOTS = AttnFwd<DP>::SLOTS;
  const int sub = tid % 8;
  for (int r = tid / 8; r < rows; r += THREADS / 8) {
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
    if (inv_out != nullptr && sub == 0) inv_out[r] = inv;
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
// launch, as many blocks as SMs (at most one a window-head).
static int attn_fwd_sms[8][64];

template <int DP, bool TILED>
int launch_attn_fwd(const void* qkv, const void* scale, void* out, int B, int gh, int gw,
                    int heads, int d, int wh, int ww, int sh, int sw, cudaStream_t stream) {
  const int items = B * heads * (gh / wh) * (gw / ww);
  return launch_persistent(attn_fwd_kernel<DP, TILED>, attn_fwd_sms[(DP / 32 - 1) * 2 + TILED],
                           kFwdThreads, AttnFwd<DP>::SMEM, items, stream, (const bf16*)qkv,
                           (const float*)scale, (bf16*)out, B, gh, gw, heads, d, wh, ww, sh, sw);
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

// ---------------------------------------------------------------------------
// Backward, kernels 6 and 16 (swift_block_attention_bwd,
// swift_tiled_attention_bwd) -- replaces swift_tpu/ops/
// pallas_block_attention.py::_bwd_call and _tiled_bwd_call (kernel bodies
// _bwd_kernel and _tiled_bwd_kernel). Per (sample, window, head): q̂ = q/|q|,
// k̂ = k/|k| (fp32, eps 1e-12), S = (q̂s)·k̂ᵀ, p = softmax(S), dv = pᵀ·do,
// dp = do·vᵀ, dS = p (dp − Σ p·dp), dq̂ = dS·k̂, dk̂ = dSᵀ·(q̂s), then
// dq = (s dq̂ − q̂ (q̂·s dq̂)) / |q| and dk = (dk̂ − k̂ (k̂·dk̂)) / |k| from the
// fp32 q̂, k̂ and norms, dv as is, written into dqkv in the [q|k|v]
// interleave at the coordinates the forward reads, and Σ dS·S / s for the
// logit scale -- with q̂s, k̂, p, dS and do rounded to bf16 before the
// products that consume them (the TPU kernel's rounding points) and every
// sum in fp32. Kernel 16 is the same bodies on qkv and dout rolled by the
// shift (TILED, the wrap compiled out of WindowIndex), in the same key and
// query order, so on rolled inputs it equals kernel 6 bit for bit.
//
// What bounds it: the bytes, as for the forward -- five window products of
// 256 x 256 x d on 4 x 256 x d bf16 read and 3 x 256 x d written, about 150
// flops a byte at d = 88. What shapes the design is that the two sums of the
// backward run along different axes: dq̂ sums over a query row's 256 keys,
// dk̂ and dv over a key's 256 queries, and no block holds a window's 256 x
// 256 logits. So two passes, with no partial of dk̂ or dv in device memory
// and no float atomics (two calls give the same bits):
//
// The query pass (attn_bwd_q_kernel): a block keeps k̂ and v of all of a
// window's 256 keys (2 x 64 KB at DP = 128; the tangent's four such
// tensors needed a cluster of two, these two fit one block), and its two
// consumers split the keys, consumer c owning [128 c, 128 c + 128). For
// each 64-row query block both hold S and dp over their keys as two
// m64n128 accumulators, exchange each row's max, Σ e and Σ e·dp (e =
// exp(S − m_c)) through shared memory once, and combine them in key order:
// m = max(m_0, m_1), c_c = exp(m_c − m), l = l_0 c_0 + l_1 c_1, D = Σ p·dp
// = (a_0 c_0 + a_1 c_1) / l, p = e c_c / l. dS = p (dp − D) is rounded to
// bf16 as the A fragments of dq̂ = dS·k̂ over the consumer's keys (k̂ read
// MN-major, as the forward reads v), while its Σ dS·S, taken as
// Σ p (dp − D) S from the thread's sums of e·dp·S and e·S, adds to the
// scale's partial. Each consumer then finishes half of dq's columns: it
// hands the other its partial of the other's columns (one fp32 addition,
// commutative, so the same bits as o_0 + o_1), takes the row's q̂·dq̂ over
// its columns from the raw q row and 1/|q|, adds the other's in order, and
// stores its columns. Consumer 0 also writes each row's m, 1/l and D (12
// bytes a row) for the key pass. The keys are split within a block rather
// than across a cluster of two, as the tangent's are: the exchanges go
// through shared memory and named barriers, and the kernel measured 6-8%
// faster so (PERF.md §6).
//
// The key pass (attn_bwd_kv_kernel), FlashAttention-2's backward without
// atomics: a block owns 64 keys and walks the window's 256 queries 64 at a
// time. Both consumers form Sᵀ = k̂·(q̂s)ᵀ (keys as M, an m64n64
// accumulator) and rebuild pᵀ = exp(Sᵀ − m) / l from the saved statistics;
// consumer 0 adds pᵀ·do into dv, consumer 1 also forms dpᵀ = v·doᵀ and adds
// dSᵀ·(q̂s) = (pᵀ (dpᵀ − D))·(q̂s) into dk̂, each a 64 x DP fp32 sum held in
// registers across the walk (pᵀ and dSᵀ as A fragments from registers, do
// and q̂s read MN-major). Splitting dv and dk̂ over the consumers costs one
// Sᵀ more a step but keeps a consumer's registers within the 168 of the
// launch bound at DP = 128 (dk̂ 64, Sᵀ 32, dpᵀ 32): both sums in one
// consumer would need 192. The key pass's p comes from another wgmma
// orientation and exp(S − m) / l, so it may differ from the query pass's
// in the last bit; each pass is deterministic.
//
// The query pass also hands the key pass each query block's q̂s as its
// stage holds it (one bulk copy a block), so that the key pass, which
// walks the queries four times a window-head, neither gathers nor
// normalises q. The scale's partials, one per (window-head, query block,
// consumer), are summed in a fixed order by block_attn_dscale_kernel.
// Scratch a query row and head: q̂s's 128 NBOX bytes (256 at d > 64, 128
// below), the statistics' 12 and the partials' 0.125.

// A consumer's rows of an m64 accumulator: thread t holds rows
// 16 (t / 32) + (t % 32) / 4 and that + 8.
__device__ __forceinline__ int acc_row(int tid) { return tid / 32 * 16 + tid % 32 / 4; }

// The scale's partials a window-head: one a query block and consumer.
constexpr int kAttnBwdPartials = 2 * kWinTokens / kQB;

template <int DP>
struct AttnBwdQ {
  static constexpr int NBOX = AttnFwd<DP>::NBOX;     // the forward's boxes
  static constexpr int Q_BOX = AttnFwd<DP>::Q_BOX;   // one box of 64 query rows
  static constexpr int KV_BOX = AttnFwd<DP>::KV_BOX; // one box of the window's 256 key rows
  static constexpr int KEYS = NBOX * KV_BOX;         // k̂ or v of the window's keys
  static constexpr int QS = NBOX * Q_BOX;            // a query block's q̂s (or do)
  static constexpr int STAGE = 2 * QS;               // its q̂s, then do
  static constexpr int HALF = DP / 2;                // the dq columns a consumer finishes
  static constexpr int LDO = HALF + 8;               // bf16 stride of the staging rows
  static constexpr int Q_OFF = 2 * KEYS;             // k̂ at 0, v at KEYS; two stages
  static constexpr int O_OFF = Q_OFF + 2 * STAGE;    // two consumers' staging rows
  static constexpr int X_OFF = O_OFF + 2 * kQB * LDO * 2;  // [c][m, l, a][64] the statistics
  static constexpr int DOT_OFF = X_OFF + 2 * 3 * kQB * 4;  // [c][64] the rows' partial q̂·s dq̂
  static constexpr int INV_OFF = DOT_OFF + 2 * kQB * 4;    // [stage][64] 1/|q|
  static constexpr int RED_OFF = INV_OFF + 2 * kQB * 4;    // [c][4] the warps' Σ dS·S
  static constexpr int ROW_OFF = RED_OFF + 2 * 4 * 4;      // tokens: [stage][64] queries, keys
  static constexpr int BAR_OFF = ROW_OFF + (2 * kQB + kWinTokens) * 8;
  enum { K_FULL, K_EMPTY, V_FULL, V_EMPTY, Q_FULL, Q_EMPTY = Q_FULL + 2, N_BARS = Q_EMPTY + 2 };
  static constexpr int SMEM = 1024 + BAR_OFF + N_BARS * 8;  // with the alignment pad
  static_assert(SMEM <= kMaxSmem, "the query pass's buffers do not fit");
  // each consumer's partial dq̂ of the other's columns: DP / 4 floats for each of 256 threads
  static_assert(256 * DP <= STAGE, "the partials dq̂ do not fit a stage");
};

// Consumer C's end of query block qb, both consumers together: its partial
// dq̂ ``o`` of the other's columns into the stage (``xo``, [c][pair][thread],
// the products that read the stage have retired), the other's partial of
// its own columns added in (one addition, commutative: the same bits as
// o_0 + o_1), the stage released; then dq = (s dq̂ − q̂ (q̂·s dq̂)) / |q|
// with q̂ from the raw q row (``qr``, the thread's bf16 pairs of its two
// rows), 1/|q| (``inv_q``) and the row's q̂·s dq̂ summed over both
// consumers' columns in order (``dots``), this consumer's columns rounded
// to bf16 into its staging rows and copied to the token each query came
// from, one bulk copy a row by thread ``row`` (tid < 64). Thread 0 also
// writes the consumer's Σ dS·S (``red``, one a warp) to ``part``.
template <int DP, int C, bool TILED>
__device__ __forceinline__ void bwd_q_finish(float (&o)[DP / 2], const uint32_t (&qr)[2][DP / 8],
                                             const float* inv_q, float s, float2* xo, float* dots,
                                             bf16* rows, uint64_t* bar, int slot, bf16* dqkv,
                                             const WindowIndex<TILED>& token, int qb,
                                             size_t feat, int col, int ncols, const float* red,
                                             float* part, int tid) {
  using L = AttnBwdQ<DP>;
  constexpr int NJ = DP / 16;  // the 8-column groups a consumer finishes
  constexpr int OWN = C * NJ, OTHER = (1 - C) * NJ;
  const int lane = tid % 32, r = acc_row(tid);
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      xo[(C * 2 * NJ + 2 * jj + hh) * 128 + tid] =
          make_float2(o[4 * (OTHER + jj) + 2 * hh], o[4 * (OTHER + jj) + 2 * hh + 1]);
  named_barrier_sync(5, 256);  // both consumers' partials are in
  const float iq[2] = {inv_q[r], inv_q[r + 8]};
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 x = xo[((1 - C) * 2 * NJ + 2 * jj + hh) * 128 + tid];
      o[4 * (OWN + jj) + 2 * hh] += x.x;
      o[4 * (OWN + jj) + 2 * hh + 1] += x.y;
    }
  __syncwarp();
  if (lane == 0) mbar_arrive(&bar[L::Q_EMPTY + slot]);  // the stage may take the next block
  // the normalise backward, rows r and r + 8: q̂·(s dq̂) over this consumer's
  // columns, which the quad holds, then over both consumers' in order
  float dot[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 q =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qr[hh][OWN + jj]));
      dot[hh] += o[4 * (OWN + jj) + 2 * hh] * s * (q.x * iq[hh]) +
                 o[4 * (OWN + jj) + 2 * hh + 1] * s * (q.y * iq[hh]);
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 1);
    dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 2);
  }
  if (lane % 4 == 0) {
    dots[C * kQB + r] = dot[0];
    dots[C * kQB + r + 8] = dot[1];
  }
  if (tid < kQB) tma_store_wait_read<0>();  // the previous block's copies have read the rows
  named_barrier_sync(5, 256);  // both consumers' dots are in
  if (tid == 0) *part = red[0] + red[1] + red[2] + red[3];
  const float full[2] = {dots[r] + dots[kQB + r], dots[r + 8] + dots[kQB + r + 8]};
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 q =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qr[hh][OWN + jj]));
      const int i = 4 * (OWN + jj) + 2 * hh;
      const float g0 = o[i] * s, g1 = o[i + 1] * s;
      *reinterpret_cast<uint32_t*>(rows + (r + 8 * hh) * L::LDO + 8 * jj + 2 * (lane % 4)) =
          pack_bf16x2((g0 - q.x * iq[hh] * full[hh]) * iq[hh],
                      (g1 - q.y * iq[hh] * full[hh]) * iq[hh]);
    }
  fence_async_smem();
  named_barrier_sync(1 + C, 128);
  if (tid < kQB && ncols > 0) {
    bulk_store(dqkv + token(qb * kQB + tid) * feat + col, rows + tid * L::LDO, ncols * 2);
    tma_store_commit();
  }
}

// Warp specialisation, 384 threads a block, persistent, walking window-heads
// with heads fastest (as the forward):
//   warpgroup 0, the producer: warps 0 and 1 gather q and do of each query
//     block through WindowIndex with cp.async into one of two stages, once
//     the block before last has left it, and normalise q in place in fp32
//     (times the logit scale, keeping 1/|q|); warps 2 and 3 load v of the
//     window's keys once the previous window-head's last dp has retired,
//     then k once its last dq̂ has.
//   warpgroups 1 and 2, the consumers: consumer c owns keys [128 c, 128 c +
//     128); both normalise the window's k in place in fp32 when it lands (256
//     threads, four times the producer's warps), then take every query
//     block, form S and dp over their keys, the
//     statistics and their exchange, dS and dq̂, the dq̂ exchange, and each
//     stores half of dq's columns.
// mbarriers: full and empty ones for k̂, v and the two stages; the
// consumers meet at named barrier 5 (256 threads) for the statistics, the
// partials and the rows' dots. Registers (setmaxnreg): 80 a producer
// thread, 208 a consumer thread, as the forward's.
template <int DP, bool TILED>
__global__ void __launch_bounds__(kFwdThreads, 1)
    attn_bwd_q_kernel(const bf16* __restrict__ qkv, const float* __restrict__ scale,
                      const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                      float* __restrict__ stats, float* __restrict__ part_s,
                      unsigned char* __restrict__ stages, int B, int gh, int gw, int heads, int d,
                      int wh, int ww, int sh, int sw) {
  using L = AttnBwdQ<DP>;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Ks = smem;  // k̂ and v of the window's keys
  unsigned char* Vs = smem + L::KEYS;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  float* inv_q = reinterpret_cast<float*>(smem + L::INV_OFF);  // [stage][64]
  const int nW = (gh / wh) * (gw / ww), items = B * nW * heads, chunks = d / 8;
  const size_t feat = (size_t)heads * 3 * d, ofeat = (size_t)heads * d;
  if (threadIdx.x == 0) {
    const int counts[L::N_BARS] = {64, 8, 64, 8, 64, 64, 8, 8};
    for (int i = 0; i < L::N_BARS; ++i) mbar_init(&bar[i], counts[i]);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<80>();
    size_t* tokens = reinterpret_cast<size_t*>(smem + L::ROW_OFF);  // [stage][64], [keys]
    if (threadIdx.x < 64) {  // warps 0 and 1: q and do of each query block
      const int tid = threadIdx.x;
      uint32_t n = 0;  // query blocks so far: stage n & 1, its phase (n >> 1) & 1
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int h = item % heads, w = item / heads % nW, b = item / heads / nW;
        const WindowIndex<TILED> token(b, w, gh, gw, wh, ww, sh, sw);
        const float scale_h = scale[h];
        for (int qb = 0; qb < kWinTokens / kQB; ++qb, ++n) {
          const int slot = n & 1;
          size_t* rows = tokens + slot * kQB;
          unsigned char* stage = smem + L::Q_OFF + slot * L::STAGE;
          mbar_wait(&bar[L::Q_EMPTY + slot], ((n >> 1) & 1) ^ 1);
          // every thread has issued the copies of the block before last from this table
          for (int t = tid; t < kQB; t += 64) rows[t] = token(qb * kQB + t);
          named_barrier_sync(4, 64);
          fwd_load<DP, 64>(stage, L::Q_BOX, kQB, qkv, rows, 0, h * 3 * d, chunks, tid, feat);
          fwd_load<DP, 64>(stage + L::QS, L::Q_BOX, kQB, dout, rows, 0, h * d, chunks, tid,
                           ofeat);
          cp_async_commit();
          cp_async_wait<0>();
          named_barrier_sync(4, 64);
          fwd_normalise<DP, true, 64>(stage, L::Q_BOX, kQB, chunks, scale_h, tid,
                                      inv_q + slot * kQB);
          fence_async_smem();
          mbar_arrive(&bar[L::Q_FULL + slot]);
        }
      }
    } else {  // warps 2 and 3: v and k of the window's keys
      const int tid = threadIdx.x - 64;
      size_t* rows = tokens + 2 * kQB;
      uint32_t it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int h = item % heads, w = item / heads % nW, b = item / heads / nW;
        const WindowIndex<TILED> token(b, w, gh, gw, wh, ww, sh, sw);
        const int head = h * 3 * d;
        named_barrier_sync(3, 64);  // both warps have issued the previous window-head's copies
        for (int t = tid; t < kWinTokens; t += 64) rows[t] = token(t);
        named_barrier_sync(3, 64);
        mbar_wait(&bar[L::V_EMPTY], (it & 1) ^ 1);  // the last dp has retired
        fwd_load<DP, 64>(Vs, L::KV_BOX, kWinTokens, qkv, rows, 0, head + 2 * d, chunks, tid,
                         feat);
        cp_async_commit();
        mbar_wait(&bar[L::K_EMPTY], (it & 1) ^ 1);  // the last dq̂ has retired
        fwd_load<DP, 64>(Ks, L::KV_BOX, kWinTokens, qkv, rows, 0, head + d, chunks, tid, feat);
        cp_async_commit();
        cp_async_wait<1>();
        fence_async_smem();
        mbar_arrive(&bar[L::V_FULL]);
        cp_async_wait<0>();
        mbar_arrive(&bar[L::K_FULL]);  // raw: the consumers normalise k together
      }
    }
  } else {  // the consumers
    setmaxnreg_inc<208>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid % 32;
    unsigned char* Kc = Ks + c * (kWinTokens / 2) * 128;  // this consumer's keys in each box
    unsigned char* Vc = Vs + c * (kWinTokens / 2) * 128;
    float* xs = reinterpret_cast<float*>(smem + L::X_OFF);  // [c][m, l, a][64]
    float* dots = reinterpret_cast<float*>(smem + L::DOT_OFF);
    float* red = reinterpret_cast<float*>(smem + L::RED_OFF) + c * 4;
    bf16* rows = reinterpret_cast<bf16*>(smem + L::O_OFF) + c * kQB * L::LDO;
    const int col = c * L::HALF;
    const int ncols = d - col < 0 ? 0 : (d - col < L::HALF ? d - col : L::HALF);
    const int q4 = lane % 4, r0 = acc_row(tid);
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar[i]);
    };
    uint32_t it = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int h = item % heads, w = item / heads % nW, b = item / heads / nW;
      const WindowIndex<TILED> token(b, w, gh, gw, wh, ww, sh, sw);
      const float scale_h = scale[h];
      const size_t wh_index = ((size_t)b * heads + h) * nW + w;
#pragma unroll 1
      for (int qb = 0; qb < kWinTokens / kQB; ++qb, ++n) {
        const int slot = n & 1;
        unsigned char* Qs = smem + L::Q_OFF + slot * L::STAGE;  // q̂s, then do
        unsigned char* dOs = Qs + L::QS;
        float2* xo = reinterpret_cast<float2*>(Qs);  // the partials, once S and dp are done
        if (qb == 0) {  // the window's k, normalised in place by both consumers
          mbar_wait(&bar[L::K_FULL], it & 1);
          fwd_normalise<DP, false, 256>(Ks, L::KV_BOX, kWinTokens, chunks, 1.0f, c * 128 + tid);
          fence_async_smem();
          named_barrier_sync(5, 256);
        }
        mbar_wait(&bar[L::Q_FULL + slot], (n >> 1) & 1);
        // q̂s as the key pass reads it, to the scratch, read before the partials
        // overwrite the stage
        const bool keeper = c == 0 && tid == 0;
        if (keeper) {
          bulk_store(stages + (wh_index * 4 + qb) * L::QS, Qs, L::QS);
          tma_store_commit();
        }
        // S = q̂s·k̂ᵀ and dp = do·vᵀ over this consumer's keys
        float s[64], dp[64];
        mbar_wait(&bar[L::K_FULL], it & 1);
        mbar_wait(&bar[L::V_FULL], it & 1);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < DP / 16; ++k)
          wgmma_m64nNk16<128>(s, wgmma_desc(Qs + (k / 4) * L::Q_BOX) + 2 * (k % 4),
                              wgmma_desc(Kc + (k / 4) * L::KV_BOX) + 2 * (k % 4), k > 0);
#pragma unroll
        for (int k = 0; k < DP / 16; ++k)
          wgmma_m64nNk16<128>(dp, wgmma_desc(dOs + (k / 4) * L::Q_BOX) + 2 * (k % 4),
                              wgmma_desc(Vc + (k / 4) * L::KV_BOX) + 2 * (k % 4), k > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (qb == kWinTokens / kQB - 1) release(L::V_EMPTY);

        // the rows' max, Σ e and Σ e·dp over this consumer's keys (row hh of
        // the thread's two in s[4 j + 2 hh + e]), to the other consumer
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 64; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
          m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
        }
        // e = exp(S − m) in place of S, and the thread's Σ e·dp·S and Σ e·S of each
        // row, from which its share of Σ dS·S = Σ p (dp − D) S follows
        float es[2] = {0.f, 0.f}, eps[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int hh = (i >> 1) & 1;
          const float e = exp2f((s[i] - m[hh]) * kLog2e);
          l[hh] += e;
          a[hh] += e * dp[i];
          es[hh] += e * s[i];
          eps[hh] += e * dp[i] * s[i];
          s[i] = e;
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int x = 1; x < 4; x <<= 1) {
            l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], x);
            a[hh] += __shfl_xor_sync(0xffffffffu, a[hh], x);
          }
        if (q4 < 3) {  // lanes 0, 1, 2 of a quad write m, l, a of its two rows
          float* x = xs + (c * 3 + q4) * kQB;
          x[r0] = q4 == 0 ? m[0] : q4 == 1 ? l[0] : a[0];
          x[r0 + 8] = q4 == 0 ? m[1] : q4 == 1 ? l[1] : a[1];
        }
        if (keeper) tma_store_wait_read<0>();  // the q̂s store has read what the partials overwrite
        named_barrier_sync(5, 256);  // both consumers' statistics are in
        float f[2], D[2];  // p = e f, and Σ p·dp
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + 8 * hh;
          // key order: the same statistics in both consumers
          const float m0 = xs[r], l0 = xs[kQB + r], a0 = xs[2 * kQB + r];
          const float m1 = xs[3 * kQB + r], l1 = xs[4 * kQB + r], a1 = xs[5 * kQB + r];
          const float mx = fmaxf(m0, m1);
          const float c0 = exp2f((m0 - mx) * kLog2e), c1 = exp2f((m1 - mx) * kLog2e);
          const float inv_l = 1.0f / (l0 * c0 + l1 * c1);
          D[hh] = (a0 * c0 + a1 * c1) * inv_l;
          f[hh] = (c ? c1 : c0) * inv_l;
          if (c == 0 && q4 == 0) {  // the row's statistics, for the key pass
            float* st = stats + (wh_index * 4 + qb) * 3 * kQB + r;
            st[0] = mx;
            st[kQB] = inv_l;
            st[2 * kQB] = D[hh];
          }
        }
        // dS = p (dp − D), p = e f, rounded to bf16 as the A fragments of the
        // 8 k16 slices, and the thread's Σ dS·S = Σ f (e·dp·S − D e·S)
        uint32_t ds[8][4];
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 8 * k + 2 * q, hh = q & 1;
            const float p0 = s[i] * f[hh], p1 = s[i + 1] * f[hh];
            ds[k][q] = pack_bf16x2(p0 * (dp[i] - D[hh]), p1 * (dp[i + 1] - D[hh]));
          }
        float dsum = f[0] * (eps[0] - D[0] * es[0]) + f[1] * (eps[1] - D[1] * es[1]);
        dsum = warp_sum(dsum);
        if (lane == 0) red[tid / 32] = dsum;
        // this consumer's partial of dq̂ = dS·k̂, k̂ read MN-major
        float o[DP / 2];
        wgmma_fence();
        const uint64_t kd = wgmma_desc_mn(Kc, L::KV_BOX);
#pragma unroll
        for (int k = 0; k < 8; ++k) wgmma_m64nNk16_rs<DP>(o, ds[k], kd + 128 * k, k > 0);
        wgmma_commit();
        // meanwhile the raw q of the thread's two rows at its columns, for the
        // normalise backward
        uint32_t qr[2][DP / 8];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const bf16* src = qkv + token(qb * kQB + r0 + 8 * hh) * feat + h * 3 * d;
#pragma unroll
          for (int jj = 0; jj < DP / 8; ++jj) {
            const int cc = 8 * jj + 2 * q4;
            qr[hh][jj] = cc < d ? *reinterpret_cast<const uint32_t*>(src + cc) : 0u;
          }
        }
        wgmma_wait<0>();
        fence_regs(o);
        if (qb == kWinTokens / kQB - 1) release(L::K_EMPTY);
        float* part = part_s + wh_index * kAttnBwdPartials + qb * 2 + c;
        if (c == 0)
          bwd_q_finish<DP, 0, TILED>(o, qr, inv_q + slot * kQB, scale_h, xo, dots, rows, bar,
                                     slot, dqkv, token, qb, feat, h * 3 * d + col, ncols, red,
                                     part, tid);
        else
          bwd_q_finish<DP, 1, TILED>(o, qr, inv_q + slot * kQB, scale_h, xo, dots, rows, bar,
                                     slot, dqkv, token, qb, feat, h * 3 * d + col, ncols, red,
                                     part, tid);
      }
    }
    if (tid < kQB) tma_store_wait_all();  // the rows stay until the last copies have read them
  }
}

// The key pass. 384 threads a block, persistent, walking (window-head, 64
// keys) items with the key blocks fastest, so that the blocks in flight
// read the same query rows.
//   warpgroup 0, the producer: k and v of the item's keys into one of two
//     buffers (the next item's load overlaps this one's walk), k normalised
//     in place in fp32 (keeping 1/|k|); then a ring of stages of 64
//     queries: q̂s as the query pass left it (normalised, scaled, swizzled:
//     no gather, no normalise) and the rows' m, 1/l and D by two bulk
//     copies, do gathered by cp.async. Its copies run one group ahead: a
//     group is handed over once the next is in flight.
//   warpgroups 1 and 2, the consumers: 0 sums dv, 1 dk̂ (above); at the end
//     of an item consumer 0 stores dv, consumer 1 dk after the normalise
//     backward from the raw k rows (copied into its staging rows when the
//     item starts) and 1/|k|, both as the forward stores.
// Registers as the forward's (80 / 208).
constexpr int kKvKeys = 64, kKvStages = 3;  // keys an item owns (queries a step alike)

template <int DP>
struct AttnBwdKV {
  static constexpr int NBOX = AttnFwd<DP>::NBOX;
  static constexpr int BOX = kKvKeys * 128;         // one box of 64 rows
  static constexpr int TILE = NBOX * BOX;           // 64 rows of k̂, v, q̂s or do
  static constexpr int KV = 2 * TILE;               // a key buffer: k̂, then v
  static constexpr int STAGE = 2 * TILE + 1024;     // q̂s, do, the queries' m, 1/l, D
  static constexpr int LDO = AttnFwd<DP>::LDO;      // the forward's staging rows
  static constexpr int ST_OFF = 2 * KV;
  static constexpr int O_OFF = ST_OFF + kKvStages * STAGE;
  static constexpr int INV_OFF = O_OFF + 2 * kKvKeys * LDO * 2;  // [buffer][64] 1/|k|
  static constexpr int ROW_OFF = INV_OFF + 2 * kKvKeys * 4;  // tokens [it & 1][keys, queries]
  static constexpr int BAR_OFF = ROW_OFF + 2 * (kKvKeys + kWinTokens) * 8;
  enum {
    KV_FULL, KV_EMPTY = KV_FULL + 2, FULL = KV_EMPTY + 2, EMPTY = FULL + kKvStages,
    N_BARS = EMPTY + kKvStages
  };
  static constexpr int SMEM = 1024 + BAR_OFF + N_BARS * 8;  // with the alignment pad
  static_assert(SMEM <= kMaxSmem, "the key pass's buffers do not fit");
  static_assert(3 * kKvKeys * 4 <= 1024, "a step's statistics do not fit its stage");
  static_assert(TILE == AttnBwdQ<DP>::QS && kKvKeys == kQB, "the query pass's q̂s");
};

// One step of a key-pass consumer: Sᵀ = k̂·(q̂s)ᵀ over the item's 64 keys
// and the stage's 64 queries, pᵀ = exp(Sᵀ − m) / l from the saved
// statistics, and acc += pᵀ·do (DK false) or, with dpᵀ = v·doᵀ,
// acc += (pᵀ (dpᵀ − D))·(q̂s) (DK true); A from registers, B read MN-major.
template <int DP, bool DK>
__device__ __forceinline__ void bwd_kv_step(float (&acc)[DP / 2], const unsigned char* Kb,
                                            const unsigned char* st, int q4) {
  using L = AttnBwdKV<DP>;
  constexpr float kLog2e = 1.4426950408889634f;
  const unsigned char* Vb = Kb + L::TILE;
  const unsigned char* Qs = st;
  const unsigned char* dOs = st + L::TILE;
  const float* sm = reinterpret_cast<const float*>(st + 2 * L::TILE);  // [m, 1/l, D][64]
  float s[32], dp[DK ? 32 : 1];
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < DP / 16; ++k)
    wgmma_m64nNk16<64>(s, wgmma_desc(Kb + (k / 4) * L::BOX) + 2 * (k % 4),
                       wgmma_desc(Qs + (k / 4) * L::BOX) + 2 * (k % 4), k > 0);
  if constexpr (DK) {
#pragma unroll
    for (int k = 0; k < DP / 16; ++k)
      wgmma_m64nNk16<64>(dp, wgmma_desc(Vb + (k / 4) * L::BOX) + 2 * (k % 4),
                         wgmma_desc(dOs + (k / 4) * L::BOX) + 2 * (k % 4), k > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  if constexpr (DK) fence_regs(dp);
  // pᵀ (or dSᵀ) rounded to bf16 as the A fragments of the 4 k16 slices of
  // queries: s[8 k + 2 q + e] is query 16 k + 8 (q / 2) + 2 (lane % 4) + e
  uint32_t a[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 8 * k + 2 * q, n = 16 * k + 8 * (q >> 1) + 2 * q4;
      const float2 m = *reinterpret_cast<const float2*>(sm + n);
      const float2 il = *reinterpret_cast<const float2*>(sm + kKvKeys + n);
      const float p0 = exp2f((s[i] - m.x) * kLog2e) * il.x;
      const float p1 = exp2f((s[i + 1] - m.y) * kLog2e) * il.y;
      if constexpr (DK) {
        const float2 D = *reinterpret_cast<const float2*>(sm + 2 * kKvKeys + n);
        a[k][q] = pack_bf16x2(p0 * (dp[i] - D.x), p1 * (dp[i + 1] - D.y));
      } else {
        a[k][q] = pack_bf16x2(p0, p1);
      }
    }
  wgmma_fence();
  const uint64_t bd = wgmma_desc_mn(DK ? Qs : dOs, L::BOX);
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma_m64nNk16_rs<DP>(acc, a[k], bd + 128 * k, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

template <int DP, bool TILED>
__global__ void __launch_bounds__(kFwdThreads, 1)
    attn_bwd_kv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                       const float* __restrict__ stats, const unsigned char* __restrict__ stages,
                       bf16* __restrict__ dqkv, int B, int gh, int gw, int heads, int d, int wh,
                       int ww, int sh, int sw) {
  using L = AttnBwdKV<DP>;
  constexpr int GROUPS = kWinTokens / kKvKeys;  // items a window-head
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  float* inv_k = reinterpret_cast<float*>(smem + L::INV_OFF);
  const int nW = (gh / wh) * (gw / ww), items = B * nW * heads * GROUPS, chunks = d / 8;
  const size_t feat = (size_t)heads * 3 * d, ofeat = (size_t)heads * d;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bar[L::KV_FULL + i], 128);
      mbar_init(&bar[L::KV_EMPTY + i], 8);
    }
    for (int i = 0; i < kKvStages; ++i) {
      mbar_init(&bar[L::FULL + i], 129);  // the producer's threads, the bulk copies' expect_tx
      mbar_init(&bar[L::EMPTY + i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<80>();
    const int tid = threadIdx.x;
    int s = 0;
    uint32_t ph = 0, it = 0;
    // the copies run one group ahead: a group (k and v, or a stage's do) is
    // handed over, k normalised first, once the next group is in flight
    unsigned char* pend = nullptr;
    int pend_bar = 0;
    float* pend_inv = nullptr;
    auto finish = [&](bool last) {
      if (pend == nullptr) return;
      if (last)
        cp_async_wait<0>();
      else
        cp_async_wait<1>();
      named_barrier_sync(3, 128);  // every producer thread's copies of it have landed
      if (pend_inv != nullptr)
        fwd_normalise<DP, false>(pend, L::BOX, kKvKeys, chunks, 1.0f, tid, pend_inv);
      fence_async_smem();
      mbar_arrive(&bar[pend_bar]);
    };
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int g = item % GROUPS, h = item / GROUPS % heads, w = item / GROUPS / heads % nW,
                b = item / GROUPS / heads / nW;
      const WindowIndex<TILED> token(b, w, gh, gw, wh, ww, sh, sw);
      const int head = h * 3 * d, kb = it & 1;
      const size_t wh_index = ((size_t)b * heads + h) * nW + w;  // the query pass's order
      // two tables in turn: a thread may write this item's while another still
      // issues the previous one's last copies from the other
      size_t* rows = reinterpret_cast<size_t*>(smem + L::ROW_OFF) + kb * (kKvKeys + kWinTokens);
      for (int t = tid; t < kKvKeys + kWinTokens; t += 128)
        rows[t] = token(t < kKvKeys ? g * kKvKeys + t : t - kKvKeys);
      named_barrier_sync(3, 128);
      // k and v, once the item before last has left the buffer
      unsigned char* Kb = smem + kb * L::KV;
      mbar_wait(&bar[L::KV_EMPTY + kb], ((it >> 1) & 1) ^ 1);
      fwd_load<DP>(Kb, L::BOX, kKvKeys, qkv, rows, 0, head + d, chunks, tid, feat);
      fwd_load<DP>(Kb + L::TILE, L::BOX, kKvKeys, qkv, rows, 0, head + 2 * d, chunks, tid, feat);
      cp_async_commit();
      finish(false);
      pend = Kb, pend_bar = L::KV_FULL + kb, pend_inv = inv_k + kb * kKvKeys;
      // the window's queries, 64 at a time: q̂s as the query pass left it and the
      // rows' m, 1/l, D by two bulk copies, do gathered
      for (int q = 0; q < kWinTokens / kQB; ++q) {
        unsigned char* st = smem + L::ST_OFF + s * L::STAGE;
        mbar_wait(&bar[L::EMPTY + s], ph ^ 1);
        if (tid == 0) {
          mbar_expect_tx(&bar[L::FULL + s], L::TILE + 3 * kQB * 4);
          bulk_load(st, stages + (wh_index * 4 + q) * L::TILE, L::TILE, &bar[L::FULL + s]);
          bulk_load(st + 2 * L::TILE, stats + (wh_index * 4 + q) * 3 * kQB, 3 * kQB * 4,
                    &bar[L::FULL + s]);
        }
        fwd_load<DP>(st + L::TILE, L::BOX, kQB, dout, rows + kKvKeys, q * kQB, h * d, chunks, tid,
                     ofeat);
        cp_async_commit();
        finish(false);
        pend = st, pend_bar = L::FULL + s, pend_inv = nullptr;
        if (++s == kKvStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    finish(true);
  } else {  // the consumers
    setmaxnreg_inc<208>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid % 32;
    const int q4 = lane % 4, r0 = acc_row(tid);
    bf16* rows = reinterpret_cast<bf16*>(smem + L::O_OFF) + c * kKvKeys * L::LDO;
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar[i]);
    };
    int s = 0;
    uint32_t ph = 0, it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int g = item % GROUPS, h = item / GROUPS % heads, w = item / GROUPS / heads % nW,
                b = item / GROUPS / heads / nW;
      const WindowIndex<TILED> token(b, w, gh, gw, wh, ww, sh, sw);
      const int kb = it & 1;
      const int col = h * 3 * d + (c == 0 ? 2 * d : d);
      if (c == 1) {  // the raw k rows into the staging rows, for the normalise backward
        if (tid < kKvKeys) tma_store_wait_read<0>();  // the last item's copies have read them
        named_barrier_sync(1 + c, 128);
        for (int i = tid; i < kKvKeys * (DP / 8); i += 128) {
          const int r = i / (DP / 8), ch = i % (DP / 8);
          cp_async16(rows + r * L::LDO + ch * 8,
                     ch < chunks ? qkv + token(g * kKvKeys + r) * feat + col + ch * 8 : qkv,
                     ch < chunks);
        }
        cp_async_commit();
      }
      const unsigned char* Kb = smem + kb * L::KV;
      mbar_wait(&bar[L::KV_FULL + kb], (it >> 1) & 1);
      const float ik[2] = {inv_k[kb * kKvKeys + r0], inv_k[kb * kKvKeys + r0 + 8]};
      float acc[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
      for (int q0 = 0; q0 < kWinTokens; q0 += kKvKeys) {
        const unsigned char* st = smem + L::ST_OFF + s * L::STAGE;
        mbar_wait(&bar[L::FULL + s], ph);
        if (c == 0)
          bwd_kv_step<DP, false>(acc, Kb, st, q4);
        else
          bwd_kv_step<DP, true>(acc, Kb, st, q4);
        release(L::EMPTY + s);
        if (++s == kKvStages) {
          s = 0;
          ph ^= 1;
        }
      }
      release(L::KV_EMPTY + kb);
      if (c == 1) {  // dk = (dk̂ − k̂ (k̂·dk̂)) / |k| from the raw k row
        cp_async_wait<0>();
        named_barrier_sync(1 + c, 128);  // every thread's copies of the raw rows have landed
        uint32_t kr[2][DP / 8];
        float dot[2] = {0.f, 0.f};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int jj = 0; jj < DP / 8; ++jj) {
            kr[hh][jj] = *reinterpret_cast<const uint32_t*>(rows + (r0 + 8 * hh) * L::LDO +
                                                            8 * jj + 2 * q4);
            const float2 k =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kr[hh][jj]));
            dot[hh] += acc[4 * jj + 2 * hh] * (k.x * ik[hh]) +
                       acc[4 * jj + 2 * hh + 1] * (k.y * ik[hh]);
          }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 1);
          dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 2);
        }
#pragma unroll
        for (int jj = 0; jj < DP / 8; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 k =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kr[hh][jj]));
            const int i = 4 * jj + 2 * hh;
            acc[i] = (acc[i] - k.x * ik[hh] * dot[hh]) * ik[hh];
            acc[i + 1] = (acc[i + 1] - k.y * ik[hh] * dot[hh]) * ik[hh];
          }
      }
      fwd_store<DP, TILED>(acc, rows, dqkv, token, g, feat, col, d, c, tid);
    }
    if (tid < kQB) tma_store_wait_all();  // the rows stay until the last copies have read them
  }
}

// dscale[h] = Σ over samples, windows, query blocks and consumers (in that
// order) of the Σ dS·S partials, / scale[h].
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

// Kernels 6 (shifted, wrapping) and 16 (TILED, on pre-rolled qkv and dout):
// the query pass and then the key pass, each as many blocks as SMs (at most
// one a window-head or item), then the scale's sum, all on ``stream``.
static int attn_bwd_sms[2][8][64];

template <int DP, bool TILED>
int launch_attn_bwd(const void* qkv, const void* scale, const void* dout, void* dqkv,
                    void* dscale, void* stats, void* part_s, void* stages, int B, int gh, int gw,
                    int heads, int d, int wh, int ww, int sh, int sw, cudaStream_t stream) {
  const int nW = (gh / wh) * (gw / ww), items = B * heads * nW;
  const int slot = (DP / 32 - 1) * 2 + TILED;
  int e = launch_persistent(attn_bwd_q_kernel<DP, TILED>, attn_bwd_sms[0][slot], kFwdThreads,
                            AttnBwdQ<DP>::SMEM, items, stream, (const bf16*)qkv,
                            (const float*)scale, (const bf16*)dout, (bf16*)dqkv, (float*)stats,
                            (float*)part_s, (unsigned char*)stages, B, gh, gw, heads, d, wh, ww,
                            sh, sw);
  if (e != cudaSuccess) return e;
  const int kv_items = items * (kWinTokens / kKvKeys);
  e = launch_persistent(attn_bwd_kv_kernel<DP, TILED>, attn_bwd_sms[1][slot], kFwdThreads,
                        AttnBwdKV<DP>::SMEM, kv_items, stream, (const bf16*)qkv,
                        (const bf16*)dout, (const float*)stats, (const unsigned char*)stages,
                        (bf16*)dqkv, B, gh, gw, heads, d, wh, ww, sh, sw);
  if (e != cudaSuccess) return e;
  block_attn_dscale_kernel<<<1, 1024, 0, stream>>>((const float*)part_s, (const float*)scale,
                                                   (float*)dscale, B, heads,
                                                   nW * kAttnBwdPartials);
  return (int)cudaGetLastError();
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

// qkv (B, gh, gw, heads*3d), dout (B, gh, gw, heads*d) bf16, scale (heads,)
// fp32 -> dqkv like qkv, dscale (heads,) fp32. Scratch: stats fp32 of
// B*heads*nW*3*256 elements (each query row's max, 1/sum and Σ p·dp),
// part_s fp32 of B*heads*nW*8 (kAttnBwdPartials), stages (q̂s) of
// B*heads*nW*4*AttnBwdQ<dp>::QS bytes (dp = d rounded up to 32: 16384
// bytes a block at dp > 64, 8192 below), all 16-byte aligned. Same shape
// rules as swift_block_attention.
extern "C" int swift_block_attention_bwd(const void* qkv, const void* scale, const void* dout,
                                         void* dqkv, void* dscale, void* stats, void* part_s,
                                         void* stages, int B, int gh, int gw, int heads, int d,
                                         int wh, int ww, int sh, int sw, void* stream) {
  const int dp = (d + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
#define SWIFT_BWD(DP)                                                                          \
  return swift::launch_attn_bwd<DP, false>(qkv, scale, dout, dqkv, dscale, stats, part_s,       \
                                           stages, B, gh, gw, heads, d, wh, ww, sh, sw, st)
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

// Kernel 16: (dqkv, dscale) of swift_tiled_attention, on qkv and dout
// rolled by the window shift. Scratch as swift_block_attention_bwd's. Same
// shape rules as swift_tiled_attention.
extern "C" int swift_tiled_attention_bwd(const void* qkv, const void* scale, const void* dout,
                                         void* dqkv, void* dscale, void* stats, void* part_s,
                                         void* stages, int B, int gh, int gw, int heads, int d,
                                         int wh, int ww, void* stream) {
  const int dp = (d + 31) / 32 * 32;
  cudaStream_t st = (cudaStream_t)stream;
#define SWIFT_BWD(DP)                                                                          \
  return swift::launch_attn_bwd<DP, true>(qkv, scale, dout, dqkv, dscale, stats, part_s,        \
                                          stages, B, gh, gw, heads, d, wh, ww, 0, 0, st)
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
