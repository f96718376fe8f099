// Hopper building blocks for the port's GEMM and attention kernels: TMA
// tile loads and stores described by 2-D tensor maps, bulk copies, an
// mbarrier ring between one producer and the consumers, warpgroup
// tensor-core products (wgmma) read from shared memory or, for A, from
// registers, stores into a cluster peer's shared memory with barriers of
// cluster scope, and setmaxnreg. Inline PTX only (no CuTe, no CUTLASS), so a
// source that includes this header builds in seconds.
//
// Layout. Every operand tile is a bf16 box of R rows x 64 columns (128
// bytes a row) that TMA writes with the 128-byte swizzle: row r lies at
// r * 128 bytes with its 16-byte chunks permuted by chunk ^ (r % 8), and
// eight rows make one 1024-byte swizzle atom. wgmma reads such a tile
// through a shared-memory descriptor (layout 128B swizzle, 1024 bytes
// between 8-row groups). A tile must start on a 1024-byte boundary. The
// SwinV2 block's forward multiplies an activation (tokens x K) by an
// nn.Linear weight (out x K): both operands are K-major (the box's columns
// run along K), the case wgmma takes without a transpose, and the k-th
// 16-deep slice of the 64-deep tile starts k * 32 bytes into it. The
// backward's products reduce along the weight's rows (dx = dy . W) or along
// the tokens (dW = dy^T . x): there a box of the tensor as it lies has its
// rows along K (MN-major), wgmma reads it with its transpose flag, and the
// k-th slice starts 16 rows, 2048 bytes, into it. An int8 box row of 128
// bytes holds 128 values under the same swizzle: the int8 operands of
// kernels 18 and 19 are K-major, as 8-bit wgmma requires, and the k-th 32-deep
// slice of a 128-deep tile starts k * 32 bytes in, so a descriptor steps
// as for bf16.
//
// Requirements (TMA's): the global base 16-byte aligned, the row stride a
// multiple of 16 bytes (K % 8 == 0 for bf16). TMA zero-fills what a box
// reads past the tensor's edge and clips what a store writes past it.
//
// Pipeline. full[s] completes when stage s's loads have landed (one
// arrive.expect_tx by the producer plus the bytes TMA reports, its own
// loads' and those that other blocks of its cluster multicast into it);
// empty[s] when every consumer warp that reads the stage's data, in this
// block or in a block it multicasts to, has released it. A waiter tracks
// the phase parity itself: the producer starts at parity 1 (every stage
// starts empty), the consumers at 0.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace swift {

// -- shared memory, barriers ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add ``bytes`` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive once on a barrier of this block.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Spin until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Arrive once on the barrier at the same offset in cluster block ``rank``
// (this block's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// The same arrival with release semantics at cluster scope: this thread's
// earlier writes (and those ordered before it, as by __syncwarp) are
// visible to a thread that sees the phase complete with mbar_wait_cluster.
__device__ __forceinline__ void mbar_arrive_cluster_release(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// mbar_wait with acquire semantics at cluster scope (the counterpart of
// mbar_arrive_cluster_release).
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// -- clusters ------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Store two floats at ``p``'s offset in the shared memory of cluster block
// ``rank`` (distributed shared memory).
__device__ __forceinline__ void st_cluster_f32x2(const void* p, uint32_t rank, float a, float b) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "st.shared::cluster.v2.f32 [remote], {%2, %3};\n}\n" ::"r"(smem_addr(p)),
      "r"(rank), "f"(a), "f"(b)
      : "memory");
}

// Orders this thread's earlier memory accesses before its later ones for
// every thread of the cluster.
__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}

// Every thread of every block of the cluster (all threads of a warp together).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// bar.sync on a named barrier (ids 1-15; 0 is __syncthreads) for ``threads``.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// bar.arrive on barrier ``id`` of ``threads``: arrive without waiting. This
// thread's earlier shared-memory writes are visible to the threads that
// pass the barrier with bar.sync.
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (a TMA store, a wgmma operand).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- TMA -----------------------------------------------------------------------

// Load the box at (c0 = column, c1 = row) of ``map`` into ``dst``; its bytes
// complete a transaction of ``bar``.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The same box written at the same offset into the shared memory of every
// cluster block in ``mask``, completing a transaction of the barrier at
// ``bar``'s offset in each.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// Fetch ``map`` (a __grid_constant__ parameter) into the TMA unit's
// descriptor cache ahead of its first load.
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Store ``src`` to the box at (c0, c1) of ``map``, clipped at the edges.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

// Copy ``bytes`` (a multiple of 16; both addresses 16-byte aligned) from
// device to shared memory by the bulk-copy engine; the bytes complete a
// transaction of ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Copy ``bytes`` (a multiple of 16; both addresses 16-byte aligned) from
// shared to device memory by the bulk-copy engine, in this thread's bulk
// group (commit, wait as for tma_store_2d).
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's store groups still read shared memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until all of this thread's store groups have completed.
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// -- wgmma ---------------------------------------------------------------------

// Descriptor of a K-major tile written by TMA with the 128-byte swizzle:
// start address >> 4 (bits 0-13), leading offset 1 (unused by swizzled
// K-major layouts, bits 16-29), 1024 bytes between 8-row groups >> 4 (bits
// 32-45), base offset 0 (the tile is 1024-byte aligned), layout 1 = 128B
// swizzle (bits 62-63). The k-th 16-deep slice is ``desc + 2 * k``.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of the warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator across
// this point (the wgmma that writes it runs asynchronously).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] . B[16 x N], bf16 operands read through the
// descriptors, fp32 accumulator in registers: thread t of the warpgroup
// holds d[4 j + 2 h + e] = D[16 (t / 32) + (t % 32) / 4 + 8 h][8 j + 2 (t % 4) + e].
// scale_d = 0 overwrites D, 1 accumulates. N is 16, 32, 64, 96, 128, 136,
// 176, 216 or 256. TA, TB are the instruction's transpose flags: 0 reads a K-major
// tile (``wgmma_desc``: A stored 64 rows of K, B stored N rows of K, the
// nn.Linear weight), 1 an MN-major one (``wgmma_desc_mn_a``,
// ``wgmma_desc_mn``: stored K rows of M or of N, as an activation's tokens
// lie when the reduction runs over them).
template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_m64nNk16(float (&d)[N / 2], uint64_t a, uint64_t b,
                                               int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 96 || N == 128 || N == 136 || N == 176 ||
                    N == 216 || N == 256,
                "unsupported wgmma width");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
  if constexpr (N == 96) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
  if constexpr (N == 136) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67"
        "}, %68, %69, p, 1, 1, %71, %72;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
  if constexpr (N == 176) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87"
        "}, %88, %89, p, 1, 1, %91, %92;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
  if constexpr (N == 216) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %110, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n216k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107"
        "}, %108, %109, p, 1, 1, %111, %112;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
          "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
          "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
  if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
        "%125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
          "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
          "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
          "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
          "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
          "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

// Descriptor of an MN-major B tile with the 128-byte swizzle, for a product
// A . B where B (K x N) is stored K rows of N: K row k of a 64-column box
// at k * 128 bytes (chunks permuted by chunk ^ (k % 8), the layout TMA's
// 128-byte swizzle writes), 1024 bytes between 8-row groups (the stride
// byte offset, bits 32-45) and ``box_bytes`` between the boxes of columns
// 0-63 and 64-127 (the leading byte offset, bits 16-29). The k-th 16-deep
// slice starts 16 rows on: ``desc + 128 * k``. The tile is 1024-byte aligned.
__device__ __forceinline__ uint64_t wgmma_desc_mn(const void* tile, uint32_t box_bytes) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((box_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Descriptor of an MN-major A tile with the 128-byte swizzle, for A . B
// where A (64 x K) is stored K rows of M: K row k of the 64-column box at
// k * 128 bytes (chunks permuted by chunk ^ (k % 8), as TMA's 128-byte
// swizzle writes a plain box of the tensor as it lies), 1024 bytes between
// 8-row groups (the stride byte offset). wgmma's 64 rows of A are one
// 64-wide box, so the leading byte offset (bytes between 64-wide M boxes)
// is never used; it is set to one box, 8192 bytes. The k-th 16-deep slice
// starts 16 rows on: ``desc + 128 * k``. The tile is 1024-byte aligned. Read
// with the instruction's transpose-A flag (``wgmma_m64nNk16<N, 1, TB>``).
__device__ __forceinline__ uint64_t wgmma_desc_mn_a(const void* tile) {
  return wgmma_desc_mn(tile, 64 * 128);
}

// D[64 x N] (+)= A[64 x 16] . B[16 x N], A bf16 from registers, B bf16
// through an MN-major descriptor (``wgmma_desc_mn``; the instruction's
// transpose-B flag set), fp32 accumulator: thread t of the warpgroup holds
// d[4 j + 2 h + e] = D[16 (t / 32) + (t % 32) / 4 + 8 h][8 j + 2 (t % 4) + e]
// and a[2 i + h] = the bf16 pair A[16 (t / 32) + (t % 32) / 4 + 8 h][8 i +
// 2 (t % 4) + {0, 1}] -- the accumulator layout of a 16-column slice of an
// m64nXk16 product, so an accumulator rounded to bf16 feeds the next
// product without passing through shared memory. N is 32, 64, 96 or 128.
template <int N>
__device__ __forceinline__ void wgmma_m64nNk16_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 96 || N == 128, "unsupported wgmma width");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
  if constexpr (N == 96) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
}

// D[64 x N] (+)= A[64 x 32] . B[32 x N], s8 operands read through K-major
// descriptors (``wgmma_desc``; 8-bit operands have no transposed form), s32
// accumulator in registers in the fp32 form's layout: thread t of the
// warpgroup holds d[4 j + 2 h + e] = D[16 (t / 32) + (t % 32) / 4 + 8 h][8 j +
// 2 (t % 4) + e]. scale_d = 0 overwrites D, 1 accumulates. N is 32, 64, 128,
// 176, 224 or 256 (s8 takes N in steps of 16 past 32, so not bf16's 136 or
// 216). Integer sums are exact, so their order does not matter.
template <int N>
__device__ __forceinline__ void wgmma_m64nNk32_s8(int (&d)[N / 2], uint64_t a, uint64_t b,
                                                  int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 176 || N == 224 || N == 256,
                "unsupported s8 wgmma width");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
          "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  if constexpr (N == 176) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n176k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87"
        "}, %88, %89, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
          "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
          "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
          "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
          "+r"(d[86]), "+r"(d[87])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  if constexpr (N == 224) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n224k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111"
        "}, %112, %113, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
          "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
          "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
          "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
          "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
          "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
          "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
          "+r"(d[110]), "+r"(d[111])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
          "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
          "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
          "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
          "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
          "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
          "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
          "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
          "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
          "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(a), "l"(b), "r"(scale_d));
  }
}

// -- registers -----------------------------------------------------------------

// Move the warpgroup's register budget (all four warps execute it).
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- the ring of kernels 1 and 14 and of the FFN's gate/up pass ------------------
//
// Y = A . W^T, 384 threads a block: warpgroup 0 the producer (one thread
// issues the TMA loads, the others give their registers away), 1 and 2 the
// consumers, each with a 64 x 256 fp32 accumulator in registers. A stage is
// 64 deep in K and holds the two consumers' 64-row A boxes and a 256-row W
// box whose two 128-row halves the two blocks of a cluster load, each
// multicasting its half into both blocks. Shared memory: the stages, the
// consumers' 64 x 64 bf16 output boxes, what else a kernel keeps, then the
// full and empty barriers of each stage.
constexpr int kLinBN = 256, kLinBK = 64, kLinRows = 64, kLinThreads = 384, kLinCluster = 2;
constexpr int kS8BK = 128;  // an s8 stage's depth: 128 int8, the same 128-byte box row
constexpr int kLinABytes = kLinRows * kLinBK * 2;              // one consumer's A box
constexpr int kLinWHalf = kLinBN / kLinCluster;                // W rows a block loads
constexpr int kLinWBytes = kLinWHalf * kLinBK * 2;
constexpr int kLinStageBytes = 2 * kLinABytes + kLinCluster * kLinWBytes;
constexpr int kLinCBox = 64 * 64 * 2;                          // one 64 x 64 bf16 output box

// Dynamic shared memory of a ring of ``stages`` stages with ``boxes`` output
// boxes and ``extra`` bytes more: the 1024-byte alignment pad included.
__host__ __device__ constexpr int ring_smem(int stages, int boxes, int extra) {
  return 1024 + stages * kLinStageBytes + boxes * kLinCBox + extra + 2 * stages * 8;
}

// The 1024-byte boundary a swizzled tile must start on.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// A walker's place in the ring: the stage and the phase parity it waits for.
template <int STAGES>
struct RingPos {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
};

// Thread 0 initialises the barriers; then the blocks of the cluster wait
// for each other, so that each block's barriers exist before another
// block arrives on them. Every thread calls it. A stage is released by each
// consumer warp of ``cluster`` blocks (1: of this block alone).
template <int STAGES>
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty,
                                          int cluster = kLinCluster) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * cluster);  // each consumer warp of those blocks
    }
    mbar_fence_init();
  }
  cluster_sync();
}

// The producer's loads of one output tile, k_blocks stages: consumer 0's A
// box at row ``row0`` of mA0 and consumer 1's at ``row1`` of mA1 where they
// hold rows (a0, a1), and, where ``w``, this block's W half at row ``wrow``
// of mW, multicast into both blocks. ``bytes``: what lands in this block's
// stage from both blocks' loads together. ``bk``: a stage's depth in
// elements, 128 bytes a box row (kLinBK bf16; 128 for int8).
template <int STAGES>
__device__ __forceinline__ void produce_tile(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                             RingPos<STAGES>& pos, const CUtensorMap* mA0,
                                             int row0, bool a0, const CUtensorMap* mA1, int row1,
                                             bool a1, const CUtensorMap* mW, int wrow, bool w,
                                             uint32_t bytes, int k_blocks, int bk = kLinBK) {
  const uint32_t rank = cluster_rank();
  for (int kb = 0; kb < k_blocks; ++kb) {
    unsigned char* stage = smem + pos.s * kLinStageBytes;
    mbar_wait(&empty[pos.s], pos.phase ^ 1);
    mbar_expect_tx(&full[pos.s], bytes);
    if (a0) tma_load_2d(stage, mA0, &full[pos.s], kb * bk, row0);
    if (a1) tma_load_2d(stage + kLinABytes, mA1, &full[pos.s], kb * bk, row1);
    if (w)
      tma_load_2d_multicast(stage + 2 * kLinABytes + rank * kLinWBytes, mW, &full[pos.s],
                            kb * bk, wrow, (1 << kLinCluster) - 1);
    pos.next();
  }
}

// The producer's last act: stay until every consumer of the cluster has
// released every stage, so that no arrival or multicast can reach this
// block after it exits.
template <int STAGES>
__device__ __forceinline__ void drain(uint64_t* empty, RingPos<STAGES>& pos) {
  for (int i = 0; i < STAGES; ++i) {
    mbar_wait(&empty[pos.s], pos.phase ^ 1);
    pos.next();
  }
}

// The producer's loads of one output tile of a product whose operands lie
// as the backward's do, stages kb0 .. kb0 + k_blocks of 64 along K, each
// box a plain 64 x 64 box of the tensor as it lies (no transposed copy
// anywhere): A (M x K) stored M rows of K, or, where A_MN, K rows of M
// (dy^T: the tokens are K); B (K x N) stored K rows of N (a weight read
// along its rows, or the tokens of x or h). Consumer c's A box holds rows
// m0 + 64 c .. + 63 of A where (a0, a1); the stage's BOXES 64-column B
// boxes at n0, n0 + 64, ... lie one after another (``wgmma_desc_mn``'s
// leading offset kMnBBox), and block ``rank`` loads boxes BOXES / 2 rank
// .. BOXES / 2 (rank + 1) - 1 of them, those that start before N,
// multicast into both blocks of the cluster. ``bytes``: what lands in this
// block's stage from both blocks' loads together.
constexpr int kMnBBox = kLinBK * 64 * 2;  // one 64-deep x 64-column B box
static_assert(4 * kMnBBox == kLinCluster * kLinWBytes, "the B boxes fill the stage's W room");

template <int STAGES, bool A_MN, int BOXES = 4>
__device__ __forceinline__ void produce_tile_mn(unsigned char* smem, uint64_t* full,
                                                uint64_t* empty, RingPos<STAGES>& pos,
                                                const CUtensorMap* mA, int m0, bool a0, bool a1,
                                                const CUtensorMap* mB, int n0, int N,
                                                uint32_t bytes, int kb0, int k_blocks) {
  const int rank = (int)cluster_rank();
  for (int kb = kb0; kb < kb0 + k_blocks; ++kb) {
    unsigned char* stage = smem + pos.s * kLinStageBytes;
    const int k = kb * kLinBK;
    mbar_wait(&empty[pos.s], pos.phase ^ 1);
    mbar_expect_tx(&full[pos.s], bytes);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (!(c ? a1 : a0)) continue;
      const int m = m0 + c * kLinRows;
      tma_load_2d(stage + c * kLinABytes, mA, &full[pos.s], A_MN ? m : k, A_MN ? k : m);
    }
#pragma unroll
    for (int b = 0; b < BOXES / kLinCluster; ++b) {
      const int j = BOXES / kLinCluster * rank + b;
      if (n0 + 64 * j < N)
        tma_load_2d_multicast(stage + 2 * kLinABytes + j * kMnBBox, mB, &full[pos.s],
                              n0 + 64 * j, k, (1 << kLinCluster) - 1);
    }
    pos.next();
  }
}

// Consumer c's products of one output tile: acc = A_c . W^T over k_blocks
// stages, four m64n(2R)k16 wgmmas a stage (R = 128: the whole 256-row W
// box), its previous wgmma group kept in flight. Each stage is released in
// both blocks of the cluster (lane r of each warp arrives in block r) once
// the wgmmas that read it are done. A_MN, B_MN: the stage was loaded by
// ``produce_tile_mn``, A stored K rows of M where A_MN, B the 2R / 64
// MN-major boxes of K rows of N (B_MN), read with wgmma's transpose flags.
// An int accumulator takes the s8 form (``wgmma_m64nNk32_s8``: a stage of
// kS8BK = 128 int8 deep, four 32-deep slices).
template <int STAGES, bool A_MN = false, bool B_MN = false, class Acc, int R>
__device__ __forceinline__ void consume_tile(Acc (&acc)[R], unsigned char* smem,
                                             uint64_t* full, uint64_t* empty,
                                             RingPos<STAGES>& pos, int c, int k_blocks) {
  const int lane = threadIdx.x % 32;
  auto release = [&](int stage) {
    if (lane < kLinCluster) mbar_arrive_cluster(&empty[stage], lane);
  };
  // descriptor steps of one 16-deep slice: 32 bytes along a K-major row, 16
  // rows of an MN-major box
  constexpr int a_step = A_MN ? 128 : 2, w_step = B_MN ? 128 : 2;
  int prev = 0;
  fence_regs(acc);
  for (int kb = 0; kb < k_blocks; ++kb) {
    mbar_wait(&full[pos.s], pos.phase);
    wgmma_fence();
    unsigned char* stage = smem + pos.s * kLinStageBytes;
    const uint64_t da =
        A_MN ? wgmma_desc_mn_a(stage + c * kLinABytes) : wgmma_desc(stage + c * kLinABytes);
    const uint64_t dw = B_MN ? wgmma_desc_mn(stage + 2 * kLinABytes, kMnBBox)
                             : wgmma_desc(stage + 2 * kLinABytes);
#pragma unroll
    for (int k = 0; k < kLinBK / 16; ++k) {  // 32-byte slices of a 128-byte box row
      if constexpr (std::is_same_v<Acc, int>) {
        static_assert(!A_MN && !B_MN, "8-bit wgmma operands are K-major");
        wgmma_m64nNk32_s8<2 * R>(acc, da + 2 * k, dw + 2 * k, kb > 0 || k > 0);
      } else {
        wgmma_m64nNk16<2 * R, A_MN, B_MN>(acc, da + a_step * k, dw + w_step * k, kb > 0 || k > 0);
      }
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
}

// Consumer c's 64 rows x 64 columns of bf16 output through a swizzled
// shared-memory box to (col, row) of ``map`` by TMA, which clips at the
// edges; stored only where ``valid``. ``pair(i)`` packs the two values of
// accumulator indices i, i + 1 with i = 4 (8 q + j) + 2 h: columns
// 8 j + 2 (lane % 4) + {0, 1} of the box, row r + 8 h. The box is written
// once its store of NB boxes back has read it. Call it with q a constant
// (an unrolled loop), so that acc stays in registers.
template <int NB, class Pair>
__device__ __forceinline__ void store_box(unsigned char* box, const CUtensorMap* map, int col,
                                          int row, bool valid, int c, int q, Pair pair) {
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int r = tid / 32 * 16 + lane / 4;  // and r + 8; r % 8 == lane / 4
  if (tid == 0) tma_store_wait_read<NB - 1>();
  named_barrier_sync(1 + c, 128);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(box + (r + 8 * h) * 128 + ((j ^ (lane / 4)) << 4) +
                                   (lane % 4) * 4) = pair(4 * (8 * q + j) + 2 * h);
  fence_async_smem();
  named_barrier_sync(1 + c, 128);
  if (tid == 0 && valid) {
    tma_store_2d(map, box, col, row);
    tma_store_commit();
  }
}

// -- host: tensor maps ---------------------------------------------------------

// Returned by a launcher when a tensor map cannot be encoded.
constexpr int kTensorMapError = -1;

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so that the library needs no link to libcuda.
using TensorMapEncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                       const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                       const cuuint32_t*, CUtensorMapInterleave,
                                       CUtensorMapSwizzle, CUtensorMapL2promotion,
                                       CUtensorMapFloatOOBfill);

inline TensorMapEncodeFn tensor_map_encoder() {
  static const TensorMapEncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncodeFn>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major bf16 matrix (rows x cols, row stride ``stride`` elements,
// cols where 0) cut into boxes of box_rows x box_cols with the 128-byte
// swizzle (box_cols * 2 <= 128) or, where ``swizzle`` is false, laid out
// densely row after row (box_cols * 2 a multiple of 16, box_cols <= 256);
// zero fill past the edges. Returns false when it cannot be encoded.
inline bool tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, uint32_t elem_bytes,
                          const void* base, uint64_t rows, uint64_t cols, uint32_t box_rows,
                          uint32_t box_cols, bool swizzle, uint64_t stride) {
  const TensorMapEncodeFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {(stride ? stride : cols) * elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool tensor_map_bf16(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                            uint32_t box_rows, uint32_t box_cols, bool swizzle = true,
                            uint64_t stride = 0) {
  return tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols, box_rows,
                       box_cols, swizzle, stride);
}

// The same for an int8 matrix (raw bytes; the zero fill is int8 0), box_cols
// <= 128, and for an fp32 one, box_cols <= 32, both with the 128-byte swizzle.
inline bool tensor_map_i8(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                          uint32_t box_rows, uint32_t box_cols) {
  return tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, rows, cols, box_rows,
                       box_cols, true, 0);
}

inline bool tensor_map_f32(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                           uint32_t box_rows, uint32_t box_cols) {
  return tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, rows, cols, box_rows,
                       box_cols, true, 0);
}

// ``kernel`` launched persistent: as many blocks of ``threads`` as the
// device has SMs, no more than ``items``. The shared-memory attribute is set
// and the SM count read once a device and instantiation, kept in ``sms``, a
// table of the calling file (a static local of a template would be one
// symbol shared by every library that defines it).
template <class Kernel, class... Args>
inline int launch_persistent(Kernel kernel, int (&sms)[64], int threads, int smem, int items,
                             cudaStream_t stream, Args... args) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int& n_sm = sms[device % 64];
  if (n_sm == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<items < n_sm ? items : n_sm, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Launches ``kernel`` in clusters of ``cluster`` blocks of kLinThreads
// threads with ``smem`` bytes of shared memory: as many clusters as the card
// holds at once (asked once a device, kept in ``resident``), and no more
// than ``tiles``, the cluster work items.
template <class Kernel, class... Args>
inline int launch_clusters(Kernel kernel, int (&resident)[64], int smem, int tiles, int cluster,
                           cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(kLinThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int& clusters = resident[device % 64];
  if (clusters == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    config.gridDim = dim3(cluster);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return (int)err;
    if (clusters == 0) return (int)cudaErrorInvalidConfiguration;
  }
  config.gridDim = dim3(cluster * (tiles < clusters ? tiles : clusters));
  err = cudaLaunchKernelEx(&config, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace swift
