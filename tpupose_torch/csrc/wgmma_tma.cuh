// Hopper building blocks shared by the kernels written for sm_90a
// (bottleneck.cu, K2; bridge.cu, K3; flash_attention.cu, K8;
// flash_attention_bwd.cu, K8b; int8_bottleneck.cu, K5; int8_deconv.cu,
// K6): mbarriers, TMA tile loads (with cluster multicast) and stores,
// shared-memory matrix descriptors for 128-byte swizzled tiles, and
// warpgroup matrix products (wgmma m64n64k16 and m64n16k16, bf16 in,
// float32 accumulators; m64n32k32, m64n64k32 and m64n128k32, s8 in, s32
// accumulators), plus the host-side encoding of tensor maps.
//
// Layouts. Every operand tile in shared memory is what a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 128 bytes (64 bf16), each
// 16-byte chunk c of row r stored at chunk c ^ (r % 8), in 1024-byte atoms
// of 8 rows that start 1024-byte aligned. Such a tile is read by wgmma as
//   - K-major (desc_k): a row is one M (or N) index, the 64 elements of the
//     row run along K; a k16 step advances the start by 32 bytes;
//   - MN-major (desc_mn): a row is one K index, the 64 elements run along
//     N; a k16 step advances the start by 16 rows = 2048 bytes.
// In both the 8-row atoms lie 1024 bytes apart. Every MN-major operand
// here is 64 wide in N, so one 128-byte row spans its whole N and the
// descriptor's second offset is never read: desc_mn sets both to 1024.
//
// Accumulators of m64nNk16 (thread t of the warpgroup, warp w = t / 32,
// lane l): d[4j + 2h + e] is row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4)
// + e. An A operand from registers (RS form) is, per warp, the A fragment
// of mma.m16n8k16 over that warp's 16 rows: a0 (row l/4, k 2(l%4)..+1),
// a1 (row l/4 + 8, same k), a2 (row l/4, k 8 + 2(l%4)..), a3 (row l/4 + 8,
// k 8 + ...), two bf16 per register.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy and the cluster
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the producer's arrival, announcing `bytes` of TMA writes to come
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive on the barrier at the same shared-memory offset in CTA `rank` of
// the cluster (this CTA's own when rank is its own)
__device__ __forceinline__ void bar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`: the
// k-th completion (k = 0, 1, ...) has parity k & 1
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// -- clusters -----------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// -- TMA ----------------------------------------------------------------------

// the same box into the same offset of every CTA in `mask`, each CTA's
// barrier at `bar`'s offset receiving the bytes it got
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// a box from shared memory (written by generic stores: fence them with
// fence_async_smem first) to the tensor; elements outside it are skipped
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the issuing thread's bulk stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory, visible to the async proxy (TMA,
// wgmma) after a barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma --------------------------------------------------------------------

// descriptor of a 128-byte-swizzled tile at p (see the top of this file)
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_k(const void* p) { return desc_sw128(p, 16, 1024); }
__device__ __forceinline__ uint64_t desc_mn(const void* p) { return desc_sw128(p, 1024, 1024); }

// before the first wgmma, and whenever registers it reads (accumulators,
// A fragments) were written by other instructions since the last one
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulators across
// the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

#define TP_WG_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TP_WG_OUT32(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d (64 x 64) = A (64 x 16, K-major at da) * B (16 x 64 at db; K-major
// when TRANS_B is 0, MN-major when 1) + (accumulate ? d : 0)
template <int TRANS_B>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                       int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TP_WG_D32
      ", %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : TP_WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// the same with B 16 x 16: d (64 x 16, 8 per thread: d[4j + 2h + e] as
// above, j = 0, 1)
template <int TRANS_B>
__device__ __forceinline__ void mma_ss_n16(float (&d)[8], uint64_t da, uint64_t db,
                                           int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, %11;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 64) = A (64 x 16 in registers, see above) * B (16 x 64 at db)
// + (accumulate ? d : 0)
template <int TRANS_B>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TP_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : TP_WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

#undef TP_WG_D32
#undef TP_WG_OUT32

// -- int8 wgmma (s8 x s8 -> s32) ------------------------------------------------
//
// m64nNk32: both operands K-major (8-bit wgmma has no transposed form), so
// a 128-byte swizzled row holds 128 K elements and a k32 step advances the
// descriptors' start by 32 bytes, as a k16 step of bf16 does; desc_k
// describes int8 tiles unchanged. The s32 accumulators lie as the float32
// ones above; an A operand from registers is, per warp, the A fragment of
// mma.m16n8k32 over that warp's 16 rows: a0 (row l/4, k 4(l%4)..+3), a1
// (row l/4 + 8, same k), a2 (row l/4, k 16 + 4(l%4)..), a3 (row l/4 + 8,
// k 16 + ...), four s8 per register: what ldmatrix_x4 gives when lanes
// 0-15 address rows 0-15 at byte 0 of the step and lanes 16-31 the same
// rows at byte 16.

__device__ __forceinline__ void mma_s8_ss_n32(int (&d)[16], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma_s8_ss_n64(int (&d)[32], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma_s8_rs_n64(int (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void mma_s8_ss_n128(int (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma_s8_rs_n128(int (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x N, N / 2 per thread) = A (64 x 32 K-major at da, or in
// registers) * B (N x 32 K-major at db) + (accumulate ? d : 0), N 32, 64 or
// 128 (32: SS only)
template <int N>
__device__ __forceinline__ void mma_s8_ss(int (&d)[N / 2], uint64_t da, uint64_t db,
                                          int accumulate) {
  if constexpr (N == 32)
    mma_s8_ss_n32(d, da, db, accumulate);
  else if constexpr (N == 64)
    mma_s8_ss_n64(d, da, db, accumulate);
  else
    mma_s8_ss_n128(d, da, db, accumulate);
}
template <int N>
__device__ __forceinline__ void mma_s8_rs(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  if constexpr (N == 64)
    mma_s8_rs_n64(d, a, db, accumulate);
  else
    mma_s8_rs_n128(d, a, db, accumulate);
}

// 2^x on the MUFU unit (flush-to-zero; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// -- host: tensor maps ----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the libraries link only
// the runtime, which hands out the driver's entry point
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of rank R over elements of type `type` (dims innermost
// first, strides in bytes of dims 1..R-1) with 128-byte swizzle and zero
// fill outside the tensor. Returns 0 or a CUDA error code.
template <int R>
inline int encode_tiled(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                        const uint64_t (&dims)[R], const uint64_t (&strides)[R - 1],
                        const uint32_t (&box)[R]) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  // The encoder is a driver call and checks `base` against the calling
  // thread's current context. A thread whose first CUDA work is this call
  // (autograd's device thread running a backward, say) has none yet: make
  // the primary context of base's device current, once per thread.
  static thread_local bool bound = false;
  if (!bound) {
    cudaPointerAttributes a;
    cudaError_t e = cudaPointerGetAttributes(&a, base);
    if (e == cudaSuccess) e = cudaSetDevice(a.device);
    if (e != cudaSuccess) return (int)e;
    bound = true;
  }
  cuuint64_t d[R], s[R > 1 ? R - 1 : 1];
  cuuint32_t b[R], e[R];
  for (int i = 0; i < R; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
  }
  for (int i = 0; i + 1 < R; ++i) s[i] = strides[i];
  const CUresult r = fn(map, type, R, const_cast<void*>(base), d, s, b, e,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int R>
inline int encode_bf16(CUtensorMap* map, const void* base, const uint64_t (&dims)[R],
                       const uint64_t (&strides)[R - 1], const uint32_t (&box)[R]) {
  return encode_tiled<R>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box);
}

// int8 data: TMA moves bytes, so the unsigned 8-bit type serves
template <int R>
inline int encode_s8(CUtensorMap* map, const void* base, const uint64_t (&dims)[R],
                     const uint64_t (&strides)[R - 1], const uint32_t (&box)[R]) {
  return encode_tiled<R>(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, dims, strides, box);
}

}  // namespace wg
