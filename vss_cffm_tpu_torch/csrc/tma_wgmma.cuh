// Hopper-only helpers (sm_90a): mbarriers, TMA tile loads, wgmma with A in
// registers and B in shared memory, and the shared-memory matrix descriptors
// wgmma reads B through.
//
// Tiles come from TMA with the 128-byte swizzle (rows of 128 bytes: head dim
// 64 in bf16) or the 64-byte one (rows of 64 bytes: head dim 32). Both XOR
// the 16-byte chunk index with address bits above the row: chunk ^ (row & 7)
// at 128 bytes, chunk ^ ((row >> 1) & 3) at 64 (vss::swz in mma_sync.cuh is
// the same map). wgmma's descriptors name the same swizzle, so what TMA
// writes is what wgmma reads, for tiles based on a multiple of 1024 bytes.
//
// Fragment layouts (g = lane / 4, t = lane % 4, warp w of the warpgroup owns
// rows 16w .. 16w + 15 of the 64-row tile):
//   A (m64 x k16, registers): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//     a3 (g+8, 2t+8..): mma.sync m16n8k16's A fragment, per warp;
//   D (m64 x nN, f32): d[4j + 0, 1] (g, 8j + 2t + 0, 1), d[4j + 2, 3] (g + 8, ...):
//     mma.sync's C fragment of n-block j, per warp.
// So the accumulators of n-blocks 2i and 2i + 1, packed to bf16, are the A
// fragment of k-step i of the next product, as with mma.sync.
#pragma once

#include <cuda.h>  // CUtensorMap (a type only: nothing links libcuda)
#include <stdint.h>

#include "mma_sync.cuh"

namespace vss {

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive and expect `bytes` more from async copies before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// ---- TMA -------------------------------------------------------------------

// the box of a 3-d tensor map at (c0, c1, c2) (innermost first) into shared
// memory; completion counts its bytes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a B tile in shared memory: start address, the stride between
// 8-row groups (sbo) and, MN-major, between 64- or 32-element column atoms
// (lbo; unused when the product's N is one atom, as here), and the swizzle
// (1: 128 bytes, 2: 64 bytes). The start is moved by whole 16-byte units: a
// k-step inside a K-major row adds 32 bytes, and the swizzle's base offset
// stays 0 while the tile sits on a 1024-byte boundary.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)swizzle << 62;
}

// order register writes (accumulators, A fragments) before the next wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of r across this point (the
// registers of an asynchronous product are read after its wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, f32) += a (64 x 16, bf16 registers) b (16 x 64, bf16 in shared
// memory); TB: b is MN-major (N contiguous) when 1, K-major when 0
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

// d (64 x 32, f32) += a (64 x 16, registers) b (16 x 32), as above
template <int TB>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

}  // namespace vss
