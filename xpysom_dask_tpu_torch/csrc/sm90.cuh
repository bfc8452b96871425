// Hopper (sm_90a) primitives shared by the wgmma searches: K4
// (highest.cu) and K1, K3 (gemm_sm90.cu). One copy of each inline-PTX
// helper: shared-memory addresses, bulk copies and mbarriers, the
// cluster's rank, barrier, multicast copy and remote arrival, wgmma
// shared-memory descriptors, and the accumulator fence.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace xps_sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}

// before an initialised mbarrier's memory is initialised again
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// after the barriers of a block are initialised, before any thread uses
// them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces `bytes` of bulk-copy traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one contiguous global block into shared memory (both 16-byte aligned,
// bytes a multiple of 16), completion counted in bytes on the mbarrier
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Thread-block clusters. The block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: arrive (release), then wait
// (acquire). Not .aligned: a warp's lanes may reach it apart.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

// bulk_copy read once from global memory and written to the same offset
// of the shared memory of every block of the cluster in `mask`, each
// block's bytes counted on its mbarrier at bar's offset
__device__ __forceinline__ void bulk_copy_multicast(void* dst, const void* src, int bytes,
                                                    uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// one arrival on the mbarrier at bar's offset in block `rank` of the
// cluster, this block's own included, with mbarrier.arrive's default
// semantics (release at CTA scope). Release at cluster scope
// (.release.cluster) made each arrival a fence: on one H100 it slowed a
// pair's feed and K1 about twofold.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      ::"r"(smem_addr(bar)), "r"(rank)
      : "memory");
}

// wgmma descriptor of a no-swizzle K-major operand at p: core matrices of
// 8 rows x 16 bytes (4 f32/TF32 or 8 bf16 values); lbo: bytes between the
// core matrices adjacent along K, sbo: bytes between 8-row groups. The
// same for f32 and bf16 operands: only the core matrix's width in
// elements differs.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3ffff) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// keeps the compiler from moving accumulator accesses across the async
// wgmma operations
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool lex_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

}  // namespace xps_sm90
