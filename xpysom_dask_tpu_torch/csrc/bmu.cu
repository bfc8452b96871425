// WMMA GEMM-form BMU searches for Hopper (sm_90a): K1-kb (K1 with K summed
// slab by slab) and K2 (top-2), two instances of the one-block search in
// gemm_bmu.cuh, each block owning 64 sample rows. K1 and K3 run on wgmma
// (gemm_sm90.cu).
//
// Replaces the Pallas kernels _kernel_gemm_argmin_kb and _kernel_gemm_top2
// of xpysom_dask_tpu/ops/pallas/bmu.py; gemm_bmu.cuh describes the product
// sets and the design.
//
// K1-kb: on the TPU the K-blocked grid shrank the per-step VMEM working set
// at wide D. On Hopper the loop over BK-deep chunks already bounds the
// staged working set whatever K is, so K-blocking changes only the f32
// association of the sum (slab by slab, as d_acc += dot(a_k, w_k)); the
// instance keeps that association so its values follow the Pallas
// kernel's, and costs one extra fragment set and one elementwise add per
// slab, plus the depth the wrapper pads to a multiple of kblock. On one
// H100 (chip_smoke.py) it took 13.58 ms against the WMMA K1's 8.57 at
// packed (16384, 16384, 512), K = 1552 padded to 2048.
//
// What bounds them on the H100: at the flagship shape (16384 rows, 16384
// nodes) K2 is 5.6e10 bf16 multiply-adds (K = 208); at D = 512 packed K1-kb
// does 2.1e11 (K = 1552, kblock 512). Both lie far above the card's
// bytes-to-FLOP line, so the tensor cores should bound them. This version
// reaches them through WMMA without asynchronous copies, so staging and the
// shared-memory finish stall them; gemm_sm90.cu's pipeline is their next
// step.

#include "gemm_bmu.cuh"

namespace {

using namespace xps_gemm;

template <Products P, bool TOP2>
__global__ void __launch_bounds__(THREADS)
gemm_bmu_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w, int n,
                int k, int xy, int ldw, int kblock, int* __restrict__ idx_out,
                float* __restrict__ val_out, int* __restrict__ idx2_out,
                float* __restrict__ val2_out) {
  __shared__ __align__(128) __nv_bfloat16 a_s[A_ELEMS];
  __shared__ __align__(128) __nv_bfloat16 b_s[B_ELEMS];
  __shared__ __align__(128) float d_s[BM * LDD];
  const Stage st{a_s, b_s, d_s};
  gemm_bmu_rows<P, TOP2>(st, blockIdx.x * BM, a, w, n, k, xy, ldw, kblock, idx_out, val_out,
                         idx2_out, val2_out);
}

using bf16p = const __nv_bfloat16*;

}  // namespace

extern "C" {

// a: (n, k) bf16 row-major; w: (k, ldw) bf16 row-major, columns >= xy
// ignored. k % 8 == 0, ldw % 8 == 0, both pointers 16-byte aligned.
// K1-kb: K1 with K summed slab by slab, kblock a positive multiple
// of 32 that divides k. Returns cudaErrorInvalidValue for another kblock,
// else cudaGetLastError() after the launch.
int xps_bmu_argmin_kb(const void* a, const void* w, int n, int k, int xy, int ldw,
                      int kblock, void* idx, void* val, void* stream) {
  if (kblock <= 0 || kblock % BK || k % kblock) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    gemm_bmu_kernel<Products::KBLOCKED, false>
        <<<(n + BM - 1) / BM, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<bf16p>(a), static_cast<bf16p>(w), n, k, xy, ldw, kblock,
            static_cast<int*>(idx), static_cast<float*>(val), nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

int xps_bmu_top2(const void* a, const void* w, int n, int k, int xy, int ldw,
                 void* idx, void* val, void* idx2, void* val2, void* stream) {
  if (n > 0) {
    gemm_bmu_kernel<Products::PACKED, true>
        <<<(n + BM - 1) / BM, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<bf16p>(a), static_cast<bf16p>(w), n, k, xy, ldw, 0,
            static_cast<int*>(idx), static_cast<float*>(val), static_cast<int*>(idx2),
            static_cast<float*>(val2));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
