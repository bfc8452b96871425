// GEMM-form BMU searches for Hopper (sm_90a): K1 (argmin), K1-kb (its
// K-blocked form), K2 (top-2) and K3 (mode 'split3'), four instances of the
// one-block search in gemm_bmu.cuh, each block owning 64 sample rows.
//
// Replaces the Pallas kernels _kernel_gemm_argmin, _kernel_gemm_argmin_kb,
// _kernel_gemm_top2 and _kernel_split3 of xpysom_dask_tpu/ops/pallas/bmu.py;
// gemm_bmu.cuh describes the product sets and the design.
//
// K1-kb: on the TPU the K-blocked grid shrank the per-step VMEM working set
// at wide D. On Hopper K1's loop over BK-deep chunks already bounds the
// staged working set whatever K is, so K-blocking changes only the f32
// association of the sum (slab by slab, as d_acc += dot(a_k, w_k)); the
// instance keeps that association so its values follow the Pallas
// kernel's, and costs one extra fragment set and one elementwise add per
// slab, plus the depth the wrapper pads to a multiple of kblock. On one
// H100 (chip_smoke.py) it took 13.58 ms against K1's 8.57 at packed
// (16384, 16384, 512), K = 1552 padded to 2048.
//
// What bounds them on the H100: at the flagship shape (16384 rows, 16384
// nodes) one chunk is 5.6e10 bf16 multiply-adds for K1 (K = 208) and
// 3 x 1.7e10 = 5.2e10 for K3 (D = 64); at D = 512 packed K1-kb does
// 2.1e11 (K = 1552, kblock 512). All lie far above the card's
// bytes-to-FLOP line, so the tensor cores should bound them. This version
// reaches them through WMMA without asynchronous copies, so staging and the
// shared-memory finish stall them; wgmma with TMA-fed pipelined tiles is
// later work.

#include "gemm_bmu.cuh"

namespace {

using namespace xps_gemm;

template <Products P, bool TOP2>
__global__ void __launch_bounds__(THREADS)
gemm_bmu_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ a_lo,
                const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ w_lo,
                const float* __restrict__ w_sq, int n, int k, int xy, int ldw, int kblock,
                int* __restrict__ idx_out, float* __restrict__ val_out,
                int* __restrict__ idx2_out, float* __restrict__ val2_out) {
  using L = Layout<P>;
  Stage st;
  if constexpr (L::ALIAS) {  // one array: the tile over the staging
    __shared__ __align__(128) unsigned char smem[L::BYTES];
#pragma unroll
    for (int s = 0; s < L::OPS; ++s) {
      st.sa[s] = reinterpret_cast<__nv_bfloat16*>(smem) + s * A_ELEMS;
      st.sb[s] = reinterpret_cast<__nv_bfloat16*>(smem) + L::OPS * A_ELEMS + s * B_ELEMS;
    }
    st.sd = reinterpret_cast<float*>(smem);
  } else {  // three arrays side by side
    __shared__ __align__(128) __nv_bfloat16 a_s[L::OPS * A_ELEMS];
    __shared__ __align__(128) __nv_bfloat16 b_s[L::OPS * B_ELEMS];
    __shared__ __align__(128) float d_s[BM * LDD];
#pragma unroll
    for (int s = 0; s < L::OPS; ++s) {
      st.sa[s] = a_s + s * A_ELEMS;
      st.sb[s] = b_s + s * B_ELEMS;
    }
    st.sd = d_s;
  }
  gemm_bmu_rows<P, TOP2>(st, blockIdx.x * BM, a, a_lo, w, w_lo, w_sq, n, k, xy, ldw, kblock,
                         idx_out, val_out, idx2_out, val2_out);
}

using bf16p = const __nv_bfloat16*;

}  // namespace

extern "C" {

// a: (n, k) bf16 row-major; w: (k, ldw) bf16 row-major, columns >= xy
// ignored. k % 8 == 0, ldw % 8 == 0, both pointers 16-byte aligned.
// Returns cudaGetLastError() after the launch.
int xps_bmu_argmin(const void* a, const void* w, int n, int k, int xy, int ldw,
                   void* idx, void* val, void* stream) {
  if (n > 0) {
    gemm_bmu_kernel<Products::PACKED, false>
        <<<(n + BM - 1) / BM, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<bf16p>(a), nullptr, static_cast<bf16p>(w), nullptr, nullptr, n, k,
            xy, ldw, 0, static_cast<int*>(idx), static_cast<float*>(val), nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// As xps_bmu_argmin, with K summed slab by slab: kblock a positive multiple
// of 32 that divides k. Returns cudaErrorInvalidValue for another kblock,
// else cudaGetLastError() after the launch.
int xps_bmu_argmin_kb(const void* a, const void* w, int n, int k, int xy, int ldw,
                      int kblock, void* idx, void* val, void* stream) {
  if (kblock <= 0 || kblock % BK || k % kblock) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    gemm_bmu_kernel<Products::KBLOCKED, false>
        <<<(n + BM - 1) / BM, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<bf16p>(a), nullptr, static_cast<bf16p>(w), nullptr, nullptr, n, k,
            xy, ldw, kblock, static_cast<int*>(idx), static_cast<float*>(val), nullptr,
            nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

int xps_bmu_top2(const void* a, const void* w, int n, int k, int xy, int ldw,
                 void* idx, void* val, void* idx2, void* val2, void* stream) {
  if (n > 0) {
    gemm_bmu_kernel<Products::PACKED, true>
        <<<(n + BM - 1) / BM, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<bf16p>(a), nullptr, static_cast<bf16p>(w), nullptr, nullptr, n, k,
            xy, ldw, 0, static_cast<int*>(idx), static_cast<float*>(val),
            static_cast<int*>(idx2), static_cast<float*>(val2));
  }
  return static_cast<int>(cudaGetLastError());
}

// xh, xl: (n, k) bf16 row-major; wh, wl: (k, ldw) bf16 row-major, columns
// >= xy ignored; w_sq: (>= xy,) f32. k % 8 == 0, ldw % 8 == 0, the four
// bf16 pointers 16-byte aligned. Returns cudaGetLastError() after the launch.
int xps_bmu_split3(const void* xh, const void* xl, const void* wh, const void* wl,
                   const void* w_sq, int n, int k, int xy, int ldw, void* idx, void* val,
                   void* stream) {
  if (n > 0) {
    gemm_bmu_kernel<Products::SPLIT3, false>
        <<<(n + BM - 1) / BM, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<bf16p>(xh), static_cast<bf16p>(xl), static_cast<bf16p>(wh),
            static_cast<bf16p>(wl), static_cast<const float*>(w_sq), n, k, xy, ldw, 0,
            static_cast<int*>(idx), static_cast<float*>(val), nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
