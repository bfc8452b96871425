// Exact-f32 GEMM BMU search for Hopper (sm_90a): K4.
//
// Replaces the Pallas kernel _kernel_highest of
// xpysom_dask_tpu/ops/pallas/bmu.py (bmu_euclidean, mode 'highest'):
//     d[n, j] = -2 * (x[n] . w[j]) + w_sq[j]
// with the dot in full f32 (Precision.HIGHEST on the TPU), folded into a
// running first-index argmin. It serves bmu_precision='highest' for the
// euclidean searches and the even-p norm_p expansion (x and w of width
// D(p+1), w_sq = 0), which is where the exactness matters: the expansion
// cancels catastrophically below f32.
//
// Design: the register-tiled search of tile_argmin.cuh with an FMA term,
// one f32 FMA per (row, codebook row, d) in index order of d. No tensor
// cores: TF32 would drop the exactness this mode exists for, and a bf16
// split is what mode 'packed' (K1) already does.
//
// What bounds it on the H100: at the flagship chunk (16384 x 16384, D = 64)
// it is 1.7e10 FMAs, 0.51 ms at the card's 67 TFLOP/s FP32 (700 W); the
// operands are 8 MB, so the FP32 pipes, not memory, bound it. This version
// reads each operand from shared memory once per 4 FMAs (one 16-byte vector
// per 4 x 4 register tile and d) with a barrier per 16-deep chunk, so
// staging and issue overheads stand between it and that bound.

#include "tile_argmin.cuh"

namespace {

struct DotTerm {
  static constexpr bool kChain = false;
  const float* w_sq;
  __device__ __forceinline__ float operator()(float acc, float a, float b) const {
    return fmaf(a, b, acc);
  }
  // -2 * acc is exact, so one fma rounds like -2 * acc + w_sq
  __device__ __forceinline__ float finish(float acc, int col) const {
    return fmaf(-2.0f, acc, w_sq[col]);
  }
};

}  // namespace

extern "C" {

// x: (n, d) f32 row-major; w: (xy, d) f32 row-major; w_sq: (xy,) f32;
// idx: (n,) int32 and val: (n,) f32 outputs.
int xps_bmu_highest(const void* x, const void* w, const void* w_sq, int n, int d,
                    int xy, void* idx, void* val, void* stream) {
  return xps_tile::launch_tile_argmin(
      static_cast<const float*>(x), static_cast<const float*>(w), n, d, xy,
      DotTerm{static_cast<const float*>(w_sq)}, static_cast<int*>(idx),
      static_cast<float*>(val), stream);
}

}  // extern "C"
