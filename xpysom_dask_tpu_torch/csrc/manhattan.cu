// L1 distance matrix for Hopper (sm_90a): K8.
//
// Replaces the Pallas kernel _kernel of xpysom_dask_tpu/ops/pallas/
// manhattan.py (manhattan_distance, the matrix behind ops/distances.py's
// 'manhattan' and so behind XPySom.activate under that activation):
//     out[n, j] = sum_d |x[n, d] - w[j, d]|
// for every sample row n and codebook row j, into the (N, XY) f32 result.
//
// Design: the register-tiled sums of tile_argmin.cuh with K5's L1 term and
// the store epilogue in place of the argmin: 64 rows per block looping over
// all 64-row codebook tiles, 4 x 4 accumulators per thread, the sum over d
// serial in index order with __fsub_rn/__fadd_rn. The Pallas kernel and the
// plain version add in the same order from 0, so K8 equals both bit for
// bit. Rows >= n and columns >= xy are never written.
//
// What bounds it on the H100: at the flagship chunk (16384 x 16384, D = 64)
// it is 1.7e10 L1 terms of two FP32 instructions each, 1.0 ms of issue at
// the card's 33.5e12 FP32 instructions/s (700 W), against 1.07 GB of output
// at 3.35 TB/s, 0.32 ms: the FP32 pipes bound it, and the stores (one
// 16-byte vector per thread and row, fire and forget) should hide behind the
// sums of the next tile.

#include "tile_argmin.cuh"

extern "C" {

// x: (n, d) f32 row-major; w: (xy, d) f32 row-major; out: (n, xy) f32
// row-major, 16-byte aligned. Returns cudaGetLastError() after the launch.
int xps_manhattan_distance(const void* x, const void* w, int n, int d, int xy, void* out,
                           void* stream) {
  return xps_tile::launch_tile_store(static_cast<const float*>(x),
                                     static_cast<const float*>(w), n, d, xy,
                                     xps_tile::L1Term{}, static_cast<float*>(out), stream);
}

}  // extern "C"
