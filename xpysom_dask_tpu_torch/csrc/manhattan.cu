// L1 distance matrix for Hopper (sm_90a): K8.
//
// Replaces the Pallas kernel _kernel of xpysom_dask_tpu/ops/pallas/
// manhattan.py (manhattan_distance, the matrix behind ops/distances.py's
// 'manhattan' and so behind XPySom.activate under that activation):
//     out[n, j] = sum_d |x[n, d] - w[j, d]|
// for every sample row n and codebook row j, into the (N, XY) f32 result.
//
// Design: K5's engine (tile_argmin.cuh) with the store epilogue in place of
// the argmin: the samples resident per block, the codebook streamed by bulk
// copies, 8 x 8 accumulators per thread, the sum over d serial in index
// order with __fsub_rn/__fadd_rn. The Pallas kernel and the plain version
// add in the same order from 0, so K8 equals both bit for bit. Rows >= n
// and columns >= xy are never written. The codebook segments fill the card
// at activate's 1024-row chunks (16 row blocks), where one block per row
// block left most SMs idle.
//
// What bounds it on the H100: at activate's chunk (1024 x 16384, D = 64) it
// is 1.07e9 L1 terms of two FP32 instructions each, 0.064 ms of issue at
// the card's 33.5e12 FP32 instructions/s (700 W), against 67 MB of output
// at 3.35 TB/s, 0.020 ms: the FP32 pipes bound it, and the stores (16-byte
// vectors, fire and forget) overlap the next tile's sums.

#include "tile_argmin.cuh"

extern "C" {

// xl, wl: the samples and the codebook laid out as for K5
// (elementwise.cu xps_layout_f32); tps: codebook tiles per segment; out:
// (n, xy) f32 row-major, 16-byte aligned. Returns cudaGetLastError() after
// the launch.
int xps_manhattan_distance(const void* xl, const void* wl, int n, int d, int xy, int tps,
                           void* out, void* stream) {
  if (d <= 0 || xy <= 0 || tps <= 0 || xps_tile::segments(xy, tps) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return xps_tile::launch<xps_tile::L1Term, true>(
      static_cast<const float*>(xl), static_cast<const float*>(wl), n, d, xy, tps,
      xps_tile::L1Term{}, nullptr, nullptr, static_cast<float*>(out),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
