// Elementwise BMU searches for Hopper (sm_90a): K5 (L1), K6 (odd p) and
// K7 (fractional p), one template over a per-term functor.
//
// Replace the Pallas kernels of xpysom_dask_tpu/ops/pallas/bmu.py launched
// through _elementwise_bmu_call:
//   K5 _kernel_manhattan_argmin (accum='serial'):  sum_d |x - w|
//   K6 _kernel_lp_odd_argmin:   sum_d t^p,  t = |x - w|, tp = t; tp = tp*t
//                                (p - 1 times)
//   K7 _kernel_lp_frac_argmin:  sum_d tp,   tp = sqrt(t) if frac = 1/2,
//                                else exp(frac * log t); then tp = tp*t
//                                floor(p) times
// each folded into a running first-index argmin (tile_argmin.cuh). The sum
// runs serially over d in index order in one f32 accumulator, and every
// multiply and add is explicitly rounded (__fmul_rn/__fadd_rn): nvcc would
// otherwise contract `acc + tp*t` into an FMA and the bits would leave the
// plain versions'. K5 and K6 therefore equal their plain versions bit for
// bit. K7's sqrtf is IEEE-rounded; expf/logf are CUDA's accurate versions
// (never __expf or --use_fast_math), within 2 ulp, so K7 agrees with its
// plain version to that tolerance. t = 0 gives exp(frac * -inf) = 0, so a
// sample equal to a codebook row wins with 0.
//
// What bounds it on the H100: at the flagship chunk (16384 x 16384, D = 64)
// it is 1.7e10 terms of 2 (L1), 2 + (p - 1) (odd p) or ~10-30 (sqrt,
// exp/log) instructions each on 8 MB of operands, so the FP32 and
// special-function pipes bound it, not memory: the L1 search is ~1.0 ms of
// issue at the card's 33.5e12 FP32 instructions/s (700 W). There is no GEMM
// form (the TPU ran these on its vector unit too); the design's job is to
// keep the pipes fed from registers: a 4 x 4 register tile per thread, one
// 16-byte shared-memory vector per operand per 16 terms, and the p-power
// multiply chain run over all 16 terms at once (tile_argmin.cuh, kChain).

#include "tile_argmin.cuh"

namespace {

using xps_tile::absdiff;
using xps_tile::L1Term;

// t^p = t * t^(p - 1) for odd p >= 1: reps = p - 1
struct OddTerm {
  static constexpr bool kChain = true;
  int reps;
  __device__ __forceinline__ float base(float a, float b, float& t) const {
    t = absdiff(a, b);
    return t;
  }
  __device__ __forceinline__ float finish(float acc, int) const { return acc; }
};

// p = m + f with m = floor(p) and 0 < f < 1: t^f, then reps = m
// multiplies by t
template <bool HALF>
struct FracTerm {
  static constexpr bool kChain = true;
  int reps;
  float f;
  __device__ __forceinline__ float base(float a, float b, float& t) const {
    t = absdiff(a, b);
    return HALF ? sqrtf(t) : expf(__fmul_rn(f, logf(t)));
  }
  __device__ __forceinline__ float finish(float acc, int) const { return acc; }
};

}  // namespace

extern "C" {

// x: (n, d) f32 row-major; w: (xy, d) f32 row-major; idx: (n,) int32 and
// val: (n,) f32 outputs. Each returns cudaGetLastError() after the launch.
int xps_bmu_manhattan(const void* x, const void* w, int n, int d, int xy, void* idx,
                      void* val, void* stream) {
  return xps_tile::launch_tile_argmin(
      static_cast<const float*>(x), static_cast<const float*>(w), n, d, xy, L1Term{},
      static_cast<int*>(idx), static_cast<float*>(val), stream);
}

// p: a positive odd integer
int xps_bmu_lp_odd(const void* x, const void* w, int n, int d, int xy, int p,
                   void* idx, void* val, void* stream) {
  return xps_tile::launch_tile_argmin(
      static_cast<const float*>(x), static_cast<const float*>(w), n, d, xy, OddTerm{p - 1},
      static_cast<int*>(idx), static_cast<float*>(val), stream);
}

// p = m + f: m = floor(p) >= 0 and the f32 fraction 0 < f < 1; half != 0
// when the caller's fraction is exactly 1/2 (the sqrt branch)
int xps_bmu_lp_frac(const void* x, const void* w, int n, int d, int xy, int m,
                    float f, int half, void* idx, void* val, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  int* ip = static_cast<int*>(idx);
  float* vp = static_cast<float*>(val);
  if (half)
    return xps_tile::launch_tile_argmin(xf, wf, n, d, xy, FracTerm<true>{m, f}, ip, vp,
                                        stream);
  return xps_tile::launch_tile_argmin(xf, wf, n, d, xy, FracTerm<false>{m, f}, ip, vp,
                                      stream);
}

}  // extern "C"
