// Elementwise BMU searches for Hopper (sm_90a): K5 (L1), K6 (odd p) and
// K7 (fractional p), instances of one engine (tile_argmin.cuh) with a
// per-term functor, and the engine's layout pre-pass and segment merge.
//
// Replace the Pallas kernels of xpysom_dask_tpu/ops/pallas/bmu.py launched
// through _elementwise_bmu_call:
//   K5 _kernel_manhattan_argmin (accum='serial'):  sum_d |x - w|
//   K6 _kernel_lp_odd_argmin:   sum_d t^p,  t = |x - w|, tp = t; tp = tp*t
//                                (p - 1 times)
//   K7 _kernel_lp_frac_argmin:  sum_d tp,   tp = sqrt(t) if frac = 1/2,
//                                else exp(frac * log t); then tp = tp*t
//                                floor(p) times
// each folded into a first-index argmin. The sum runs serially over d in
// index order in one f32 accumulator, and every subtract, multiply and add
// is explicitly rounded (__fsub_rn/__fmul_rn/__fadd_rn): nvcc would
// otherwise contract `acc + tp*t` into an FMA and the bits would leave the
// plain versions'. K5 and K6 therefore equal their plain versions bit for
// bit. K7 takes t^f from the special-function unit (sqrt.approx.f32, or
// ex2.approx.f32(f * lg2.approx.f32(t)); the .ftz forms where floor(p) >= 1,
// tile_argmin.cuh FracTerm) where the plain version calls IEEE sqrt or the
// accurate exp and log. Measured on an H100 over 2^21 values of t (uniform
// in [0, 1) and log-uniform in [2^-149, 2^127], chip_smoke.py's term
// sweep), the term t^p errs by at most 3.8e-6 relative to float64 (p = 0.3;
// the plain version 3.2e-6) and 2.0e-7 through the sqrt branch, and stays
// within 6.2e-6 of the plain version's term; chip_smoke.py holds the
// values to the plain version's within FRAC_RTOL = 1e-5 relative and the
// winners outside the near-tie band. t = 0 gives 0 and t = +inf gives
// +inf, so a sample equal to a codebook row wins with 0.
//
// What bounds it on the H100: at the flagship chunk (16384 x 16384, D = 64)
// it is 1.7e10 terms on 8 MB of operands, so the pipes bound it, not
// memory: two FP32 instructions a term for L1 (1.03 ms of issue at the
// card's 33.5e12 FP32 instructions/s, 700 W), p + 1 for odd p, and one
// (sqrt) or two (lg2, ex2) special-function results a term for K7 at
// 4.18e12/s (4.1 or 8.2 ms); K7's whole sequence issues 4.1 (p = 1.5) or
// 7.1 (p = 2.7) SASS instructions a term, 2.1 or 3.7 ms of issue, so the
// special-function unit bounds it. The engine keeps the pipes fed: the
// samples resident in shared memory, the codebook streamed by bulk copies
// ahead of the sums, an 8 x 8 register tile per thread (four 16-byte
// shared-memory vectors per 64 terms), and the codebook cut into segments
// where the sample rows alone would leave SMs idle.

#include "tile_argmin.cuh"

namespace {

using namespace xps_tile;

// src (rows, d) f32 with row stride ld, written as tiles of TR rows, each
// as nk chunks of KC depth x TR rows, d-major, zero past the rows and past
// d. One block per chunk (blockIdx.x = tile * nk + chunk): the chunk's
// rows read as 4-vectors along d (16-byte loads where d, ld and src allow),
// transposed through shared memory, written in order as 4-vectors.
template <int TR>
__global__ void __launch_bounds__(256)
layout_f32_kernel(const float* __restrict__ src, int rows, int d, long long ld, int nk,
                  float* __restrict__ dst) {
  constexpr int VECS = TR * KC / 4 / 256;  // 4-vectors per thread
  __shared__ float tile[KC][TR + 1];
  const long long r0 = (long long)(blockIdx.x / nk) * TR;
  const int k0 = (blockIdx.x % nk) * KC;
  const bool vec = ((ld | d) & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
#pragma unroll
  for (int it = 0; it < VECS; ++it) {
    const int e = threadIdx.x + it * 256;
    const int r = e / (KC / 4), k = 4 * (e % (KC / 4));  // row r, depths k .. k + 3
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r0 + r < rows) {
      const float* p = src + (r0 + r) * ld + k0 + k;
      if (vec) {
        if (k0 + k < d) {
          const float4 q = *reinterpret_cast<const float4*>(p);
          v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k0 + k + q < d) v[q] = p[q];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) tile[k + q][r] = v[q];
  }
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(dst + (size_t)blockIdx.x * TR * KC);
#pragma unroll
  for (int it = 0; it < VECS; ++it) {
    const int e = threadIdx.x + it * 256;
    const int k = e / (TR / 4), r = 4 * (e % (TR / 4));  // depth k, rows r .. r + 3
    out[e] = make_float4(tile[k][r], tile[k][r + 1], tile[k][r + 2], tile[k][r + 3]);
  }
}

// the segments' (value, index) of each row in segment order: a strict '<'
// keeps the earlier segment's (lower) index on a tie
__global__ void merge_kernel(const int* __restrict__ pidx, const float* __restrict__ pval, int n,
                             int segs, int* __restrict__ idx, float* __restrict__ val) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float v = pval[r];
  int i = pidx[r];
  for (int s = 1; s < segs; ++s) {
    const float o = pval[(size_t)s * n + r];
    if (o < v) {
      v = o;
      i = pidx[(size_t)s * n + r];
    }
  }
  idx[r] = i;
  val[r] = v;
}

// the search over the laid-out operands; with several segments through
// parts (2 * segments * n 32-bit words), then the merge
template <class Term>
int search(const void* xl, const void* wl, int n, int d, int xy, int tps, Term term, void* parts,
           void* idx, void* val, void* stream) {
  if (d <= 0 || xy <= 0 || tps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int segs = segments(xy, tps);
  if (segs > 65535 || (segs > 1 && !parts)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* pidx = segs > 1 ? static_cast<int*>(parts) : static_cast<int*>(idx);
  float* pval = segs > 1 ? reinterpret_cast<float*>(pidx + (size_t)segs * n)
                         : static_cast<float*>(val);
  const int rc = launch<Term, false>(static_cast<const float*>(xl), static_cast<const float*>(wl),
                                     n, d, xy, tps, term, pidx, pval, nullptr, st);
  if (rc != 0 || segs == 1) return rc;
  merge_kernel<<<(n + 255) / 256, 256, 0, st>>>(pidx, pval, n, segs, static_cast<int*>(idx),
                                                static_cast<float*>(val));
  return static_cast<int>(cudaGetLastError());
}

// K7: the chain's multiply count m as a template argument where it is
// small
template <bool HALF>
int frac_search(int m, float f, const void* xl, const void* wl, int n, int d, int xy, int tps,
                void* parts, void* idx, void* val, void* stream) {
  switch (m) {
    case 0: return search(xl, wl, n, d, xy, tps, FracTerm<HALF, 0>{m, f}, parts, idx, val, stream);
    case 1: return search(xl, wl, n, d, xy, tps, FracTerm<HALF, 1>{m, f}, parts, idx, val, stream);
    case 2: return search(xl, wl, n, d, xy, tps, FracTerm<HALF, 2>{m, f}, parts, idx, val, stream);
    default:
      return search(xl, wl, n, d, xy, tps, FracTerm<HALF, -1>{m, f}, parts, idx, val, stream);
  }
}

}  // namespace

extern "C" {

// src: rows x d f32, row stride ld (elements); dst: ceil(rows / trows) *
// trows * ceil(d / 32) * 32 f32, 16-byte aligned: the operand laid out for
// the engine (trows 64 for samples, 128 for a codebook). Returns
// cudaGetLastError().
int xps_layout_f32(const void* src, int rows, int d, long long ld, int trows, void* dst,
                   void* stream) {
  if (rows <= 0 || d <= 0 || (trows != BM && trows != BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nk = (d + KC - 1) / KC;
  const long long blocks = ((long long)rows + trows - 1) / trows * nk;
  if (blocks >= 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(src);
  float* o = static_cast<float*>(dst);
  if (trows == BM)
    layout_f32_kernel<BM><<<static_cast<unsigned>(blocks), 256, 0, st>>>(s, rows, d, ld, nk, o);
  else
    layout_f32_kernel<BN><<<static_cast<unsigned>(blocks), 256, 0, st>>>(s, rows, d, ld, nk, o);
  return static_cast<int>(cudaGetLastError());
}

// xl: the samples (n x d f32) laid out in 64-row tiles; wl: the codebook
// (xy x d f32) laid out in 128-row tiles; tps: codebook tiles per segment;
// parts: 2 * segments * n 32-bit words of scratch (null for one segment);
// idx: (n,) int32 and val: (n,) f32 outputs. Each returns
// cudaGetLastError() after the launches.
int xps_bmu_manhattan(const void* xl, const void* wl, int n, int d, int xy, int tps, void* parts,
                      void* idx, void* val, void* stream) {
  return search(xl, wl, n, d, xy, tps, L1Term{}, parts, idx, val, stream);
}

// p: a positive odd integer
int xps_bmu_lp_odd(const void* xl, const void* wl, int n, int d, int xy, int tps, int p,
                   void* parts, void* idx, void* val, void* stream) {
  if (p == 3) return search(xl, wl, n, d, xy, tps, PowTerm<2>{2}, parts, idx, val, stream);
  return search(xl, wl, n, d, xy, tps, PowTerm<-1>{p - 1}, parts, idx, val, stream);
}

// p = m + f: m = floor(p) >= 0 and the f32 fraction 0 < f < 1; half != 0
// when the caller's fraction is exactly 1/2 (the sqrt branch)
int xps_bmu_lp_frac(const void* xl, const void* wl, int n, int d, int xy, int tps, int m,
                    float f, int half, void* parts, void* idx, void* val, void* stream) {
  if (half) return frac_search<true>(m, f, xl, wl, n, d, xy, tps, parts, idx, val, stream);
  return frac_search<false>(m, f, xl, wl, n, d, xy, tps, parts, idx, val, stream);
}

}  // extern "C"
