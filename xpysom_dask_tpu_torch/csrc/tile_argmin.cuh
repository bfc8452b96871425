// Register-tiled exact-f32 sample-by-codebook tiling for Hopper (sm_90a),
// shared by K5-K7 (elementwise.cu) and K8 (manhattan.cu). K4 left it for
// the TF32 tensor cores (highest.cu): a dot product has a matrix-unit
// form, the elementwise L1 and |x - w|^p terms do not, so these kernels
// stay on the FP32 pipes, where their term's instruction count bounds
// them.
//
// For every sample row n and codebook row j the tiling computes
//     d[n, j] = finish(sum_d term(x[n, d], w[j, d]))
// and hands each tile of d to an epilogue: the BMU searches fold it into a
// running first-index (value, index) minimum, so the (N, XY) distance
// matrix never reaches device memory (tile_argmin_kernel); K8 stores it
// (tile_store_kernel). The per-pair sum runs SERIALLY over d in index
// order in one f32 accumulator: the order of the Pallas kernels' bodies (a
// Python loop over d adding into one tile accumulator) and of the plain
// PyTorch versions (one d at a time into an (N, XY) accumulator). With
// explicitly rounded arithmetic in the term (no FMA contraction) the
// elementwise kernels thus give the plain versions' bits.
//
// Design (simple first version):
//   * one block owns BM = 64 sample rows and loops over ALL codebook tiles
//     of BN = 64 rows itself; the loop takes the place of the TPU's
//     sequential grid axis, so nothing carries between blocks;
//   * per tile, x and w are staged through shared memory in BK = 16-deep
//     chunks of d, transposed so that each of the 16 x 16 threads reads its
//     4 rows and 4 codebook rows as one 16-byte vector per d (tile_sums);
//   * each thread keeps a 4 x 4 register tile of accumulators;
//   * the argmin epilogue is K1's: per row, the thread's 4 columns in
//     increasing order, then a lexicographic (value, index) merge over the
//     16 lanes that share the row (lowest index on ties), then a strict '<'
//     against the running minimum (an earlier tile keeps a tie);
//   * the store epilogue writes the thread's 4 x 4 values, one 16-byte
//     vector per row where the row stride allows it.
// Bounds: rows >= n are read as zeros and never written; codebook rows
// >= xy are never candidates and never stored; the d loop stops at d (no
// padded terms).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

namespace xps_tile {

constexpr int BM = 64;        // sample rows per block
constexpr int BN = 64;        // codebook rows per tile
constexpr int BK = 16;        // depth of d per staged chunk
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // codebook rows per thread
constexpr int THREADS = 256;  // 16 (row groups) x 16 (column groups)
constexpr int LD = BM + 4;    // shared stride in floats: 16-byte rows
static_assert(BM == BN, "x and w tiles share the staging layout");
static_assert(BM == 16 * TM && BN == 16 * TN, "16 x 16 threads cover a tile");
static_assert((BM * BK) % THREADS == 0, "whole staging rounds");

__device__ __forceinline__ bool lex_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// |a - b| with the subtraction explicitly rounded
__device__ __forceinline__ float absdiff(float a, float b) { return fabsf(__fsub_rn(a, b)); }

// The L1 term of K5's search and K8's matrix: acc + |x_d - w_d|, rounded
struct L1Term {
  static constexpr bool kChain = false;
  __device__ __forceinline__ float operator()(float acc, float a, float b) const {
    return __fadd_rn(acc, absdiff(a, b));
  }
  __device__ __forceinline__ float finish(float acc, int) const { return acc; }
};

// Term, one of two forms:
//   kChain == false: acc' = term(acc, x_d, w_d);
//   kChain == true:  acc' = acc + base(x_d, w_d, t) * t * ... * t, with
//     term.reps multiplies, each rounded. The loop runs the multiply chain
//     over all 16 terms of a step together, so a repetition count known
//     only at run time does not serialize the 16 independent terms (a loop
//     inside each term made K7 4x slower).
// in index order of d; the epilogue then applies term.finish(acc, column).
//
// tile_sums fills acc with the sums of the tile at sample rows row0 ..
// +BM and codebook rows col0 .. +BN (this thread's 4 x 4 of them); it
// begins and ends with every thread past a barrier, so the shared staging
// buffers are free on return.
template <class Term>
__device__ __forceinline__ void tile_sums(const float* __restrict__ x,
                                          const float* __restrict__ w, int n, int d,
                                          int xy, int row0, int col0, const Term& term,
                                          float* xs, float* ws, float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group: codebook rows tx*TN .. +TN-1
  const int ty = tid >> 4;  // row group: sample rows ty*TM .. +TM-1
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    const int kc = min(BK, d - k0);
    // stage x[row0 .. +BM, k0 .. +kc] and w[col0 .. +BN, k0 .. +kc],
    // transposed: sixteen neighbouring threads read one row's chunk
#pragma unroll
    for (int it = 0; it < (BM * BK) / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int r = e / BK;
      const int kk = e % BK;
      const int gr = row0 + r;
      const int gc = col0 + r;
      float xv = 0.0f, wv = 0.0f;
      if (kk < kc) {
        if (gr < n) xv = x[(size_t)gr * d + k0 + kk];
        if (gc < xy) wv = w[(size_t)gc * d + k0 + kk];
      }
      xs[kk * LD + r] = xv;
      ws[kk * LD + r] = wv;
    }
    __syncthreads();
    auto step = [&](int kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(xs + kk * LD + ty * TM);
      const float4 b4 = *reinterpret_cast<const float4*>(ws + kk * LD + tx * TN);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
      if constexpr (Term::kChain) {
        float t[TM][TN], tp[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int c = 0; c < TN; ++c) tp[i][c] = term.base(a[i], b[c], t[i][c]);
        for (int r = 0; r < term.reps; ++r)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int c = 0; c < TN; ++c) tp[i][c] = __fmul_rn(tp[i][c], t[i][c]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[i][c] = __fadd_rn(acc[i][c], tp[i][c]);
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[i][c] = term(acc[i][c], a[i], b[c]);
      }
    };
    if (kc == BK) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) step(kk);
    } else {
      for (int kk = 0; kk < kc; ++kk) step(kk);
    }
    __syncthreads();
  }
}

template <class Term>
__global__ void __launch_bounds__(THREADS)
tile_argmin_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   int n, int d, int xy, Term term, int* __restrict__ idx_out,
                   float* __restrict__ val_out) {
  __shared__ __align__(16) float xs[BK * LD];
  __shared__ __align__(16) float ws[BK * LD];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * BM;

  float best[TM];
  int besti[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    besti[i] = 0;
  }

  const int ntiles = (xy + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    const int col0 = j * BN;
    float acc[TM][TN];
    tile_sums(x, w, n, d, xy, row0, col0, term, xs, ws, acc);

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      // this thread's columns, in increasing index order
      float tv = INFINITY;
      int ti = INT_MAX;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int gc = col0 + tx * TN + c;
        if (gc < xy) {
          const float v = term.finish(acc[i][c], gc);
          if (lex_less(v, gc, tv, ti)) {
            tv = v;
            ti = gc;
          }
        }
      }
      // the 16 lanes of a row group (one half-warp) merge lexicographically
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, tv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, ti, off);
        if (lex_less(ov, oi, tv, ti)) {
          tv = ov;
          ti = oi;
        }
      }
      // later tiles hold higher indices: strict '<' keeps the first
      if (tv < best[i]) {
        best[i] = tv;
        besti[i] = ti;
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = row0 + ty * TM + i;
      if (gr < n) {
        idx_out[gr] = besti[i];
        val_out[gr] = best[i];
      }
    }
  }
}

// The whole (n, xy) matrix of term.finish(sums) into out (row-major, row
// stride xy). A 16-byte vector per thread and row where xy % 4 == 0 (every
// row then starts 16-byte aligned and a thread's 4 columns are all in
// range or all out), single stores otherwise.
template <class Term>
__global__ void __launch_bounds__(THREADS)
tile_store_kernel(const float* __restrict__ x, const float* __restrict__ w, int n, int d,
                  int xy, Term term, float* __restrict__ out) {
  __shared__ __align__(16) float xs[BK * LD];
  __shared__ __align__(16) float ws[BK * LD];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * BM;
  const bool vec = (xy & 3) == 0;

  const int ntiles = (xy + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    const int col0 = j * BN;
    float acc[TM][TN];
    tile_sums(x, w, n, d, xy, row0, col0, term, xs, ws, acc);
    const int gc0 = col0 + tx * TN;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = row0 + ty * TM + i;
      if (gr >= n) continue;
      float* o = out + (size_t)gr * xy + gc0;
      if (vec) {
        if (gc0 < xy)
          *reinterpret_cast<float4*>(o) =
              make_float4(term.finish(acc[i][0], gc0), term.finish(acc[i][1], gc0 + 1),
                          term.finish(acc[i][2], gc0 + 2), term.finish(acc[i][3], gc0 + 3));
      } else {
#pragma unroll
        for (int c = 0; c < TN; ++c)
          if (gc0 + c < xy) o[c] = term.finish(acc[i][c], gc0 + c);
      }
    }
  }
}

// Launches the search on `stream`; returns cudaGetLastError().
template <class Term>
int launch_tile_argmin(const float* x, const float* w, int n, int d, int xy,
                       Term term, int* idx, float* val, void* stream) {
  if (n > 0) {
    tile_argmin_kernel<Term><<<(n + BM - 1) / BM, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        x, w, n, d, xy, term, idx, val);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the store on `stream`; returns cudaGetLastError().
template <class Term>
int launch_tile_store(const float* x, const float* w, int n, int d, int xy, Term term,
                      float* out, void* stream) {
  if (n > 0) {
    tile_store_kernel<Term><<<(n + BM - 1) / BM, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(x, w, n, d, xy, term, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xps_tile
