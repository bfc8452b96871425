// Register-tiled exact-f32 BMU search for Hopper (sm_90a), shared by K4
// (highest.cu) and K5-K7 (elementwise.cu).
//
// For every sample row n the kernel folds the distances
//     d[n, j] = finish(sum_d term(x[n, d], w[j, d]))
// over all codebook rows j into a running first-index (value, index)
// minimum, so the (N, XY) distance matrix never reaches device memory. The
// per-pair sum runs SERIALLY over d in index order in one f32 accumulator:
// the order of the Pallas kernels' bodies (a Python loop over d adding into
// one tile accumulator) and of the plain PyTorch versions (one d at a time
// into an (N, XY) accumulator). With explicitly rounded arithmetic in the
// term (no FMA contraction) the elementwise searches thus give the plain
// versions' bits.
//
// Design (simple first version):
//   * one block owns BM = 64 sample rows and loops over ALL codebook tiles
//     of BN = 64 rows itself; the loop takes the place of the TPU's
//     sequential grid axis, so nothing carries between blocks;
//   * per tile, x and w are staged through shared memory in BK = 16-deep
//     chunks of d, transposed so that each of the 16 x 16 threads reads its
//     4 rows and 4 codebook rows as one 16-byte vector per d;
//   * each thread keeps a 4 x 4 register tile of accumulators;
//   * the finish is K1's: per row, the thread's 4 columns in increasing
//     order, then a lexicographic (value, index) merge over the 16 lanes
//     that share the row (lowest index on ties), then a strict '<' against
//     the running minimum (an earlier tile keeps a tie).
// Bounds: rows >= n are read as zeros and never written; codebook rows
// >= xy are never candidates; the d loop stops at d (no padded terms).

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

// Term, one of two forms:
//   kChain == false: acc' = term(acc, x_d, w_d);
//   kChain == true:  acc' = acc + base(x_d, w_d, t) * t * ... * t, with
//     term.reps multiplies, each rounded. The kernel runs the multiply
//     loop over all 16 terms of a step together, so a repetition count
//     known only at run time does not serialize the 16 independent terms
//     (a loop inside each term made K7 4x slower).
// in index order of d; then value = term.finish(acc, column).
template <class Term>
__global__ void __launch_bounds__(THREADS)
tile_argmin_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   int n, int d, int xy, Term term, int* __restrict__ idx_out,
                   float* __restrict__ val_out) {
  __shared__ __align__(16) float xs[BK * LD];
  __shared__ __align__(16) float ws[BK * LD];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group: codebook rows tx*TN .. +TN-1
  const int ty = tid >> 4;  // row group: sample rows ty*TM .. +TM-1
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

}  // namespace xps_tile
