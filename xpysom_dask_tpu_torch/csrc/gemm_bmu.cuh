// The WMMA GEMM-form BMU search of one 64-row block for Hopper (sm_90a):
// the first phase of K10 (fused_stats.cu). K1, K2, K1-kb and K3 run on
// wgmma (gemm_sm90.cu); this search is the next candidate for that
// pipeline.
//
// The block's rows are searched against ALL codebook columns of one packed
// K-chain d[n, j] = A[n, :] . W[:, j], where A = [xh | xl | xh | 1 1 1] and
// W = [wh; wh; wl; s1; s2; s3] are bf16 splits prepared by the wrapper
// (xpysom_dask_tpu_torch/ops/kernels/bmu.py), so d is the partial squared
// distance -2 x.w + |w|^2 in f32. It returns the first-index argmin of each
// row and its value; the (N, XY) distance matrix never reaches device
// memory.
//
// Design (simple first version):
//   * one block owns BM sample rows and loops over ALL codebook tiles of BN
//     columns; this loop takes the place of the TPU's sequential grid axis,
//     so nothing carries between blocks;
//   * each BN-column tile is one bf16 tensor-core GEMM through WMMA
//     (m16n16k16, f32 accumulation), each warp holding 2 x 2 fragments (32
//     x 32 per warp), with the operands staged through shared memory in
//     BK-deep chunks; bf16 x bf16 products are exact in f32;
//   * the f32 tile goes to shared memory and four threads per row fold it
//     into a running (value, index) minimum. Ties: within a tile the
//     lexicographic (value, index) order keeps the lowest index; across
//     tiles a strict '<' keeps the earlier tile's winner.
// Shared memory: the staged chunks and the f32 tile fit in 48 KB side by
// side. The caller owns the buffers (Stage).
// Bounds: rows >= n are neither read nor written; codebook columns >= xy
// are never candidates; depth past k is zero-filled.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <climits>

namespace xps_gemm {

using namespace nvcuda;

constexpr int BM = 64;        // sample rows per block
constexpr int BN = 128;       // codebook columns per tile
constexpr int BK = 32;        // depth per staged chunk
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns) of 32x32
constexpr int LDA = BK + 8;   // shared strides (elements), padded against
constexpr int LDB = BN + 8;   // bank conflicts; WMMA needs multiples of 8
constexpr int LDD = BN + 4;   // (bf16) and 4 (f32)
constexpr int A_ELEMS = BM * LDA;
constexpr int B_ELEMS = BK * LDB;
constexpr int D_BYTES = BM * LDD * (int)sizeof(float);
constexpr int STATIC_SMEM = 48 * 1024;
// WMMA pointers must be 32-byte aligned: every buffer starts on 32 bytes
static_assert((A_ELEMS * sizeof(__nv_bfloat16)) % 32 == 0, "A buffer alignment");
static_assert((B_ELEMS * sizeof(__nv_bfloat16)) % 32 == 0, "B buffer alignment");
static_assert((A_ELEMS + B_ELEMS) * (int)sizeof(__nv_bfloat16) + D_BYTES <= STATIC_SMEM,
              "static shared memory");

// The shared buffers of one block: the staged operand chunks (sa, sb) and
// the f32 tile sd.
struct Stage {
  __nv_bfloat16* sa;
  __nv_bfloat16* sb;
  float* sd;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ bool lex_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// Search rows row0 .. row0 + BM - 1 against every codebook column and write
// their winners. a, w: the operands. Every thread of the block calls it. It
// may be called again at once on the same buffers; other uses of them need
// a barrier first (the finish still reads sd).
__device__ __forceinline__ void gemm_bmu_rows(const Stage& st, int row0,
                                              const __nv_bfloat16* __restrict__ a,
                                              const __nv_bfloat16* __restrict__ w, int n, int k,
                                              int xy, int ldw, int* __restrict__ idx_out,
                                              float* __restrict__ val_out) {
  float* sd = st.sd;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;  // 32-row half of the block's rows
  const int warp_n = warp & 3;   // 32-column quarter of the tile

  // finish mapping: four neighbouring lanes share a row and read
  // interleaved columns (conflict-free with the LDD padding)
  const int frow = tid >> 2;
  const int fsub = tid & 3;

  float best = INFINITY;
  int besti = 0;

  const int ntiles = (xy + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    const int col0 = j * BN;
    FragC acc[2][2];
#pragma unroll
    for (int fm = 0; fm < 2; ++fm)
#pragma unroll
      for (int fn = 0; fn < 2; ++fn) wmma::fill_fragment(acc[fm][fn], 0.0f);

    for (int k0 = 0; k0 < k; k0 += BK) {
      {  // A chunk: BM x BK, one 16-byte vector per thread
        const int r = tid >> 2;
        const int kq = (tid & 3) * 8;
        const int gr = row0 + r;
        const int gk = k0 + kq;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gr < n && gk < k) v = *reinterpret_cast<const uint4*>(a + (size_t)gr * k + gk);
        *reinterpret_cast<uint4*>(st.sa + r * LDA + kq) = v;
      }
#pragma unroll
      for (int it = 0; it < 2; ++it) {  // W chunks: BK x BN, two vectors each
        const int e = tid + it * THREADS;
        const int kr = e >> 4;
        const int cq = (e & 15) * 8;
        const int gk = k0 + kr;
        const int gc = col0 + cq;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gk < k && gc < ldw) v = *reinterpret_cast<const uint4*>(w + (size_t)gk * ldw + gc);
        *reinterpret_cast<uint4*>(st.sb + kr * LDB + cq) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        if (k0 + kk < k) {  // uniform over the block
          FragA fa[2];
          FragB fb[2];
#pragma unroll
          for (int fm = 0; fm < 2; ++fm)
            wmma::load_matrix_sync(fa[fm], st.sa + (warp_m * 32 + fm * 16) * LDA + kk, LDA);
#pragma unroll
          for (int fn = 0; fn < 2; ++fn)
            wmma::load_matrix_sync(fb[fn], st.sb + kk * LDB + warp_n * 32 + fn * 16, LDB);
#pragma unroll
          for (int fm = 0; fm < 2; ++fm)
#pragma unroll
            for (int fn = 0; fn < 2; ++fn)
              wmma::mma_sync(acc[fm][fn], fa[fm], fb[fn], acc[fm][fn]);
        }
      }
      __syncthreads();
    }
    // to shared memory
#pragma unroll
    for (int fm = 0; fm < 2; ++fm)
#pragma unroll
      for (int fn = 0; fn < 2; ++fn)
        wmma::store_matrix_sync(sd + (warp_m * 32 + fm * 16) * LDD + warp_n * 32 + fn * 16,
                                acc[fm][fn], LDD, wmma::mem_row_major);
    __syncthreads();

    // per-thread pass over its columns, in increasing index order
    float tv = INFINITY;
    int ti = INT_MAX;
    for (int c = fsub; c < BN; c += 4) {
      const int gc = col0 + c;
      if (gc >= xy) break;
      const float v = sd[frow * LDD + c];
      if (v < tv) {
        tv = v;
        ti = gc;
      }
    }
    // merge the four lanes of the row (lexicographic: lowest index on ties)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, tv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, ti, off);
      if (lex_less(ov, oi, tv, ti)) {
        tv = ov;
        ti = oi;
      }
    }
    // fold into the running minimum; later tiles hold higher indices
    if (tv < best) {
      best = tv;
      besti = ti;
    }
    // sd is rewritten only after the next tile's chunk loop, whose
    // barriers every thread reaches after finishing this pass; the same
    // holds for a next call on the same buffers
  }

  const int gr = row0 + frow;
  if (fsub == 0 && gr < n) {
    idx_out[gr] = besti;
    val_out[gr] = best;
  }
}

}  // namespace xps_gemm
