// Packed BMU search for Hopper (sm_90a): K1 (argmin) and K2 (top-2).
//
// Replaces the Pallas kernels _kernel_gemm_argmin and _kernel_gemm_top2 of
// xpysom_dask_tpu/ops/pallas/bmu.py. Each sample row n gets
//     d[n, j] = A[n, :] . W[:, j]
// where A = [xh | xl | xh | 1 1 1] and W = [wh; wh; wl; s1; s2; s3] are bf16
// splits prepared by the wrapper (xpysom_dask_tpu_torch/ops/kernels/bmu.py),
// so d is the partial squared distance -2 x.w + |w|^2 in f32. The kernel
// returns the first-index argmin of each row (K1) or the two best
// (value, index) pairs in stable-argsort order (K2). The (N, XY) distance
// matrix never reaches device memory.
//
// Design (simple first version):
//   * one block owns BM sample rows and loops over ALL codebook tiles of BN
//     columns; this loop takes the place of the TPU's sequential grid axis,
//     so nothing carries between blocks;
//   * each BN-column tile is one bf16 tensor-core GEMM through WMMA
//     (m16n16k16, f32 accumulation), with A and W staged through shared
//     memory in BK-deep chunks; bf16 x bf16 products are exact in f32;
//   * the f32 tile goes to shared memory and four threads per row fold it
//     into a running (value, index) minimum. Ties: within a tile the
//     lexicographic (value, index) order keeps the lowest index; across
//     tiles a strict '<' keeps the earlier tile's winner. K2 keeps two such
//     pairs, so a duplicate minimum is the runner-up.
// Bounds: rows >= n are neither read nor written; codebook columns >= xy
// are never candidates; depth past k is zero-filled.
//
// What bounds it on the H100: at the flagship shape (16384 rows, 16384
// nodes, K = 208) one chunk is 5.6e10 bf16 multiply-adds, far above the
// card's bytes-to-FLOP line, so the tensor cores should bound it. This
// version reaches them through WMMA without asynchronous copies, so
// staging and the shared-memory finish stall them; wgmma with TMA-fed
// pipelined tiles is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <climits>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // sample rows per block
constexpr int BN = 128;       // codebook columns per tile
constexpr int BK = 32;        // depth per staged chunk
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns) of 32x32
constexpr int LDA = BK + 8;   // shared strides (elements), padded against
constexpr int LDB = BN + 8;   // bank conflicts; WMMA needs multiples of 8
constexpr int LDD = BN + 4;   // (bf16) and 4 (f32)

__device__ __forceinline__ bool lex_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// Merge the sorted pair (ov, oi, ov2, oi2) into the sorted pair
// (v, i, v2, i2), keeping the two lexicographically smallest entries.
__device__ __forceinline__ void merge_top2(float& v, int& i, float& v2, int& i2,
                                           float ov, int oi, float ov2, int oi2) {
  if (lex_less(ov, oi, v, i)) {
    if (lex_less(v, i, ov2, oi2)) {
      v2 = v;
      i2 = i;
    } else {
      v2 = ov2;
      i2 = oi2;
    }
    v = ov;
    i = oi;
  } else if (lex_less(ov, oi, v2, i2)) {
    v2 = ov;
    i2 = oi;
  }
}

template <bool TOP2>
__global__ void __launch_bounds__(THREADS)
gemm_bmu_kernel(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ w, int n, int k, int xy,
                int ldw, int* __restrict__ idx_out, float* __restrict__ val_out,
                int* __restrict__ idx2_out, float* __restrict__ val2_out) {
  __shared__ __align__(128) __nv_bfloat16 sa[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 sb[BK * LDB];
  __shared__ __align__(128) float sd[BM * LDD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;  // 32-row half of the block's rows
  const int warp_n = warp & 3;   // 32-column quarter of the tile
  const int row0 = blockIdx.x * BM;

  // finish mapping: four neighbouring lanes share a row and read
  // interleaved columns (conflict-free with the LDD padding)
  const int frow = tid >> 2;
  const int fsub = tid & 3;

  float best = INFINITY, best2 = INFINITY;
  int besti = 0, besti2 = INT_MAX;

  const int ntiles = (xy + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    const int col0 = j * BN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
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
        if (gr < n && gk < k)
          v = *reinterpret_cast<const uint4*>(a + (size_t)gr * k + gk);
        *reinterpret_cast<uint4*>(sa + r * LDA + kq) = v;
      }
#pragma unroll
      for (int it = 0; it < 2; ++it) {  // W chunk: BK x BN, two vectors
        const int e = tid + it * THREADS;
        const int kr = e >> 4;
        const int cq = (e & 15) * 8;
        const int gk = k0 + kr;
        const int gc = col0 + cq;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gk < k && gc < ldw)
          v = *reinterpret_cast<const uint4*>(w + (size_t)gk * ldw + gc);
        *reinterpret_cast<uint4*>(sb + kr * LDB + cq) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        if (k0 + kk < k) {  // uniform over the block
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb[2];
#pragma unroll
          for (int fm = 0; fm < 2; ++fm)
            wmma::load_matrix_sync(fa[fm], sa + (warp_m * 32 + fm * 16) * LDA + kk,
                                   LDA);
#pragma unroll
          for (int fn = 0; fn < 2; ++fn)
            wmma::load_matrix_sync(fb[fn], sb + kk * LDB + warp_n * 32 + fn * 16,
                                   LDB);
#pragma unroll
          for (int fm = 0; fm < 2; ++fm)
#pragma unroll
            for (int fn = 0; fn < 2; ++fn)
              wmma::mma_sync(acc[fm][fn], fa[fm], fb[fn], acc[fm][fn]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int fm = 0; fm < 2; ++fm)
#pragma unroll
      for (int fn = 0; fn < 2; ++fn)
        wmma::store_matrix_sync(
            sd + (warp_m * 32 + fm * 16) * LDD + warp_n * 32 + fn * 16,
            acc[fm][fn], LDD, wmma::mem_row_major);
    __syncthreads();

    // per-thread pass over its columns, in increasing index order
    float tv = INFINITY, tv2 = INFINITY;
    int ti = INT_MAX, ti2 = INT_MAX;
    for (int c = fsub; c < BN; c += 4) {
      const int gc = col0 + c;
      if (gc >= xy) break;
      const float v = sd[frow * LDD + c];
      if (TOP2) {
        if (lex_less(v, gc, tv, ti)) {
          tv2 = tv;
          ti2 = ti;
          tv = v;
          ti = gc;
        } else if (lex_less(v, gc, tv2, ti2)) {
          tv2 = v;
          ti2 = gc;
        }
      } else if (v < tv) {
        tv = v;
        ti = gc;
      }
    }
    // merge the four lanes of the row (lexicographic: lowest index on ties)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, tv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, ti, off);
      if (TOP2) {
        const float ov2 = __shfl_xor_sync(0xffffffffu, tv2, off);
        const int oi2 = __shfl_xor_sync(0xffffffffu, ti2, off);
        merge_top2(tv, ti, tv2, ti2, ov, oi, ov2, oi2);
      } else if (lex_less(ov, oi, tv, ti)) {
        tv = ov;
        ti = oi;
      }
    }
    // fold into the running carry; later tiles hold higher indices
    if (TOP2) {
      merge_top2(best, besti, best2, besti2, tv, ti, tv2, ti2);
    } else if (tv < best) {
      best = tv;
      besti = ti;
    }
    // sd is rewritten only after the next tile's chunk loop, whose
    // barriers every thread reaches after finishing this pass
  }

  const int gr = row0 + frow;
  if (fsub == 0 && gr < n) {
    idx_out[gr] = besti;
    val_out[gr] = best;
    if (TOP2) {
      idx2_out[gr] = besti2;
      val2_out[gr] = best2;
    }
  }
}

}  // namespace

extern "C" {

// a: (n, k) bf16 row-major; w: (k, ldw) bf16 row-major, columns >= xy
// ignored. k % 8 == 0, ldw % 8 == 0, both pointers 16-byte aligned.
// Returns cudaGetLastError() after the launch.
int xps_bmu_argmin(const void* a, const void* w, int n, int k, int xy, int ldw,
                   void* idx, void* val, void* stream) {
  if (n > 0) {
    gemm_bmu_kernel<false><<<(n + BM - 1) / BM, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
        n, k, xy, ldw, static_cast<int*>(idx), static_cast<float*>(val), nullptr,
        nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

int xps_bmu_top2(const void* a, const void* w, int n, int k, int xy, int ldw,
                 void* idx, void* val, void* idx2, void* val2, void* stream) {
  if (n > 0) {
    gemm_bmu_kernel<true><<<(n + BM - 1) / BM, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
        n, k, xy, ldw, static_cast<int*>(idx), static_cast<float*>(val),
        static_cast<int*>(idx2), static_cast<float*>(val2));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
