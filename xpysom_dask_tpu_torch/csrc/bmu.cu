// GEMM-form BMU searches for Hopper (sm_90a): K1 (argmin), K2 (top-2) and
// K3 (mode 'split3'), three instances of one kernel template.
//
// Replaces the Pallas kernels _kernel_gemm_argmin, _kernel_gemm_top2 and
// _kernel_split3 of xpysom_dask_tpu/ops/pallas/bmu.py. The template is
// parametrised by its product set:
//   * PACKED (K1, K2): one K-chain d[n, j] = A[n, :] . W[:, j], where
//     A = [xh | xl | xh | 1 1 1] and W = [wh; wh; wl; s1; s2; s3] (or the
//     bf16/split2 operands) are bf16 splits prepared by the wrapper
//     (xpysom_dask_tpu_torch/ops/kernels/bmu.py), so d is the partial squared
//     distance -2 x.w + |w|^2 in f32;
//   * SPLIT3 (K3): three SEPARATE f32 accumulations of the bf16 splits of the
//     centered samples (xh, xl) and of the codebook's transpose (wh, wl),
//     summed in the JAX kernel's order, cross = (xh.wh + xh.wl) + xl.wh,
//     then d = -2 * cross + w_sq with the f32 |w|^2. The order is the mode's
//     documented behaviour: it can flip float64 near-ties relative to the
//     packed single chain (bmu.py module docstring), so it is not folded
//     into one K-chain.
// The kernel returns the first-index argmin of each row and its value (K1,
// K3) or the two best (value, index) pairs in stable-argsort order (K2). The
// (N, XY) distance matrix never reaches device memory.
//
// Design (simple first version):
//   * one block owns BM sample rows and loops over ALL codebook tiles of BN
//     columns; this loop takes the place of the TPU's sequential grid axis,
//     so nothing carries between blocks;
//   * each BN-column tile is one bf16 tensor-core GEMM per product through
//     WMMA (m16n16k16, f32 accumulation), each warp holding 2 x 2 fragments
//     of every product (32 x 32 per warp), with the operands staged through
//     shared memory in BK-deep chunks; bf16 x bf16 products are exact in f32;
//   * SPLIT3 adds its three fragments elementwise in registers (the same
//     fragment type has the same element layout), (hh + hl) + lh with
//     explicit rounding;
//   * the f32 tile goes to shared memory and four threads per row fold it
//     into a running (value, index) minimum. Ties: within a tile the
//     lexicographic (value, index) order keeps the lowest index; across
//     tiles a strict '<' keeps the earlier tile's winner. K2 keeps two such
//     pairs, so a duplicate minimum is the runner-up.
// Shared memory: PACKED's staged chunks and the f32 tile fit in 48 KB side
// by side; SPLIT3 stages twice the operands, so its tile aliases the staging
// buffers and one more barrier closes each tile's finish.
// Bounds: rows >= n are neither read nor written; codebook columns >= xy
// are never candidates; depth past k is zero-filled.
//
// What bounds it on the H100: at the flagship shape (16384 rows, 16384
// nodes) one chunk is 5.6e10 bf16 multiply-adds for K1 (K = 208) and
// 3 x 1.7e10 = 5.2e10 for K3 (D = 64), far above the card's bytes-to-FLOP
// line, so the tensor cores should bound it. This version reaches them
// through WMMA without asynchronous copies, so staging and the
// shared-memory finish stall them; wgmma with TMA-fed pipelined tiles is
// later work.

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
constexpr int A_ELEMS = BM * LDA;
constexpr int B_ELEMS = BK * LDB;
constexpr int D_BYTES = BM * LDD * (int)sizeof(float);
constexpr int STATIC_SMEM = 48 * 1024;
// WMMA pointers must be 32-byte aligned: every buffer starts on 32 bytes
static_assert((A_ELEMS * sizeof(__nv_bfloat16)) % 32 == 0, "A buffer alignment");
static_assert((B_ELEMS * sizeof(__nv_bfloat16)) % 32 == 0, "B buffer alignment");

enum class Products { PACKED, SPLIT3 };

// Shared-memory layout of a product set: OPS staged (A, W) operand pairs
// and the f32 tile, which aliases the staging when both do not fit.
template <Products P>
struct Layout {
  static constexpr int OPS = P == Products::SPLIT3 ? 2 : 1;
  static constexpr int ACCS = P == Products::SPLIT3 ? 3 : 1;
  static constexpr int STAGE = OPS * (A_ELEMS + B_ELEMS) * (int)sizeof(__nv_bfloat16);
  static constexpr bool ALIAS = STAGE + D_BYTES > STATIC_SMEM;
  static constexpr int BYTES = ALIAS ? (STAGE > D_BYTES ? STAGE : D_BYTES) : STAGE + D_BYTES;
  static_assert(BYTES <= STATIC_SMEM, "static shared memory");
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

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

// a, w: the (first) operand pair; a_lo, w_lo, w_sq: SPLIT3's low halves and
// |w|^2 (unused by PACKED).
template <Products P, bool TOP2>
__global__ void __launch_bounds__(THREADS)
gemm_bmu_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ a_lo,
                const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ w_lo,
                const float* __restrict__ w_sq, int n, int k, int xy, int ldw,
                int* __restrict__ idx_out, float* __restrict__ val_out,
                int* __restrict__ idx2_out, float* __restrict__ val2_out) {
  using L = Layout<P>;
  constexpr bool SPLIT3 = P == Products::SPLIT3;
  // indices of the low operand and of the hl and lh accumulators (0 under
  // PACKED, whose code never reaches them)
  constexpr int LO = SPLIT3 ? 1 : 0, HL = SPLIT3 ? 1 : 0, LH = SPLIT3 ? 2 : 0;
  __nv_bfloat16* sa[L::OPS];
  __nv_bfloat16* sb[L::OPS];
  float* sd;
  if constexpr (L::ALIAS) {  // one array: the tile over the staging
    __shared__ __align__(128) unsigned char smem[L::BYTES];
#pragma unroll
    for (int s = 0; s < L::OPS; ++s) {
      sa[s] = reinterpret_cast<__nv_bfloat16*>(smem) + s * A_ELEMS;
      sb[s] = reinterpret_cast<__nv_bfloat16*>(smem) + L::OPS * A_ELEMS + s * B_ELEMS;
    }
    sd = reinterpret_cast<float*>(smem);
  } else {  // three arrays side by side
    __shared__ __align__(128) __nv_bfloat16 a_s[L::OPS * A_ELEMS];
    __shared__ __align__(128) __nv_bfloat16 b_s[L::OPS * B_ELEMS];
    __shared__ __align__(128) float d_s[BM * LDD];
#pragma unroll
    for (int s = 0; s < L::OPS; ++s) {
      sa[s] = a_s + s * A_ELEMS;
      sb[s] = b_s + s * B_ELEMS;
    }
    sd = d_s;
  }
  const __nv_bfloat16* ga[2] = {a, a_lo};
  const __nv_bfloat16* gw[2] = {w, w_lo};

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
    // acc[0]: the packed chain, or hh; acc[1]: hl; acc[2]: lh
    FragC acc[L::ACCS][2][2];
#pragma unroll
    for (int p = 0; p < L::ACCS; ++p)
#pragma unroll
      for (int fm = 0; fm < 2; ++fm)
#pragma unroll
        for (int fn = 0; fn < 2; ++fn) wmma::fill_fragment(acc[p][fm][fn], 0.0f);

    for (int k0 = 0; k0 < k; k0 += BK) {
      {  // A chunks: BM x BK, one 16-byte vector per thread and operand
        const int r = tid >> 2;
        const int kq = (tid & 3) * 8;
        const int gr = row0 + r;
        const int gk = k0 + kq;
        const bool in = gr < n && gk < k;
#pragma unroll
        for (int s = 0; s < L::OPS; ++s) {
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (in) v = *reinterpret_cast<const uint4*>(ga[s] + (size_t)gr * k + gk);
          *reinterpret_cast<uint4*>(sa[s] + r * LDA + kq) = v;
        }
      }
#pragma unroll
      for (int it = 0; it < 2; ++it) {  // W chunks: BK x BN, two vectors each
        const int e = tid + it * THREADS;
        const int kr = e >> 4;
        const int cq = (e & 15) * 8;
        const int gk = k0 + kr;
        const int gc = col0 + cq;
        const bool in = gk < k && gc < ldw;
#pragma unroll
        for (int s = 0; s < L::OPS; ++s) {
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (in) v = *reinterpret_cast<const uint4*>(gw[s] + (size_t)gk * ldw + gc);
          *reinterpret_cast<uint4*>(sb[s] + kr * LDB + cq) = v;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        if (k0 + kk < k) {  // uniform over the block
          FragA fa[L::OPS][2];
          FragB fb[L::OPS][2];
#pragma unroll
          for (int s = 0; s < L::OPS; ++s) {
#pragma unroll
            for (int fm = 0; fm < 2; ++fm)
              wmma::load_matrix_sync(fa[s][fm], sa[s] + (warp_m * 32 + fm * 16) * LDA + kk,
                                     LDA);
#pragma unroll
            for (int fn = 0; fn < 2; ++fn)
              wmma::load_matrix_sync(fb[s][fn], sb[s] + kk * LDB + warp_n * 32 + fn * 16,
                                     LDB);
          }
#pragma unroll
          for (int fm = 0; fm < 2; ++fm)
#pragma unroll
            for (int fn = 0; fn < 2; ++fn) {
              wmma::mma_sync(acc[0][fm][fn], fa[0][fm], fb[0][fn], acc[0][fm][fn]);
              if constexpr (SPLIT3) {
                wmma::mma_sync(acc[HL][fm][fn], fa[0][fm], fb[LO][fn], acc[HL][fm][fn]);
                wmma::mma_sync(acc[LH][fm][fn], fa[LO][fm], fb[0][fn], acc[LH][fm][fn]);
              }
            }
        }
      }
      __syncthreads();
    }
    // to shared memory (SPLIT3: cross = (hh + hl) + lh, element by element;
    // the chunk loop's last barrier has retired every staging read)
#pragma unroll
    for (int fm = 0; fm < 2; ++fm)
#pragma unroll
      for (int fn = 0; fn < 2; ++fn) {
        if constexpr (SPLIT3) {
#pragma unroll
          for (int e = 0; e < acc[0][fm][fn].num_elements; ++e)
            acc[0][fm][fn].x[e] = __fadd_rn(__fadd_rn(acc[0][fm][fn].x[e], acc[HL][fm][fn].x[e]),
                                            acc[LH][fm][fn].x[e]);
        }
        wmma::store_matrix_sync(sd + (warp_m * 32 + fm * 16) * LDD + warp_n * 32 + fn * 16,
                                acc[0][fm][fn], LDD, wmma::mem_row_major);
      }
    __syncthreads();

    // per-thread pass over its columns, in increasing index order; under
    // SPLIT3, -2 * cross is exact, so d rounds once, as -2.0 * cross + w_sq
    float tv = INFINITY, tv2 = INFINITY;
    int ti = INT_MAX, ti2 = INT_MAX;
    for (int c = fsub; c < BN; c += 4) {
      const int gc = col0 + c;
      if (gc >= xy) break;
      const float s = sd[frow * LDD + c];
      const float v = SPLIT3 ? __fadd_rn(-2.0f * s, w_sq[gc]) : s;
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
    // without aliasing, sd is rewritten only after the next tile's chunk
    // loop, whose barriers every thread reaches after finishing this pass;
    // with it, the next tile's staging overwrites sd
    if constexpr (L::ALIAS) __syncthreads();
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
            xy, ldw, static_cast<int*>(idx), static_cast<float*>(val), nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

int xps_bmu_top2(const void* a, const void* w, int n, int k, int xy, int ldw,
                 void* idx, void* val, void* idx2, void* val2, void* stream) {
  if (n > 0) {
    gemm_bmu_kernel<Products::PACKED, true>
        <<<(n + BM - 1) / BM, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<bf16p>(a), nullptr, static_cast<bf16p>(w), nullptr, nullptr, n, k,
            xy, ldw, static_cast<int*>(idx), static_cast<float*>(val),
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
            static_cast<bf16p>(wl), static_cast<const float*>(w_sq), n, k, xy, ldw,
            static_cast<int*>(idx), static_cast<float*>(val), nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
