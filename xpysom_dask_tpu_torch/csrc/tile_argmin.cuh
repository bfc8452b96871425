// Register-tiled exact-f32 sample-by-codebook engine for Hopper (sm_90a),
// shared by K5-K7 (elementwise.cu) and K8 (manhattan.cu). The elementwise
// L1 and |x - w|^p terms have no matrix-unit form, so these kernels run on
// the FP32 pipes (and, for K7, the special-function pipe), where the count
// of instructions per term bounds them.
//
// For every sample row n and codebook row j the engine computes
//     d[n, j] = sum_d term(|x[n, d] - w[j, d]|)
// and hands each finished tile to an epilogue: the BMU searches fold it
// into a running first-index (value, index) minimum, so the (N, XY)
// distance matrix never reaches device memory; K8 stores it. The per-pair
// sum runs SERIALLY over d in index order in one f32 accumulator from 0:
// the order of the Pallas kernels' bodies (a Python loop over d adding into
// one tile accumulator) and of the plain PyTorch versions (one d at a time
// into an (N, XY) accumulator). Every subtract, multiply and add is
// explicitly rounded (__fsub_rn, __fmul_rn, __fadd_rn), so no FMA forms and
// K5, K6 and K8 give the plain versions' bits.
//
// Design:
//   * layout pre-pass (layout_f32_kernel in elementwise.cu): an operand of
//     R rows x d is written as tiles of T rows (T = BM for the samples, BN
//     for the codebook), each tile as nk = ceil(d / KC) chunks of KC depth,
//     each chunk d-major ([k][row], zero past the rows and past d), so one
//     chunk is one contiguous bulk copy and a thread reads its rows or
//     columns at one depth as 16-byte vectors. The codebook is laid out once
//     per ElementwiseCodebook (once per epoch or scoring call), the samples
//     once per call;
//   * a block owns BM = 64 sample rows and walks one segment of the
//     codebook's BN = 128-row tiles (blockIdx.y; the wrapper's tile_plan
//     cuts the codebook into segments so that about two blocks per SM are
//     in flight when the sample rows alone would leave SMs idle). Its
//     samples stay resident in shared memory for the whole walk, copied
//     once, where the padded depth is <= RESIDENT_D; deeper samples go
//     through in d-slabs of KC beside the codebook chunk in each stage;
//   * one producer thread streams the codebook chunks by cp.async.bulk into
//     a ring of STAGES stages on mbarriers ("full"); the four consumer warps
//     release a stage on a second mbarrier ("empty", one arrival per warp),
//     so copies run ahead of the sums with no block barrier;
//   * each consumer thread keeps an 8 x 8 register tile of accumulators:
//     rows 4ty .. +3 and 32 + 4ty .. +3, codebook rows 4tx .. +3 and
//     64 + 4tx .. +3 of the tile (tx = tid % 16, ty = tid / 16), read per
//     depth as four 16-byte shared-memory vectors, conflict-free, the next
//     depth's vectors loaded while this one's 64 terms run. A term's chain
//     (K6's and K7's multiplies by t) runs over one row's 8 terms at once,
//     unrolled where the count is a template argument;
//   * the argmin epilogue: per row, the minimum of the thread's 8 columns
//     (fminf), and only where it is below the running minimum the first
//     column holding it; a strict '<' against the running minimum keeps an
//     earlier tile's tie. After the segment, a lexicographic (value, index)
//     merge over the 16 lanes that share a row; with several segments each
//     writes its (value, index) and merge_kernel (elementwise.cu) folds
//     them in segment order with a strict '<', so the first index wins
//     across segments too;
//   * the store epilogue (K8) writes the thread's 8 x 8 values, 16-byte
//     vectors where the row stride allows it.
// Bounds: sample rows >= n are zero in the layout and never written;
// codebook rows >= xy are never candidates and never stored; the d loop
// stops at d (padded depth is never summed).
// The instances' times, registers and SASS instructions per term are in
// PERF.md (chip_smoke.py prints them). The constants are fixed: three
// blocks per SM (launch bounds forcing 128 registers), a fourth stage and
// a deeper unroll were each tried on the H100 and none was faster.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"  // bulk copies, mbarriers, lex_less

namespace xps_tile {

using namespace xps_sm90;

constexpr int BM = 64;   // sample rows per block
constexpr int BN = 128;  // codebook rows per tile
constexpr int KC = 32;   // depth of a laid-out chunk and of a stage
constexpr int TM = 8;    // rows per thread
constexpr int TN = 8;    // codebook rows per thread
constexpr int CONSUMERS = (BM / TM) * (BN / TN);  // 8 row groups x 16 column groups
constexpr int THREADS = CONSUMERS + 32;           // and one producer warp
constexpr int STAGES = 3;
constexpr int RESIDENT_D = 256;  // samples stay resident up to this padded depth
constexpr int X_CHUNK = BM * KC * 4;  // bytes of a samples chunk
constexpr int W_CHUNK = BN * KC * 4;  // bytes of a codebook chunk
static_assert(CONSUMERS == 128, "four consumer warps");

// dynamic shared memory of a launch at padded depth d32: the resident
// samples, then the ring of codebook chunks; or the ring of (codebook
// chunk, samples chunk) stages
__host__ __device__ constexpr int smem_bytes(int d32) {
  return d32 <= RESIDENT_D ? BM * d32 * 4 + STAGES * W_CHUNK : STAGES * (W_CHUNK + X_CHUNK);
}
constexpr int MAX_SMEM = smem_bytes(RESIDENT_D) > smem_bytes(RESIDENT_D + KC)
                             ? smem_bytes(RESIDENT_D)
                             : smem_bytes(RESIDENT_D + KC);
static_assert(MAX_SMEM <= 227 * 1024, "shared memory of a block");

// |a - b| with the subtraction explicitly rounded
__device__ __forceinline__ float absdiff(float a, float b) { return fabsf(__fsub_rn(a, b)); }

// The terms: base(t) of t = |x_d - w_d|, then REPS rounded multiplies by t
// (REPS < 0: reps, passed at run time), then one rounded add.
// K5 and K8: t.
struct L1Term {
  static constexpr int REPS = 0;
  int reps = 0;
  __device__ __forceinline__ float base(float t) const { return t; }
};

// K6: t^p = t * t^(p - 1) for odd p >= 1: REPS = p - 1
template <int R>
struct PowTerm {
  static constexpr int REPS = R;
  int reps;
  __device__ __forceinline__ float base(float t) const { return t; }
};

// K7: p = m + f with m = floor(p) and 0 < f < 1: t^f, then REPS = m
// multiplies by t. t^f on the special-function pipe: sqrt.approx (f = 1/2)
// or ex2.approx(f * lg2.approx(t)); t = 0 gives 0 and t = +inf gives +inf.
// For m = 0 subnormal t and results are kept (the non-.ftz forms' scaling
// costs 4 to 7 more instructions a term); for m >= 1 (REPS != 0) the .ftz
// forms flush them, which changes only
// terms below 2^-126, each by less than 2^-126 (a flushed t or t^f bounds
// the term, as t^p <= t^f < 1 there).
template <bool FTZ>
__device__ __forceinline__ float sqrt_approx(float t) {
  float r;
  if constexpr (FTZ) {
    asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t));
  } else {
    asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(t));
  }
  return r;
}
template <bool FTZ>
__device__ __forceinline__ float lg2_approx(float t) {
  float r;
  if constexpr (FTZ) {
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t));
  } else {
    asm("lg2.approx.f32 %0, %1;" : "=f"(r) : "f"(t));
  }
  return r;
}
template <bool FTZ>
__device__ __forceinline__ float ex2_approx(float y) {
  float r;
  if constexpr (FTZ) {
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  } else {
    asm("ex2.approx.f32 %0, %1;" : "=f"(r) : "f"(y));
  }
  return r;
}

template <bool HALF, int R>
struct FracTerm {
  static constexpr int REPS = R;
  static constexpr bool FTZ = R != 0;
  int reps;
  float f;
  __device__ __forceinline__ float base(float t) const {
    return HALF ? sqrt_approx<FTZ>(t) : ex2_approx<FTZ>(__fmul_rn(f, lg2_approx<FTZ>(t)));
  }
};

// the thread's i-th row and j-th codebook row of a tile
__device__ __forceinline__ int row_of(int i, int ty) { return (i >> 2) * 32 + 4 * ty + (i & 3); }
__device__ __forceinline__ int col_of(int j, int tx) { return (j >> 2) * 64 + 4 * tx + (j & 3); }

struct Operands {
  float4 a0, a1, b0, b1;
};

// the thread's samples and codebook rows at one depth: xk = the chunk's
// samples at that depth (BM floats), wk = its codebook rows (BN floats)
__device__ __forceinline__ Operands load_depth(const float* xk, const float* wk, int ty, int tx) {
  const float4* x4 = reinterpret_cast<const float4*>(xk);
  const float4* w4 = reinterpret_cast<const float4*>(wk);
  return {x4[ty], x4[8 + ty], w4[tx], w4[16 + tx]};
}

// acc[i][j] += term of the thread's 8 x 8 pairs at one depth, row by row
template <class Term>
__device__ __forceinline__ void add_depth(const Term& term, const Operands& o,
                                          float (&acc)[TM][TN]) {
  const float a[TM] = {o.a0.x, o.a0.y, o.a0.z, o.a0.w, o.a1.x, o.a1.y, o.a1.z, o.a1.w};
  const float b[TN] = {o.b0.x, o.b0.y, o.b0.z, o.b0.w, o.b1.x, o.b1.y, o.b1.z, o.b1.w};
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float t[TN], tp[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      t[j] = absdiff(a[i], b[j]);
      tp[j] = term.base(t[j]);
    }
    if constexpr (Term::REPS > 0) {
#pragma unroll
      for (int r = 0; r < Term::REPS; ++r)
#pragma unroll
        for (int j = 0; j < TN; ++j) tp[j] = __fmul_rn(tp[j], t[j]);
    } else if constexpr (Term::REPS < 0) {
#pragma unroll 1
      for (int r = 0; r < term.reps; ++r)
#pragma unroll
        for (int j = 0; j < TN; ++j) tp[j] = __fmul_rn(tp[j], t[j]);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = __fadd_rn(acc[i][j], tp[j]);
  }
}

// the sums of kc depths of one chunk (xs: the samples chunk, ws: the
// codebook chunk, both d-major), the next depth's operands loaded ahead
template <class Term>
__device__ __forceinline__ void add_chunk(const Term& term, const float* xs, const float* ws,
                                          int kc, int ty, int tx, float (&acc)[TM][TN]) {
  Operands cur = load_depth(xs, ws, ty, tx);
  if (kc == KC) {
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      const int kn = min(k + 1, KC - 1);
      const Operands next = load_depth(xs + kn * BM, ws + kn * BN, ty, tx);
      add_depth(term, cur, acc);
      cur = next;
    }
  } else {
#pragma unroll 1
    for (int k = 0; k < kc; ++k) {
      const int kn = min(k + 1, kc - 1);
      const Operands next = load_depth(xs + kn * BM, ws + kn * BN, ty, tx);
      add_depth(term, cur, acc);
      cur = next;
    }
  }
}

// xl: the samples laid out in BM-row tiles; wl: the codebook laid out in
// BN-row tiles (both at padded depth nk * KC); tps: codebook tiles per
// segment (blockIdx.y). Search (STORE false): the (value, index) of each
// row's first-index minimum over the segment into val_out / idx_out at
// [blockIdx.y * n + row]. STORE: the sums into out (n x xy, row-major).
template <class Term, bool STORE>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const float* __restrict__ xl, const float* __restrict__ wl, int n, int d, int xy,
            int tps, Term term, int* __restrict__ idx_out, float* __restrict__ val_out,
            float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES];   // stage landed
  __shared__ __align__(8) uint64_t empty[STAGES];  // stage released by every consumer warp
  __shared__ __align__(8) uint64_t x_full;         // resident samples landed

  const int tid = threadIdx.x;
  const int nk = (d + KC - 1) / KC;
  const int d32 = nk * KC;
  const bool resident = d32 <= RESIDENT_D;
  const int ntiles = (xy + BN - 1) / BN;
  const int t0 = blockIdx.y * tps;
  const int total = (min(ntiles, t0 + tps) - t0) * nk;  // stages of this block's walk
  const float* xb = xl + (size_t)blockIdx.x * BM * d32;  // this block's samples
  const float* xres = reinterpret_cast<const float*>(smem);
  unsigned char* ring = smem + (resident ? BM * d32 * 4 : 0);
  const int stage_bytes = W_CHUNK + (resident ? 0 : X_CHUNK);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init(&x_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread issues every copy
    if (tid != CONSUMERS) return;
    if (resident) {
      mbar_expect_tx(&x_full, BM * d32 * 4);
      bulk_copy(smem, xb, BM * d32 * 4, &x_full);
    }
    for (int it = 0; it < total; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
      const int tile = t0 + it / nk, c = it % nk;
      unsigned char* st = ring + s * stage_bytes;
      mbar_expect_tx(&full[s], stage_bytes);
      bulk_copy(st, wl + ((size_t)tile * nk + c) * BN * KC, W_CHUNK, &full[s]);
      if (!resident) bulk_copy(st + W_CHUNK, xb + (size_t)c * BM * KC, X_CHUNK, &full[s]);
    }
    return;
  }

  const int lane = tid & 31;
  const int tx = tid & 15;  // column group
  const int ty = tid >> 4;  // row group
  float best[STORE ? 1 : TM];
  int besti[STORE ? 1 : TM];
#pragma unroll
  for (int i = 0; i < (STORE ? 1 : TM); ++i) {
    best[i] = INFINITY;
    besti[i] = 0;
  }
  float acc[TM][TN];

  if (resident) mbar_wait(&x_full, 0);
  for (int it = 0; it < total; ++it) {
    const int s = it % STAGES;
    const int tile = t0 + it / nk, c = it % nk;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    }
    mbar_wait(&full[s], (it / STAGES) & 1);
    const float* ws = reinterpret_cast<const float*>(ring + s * stage_bytes);
    const float* xs = resident ? xres + c * KC * BM : ws + BN * KC;
    add_chunk(term, xs, ws, min(KC, d - c * KC), ty, tx, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (c != nk - 1) continue;

    const int col0 = tile * BN;
    const int lim = xy - col0;  // columns below lim are codebook rows
    if constexpr (STORE) {
      const bool vec = (xy & 3) == 0;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = blockIdx.x * BM + row_of(i, ty);
        if (row >= n) continue;
        float* o = out + (size_t)row * xy + col0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cb = h * 64 + 4 * tx;
          if (vec && cb + 4 <= lim) {
            *reinterpret_cast<float4*>(o + cb) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (cb + e < lim) o[cb + e] = acc[i][4 * h + e];
          }
        }
      }
    } else {
      const bool full_tile = lim >= BN;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float m = INFINITY;
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (full_tile || col_of(j, tx) < lim) m = fminf(m, acc[i][j]);
        // a new minimum of the row: the first of the thread's columns
        // (increasing index order) that holds it
        if (m < best[i]) {
          int jj = 0;
#pragma unroll
          for (int j = TN - 1; j >= 0; --j)
            if (acc[i][j] == m && (full_tile || col_of(j, tx) < lim)) jj = j;
          best[i] = m;
          besti[i] = col0 + col_of(jj, tx);
        }
      }
    }
  }

  if constexpr (!STORE) {
    // the 16 lanes of a row group (one half-warp) merge lexicographically
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float v = best[i];
      int bi = besti[i];
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (lex_less(ov, oi, v, bi)) {
          v = ov;
          bi = oi;
        }
      }
      const int row = blockIdx.x * BM + row_of(i, ty);
      if (tx == 0 && row < n) {
        idx_out[(size_t)blockIdx.y * n + row] = bi;
        val_out[(size_t)blockIdx.y * n + row] = v;
      }
    }
  }
}

// codebook segments of a walk with tps tiles per segment
__host__ __device__ inline int segments(int xy, int tps) {
  return ((xy + BN - 1) / BN + tps - 1) / tps;
}

// Launches the engine on `stream` (n > 0, d > 0, xy > 0, tps > 0): the
// search into idx / val (segment s at [s * n + row]), or the store into
// out. Returns cudaGetLastError().
template <class Term, bool STORE>
int launch(const float* xl, const float* wl, int n, int d, int xy, int tps, Term term, int* idx,
           float* val, float* out, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_kernel<Term, STORE>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int nk = (d + KC - 1) / KC;
  tile_kernel<Term, STORE>
      <<<dim3((n + BM - 1) / BM, segments(xy, tps)), THREADS, smem_bytes(nk * KC), stream>>>(
          xl, wl, n, d, xy, tps, term, idx, val, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xps_tile
