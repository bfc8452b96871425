// Exact-f32-class GEMM BMU search on the TF32 tensor cores for Hopper
// (sm_90a): K4.
//
// Replaces the Pallas kernel _kernel_highest of
// xpysom_dask_tpu/ops/pallas/bmu.py (bmu_euclidean, mode 'highest'):
//     d[n, j] = -2 * (x[n] . w[j]) + w_sq[j]
// with the dot at f32 accuracy (Precision.HIGHEST on the TPU, itself a
// multi-pass bf16 product on the matrix unit), folded into a running
// first-index argmin. It serves bmu_precision='highest' for the euclidean
// searches and the even-p norm_p expansion (x and w of width D(p+1),
// w_sq = 0), where the accuracy matters: the expansion cancels
// catastrophically below f32.
//
// Split ("3xTF32"). Each operand v is split as hi = tf32_rna(v) and
// lo = tf32_rna(v - hi) (cvt.rna.satfinite.tf32.f32: round to nearest,
// ties away; v - hi is exact) by split_tf32_kernel, once per call
// for x and w, which also lays both halves out as the search reads them
// (below). The dot is accumulated in f32 on the tensor cores as
// lo.hi + hi.lo, then hi.hi, per 8-deep step, and finished as before with
// fmaf(-2, acc, w_sq[j]).
//
// Error envelope, with S = sum_d |x_d||2 w_d| (the term magnitudes of d):
//   * TF32 keeps 11 significant bits, so |v - hi| <= 2^-11 |v| and
//     |v - hi - lo| <= 2^-11 |v - hi| <= 2^-22 |v|; the dropped lo.lo term
//     and the two split residues each err by at most 2^-22 |x_d||w_d| per
//     product: 3 * 2^-22 * S / 2 on the dot, so 3 * 2^-22 * S on d;
//   * the tensor core adds the 3D products into the f32 accumulator with
//     at most one f32 rounding (2^-23 relative, truncation) per add, so at
//     most 3 * D * 2^-23 * S / 2 on the dot, 3 * D * 2^-23 * S on d;
//   * the f32 finish rounds once more (2^-24 |d|).
// So |d_K4 - d_exact| <= (3 * 2^-22 + 3 * D * 2^-23) * S + 2^-24 |d|, about
// 6x the FFMA chain's D * 2^-24 * S (which the cuBLAS plain version keeps).
//
// What bounds it on the H100: three TF32 passes of 2 * N * XY * D
// operations at 495 TFLOP/s, 0.208 ms at the flagship chunk (16384 x
// 16384, D = 64) and 1.04 ms at the p = 4 expansion's D' = 320; one pass of
// FP32 FFMA (the first version, and the least an FFMA kernel could take)
// is 0.513 ms at D = 64. This version takes 0.4970 ms and 1.9016 ms at
// those two shapes on an H100 80GB HBM3 at 700 W (cuBLAS addmm + argmin:
// 1.4538 and 3.9277 ms; chip_smoke.py), 42% and 55% of the TF32 bound;
// the first wgmma version, which copied with per-thread cp.async, took
// 1.16 ms, bound by its copies.
//
// Design (built for reuse by the GEMM searches' later redesign):
//   * one block of two warpgroups owns BM = 128 sample rows (64 each) and
//     loops over all codebook tiles of BN = 128 rows, so nothing carries
//     between blocks;
//   * x and w are both K-major (row-major in D), as the port stores them,
//     which is the only layout wgmma takes for TF32. The split writes each
//     (128-row tile, 16-deep chunk of D) of each half as one contiguous
//     8 KB block in wgmma's canonical no-swizzle layout (8-row x 16-byte
//     core matrices), zero past the rows and past D, so a stage of the
//     search is four bulk copies (cp.async.bulk, one thread, completion on
//     an mbarrier) into a 4-stage ring, two stages ahead. Copying the
//     halves with per-thread 16-byte cp.async instead took twice the
//     tensor-core time on the H100: the copies, not the products, bound it;
//   * per 8-deep step each warpgroup issues three wgmma m64n128k8 from
//     shared memory (lo.hi, hi.lo, hi.hi) into one set of 64 accumulator
//     registers; the copy of the next stage is in flight meanwhile, and a
//     stage is overwritten only after every warpgroup retired the wgmmas
//     that read it (wgmma.wait_group 1, then the stage's barrier), so one
//     stage's wgmmas stay queued behind the running ones;
//   * the finish reads the accumulators in registers: each thread takes
//     its 32 columns of a row in increasing order, a lexicographic (value,
//     index) merge across the quad that shares the row (__shfl_xor_sync),
//     then a strict '<' against the running minimum held in registers (an
//     earlier tile keeps a tie).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int BM = 128;       // sample rows per block (two warpgroups of 64)
constexpr int BN = 128;       // codebook rows per tile
constexpr int BK = 16;        // depth per stage
constexpr int STAGES = 4;
constexpr int AHEAD = 2;      // stages in flight ahead of the one computed
constexpr int THREADS = 256;
constexpr int TILE_FLOATS = 128 * BK;                  // one operand half of a stage
constexpr int STAGE_FLOATS = 4 * TILE_FLOATS;          // x hi, x lo, w hi, w lo
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;  // 128 KB
// canonical no-swizzle K-major layout of a 128 x BK block: core matrix =
// 8 rows x 4 floats (128 B); the BK / 4 core matrices of an 8-row group are
// adjacent (LBO), 8-row groups follow each other (SBO)
constexpr int LBO_BYTES = 128;
constexpr int SBO_BYTES = 128 * (BK / 4);
static_assert(BM == 128 && BN == 128 && BK == 16, "the split's block layout");

__device__ __forceinline__ bool lex_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// round to TF32 (11 significant bits), to nearest with ties away from zero
// (cvt.rna); .satfinite keeps a finite v within half a TF32 ulp of FLT_MAX
// finite (the largest TF32 value) instead of rounding it to Inf, and NaN
// stays NaN. The 13 bits below TF32's are cleared, so hi and lo are f32
// values the tensor core reads whole.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.satfinite.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xffffe000u);
}

// hi = tf32_rna(v), lo = tf32_rna(v - hi) of v (rows, d) row-major, written
// as blocks of 128 rows x BK in the canonical layout, block (tile, chunk)
// at (tile * nk + chunk) * TILE_FLOATS, zero past the rows and past d; one
// 16-byte core-matrix row per thread-step, written in order
__global__ void split_tf32_kernel(const float* __restrict__ v, int rows, int d, int nk,
                                  float4* __restrict__ hi, float4* __restrict__ lo,
                                  long long count4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long block = i / (TILE_FLOATS / 4);
    const int within = static_cast<int>(i % (TILE_FLOATS / 4));
    const long long r = (block / nk) * 128 + (within / 32) * 8 + within % 8;
    const int k = static_cast<int>(block % nk) * BK + ((within / 8) % 4) * 4;
    float a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = r < rows && k + j < d ? v[r * d + k + j] : 0.0f;
    const float4 h = make_float4(tf32_rna(a[0]), tf32_rna(a[1]), tf32_rna(a[2]), tf32_rna(a[3]));
    hi[i] = h;
    lo[i] = make_float4(tf32_rna(__fsub_rn(a[0], h.x)), tf32_rna(__fsub_rn(a[1], h.y)),
                        tf32_rna(__fsub_rn(a[2], h.z)), tf32_rna(__fsub_rn(a[3], h.w)));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one contiguous global block into shared memory, completion counted in
// bytes on the mbarrier
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3ffff) >> 4) | (static_cast<uint64_t>(LBO_BYTES >> 4) << 16) |
         (static_cast<uint64_t>(SBO_BYTES >> 4) << 32);
}

// d (64 rows x 128 codebook rows of the warpgroup, f32) += A . B^T, both
// operands TF32 from shared memory, K = 8
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// keeps the compiler from moving accumulator accesses across the async ops
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(THREADS, 1)
bmu_highest_kernel(const float* __restrict__ xh, const float* __restrict__ xl,
                   const float* __restrict__ wh, const float* __restrict__ wl,
                   const float* __restrict__ w_sq, int n, int nk, int xy,
                   int* __restrict__ idx_out, float* __restrict__ val_out) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[STAGES];  // stage landed

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;            // warpgroup: rows wg*64 .. +63
  const int g = lane >> 2;            // accumulator row within the warp's 16
  const int t = lane & 3;             // quad lane: columns 2t, 2t + 1 of each 8
  const int row_w = wg * 64 + ((tid >> 5) & 3) * 16 + g;  // this thread's first row
  const int row0 = blockIdx.x * BM;

  const int ntiles = (xy + BN - 1) / BN;
  const int total = nk * ntiles;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&full[s])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // stage it: the x blocks of this row tile and the w blocks of codebook
  // tile it / nk, depth chunk it % nk (one thread issues)
  auto load = [&](int it) {
    if (tid != 0) return;
    float* s = ring + (it % STAGES) * STAGE_FLOATS;
    uint64_t* bar = &full[it % STAGES];
    const size_t xo = ((size_t)blockIdx.x * nk + it % nk) * TILE_FLOATS;
    const size_t wo = (size_t)it * TILE_FLOATS;  // (it / nk) * nk + it % nk
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(4 * TILE_FLOATS * 4)
                 : "memory");
    bulk_copy(s, xh + xo, TILE_FLOATS * 4, bar);
    bulk_copy(s + TILE_FLOATS, xl + xo, TILE_FLOATS * 4, bar);
    bulk_copy(s + 2 * TILE_FLOATS, wh + wo, TILE_FLOATS * 4, bar);
    bulk_copy(s + 3 * TILE_FLOATS, wl + wo, TILE_FLOATS * 4, bar);
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  // running minimum of rows row_w and row_w + 8 (the same in the quad)
  float best[2] = {INFINITY, INFINITY};
  int besti[2] = {0, 0};

  for (int s = 0; s < AHEAD && s < total; ++s) load(s);
  for (int it = 0; it < total; ++it) {
    // this warpgroup's wgmmas of stage it - 2 are retired (those of it - 1
    // may still run); then every warpgroup is, and stage it + 2 takes
    // their buffer
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    __syncthreads();
    if (it + AHEAD < total) load(it + AHEAD);
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);

    const float* s = ring + (it % STAGES) * STAGE_FLOATS;
    const float* a_hi = s + wg * 8 * (SBO_BYTES / 4);  // this warpgroup's 64 rows
    const float* a_lo = a_hi + TILE_FLOATS;
    const float* b_hi = s + 2 * TILE_FLOATS;
    const float* b_lo = s + 3 * TILE_FLOATS;
    const int kc = it % nk;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    // each 8-deep step is two core matrices along K
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      const int off = (ks / 4) * (LBO_BYTES / 4);
      wgmma_tf32(acc, smem_desc(a_lo + off), smem_desc(b_hi + off));
      wgmma_tf32(acc, smem_desc(a_hi + off), smem_desc(b_lo + off));
      wgmma_tf32(acc, smem_desc(a_hi + off), smem_desc(b_hi + off));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");

    if (kc == nk - 1) {
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      // finish the tile: columns j*8 + 2t + e of rows row_w + 8h
      const int col0 = (it / nk) * BN;
      float sq[BN / 8][2];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col0 + j * 8 + 2 * t + e;
          sq[j][e] = c < xy ? w_sq[c] : 0.0f;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tv = INFINITY;
        int ti = INT_MAX;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = col0 + j * 8 + 2 * t + e;
            if (c < xy) {
              // -2 * acc is exact, so one fma rounds like -2 * acc + w_sq
              const float v = fmaf(-2.0f, acc[4 * j + 2 * h + e], sq[j][e]);
              if (lex_less(v, c, tv, ti)) {
                tv = v;
                ti = c;
              }
            }
          }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, tv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, ti, o);
          if (lex_less(ov, oi, tv, ti)) {
            tv = ov;
            ti = oi;
          }
        }
        // later tiles hold higher indices: strict '<' keeps the first
        if (tv < best[h]) {
          best[h] = tv;
          besti[h] = ti;
        }
      }
      // the next tile's sums start from zero
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");

  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + row_w + 8 * h;
      if (r < n) {
        idx_out[r] = besti[h];
        val_out[r] = best[h];
      }
    }
  }
}

}  // namespace

extern "C" {

// v: (rows, d) f32 row-major; hi, lo: ceil(rows / 128) * 128 * nk * 16
// floats each (nk = ceil(d / 16)), 16-byte aligned: the TF32 halves of v
// in the search's block layout. Returns cudaGetLastError().
int xps_split_tf32(const void* v, int rows, int d, void* hi, void* lo, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nk = (d + BK - 1) / BK;
  const long long count4 = (long long)((rows + 127) / 128) * nk * (TILE_FLOATS / 4);
  const int blocks = static_cast<int>(min(8192LL, (count4 + 255) / 256));
  split_tf32_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), rows, d, nk, static_cast<float4*>(hi),
      static_cast<float4*>(lo), count4);
  return static_cast<int>(cudaGetLastError());
}

// xh, xl: the halves of x (n, d) and wh, wl: those of w (xy, d), as
// xps_split_tf32 writes them; w_sq: (xy,) f32; idx: (n,) int32 and
// val: (n,) f32 outputs. Returns cudaGetLastError().
int xps_bmu_highest(const void* xh, const void* xl, const void* wh, const void* wl,
                    const void* w_sq, int n, int d, int xy, void* idx, void* val,
                    void* stream) {
  if (d <= 0 || xy <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        bmu_highest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  bmu_highest_kernel<<<(n + BM - 1) / BM, THREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xh), static_cast<const float*>(xl),
      static_cast<const float*>(wh), static_cast<const float*>(wl),
      static_cast<const float*>(w_sq), n, (d + BK - 1) / BK, xy, static_cast<int*>(idx),
      static_cast<float*>(val));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
