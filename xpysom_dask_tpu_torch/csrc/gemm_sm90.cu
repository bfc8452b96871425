// GEMM-form BMU searches on Hopper's wgmma (sm_90a), four variants of one
// kernel: K1 (packed, bf16 and split2 operands: one augmented bf16
// K-chain), K3 (mode 'split3': three separate f32 accumulations), K2 (K1's
// chain with a top-2 finish) and K1-kb (K1's chain with K summed slab by
// slab), with the pre-pass that lays their operands out for wgmma.
//
// Replaces the Pallas kernels _kernel_gemm_argmin, _kernel_split3,
// _kernel_gemm_top2 and _kernel_gemm_argmin_kb of
// xpysom_dask_tpu/ops/pallas/bmu.py:
//   K1  d[n, j] = A[n, :] . W_aug[:, j]  (A = [xh | xl | xh | 1 1 1] and
//       W_aug = [wh; wh; wl; s1; s2; s3], or the bf16/split2 operands,
//       prepared by ops/kernels/bmu.py), so d = -2 x.w + |w|^2 in f32;
//   K3  cross = (xh.wh + xh.wl) + xl.wh, three f32 accumulations summed
//       per element with __fadd_rn in the JAX kernel's order, then
//       d = __fadd_rn(-2 * cross, w_sq[j]). The order is the mode's
//       documented behaviour: it can flip float64 near-ties relative to the
//       packed single chain, so the three sets are not folded into one
//       K-chain;
//   K2  K1's d, ranked to the two best (value, index) pairs of each row in
//       stable-argsort order: a duplicate minimum is the runner-up with
//       val2 == val. Its first place is K1's, bit for bit (the same wgmma
//       chain and the same first-place compares);
//   K1-kb  K1's d with K cut into slabs of kblock (a multiple of 128, so
//       slab ends fall on the layout's 64-deep chunk ends): each slab runs
//       into a fresh accumulator set, added into a running f32 sum with
//       __fadd_rn, the Pallas kernel's d_acc += dot(a_k, w_k) from 0.0.
//       K is not padded to kblock: the last slab closes at K's end (zero
//       depth would add exact zeros);
// each folded into the first-index argmin (K2: the top two) of every
// sample row; the (N, XY) distance matrix never reaches device memory.
//
// What bounds them on the H100: at the flagship chunk (16384 rows x 16384
// nodes, D = 64) K1 is 2 N XY K = 1.1e11 bf16 operations (K = 208), 0.113
// ms at 989 TFLOP/s, and K3 3 x 2 N XY 64 = 1.0e11, 0.104 ms: the tensor
// cores. Measured with A resident in both (chip_smoke.py, one H100 80GB
// HBM3 at 700 W): K1 0.3486 ms through its wrapper (the samples' layout
// included; one bf16 cuBLAS product with an f32 output + argmin takes
// 0.8254), K3 0.3546 ms, 32% and 29% of the bound. The first versions (WMMA
// m16n16k16, synchronous staging through registers, a shared-memory
// distance tile) took 1.2676 and 1.6549. ptxas: K1 90 registers, K3 135,
// no spills. K2 and K1-kb ran on that WMMA design too (1.4763 ms at the
// flagship chunk; 13.5092 at packed D = 512, kblock 512, K padded from 1552
// to 2048); their times and registers on this pipeline are in PERF.md.
//
// Design (K4's pipeline, csrc/highest.cu, generalised):
//   * layout pre-pass (layout_kernel): an operand of R rows x K is written
//     in tiles of T rows (T = 128 sample rows, or the codebook tile width
//     BN), each tile as chunks of BK = 64 depth (the last chunk dc <= 64
//     deep, K padded to 16), each chunk contiguous in wgmma's canonical
//     no-swizzle K-major layout: core matrices of 8 rows x 8 bf16 (16
//     bytes a row), the dc / 8 core matrices of an 8-row group adjacent
//     (LBO 128 bytes), 8-row groups at SBO = 16 dc bytes; zero past the
//     rows and past K. A chunk is then one bulk copy. The codebook is laid
//     out once per PackedCodebook (once per epoch); the samples are packed
//     (split, ones columns, padding) and laid out in one pass per chunk
//     (pack_layout_kernel), which took ~10 launches of glue before;
//   * a block of two consumer warpgroups (64 sample rows each, BM = 128)
//     and one producer warp loops over all codebook tiles, so nothing
//     carries between blocks. One producer thread issues cp.async.bulk
//     copies into a 4-stage ring on mbarriers ("full"); the consumers
//     release a stage on a second mbarrier ("empty", one arrival per
//     consumer warp) once the wgmmas that read it retired (wait_group 1
//     after the next stage's wgmmas are issued, as K4), so copies run up
//     to four stages ahead and the warpgroups need no block barrier. The
//     role is read through a shuffle: branching on threadIdx alone put the
//     wgmmas on a path ptxas took as divergent, and it serialized them
//     (its warning C7520);
//   * K3's A (both halves) stays resident in shared memory for all
//     codebook tiles where it fits (K <= 256, so D <= 256), copied once,
//     and the ring carries the codebook alone; K1 (and K2, K1-kb, which
//     read its operands) streams its A chunk beside the W chunk in every
//     stage. Measured at the flagship chunk
//     (the kernel alone, chip_smoke.py, two runs): K3 0.3429 resident
//     against 0.3795 streamed; K1 0.3342 and 0.3352 resident against
//     0.3017 and 0.2998 streamed (its resident ring holds half the bytes
//     in flight);
//   * K1, K2, K1-kb: per 16-deep step one wgmma m64n128k16 per warpgroup
//     into 64 accumulator registers (K1-kb adds 64 for its running sum);
//     K3: three wgmma m64n64k16 (hh, hl, lh) into
//     three sets of 32 (BN = 64 keeps them at 96 registers). A tile's
//     first product runs with scale-d 0, so no other instruction zeroes
//     the accumulators (zeroing them behind in-flight wgmmas made ptxas
//     serialize them, warning C7515). A second accumulator bank for K1,
//     finishing tile t - 1 while tile t's first chunk ran, was no faster
//     in a trial and was dropped;
//   * the finish reads the accumulators in registers: each thread walks its
//     columns of its two rows in increasing index order (a strict '<', the
//     column offsets immediates), a lexicographic (value, index) merge
//     across the quad that shares a row (__shfl_xor_sync), then a strict
//     '<' against the running minimum held in registers, so an earlier
//     tile keeps a tie. K2 walks the same columns keeping two (value,
//     offset) places, merges the quad's pairs and the running pair with
//     merge_top2 (lexicographic (value, index) order); K1-kb finishes its
//     running sum as K1 finishes its chain. K1's sums equal the WMMA
//     search's (K10's phase 1) bit for bit: the tensor cores add each
//     16-deep product in the same order;
//   * K1-kb closes a slab at its last chunk: wait_group 0, both stages
//     released, then running += fresh; the next slab's first wgmma runs
//     with scale-d 0 into the same fresh set, so no instruction writes an
//     accumulator that a wgmma may still be writing.
// Bounds: rows >= n are neither read (zero in the layout) nor written;
// codebook rows >= xy are never candidates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

#include "sm90.cuh"  // bulk copies, mbarriers, descriptors, fences

namespace {

using namespace xps_sm90;

constexpr int BM = 128;           // sample rows per block (two warpgroups of 64)
constexpr int BK = 64;            // depth of a layout chunk and of a stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;    // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int RESIDENT_K = 256;   // A stays resident up to this padded depth
constexpr int LBO_BYTES = 128;    // between the core matrices adjacent along K

// The searches: K1's argmin, K3's three products, K2's top two, K1-kb's
// slab sums
enum class Search { ARGMIN, SPLIT3, TOP2, KBLOCKED };

template <int BN_, int OPS_, int NACC_>
struct Shape {
  static constexpr int BN = BN_;      // codebook rows per tile
  static constexpr int OPS = OPS_;    // operand halves (hi, lo)
  static constexpr int NACC = NACC_;  // wgmma accumulator sets
  static constexpr int REGS = BN / 2;  // f32 accumulators per set
  static constexpr int A_CHUNK = BM * BK * 2;  // bytes of one half's A chunk
  static constexpr int B_CHUNK = BN * BK * 2;
  // resident: the A tile, then the ring of W chunks; streamed: the ring of
  // (A chunk, W chunk) stages
  static constexpr int RESIDENT_BYTES = OPS * BM * RESIDENT_K * 2 + STAGES * OPS * B_CHUNK;
  static constexpr int STREAMED_BYTES = STAGES * OPS * (A_CHUNK + B_CHUNK);
  static constexpr int SMEM_BYTES =
      RESIDENT_BYTES > STREAMED_BYTES ? RESIDENT_BYTES : STREAMED_BYTES;
};

// Each variant's tile width, operand halves and accumulator sets. K2 and
// K1-kb read K1's codebook layout (128-row tiles); K1-kb also keeps a
// running sum of BN / 2 registers beside its set. K3's three sets at
// BN = 64 keep 96 accumulator registers.
template <Search S>
struct Cfg;
template <>
struct Cfg<Search::ARGMIN> : Shape<128, 1, 1> {};
template <>
struct Cfg<Search::SPLIT3> : Shape<64, 2, 3> {};
template <>
struct Cfg<Search::TOP2> : Shape<128, 1, 1> {};
template <>
struct Cfg<Search::KBLOCKED> : Shape<128, 1, 1> {};
static_assert(Cfg<Search::SPLIT3>::SMEM_BYTES <= 227 * 1024, "shared memory of K3");
static_assert(Cfg<Search::ARGMIN>::SMEM_BYTES <= 227 * 1024, "shared memory of K1");

// Merge the sorted pair (ov, oi, ov2, oi2) into the sorted pair
// (v, i, v2, i2), keeping the two lexicographically smallest entries. In
// selects, not branches: lanes of a warp disagree on the outcome.
__device__ __forceinline__ void merge_top2(float& v, int& i, float& v2, int& i2, float ov, int oi,
                                           float ov2, int oi2) {
  const bool first = lex_less(ov, oi, v, i);  // the other's first leads
  // the runner-up: the better of the loser of the firsts and the winner's
  // second
  const bool mine = first ? lex_less(v, i, ov2, oi2) : !lex_less(ov, oi, v2, i2);
  const float nv2 = first ? (mine ? v : ov2) : (mine ? v2 : ov);
  const int ni2 = first ? (mine ? i : oi2) : (mine ? i2 : oi);
  v = first ? ov : v;
  i = first ? oi : i;
  v2 = nv2;
  i2 = ni2;
}

// d (64 rows x 128 codebook rows of the warpgroup, f32) = A . B^T + (acc ?
// d : 0), both operands bf16 K-major from shared memory, K = 16: a tile's
// first product overwrites the accumulators, so they are never zeroed by
// other instructions while a wgmma may be in flight
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(acc));
}

// the same with 64 codebook rows
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// The operand row r and depth k0 .. k0 + 7 of 16-byte unit i of the
// chunked canonical layout above (tiles of trows rows x k16): units run
// tile by tile, chunk by chunk, 8-row group by group, core matrix by core
// matrix along K, row by row.
__device__ __forceinline__ void layout_unit(long long i, int trows, int k16, long long& r,
                                            int& k0) {
  const long long per_tile = (long long)trows * k16 / 8;
  const int per_chunk = trows * BK / 8;
  const long long tile = i / per_tile;
  const int j = static_cast<int>(i - tile * per_tile);
  const int c = j / per_chunk;
  const int jj = j - c * per_chunk;
  const int dc = min(BK, k16 - c * BK);
  const int g = jj / dc, rem = jj - g * dc;  // 8-row group; unit in it
  r = tile * trows + g * 8 + (rem & 7);
  k0 = c * BK + (rem >> 3) * 8;
}

// src element (r, k) at src[r * rs + k * ks], rows x k, written as tiles
// of trows rows x k16 (k padded to 16) in the chunked canonical layout
// above, zero past the rows and past k: one 16-byte core-matrix row
// (8 bf16 along K) per thread-step, in output order
__global__ void layout_kernel(const __nv_bfloat16* __restrict__ src, int rows, int k,
                              long long rs, long long ks, int trows, int k16,
                              uint4* __restrict__ dst, long long count8) {
  const bool vec = ks == 1 && rs % 8 == 0 && k % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count8;
       i += (long long)gridDim.x * blockDim.x) {
    long long r;
    int k0;
    layout_unit(i, trows, k16, r, k0);
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      if (vec) {
        if (k0 < k) out = *reinterpret_cast<const uint4*>(src + r * rs + k0);
      } else {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = k0 + e < k ? src[r * rs + (long long)(k0 + e) * ks] : __float2bfloat16(0.0f);
        out = *reinterpret_cast<const uint4*>(v);
      }
    }
    dst[i] = out;
  }
}

// The samples' side of layout_kernel fused with their packing
// (ops/kernels/bmu.py pack_samples / split3_samples): value (r, k) of the
// operand is, for k < nseg * d, the high or low bf16 half (bit k / d of
// lo_mask) of xc = x[r, k % d] - center[k % d] (no subtraction without a
// center), with hi = bf16_rn(xc) and lo = bf16_rn(xc - hi); then `ones`
// columns of 1; zero past them, to k16, and past the rows. The same
// roundings as the plain version's, so the output is its laid-out
// operand bit for bit.
__global__ void pack_layout_kernel(const float* __restrict__ x, long long ldx,
                                   const float* __restrict__ center, int rows, int d, int nseg,
                                   int lo_mask, int ones, int k16, uint4* __restrict__ dst,
                                   long long count8) {
  const int kseg = nseg * d;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count8;
       i += (long long)gridDim.x * blockDim.x) {
    long long r;
    int k0;
    layout_unit(i, BM, k16, r, k0);
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = k0 + e;
      float out = 0.0f;
      if (r < rows && k < kseg) {
        const int s = k / d, col = k - s * d;
        const float xv = x[r * ldx + col];
        const float xc = center ? __fsub_rn(xv, center[col]) : xv;
        const __nv_bfloat16 hi = __float2bfloat16_rn(xc);
        v[e] = (lo_mask >> s) & 1 ? __float2bfloat16_rn(__fsub_rn(xc, __bfloat162float(hi))) : hi;
        continue;
      }
      if (r < rows && k < kseg + ones) out = 1.0f;
      v[e] = __float2bfloat16_rn(out);
    }
    dst[i] = *reinterpret_cast<const uint4*>(v);
  }
}

// slab: K1-kb's chunks per slab (kblock / BK); unused by the others.
// idx2_out, val2_out: K2's runner-up; unused by the others.
template <Search S>
__global__ void __launch_bounds__(THREADS, 1)
gemm_sm90_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ a_lo,
                 const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ w_lo,
                 const float* __restrict__ w_sq, int n, int k16, int xy, int resident, int slab,
                 int* __restrict__ idx_out, float* __restrict__ val_out,
                 int* __restrict__ idx2_out, float* __restrict__ val2_out) {
  using C = Cfg<S>;
  constexpr int BN = C::BN;
  constexpr bool SPLIT3 = S == Search::SPLIT3;
  constexpr bool TOP2 = S == Search::TOP2;
  constexpr bool KB = S == Search::KBLOCKED;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES];   // stage landed
  __shared__ __align__(8) uint64_t empty[STAGES];  // stage released by every consumer warp
  __shared__ __align__(8) uint64_t a_full;         // resident A landed

  const int tid = threadIdx.x;
  // the warpgroup (2: the producer warp), read through a shuffle so the
  // compiler sees it uniform across the warp: the wgmmas then lie on a
  // uniform path, and ptxas does not serialize them
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int nk = (k16 + BK - 1) / BK;
  const int ntiles = (xy + BN - 1) / BN;
  const int total = nk * ntiles;
  // resident: A tile (OPS halves of BM x k16), then the ring of W chunks
  const int a_bytes = BM * k16 * 2;  // one half's A tile
  unsigned char* ring = resident ? smem + C::OPS * a_bytes : smem;
  const int stage_bytes = C::OPS * (C::B_CHUNK + (resident ? 0 : C::A_CHUNK));

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init(&a_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS / 128) {  // the producer warp: one thread issues every copy
    if (tid != CONSUMERS) return;
    const __nv_bfloat16* ga[2] = {a, a_lo};
    const __nv_bfloat16* gw[2] = {w, w_lo};
    const size_t a_tile = (size_t)blockIdx.x * BM * k16;  // this block's A tile
    if (resident) {
      mbar_expect_tx(&a_full, C::OPS * a_bytes);
#pragma unroll
      for (int h = 0; h < C::OPS; ++h) bulk_copy(smem + h * a_bytes, ga[h] + a_tile, a_bytes, &a_full);
    }
    for (int it = 0; it < total; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
      const int tile = it / nk, c = it - (it / nk) * nk;
      const int dc = min(BK, k16 - c * BK);
      const int b_bytes = BN * dc * 2, ac_bytes = BM * dc * 2;
      unsigned char* st = ring + s * stage_bytes;
      mbar_expect_tx(&full[s], C::OPS * (b_bytes + (resident ? 0 : ac_bytes)));
#pragma unroll
      for (int h = 0; h < C::OPS; ++h) {
        bulk_copy(st + h * C::B_CHUNK, gw[h] + (size_t)tile * BN * k16 + (size_t)BN * c * BK,
                  b_bytes, &full[s]);
        if (!resident)
          bulk_copy(st + C::OPS * C::B_CHUNK + h * C::A_CHUNK, ga[h] + a_tile + (size_t)BM * c * BK,
                    ac_bytes, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg*64 .. +63 of the block
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator row within the warp's 16
  const int q = lane & 3;   // quad lane: columns 2q, 2q + 1 of each 8
  const int row_w = wg * 64 + ((tid >> 5) & 3) * 16 + g;  // this thread's first row

  using Acc = float[C::NACC][C::REGS];
  Acc acc;
#pragma unroll
  for (int p = 0; p < C::NACC; ++p)
#pragma unroll
    for (int i = 0; i < C::REGS; ++i) acc[p][i] = 0.0f;  // defined before any wgmma
  // K1-kb: the tile's running sum of closed slabs, from 0.0 (not a wgmma
  // accumulator: only the consumers' own adds write it)
  float run[KB ? C::REGS : 1];
#pragma unroll
  for (int i = 0; i < (KB ? C::REGS : 1); ++i) run[i] = 0.0f;
  // running minimum of rows row_w and row_w + 8 (the same in the quad);
  // K2 also the runner-up, both places from (+inf, INT_MAX)
  float best[2] = {INFINITY, INFINITY};
  int besti[2] = {TOP2 ? INT_MAX : 0, TOP2 ? INT_MAX : 0};
  float best2[2] = {INFINITY, INFINITY};
  int besti2[2] = {INT_MAX, INT_MAX};

  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(&empty[it % STAGES]);
  };
  // K1-kb: chunk c is the last of its slab (K's last chunk is checked apart)
  auto slab_end = [&](int c) { return KB && c % slab == slab - 1; };

  // wait for stage it (chunk c of its tile) and issue its wgmmas into ac,
  // as one commit group
  auto issue = [&](Acc& ac, int it, int c) {
    const int s = it % STAGES;
    const int dc = min(BK, k16 - c * BK);
    const uint32_t sbo = 16u * dc;  // bytes between 8-row groups of this chunk
    mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned char* st = ring + s * stage_bytes;
    // this warpgroup's 64 rows of the A chunk (8 groups of 8 rows), per half
    const unsigned char* a_c[2];
#pragma unroll
    for (int h = 0; h < C::OPS; ++h)
      a_c[h] = (resident ? smem + h * a_bytes + BM * c * BK * 2
                         : st + C::OPS * C::B_CHUNK + h * C::A_CHUNK) +
               wg * 8 * sbo;
#pragma unroll
    for (int p = 0; p < C::NACC; ++p) fence_acc(ac[p]);
    wgmma_fence();
    // the first chunk of a tile (K1-kb: of a slab) starts its set afresh
    const bool first = KB ? c % slab == 0 : c == 0;
    // a 16-deep step is two core matrices along K
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      if (ks * 16 < dc) {
        const int off = ks * 2 * LBO_BYTES;
        const uint64_t da = smem_desc(a_c[0] + off, LBO_BYTES, sbo);
        const uint64_t db = smem_desc(st + off, LBO_BYTES, sbo);
        const int keep = !first || ks != 0;  // 0: the set's first product
        wgmma_bf16(ac[0], da, db, keep);
        if constexpr (SPLIT3) {
          // hl = xh . wl, lh = xl . wh
          wgmma_bf16(ac[1], da, smem_desc(st + C::B_CHUNK + off, LBO_BYTES, sbo), keep);
          wgmma_bf16(ac[2], smem_desc(a_c[1] + off, LBO_BYTES, sbo), db, keep);
        }
      }
    }
    wgmma_commit();
  };

  // fold tile `tile` (its wgmmas retired) into the running minimum:
  // columns col0 + j*8 + 2q + e of rows row_w + 8h
  auto finish = [&](Acc& ac, int tile) {
#pragma unroll
    for (int p = 0; p < C::NACC; ++p) fence_acc(ac[p]);
    const int col0 = tile * BN;
    float sq[BN / 8][2];
    if constexpr (SPLIT3) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + j * 8 + 2 * q + e;
          sq[j][e] = col < xy ? w_sq[col] : 0.0f;
        }
    }
    // the thread's columns of the tile, in increasing order, as offsets
    // j * 8 + e from col0 + 2q (immediates in the unrolled loop); columns
    // past xy only in the last tile
    const bool full_tile = col0 + BN <= xy;
    const int lim = xy - col0 - 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // first (and K2's second) place; in increasing index order a strict
      // '<' is the lexicographic (value, index) order
      float tv = INFINITY, tv2 = INFINITY;
      int to = -1, to2 = -1;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * j + 2 * h + e;
          float v;
          if constexpr (SPLIT3) {
            // -2 * cross is exact, so d rounds once, as -2.0 * cross + w_sq
            const float cross = __fadd_rn(__fadd_rn(ac[0][r], ac[1][r]), ac[2][r]);
            v = __fadd_rn(-2.0f * cross, sq[j][e]);
          } else if constexpr (KB) {
            v = run[r];
          } else {
            v = ac[0][r];
          }
          if constexpr (TOP2) {
            // selects, not branches (lanes disagree on the outcome)
            const bool in = full_tile || j * 8 + e < lim;
            const bool lt1 = in && v < tv, lt2 = in && v < tv2;
            tv2 = lt1 ? tv : (lt2 ? v : tv2);
            to2 = lt1 ? to : (lt2 ? j * 8 + e : to2);
            tv = lt1 ? v : tv;
            to = lt1 ? j * 8 + e : to;
          } else if (v < tv && (full_tile || j * 8 + e < lim)) {
            tv = v;
            to = j * 8 + e;
          }
        }
      // (INFINITY, INT_MAX) where no column was below +inf
      int ti = to < 0 ? INT_MAX : col0 + 2 * q + to;
      if constexpr (TOP2) {
        int ti2 = to2 < 0 ? INT_MAX : col0 + 2 * q + to2;
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, tv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, ti, o);
          const float ov2 = __shfl_xor_sync(0xffffffffu, tv2, o);
          const int oi2 = __shfl_xor_sync(0xffffffffu, ti2, o);
          merge_top2(tv, ti, tv2, ti2, ov, oi, ov2, oi2);
        }
        // later tiles hold higher indices, so the first place moves only on
        // a strict '<', as K1's
        merge_top2(best[h], besti[h], best2[h], besti2[h], tv, ti, tv2, ti2);
      } else {
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
    }
  };

  if (resident) mbar_wait(&a_full, 0);
  for (int it = 0; it < total; ++it) {
    const int tile = it / nk, c = it - (it / nk) * nk;
    issue(acc, it, c);
    // the wgmmas of it - 1 are retired (of it too where a tile or a slab
    // ends); it - 1 was released already if it ended a tile or a slab
    const bool ends = c == nk - 1 || slab_end(c);
    if (ends) {
      wgmma_wait<0>();
    } else {
      wgmma_wait<1>();
    }
    if (c != 0 && !slab_end(c - 1)) release(it - 1);
    if (ends) {
      release(it);
      if constexpr (KB) {
        fence_acc(acc[0]);
#pragma unroll
        for (int i = 0; i < C::REGS; ++i) run[i] = __fadd_rn(run[i], acc[0][i]);
      }
      if (c == nk - 1) {
        finish(acc, tile);
        if constexpr (KB) {
#pragma unroll
          for (int i = 0; i < C::REGS; ++i) run[i] = 0.0f;
        }
      }
    }
  }

  if (q == 0) {
    const int row0 = blockIdx.x * BM;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + row_w + 8 * h;
      if (r < n) {
        idx_out[r] = besti[h];
        val_out[r] = best[h];
        if constexpr (TOP2) {
          idx2_out[r] = besti2[h];
          val2_out[r] = best2[h];
        }
      }
    }
  }
}

template <Search S>
int launch(const void* a, const void* a_lo, const void* w, const void* w_lo, const void* w_sq,
           int n, int k16, int xy, int resident, int slab, void* idx, void* val, void* idx2,
           void* val2, void* stream) {
  using C = Cfg<S>;
  if (k16 <= 0 || k16 % 16 || xy <= 0 || (resident && k16 > RESIDENT_K) ||
      (S == Search::KBLOCKED && slab <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_sm90_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  gemm_sm90_kernel<S><<<(n + BM - 1) / BM, THREADS, C::SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(a_lo),
      static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(w_lo),
      static_cast<const float*>(w_sq), n, k16, xy, resident, slab, static_cast<int*>(idx),
      static_cast<float*>(val), static_cast<int*>(idx2), static_cast<float*>(val2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// src: rows x k bf16, element (r, c) at src[r * rs + c * ks]; dst:
// ceil(rows / trows) * trows * k16 bf16 (k16 = k rounded up to 16, at
// least k16 if given larger), 16-byte aligned: the operand in the
// searches' chunked canonical layout of trows-row tiles. trows a multiple
// of 64. Returns cudaGetLastError().
int xps_layout_bf16(const void* src, int rows, int k, long long rs, long long ks, int trows,
                    int k16, void* dst, void* stream) {
  if (rows <= 0 || k <= 0 || trows <= 0 || trows % 64 || k16 % 16 || k16 < k)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long count8 = (long long)((rows + trows - 1) / trows) * trows * k16 / 8;
  const int blocks = static_cast<int>(min(8192LL, (count8 + 255) / 256));
  layout_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(src), rows, k, rs, ks, trows, k16,
      static_cast<uint4*>(dst), count8);
  return static_cast<int>(cudaGetLastError());
}

// x: (rows, d) f32 with row stride ldx; center: (d,) f32 or null; dst:
// ceil(rows / 128) * 128 * k16 bf16, 16-byte aligned, k16 = nseg * d +
// ones rounded up to 16: the packed samples laid out in 128-row tiles (see
// pack_layout_kernel). Returns cudaGetLastError().
int xps_pack_layout(const void* x, long long ldx, const void* center, int rows, int d, int nseg,
                    int lo_mask, int ones, int k16, void* dst, void* stream) {
  if (rows <= 0 || d <= 0 || nseg <= 0 || k16 % 16 || k16 < nseg * d + ones)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long count8 = (long long)((rows + BM - 1) / BM) * BM * k16 / 8;
  const int blocks = static_cast<int>(min(8192LL, (count8 + 255) / 256));
  pack_layout_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ldx, static_cast<const float*>(center), rows, d, nseg,
      lo_mask, ones, k16, static_cast<uint4*>(dst), count8);
  return static_cast<int>(cudaGetLastError());
}

// K1. a: the samples' A (n x k16) laid out in 128-row tiles; w: W_aug's
// transpose (xy x k16) laid out in 128-row tiles; resident: keep each
// block's A in shared memory (k16 <= 256). idx: (n,) int32 and val: (n,)
// f32 outputs. Returns cudaGetLastError().
int xps_gemm_argmin(const void* a, const void* w, int n, int k16, int xy, int resident,
                    void* idx, void* val, void* stream) {
  return launch<Search::ARGMIN>(a, nullptr, w, nullptr, nullptr, n, k16, xy, resident, 0, idx,
                                val, nullptr, nullptr, stream);
}

// K3. xh, xl: the samples' split (n x k16) laid out in 128-row tiles; wh,
// wl: the codebook's split (xy x k16) laid out in 64-row tiles; w_sq: (xy,)
// f32. Returns cudaGetLastError().
int xps_gemm_split3(const void* xh, const void* xl, const void* wh, const void* wl,
                    const void* w_sq, int n, int k16, int xy, int resident, void* idx, void* val,
                    void* stream) {
  return launch<Search::SPLIT3>(xh, xl, wh, wl, w_sq, n, k16, xy, resident, 0, idx, val,
                                nullptr, nullptr, stream);
}

// K2. a, w: as K1's (A streamed); idx, val: the winner, idx2, val2: the
// runner-up, (n,) int32 and f32 each. Returns cudaGetLastError().
int xps_gemm_top2(const void* a, const void* w, int n, int k16, int xy, void* idx, void* val,
                  void* idx2, void* val2, void* stream) {
  return launch<Search::TOP2>(a, nullptr, w, nullptr, nullptr, n, k16, xy, 0, 0, idx, val, idx2,
                              val2, stream);
}

// K1-kb. a, w: as K1's (A streamed), k16 not padded to kblock; kblock: the
// slab depth, a positive multiple of 64 (the layout's chunk depth).
// Returns cudaErrorInvalidValue for another kblock, else
// cudaGetLastError().
int xps_gemm_argmin_kb(const void* a, const void* w, int n, int k16, int xy, int kblock,
                       void* idx, void* val, void* stream) {
  if (kblock <= 0 || kblock % BK) return static_cast<int>(cudaErrorInvalidValue);
  return launch<Search::KBLOCKED>(a, nullptr, w, nullptr, nullptr, n, k16, xy, 0, kblock / BK,
                                  idx, val, nullptr, nullptr, stream);
}

}  // extern "C"
