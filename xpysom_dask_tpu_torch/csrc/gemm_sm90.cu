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
//     carries between blocks but the pairs' shared copies (below); the
//     search is gemm_sm90.cuh's search_rows, which K10's persistent blocks
//     run too. One producer thread issues
//     cp.async.bulk copies into a 4-stage ring on mbarriers ("full"); the
//     consumers release a stage on a second mbarrier ("empty", one
//     arrival per consumer warp) once the wgmmas that read it retired
//     (wait_group 1 after the next stage's wgmmas are issued, as K4), so
//     copies run up to four stages ahead and the warpgroups need no block
//     barrier. The role is read through a shuffle: branching on threadIdx
//     alone put the wgmmas on a path ptxas took as divergent, and it
//     serialized them (its warning C7520);
//   * K3's A (both halves) stays resident in shared memory for all
//     codebook tiles where it fits (K <= 256, so D <= 256), copied once,
//     and the ring carries the codebook alone; K1 (and K2, K1-kb, which
//     read its operands) streams its A chunk beside the W chunk in every
//     stage. Measured at the flagship chunk
//     (the kernel alone, chip_smoke.py, two runs): K3 0.3429 resident
//     against 0.3795 streamed; K1 0.3342 and 0.3352 resident against
//     0.3017 and 0.2998 streamed (its resident ring holds half the bytes
//     in flight);
//   * K1's and K2's feed follows the shape (ops/kernels/bmu.py search_feed
//     picks one; the C entries take it as `feed`). Every feed runs the same
//     wgmma chain in the same tile order with the same finish, so all give
//     the same bits:
//     - A in registers (padded depth <= REGISTER_K = 256; one block a row
//       block): each consumer thread loads its warp's rows of A once, as
//       wgmma's register fragments (4 registers a 16-deep step: 52 at
//       K = 208), and the ring carries the codebook chunks alone (8 stages
//       of 16 KB). A block reads its A from L2 once instead of once a
//       codebook tile, and the tensor cores read only the codebook from
//       shared memory. Keeping A resident in shared memory (above) cut the
//       L2 reads too, but not the shared-memory reads, and lost;
//     - pairs (past REGISTER_K, two row blocks or more, the laid-out
//       codebook larger than the 50 MB L2): clusters of PAIR = 2 blocks
//       along the row blocks (cudaLaunchKernelEx with a cluster dimension)
//       that walk the same codebook chunks in the same order. Each block's
//       producer copies its own A chunk and one of the stage's two laid-out
//       codebook chunks (below: rank r the tile's r-th) with one multicast
//       bulk copy into the same stage offset of both blocks, so each
//       block's full[s] expects its A bytes and the whole stage's codebook
//       chunks, and a stage is refilled only once the consumer
//       warps of both blocks released it (empty[s] counts 16 arrivals;
//       lane r of each warp arrives on block r's barrier through mapa, with
//       mbarrier.arrive's default CTA-scope release: at cluster scope each
//       arrival was a fence, and the pairs ran about twice as slow). A
//       cluster barrier follows the barriers' initialisation, and another
//       ends the kernel, so that no block exits while its partner can
//       still arrive on its barriers. With an odd row-block count the last
//       pair's second block has no rows (the laid-out A ends at the last
//       row block): it feeds its half and releases its stages, loading no
//       A and writing nothing. A pair reads each codebook chunk from L2
//       once; each SM still receives every byte of it (48 KB a stage);
//     - A streamed beside each codebook chunk, one block a row block: the
//       rest (a deep codebook that fits L2).
//     On the two deep feeds (A streamed, pairs) a tile is WIDE_BN = 256
//     codebook rows: a stage carries depth chunk c of laid-out tiles 2t and
//     2t + 1 back to back (48 KB with A's 16 KB; four stages), and since
//     the layout's 8-row groups follow one another at SBO = 16 dc bytes the
//     two chunks side by side are the canonical operand of 256 rows, with
//     no other layout or copy of the codebook. A block then reads each A
//     chunk once for every 256 units, half as often: at websom-fit's chunk
//     A's reads fall from 386 to 193 GB a call, and each SM receives 24 KB
//     for every 1.05 M MACs where it received 32. Where the laid-out tiles are odd
//     in number the last tile's second chunk is not copied (nor counted
//     on full[s]); its columns lie past xy, which the finish never reads.
//     A in registers keeps 128-row tiles: 52 fragment registers at
//     K = 208 and a 128-register set would not fit beside each other.
//     Measured on one H100 (chip_smoke.py phase_feeds; PERF.md): at the flagship
//     chunk K1 0.2746 ms streamed, 0.2196 with A in registers, 0.3103 as
//     pairs (K2 0.3732, 0.3513, 0.4116) on 128-row tiles; at websom-fit's
//     chunk (K = 1504, a 3.0 GB codebook operand) K1 144.4 ms streamed,
//     136.6 as pairs (K2 142.9, 138.8) on 128-row tiles, and 89.8-104.6
//     streamed, 87.3-88.1 as pairs (K2 87.5-97.3, 99.1-103.5) on
//     256-row tiles. K1's ring alone (variant FEED: the copies, no
//     products) delivers the flagship chunk's 1.745 GB at 9.7-10.0 TB/s,
//     where K1 streamed reads it at 6.4 TB/s: L2 bandwidth does not cap
//     K1 there. Rings of 5-7 stages were no faster at the flagship chunk
//     and slower at websom-fit's. K10, K3 and K1-kb keep A streamed (K3
//     resident), one block a row block;
//   * K1, K2, K1-kb: per 16-deep step one wgmma m64n128k16 per warpgroup
//     into 64 accumulator registers (K1-kb adds 64 for its running sum;
//     K1 and K2 on the deep feeds one m64n256k16 into 128, A read from
//     shared memory once for all 256 columns);
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
//     running sum as K1 finishes its chain. The first design's WMMA
//     m16n16k16 search gave the same sums bit for bit: the tensor cores
//     add each 16-deep product in the same order;
//   * K1-kb closes a slab at its last chunk: wait_group 0, both stages
//     released, then running += fresh; the next slab's first wgmma runs
//     with scale-d 0 into the same fresh set, so no instruction writes an
//     accumulator that a wgmma may still be writing.
// Bounds: rows >= n are neither read (zero in the layout) nor written;
// codebook rows >= xy are never candidates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"  // the search, its constants and variants

namespace {

using namespace xps_gemm;

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

// One row block per block: the search of gemm_sm90.cuh. CLUSTER > 1:
// clusters of CLUSTER blocks that share each codebook chunk; RA > 0: A in
// registers, RA chunks deep; NS: the ring's stages; WIDE: tiles of WIDE_BN
// codebook rows.
template <Search S, int CLUSTER, int RA = 0, int NS = STAGES, bool WIDE = false>
__global__ void __launch_bounds__(THREADS, 1)
gemm_sm90_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ a_lo,
                 const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ w_lo,
                 const float* __restrict__ w_sq, int n, int k16, int xy, int resident, int slab,
                 int* __restrict__ idx_out, float* __restrict__ val_out,
                 int* __restrict__ idx2_out, float* __restrict__ val2_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) RingOf<NS> bar;
  if (threadIdx.x == 0) ring_init<CLUSTER>(bar);
  if constexpr (CLUSTER > 1) {
    cluster_sync();  // every block's barriers initialised before any copy lands on them
  } else {
    __syncthreads();
  }
  search_rows<S, CLUSTER, RA, WIDE>(bar, smem, blockIdx.x, a, a_lo, w, w_lo, w_sq, n, k16, xy,
                                    resident, slab, idx_out, val_out, idx2_out, val2_out);
  // the others' consumers may still arrive on this block's barriers
  if constexpr (CLUSTER > 1) cluster_sync();
}

template <Search S, int CLUSTER = 1, int RA = 0, int NS = STAGES, bool WIDE = false>
int launch(const void* a, const void* a_lo, const void* w, const void* w_lo, const void* w_sq,
           int n, int k16, int xy, int resident, int slab, void* idx, void* val, void* idx2,
           void* val2, void* stream) {
  using C = CfgOf<S, WIDE>;
  // A in registers: the ring carries the codebook alone
  constexpr int smem_bytes = RA ? NS * C::OPS * C::B_CHUNK : C::smem_bytes(NS);
  static_assert(smem_bytes <= 227 * 1024, "shared memory of a search");
  if (k16 <= 0 || k16 % 16 || xy <= 0 || (resident && k16 > RESIDENT_K) ||
      (RA && (k16 + BK - 1) / BK != RA) || (S == Search::KBLOCKED && slab <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_sm90_kernel<S, CLUSTER, RA, NS, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int blocks = (n + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + CLUSTER - 1) / CLUSTER * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gemm_sm90_kernel<S, CLUSTER, RA, NS, WIDE>, static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(a_lo), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(w_lo), static_cast<const float*>(w_sq), n, k16, xy,
      resident, slab, static_cast<int*>(idx), static_cast<float*>(val), static_cast<int*>(idx2),
      static_cast<float*>(val2));
  const cudaError_t last = cudaGetLastError();  // read (and cleared) either way
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// K1 or K2 (S) on its feed (the Feed enum of gemm_sm90.cuh), the deep
// feeds on tiles of WIDE_BN codebook rows; cudaErrorInvalidValue for
// another feed, or A in registers past REGISTER_K
template <Search S>
int launch_fed(int feed, const void* a, const void* w, int n, int k16, int xy, void* idx,
               void* val, void* idx2, void* val2, void* stream) {
  if (feed == FEED_STREAMED)
    return launch<S, 1, 0, STAGES, true>(a, nullptr, w, nullptr, nullptr, n, k16, xy, 0, 0, idx,
                                         val, idx2, val2, stream);
  if (feed == FEED_PAIRS)
    return launch<S, PAIR, 0, STAGES, true>(a, nullptr, w, nullptr, nullptr, n, k16, xy, 0, 0,
                                            idx, val, idx2, val2, stream);
  if (feed != FEED_REGISTERS) return static_cast<int>(cudaErrorInvalidValue);
  switch ((k16 + BK - 1) / BK) {
    case 1:
      return launch<S, 1, 1, REG_STAGES>(a, nullptr, w, nullptr, nullptr, n, k16, xy, 0, 0, idx,
                                         val, idx2, val2, stream);
    case 2:
      return launch<S, 1, 2, REG_STAGES>(a, nullptr, w, nullptr, nullptr, n, k16, xy, 0, 0, idx,
                                         val, idx2, val2, stream);
    case 3:
      return launch<S, 1, 3, REG_STAGES>(a, nullptr, w, nullptr, nullptr, n, k16, xy, 0, 0, idx,
                                         val, idx2, val2, stream);
    case 4:
      return launch<S, 1, 4, REG_STAGES>(a, nullptr, w, nullptr, nullptr, n, k16, xy, 0, 0, idx,
                                         val, idx2, val2, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
// transpose (xy x k16) laid out in 128-row tiles; feed: FEED_STREAMED,
// FEED_PAIRS or FEED_REGISTERS (k16 <= REGISTER_K). idx: (n,) int32 and
// val: (n,) f32 outputs. Returns the launch's error.
int xps_gemm_argmin(const void* a, const void* w, int n, int k16, int xy, int feed, void* idx,
                    void* val, void* stream) {
  return launch_fed<Search::ARGMIN>(feed, a, w, n, k16, xy, idx, val, nullptr, nullptr, stream);
}

// K3. xh, xl: the samples' split (n x k16) laid out in 128-row tiles; wh,
// wl: the codebook's split (xy x k16) laid out in 64-row tiles; w_sq: (xy,)
// f32. Returns the launch's error.
int xps_gemm_split3(const void* xh, const void* xl, const void* wh, const void* wl,
                    const void* w_sq, int n, int k16, int xy, int resident, void* idx, void* val,
                    void* stream) {
  return launch<Search::SPLIT3>(xh, xl, wh, wl, w_sq, n, k16, xy, resident, 0, idx, val, nullptr,
                                nullptr, stream);
}

// K2. a, w, feed: as K1's; idx, val: the winner, idx2, val2: the
// runner-up, (n,) int32 and f32 each. Returns the launch's error.
int xps_gemm_top2(const void* a, const void* w, int n, int k16, int xy, int feed, void* idx,
                  void* val, void* idx2, void* val2, void* stream) {
  return launch_fed<Search::TOP2>(feed, a, w, n, k16, xy, idx, val, idx2, val2, stream);
}

// K1's feed alone (variant FEED): K1's grid, ring and copies on K1's
// operands on the deep feeds (A streamed, tiles of WIDE_BN codebook rows),
// each stage released as it lands, no product and no output; cluster: 1,
// or PAIR (pairs of row blocks sharing each codebook chunk). What the
// ring's copies can deliver, timed beside K1. Returns the launch's error.
int xps_gemm_feed(const void* a, const void* w, int n, int k16, int xy, int cluster,
                  void* stream) {
  if (cluster == 1)
    return launch<Search::FEED, 1, 0, STAGES, true>(a, nullptr, w, nullptr, nullptr, n, k16, xy,
                                                    0, 0, nullptr, nullptr, nullptr, nullptr,
                                                    stream);
  if (cluster == PAIR)
    return launch<Search::FEED, PAIR, 0, STAGES, true>(a, nullptr, w, nullptr, nullptr, n, k16,
                                                       xy, 0, 0, nullptr, nullptr, nullptr,
                                                       nullptr, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
