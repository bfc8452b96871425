// Deterministic per-BMU statistics scatter for Hopper (sm_90a): K9.
//
// Replaces the Pallas kernel _kernel of xpysom_dask_tpu/ops/pallas/stats.py:
//     acc[idx_n] += [x_n | 1] * m_n     into a fresh (XY, D+1) f32 partial.
// The TPU kernel walks the rows in order and read-modify-writes one
// accumulator row per sample. Float atomics would change the summation
// order from run to run, and the JAX tests pin bitwise reproducibility, so
// the contract here is: acc[b, c] is the sum over node b's rows IN ROW
// ORDER, starting from 0.0, of __fmul_rn([x|1][c], m) added with
// __fadd_rn -- the order of the Pallas kernel and of XLA's CPU scatter.
// Indices outside [0, xy) contribute nothing; every output element is
// written (zeros for nodes without rows); there are no float atomics.
//
// What bounds it on the H100: at the flagship chunk (16384 rows, D = 64,
// 16384 nodes) it moves 4.3 MB of rows and 4.3 MB of partial, 0.0026 ms at
// 3.35 TB/s. Its first design (a global stable sort by node, searchsorted
// of the run bounds, then one 128-thread block per node) ran ~10 waves of
// mostly idle blocks, each paying three dependent loads per step.
//
// Design: one launch, no sort, a grid sized to the card.
//   * Each block owns a contiguous range of `nodes` nodes (the wrapper
//     sizes it so the grid is about two blocks per SM) and keeps their
//     (node, column) sums in shared memory for one pass of <= 128 columns.
//   * Scan: the block reads the whole idx vector in row order (16-byte
//     loads; 64 KB at the flagship, served from L2), and compacts the rows
//     that fall in its range into a shared list, in row order (a per-thread
//     hit mask and a block-wide exclusive scan).
//   * Group: when the list is full, or at the end, a stable counting sort
//     inside shared memory groups it by node: per-warp counts of each node
//     (__match_any_sync finds the equal nodes of each 32-entry step), one
//     exclusive scan over the range's nodes and warps, then a stable
//     placement where the same match ranks equal nodes by lane. The
//     warps' segments are in list order, so every node's rows stay in row
//     order.
//   * Stage: the whole block copies the grouped rows' x columns and m
//     into shared memory with cp.async, a half-warp per row, in batches of
//     32 KB, double-buffered: batch k + 1 is in flight while batch k is
//     summed.
//   * Sum: one thread per (node, column) of the nodes in the batch adds
//     its node's staged rows, __fmul_rn(x, m) with __fadd_rn, into its
//     shared running sum, eight rows' loads ahead of their adds. A long
//     run (early training sends ~1e3 rows of a chunk to one node) is one
//     add chain per column, staged by the whole block: ~31 ns a row on an
//     H100 80GB HBM3 at 700 W, the kernel's floor under skew (47.5 us of
//     device time on the flagship's first chunk, whose longest run holds
//     1230 rows; 91.4 us a chunk in the second epoch, whose runs reach
//     ~2900 rows; chip_smoke.py and profile_torch_epoch.py). zeros +
//     index_add_ takes 11.7 us on that first chunk, with float atomics.
//   * Columns: widths above 128 take several passes of the steps above, so
//     any D runs with shared memory bounded by the node range.
// The body over one node range is stats.cuh's scatter_range, which K10's
// second phase runs too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stats.cuh"  // the scatter over one node range, its constants

namespace {

using namespace xps_stats;

// Block b owns nodes [b * nodes_per_block, +nodes_per_block) of [0, xy).
// Two blocks per SM lets ptxas use up to 128 registers, enough to keep the
// chain's eight rows of loads in flight.
__global__ void __launch_bounds__(THREADS, 2)
scatter_stats_kernel(const float* __restrict__ x, const float* __restrict__ m,
                     const int* __restrict__ idx, int n, int d, int xy,
                     int nodes_per_block, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int node0 = blockIdx.x * nodes_per_block;
  scatter_range<OwnBlock>(smem_raw, x, m, idx, n, d, node0, min(nodes_per_block, xy - node0),
                          nodes_per_block, out);
}

}  // namespace

extern "C" {

// x: (n, d) f32; m: (n,) f32; idx: (n,) int32 (entries outside [0, xy)
// are dropped); out: (xy, d + 1) f32, every element written. Block b owns
// nodes [b * nodes_per_block, ...), 1 <= nodes_per_block <= 128.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue
// for a node range the kernel does not take).
int xps_scatter_stats(const void* x, const void* m, const void* idx, int n, int d, int xy,
                      int nodes_per_block, void* out, void* stream) {
  if (nodes_per_block < 1 || nodes_per_block > MAX_NODES || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (xy <= 0) return static_cast<int>(cudaGetLastError());
  const int smem = smem_bytes(nodes_per_block, d);
  static int smem_set = 0;  // the largest dynamic size granted so far
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        scatter_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    // all of the SM's shared memory, so that two blocks fit on each SM
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(scatter_stats_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  const int blocks = (xy + nodes_per_block - 1) / nodes_per_block;
  scatter_stats_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m),
      static_cast<const int*>(idx), n, d, xy, nodes_per_block, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
