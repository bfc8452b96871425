// Fused BMU search + per-BMU statistics for Hopper (sm_90a): K10.
//
// Replaces the Pallas kernel _kernel of xpysom_dask_tpu/ops/pallas/
// fused_stats.py: in one launch, the packed BMU winners of a chunk (K1 on
// the uncentered packed operands) AND the fresh (XY, D+1) f32 partial
//     acc[idx_n] += [x_n | 1] * m_n.
// The TPU kernel scatters each row block's rows into a VMEM-resident
// accumulator once that block's winners are final, walking the grid in
// order. Blocks of a CUDA grid run in no order, so the port splits the
// launch in two phases around one grid-wide barrier, and each phase is
// the device code of the kernel that does that work alone:
//   * phase 1: K1's wgmma search (gemm_sm90.cuh search_rows, variant
//     ARGMIN, A streamed) on threads 0-287 (K1's block: two consumer
//     warpgroups and a producer warp) over the 128-row blocks blockIdx.x,
//     blockIdx.x + gridDim.x, ..., each on a fresh ring (ring_reset between
//     them, behind a named barrier over those 288 threads). Each row's
//     winner and value go to device memory;
//   * cg::this_grid().sync(): every winner is written and visible; every
//     bulk copy phase 1 issued has landed (the consumers waited on each
//     stage) and every wgmma has retired, so phase 2 may reuse the ring's
//     shared memory;
//   * phase 2: K9's scatter (stats.cuh scatter_range) on two groups of 256
//     threads per block, as K9 runs two blocks per SM: group g of block b
//     takes node ranges 2b + g, 2b + g + 2 gridDim.x, ... of `nodes` nodes,
//     in its own half of the shared memory, on its own named barrier; the
//     winners are read through L2 (ld.global.cg), since this launch wrote
//     them. One group of 256 threads per SM ran the scatter slower than K9
//     on skewed chunks, where a thread adds the long runs of more nodes.
// The grid, the node range and the shared memory (the larger of phase 1's
// ring and phase 2's two groups' sums, lists and staging) come from the
// caller's plan (ops/kernels/fused_stats.py fused_plan): one block of 512
// threads per SM, whose last 224 threads wait at the grid barrier while
// phase 1 runs.
// Determinism: the winners are K1's bits and acc is K9's on them bit for
// bit (each node's rows added in row order from 0.0 with __fmul_rn and
// __fadd_rn, no float atomics), on every run and at any grid size.
// No block waits on a flag of another block: the only cross-block wait is
// the cooperative grid barrier, whose launch fails unless every block is
// resident.
//
// What bounds it on the H100: phase 1 is K1 (the tensor cores: 1.1e11
// bf16 operations per flagship chunk, 0.113 ms); phase 2 is K9 (8.6 MB,
// 0.0026 ms, and under skew a long run's add chain). Its first design ran
// phase 1 on K1's first, WMMA search and phase 2 on an older per-warp
// scatter: 1.3701 ms at the uniform flagship chunk against 0.4105 for
// K1 + K9 (PERF.md).

#include <cooperative_groups.h>

#include "gemm_sm90.cuh"
#include "stats.cuh"

namespace cg = cooperative_groups;

namespace {

using xps_gemm::BM;
using xps_gemm::Search;
constexpr int RING_BYTES = xps_gemm::Cfg<Search::ARGMIN>::SMEM_BYTES;
constexpr int GROUPS = 2;  // phase 2's groups of 256 threads
constexpr int THREADS = GROUPS * xps_stats::THREADS;
static_assert(THREADS >= xps_gemm::THREADS, "phase 1 runs on the block's first 288 threads");

// The bytes of one phase-2 group's shared memory (16-byte aligned for its
// staging copies).
__host__ __device__ constexpr int group_bytes(int nodes, int d) {
  return (xps_stats::smem_bytes(nodes, d) + 127) & ~127;
}

__global__ void __launch_bounds__(THREADS, 1)
fused_stats_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ x, const float* __restrict__ m, int n, int k16,
                   int xy, int d, int nodes, int* idx, float* __restrict__ val,
                   float* __restrict__ acc) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) xps_gemm::Ring bar;
  if (threadIdx.x == 0) xps_gemm::ring_init(bar);
  __syncthreads();

  // phase 1: the winners of this block's row blocks, each on a fresh ring,
  // on K1's 288 threads (the warp index read through a shuffle, uniform
  // across the warp, so that ptxas keeps the wgmmas on a uniform path)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp < xps_gemm::THREADS / 32) {
    const int row_blocks = (n + BM - 1) / BM;
    for (int rb = blockIdx.x; rb < row_blocks; rb += gridDim.x) {
      if (rb != blockIdx.x) {
        asm volatile("bar.sync 3, %0;" ::"n"(xps_gemm::THREADS) : "memory");
        if (threadIdx.x == 0) xps_gemm::ring_reset(bar);
        asm volatile("bar.sync 3, %0;" ::"n"(xps_gemm::THREADS) : "memory");
      }
      xps_gemm::search_rows<Search::ARGMIN>(bar, smem, rb, a, nullptr, w, nullptr, nullptr, n,
                                            k16, xy, 0, 0, idx, val, nullptr, nullptr);
    }
  }
  // the ring's bytes were written by bulk copies and read by wgmma (the
  // async proxy); phase 2 writes them through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  cg::this_grid().sync();

  // phase 2: the statistics of this group's node ranges
  const int g = threadIdx.x / xps_stats::THREADS;
  const int ranges = (xy + nodes - 1) / nodes;
  for (int r = GROUPS * blockIdx.x + g; r < ranges; r += GROUPS * gridDim.x)
    xps_stats::scatter_range<xps_stats::FusedGroup>(smem + g * group_bytes(nodes, d), x, m, idx,
                                                     n, d, r * nodes, min(nodes, xy - r * nodes),
                                                     nodes, acc);
}

}  // namespace

extern "C" {

// a: the samples' packed A (n x k16) laid out in 128-row tiles, w: W_aug's
// transpose (xy x k16) laid out in 128-row tiles (K1's operands); x: (n,
// d) f32; m: (n,) f32; idx: (n,) int32 and val: (n,) f32 outputs (the
// winners and their values); acc: (xy, d + 1) f32 output. grid, nodes,
// smem: the plan (blocks; nodes per range, at most 128; dynamic shared
// memory bytes, at least both phases' need: K1's ring, and two groups'
// sums, lists and staging, each rounded up to 128 bytes). Returns
// cudaErrorInvalidValue for a plan the kernel does not take,
// cudaErrorNotSupported without cooperative launch,
// cudaErrorCooperativeLaunchTooLarge when the grid does not fit the card
// at once, else the launch's error.
int xps_bmu_stats_fused(const void* a, const void* w, const void* x, const void* m, int n,
                        int k16, int xy, int d, int grid, int nodes, int smem, void* idx,
                        void* val, void* acc, void* stream) {
  if (n < 0 || xy <= 0 || d < 0 || k16 <= 0 || k16 % 16 || grid < 1 || nodes < 1 ||
      nodes > xps_stats::MAX_NODES || smem < RING_BYTES || smem < GROUPS * group_bytes(nodes, d))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev, sms, coop, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  static int smem_set = 0;  // the largest dynamic size granted so far
  if (e == cudaSuccess && smem > smem_set) {
    e = cudaFuncSetAttribute(fused_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess) smem_set = smem;
  }
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_stats_kernel, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop || per_sm < 1) return static_cast<int>(cudaErrorNotSupported);
  if (grid > per_sm * sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  auto a_ = static_cast<const __nv_bfloat16*>(a);
  auto w_ = static_cast<const __nv_bfloat16*>(w);
  auto x_ = static_cast<const float*>(x);
  auto m_ = static_cast<const float*>(m);
  auto idx_ = static_cast<int*>(idx);
  auto val_ = static_cast<float*>(val);
  auto acc_ = static_cast<float*>(acc);
  void* args[] = {&a_, &w_, &x_, &m_, &n, &k16, &xy, &d, &nodes, &idx_, &val_, &acc_};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_stats_kernel), dim3(grid),
                                  dim3(THREADS), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
