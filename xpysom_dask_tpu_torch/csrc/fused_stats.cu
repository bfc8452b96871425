// Fused BMU search + per-BMU statistics for Hopper (sm_90a): K10.
//
// Replaces the Pallas kernel _kernel of xpysom_dask_tpu/ops/pallas/
// fused_stats.py: in one launch, the packed BMU winners of a chunk (K1 on
// the uncentered packed operands) AND the fresh (XY, D+1) f32 partial
//     acc[idx_n] += [x_n | 1] * m_n.
// The TPU kernel scatters each row block's rows into a VMEM-resident
// accumulator once that block's winners are final, walking the grid in
// order. Blocks of a CUDA grid run in no order, so the port splits the
// launch in two phases around one grid-wide barrier:
//   * phase 1: the grid is persistent (a cooperative launch of as many
//     blocks as can be resident at once, so every block reaches the
//     barrier); each block runs the WMMA one-block search (gemm_bmu.cuh,
//     K1's first version; K1 itself now runs on wgmma, gemm_sm90.cu, with
//     the same sums bit for bit) over 64-row blocks blockIdx.x,
//     blockIdx.x + gridDim.x, ... and writes each row's winner to device
//     memory. The launch asks for enough dynamic shared memory that only
//     ceil(row blocks / SMs) blocks fit on an SM: with room for four, the
//     scheduler put four of a flagship chunk's 256 row blocks on some SMs
//     and one on others, and the launch took 2.35 ms against K1's 1.28
//     (chip_smoke.py, one H100);
//   * cg::this_grid().sync(): every winner is written and visible;
//   * phase 2: each block owns contiguous node ranges of `range` nodes,
//     accumulated in shared memory. It stages the winners 256 at a time;
//     each warp owns the range's nodes whose offset is its warp index
//     modulo 8, lists its rows of the 256 in row order (a ballot per 32),
//     and adds each listed row's [x | 1] * m into its node's shared row, a
//     lane per column, the rows' loads issued eight at a time ahead of the
//     adds. Listing first matters under skew: a node with a long run has
//     a row or two in most 32-row groups, and batching per group paid a
//     load latency for each. Then the range's rows go to acc, every
//     element written once.
// Determinism: no float atomics. Each (node, column) element is summed by
// one lane, starting from 0.0, over that node's rows in row order, with
// explicitly rounded multiply and add: the row-serial order of the Pallas
// kernel and of K9 (stats.cu), so acc equals K9's on the same winners bit
// for bit, on every run and at any grid size; the winners are K1's bits
// (chip_smoke.py checks both).
// No block waits on a flag of another block: the only cross-block wait is
// the cooperative grid barrier, whose launch fails unless every block is
// resident.
//
// What bounds it on the H100: phase 1 is K1 (the tensor cores: 5.6e10
// bf16 multiply-adds per flagship chunk); phase 2 reads each row once
// (4.3 MB at the flagship) and each block scans the N winners from L2.
// A node that takes a long run of rows (early training) serializes in
// one warp: the design's cost under skew. On one H100 (chip_smoke.py) a
// uniform flagship chunk took 1.33 ms against K1 + K9's 1.42, the first
// chunk under the initial codebook (1230 rows on one node) 1.70 against
// 1.54, when K1 was the WMMA search; against the wgmma K1 + K9 it takes
// 1.3405 against 0.4252 and 1.7004 against 0.4485.

#include <cooperative_groups.h>

#include "gemm_bmu.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace xps_gemm;

constexpr int WARPS = THREADS / 32;
// listed rows whose loads are issued together (16 was no faster on the
// H100 and needs more registers)
constexpr int BATCH = 8;
// dynamic shared memory: K1's staging and tile side by side, reused by
// phase 2 for the staged winners and the range's accumulator
constexpr int SMEM = (A_ELEMS + B_ELEMS) * (int)sizeof(__nv_bfloat16) + D_BYTES;
// the staged winners and masks, and each warp's list of its rows
constexpr int STAGED = THREADS * (2 + WARPS) * (int)sizeof(float);

// two blocks per SM at most 128 registers each: phase 1 then overlaps two
// row blocks per SM as K1 does
__global__ void __launch_bounds__(THREADS, 2)
fused_stats_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ x, const float* __restrict__ m, int n, int k,
                   int xy, int ldw, int d, int range, int* idx, float* __restrict__ val,
                   float* __restrict__ acc) {
  extern __shared__ __align__(128) unsigned char smem[];
  Stage st;
  st.sa = reinterpret_cast<__nv_bfloat16*>(smem);
  st.sb = st.sa + A_ELEMS;
  st.sd = reinterpret_cast<float*>(st.sb + B_ELEMS);

  // phase 1: the winners
  const int row_blocks = (n + BM - 1) / BM;
  for (int rb = blockIdx.x; rb < row_blocks; rb += gridDim.x)
    gemm_bmu_rows(st, rb * BM, a, w, n, k, xy, ldw, idx, val);
  cg::this_grid().sync();

  // phase 2: the statistics of node ranges
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_m = reinterpret_cast<float*>(smem) + THREADS;
  float* s_acc = reinterpret_cast<float*>(smem + STAGED);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int width = d + 1;
  const int ranges = (xy + range - 1) / range;
  for (int r = blockIdx.x; r < ranges; r += gridDim.x) {
    const int lo = r * range;
    const int cnt = min(range, xy - lo);
    __syncthreads();  // the previous range's write-out, or phase 1's tile
    for (int e = tid; e < cnt * width; e += THREADS) s_acc[e] = 0.0f;
    for (int base = 0; base < n; base += THREADS) {
      __syncthreads();  // zeroing done, the previous group's reads done
      const int row = base + tid;
      // written in this launch: read through L2, not the read-only path
      s_idx[tid] = row < n ? __ldcg(idx + row) : -1;
      s_m[tid] = row < n ? m[row] : 0.0f;
      __syncthreads();
      // this warp's rows of the 256, in row order
      int* list = reinterpret_cast<int*>(s_m + THREADS) + warp * THREADS;
      int mine = 0;
      for (int g = 0; g < WARPS; ++g) {
        const int local = s_idx[g * 32 + lane] - lo;
        const bool own = local >= 0 && local < cnt && local % WARPS == warp;
        const unsigned bits = __ballot_sync(0xffffffffu, own);
        if (own) list[mine + __popc(bits & ((1u << lane) - 1u))] = g * 32 + lane;
        mine += __popc(bits);
      }
      __syncwarp();
      for (int b0 = 0; b0 < mine; b0 += BATCH) {
        int slot[BATCH];
#pragma unroll
        for (int q = 0; q < BATCH; ++q) slot[q] = b0 + q < mine ? list[b0 + q] : -1;
        for (int c = lane; c < width; c += 32) {
          float v[BATCH];
#pragma unroll
          for (int q = 0; q < BATCH; ++q)
            v[q] = slot[q] >= 0 && c < d ? x[(size_t)(base + slot[q]) * d + c] : 1.0f;
#pragma unroll
          for (int q = 0; q < BATCH; ++q) {
            if (slot[q] >= 0) {
              float* s = s_acc + (s_idx[slot[q]] - lo) * width + c;
              *s = __fadd_rn(*s, __fmul_rn(v[q], s_m[slot[q]]));
            }
          }
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < cnt * width; e += THREADS) acc[(size_t)lo * width + e] = s_acc[e];
  }
}

}  // namespace

extern "C" {

// a: (n, k) bf16 row-major; w: (k, ldw) bf16 row-major, columns >= xy
// ignored (the packed operands, as for xps_bmu_argmin); x: (n, d) f32; m:
// (n,) f32; idx: (n,) int32 and val: (n,) f32 outputs (the winners and
// their values); acc: (xy, d + 1) f32 output. k % 8 == 0, ldw % 8 == 0,
// a and w 16-byte aligned. Returns cudaErrorInvalidValue when one node's
// row does not fit the shared accumulator, cudaErrorNotSupported without
// cooperative launch, else the launch's error.
int xps_bmu_stats_fused(const void* a, const void* w, const void* x, const void* m, int n,
                        int k, int xy, int ldw, int d, void* idx, void* val, void* acc,
                        void* stream) {
  if (xy <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev, sms, coop, sm_bytes, reserved, optin, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_stats_kernel, THREADS, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop || per_sm < 1) return static_cast<int>(cudaErrorNotSupported);
  // blocks per SM: as many as phase 1 has row blocks for, at most what fits
  const int want = max(1, min(per_sm, ((n + BM - 1) / BM + sms - 1) / sms));
  int smem = SMEM;
  if (want < per_sm) {  // the shared memory that leaves room for `want` only
    smem = max(SMEM, min(optin, sm_bytes / want - reserved));
    e = cudaFuncSetAttribute(fused_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_stats_kernel, THREADS,
                                                        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorNotSupported);
  }
  const int width = d + 1;
  const int rmax = (smem - STAGED) / (width * (int)sizeof(float));
  if (rmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = per_sm * sms;
  int range = (xy + grid - 1) / grid;
  if (range > rmax) range = rmax;

  auto a_ = static_cast<const __nv_bfloat16*>(a);
  auto w_ = static_cast<const __nv_bfloat16*>(w);
  auto x_ = static_cast<const float*>(x);
  auto m_ = static_cast<const float*>(m);
  auto idx_ = static_cast<int*>(idx);
  auto val_ = static_cast<float*>(val);
  auto acc_ = static_cast<float*>(acc);
  void* args[] = {&a_, &w_, &x_, &m_, &n, &k, &xy, &ldw, &d, &range, &idx_, &val_, &acc_};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_stats_kernel), dim3(grid),
                                  dim3(THREADS), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
