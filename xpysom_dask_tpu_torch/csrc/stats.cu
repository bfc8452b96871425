// Deterministic per-BMU statistics scatter for Hopper (sm_90a): K9.
//
// Replaces the Pallas kernel _kernel of xpysom_dask_tpu/ops/pallas/stats.py:
//     acc[idx_n] += [x_n | 1] * m_n     into a fresh (XY, D+1) f32 partial.
// The TPU kernel walks the rows in order and read-modify-writes one
// accumulator row per sample. On the GPU the obvious port is float atomics,
// whose summation order changes from run to run; the JAX tests pin bitwise
// reproducibility, so this kernel is a segmented sum instead:
//   * the wrapper sorts the row indices by BMU with a stable sort, so each
//     node's rows form one run in their original order, and finds each
//     run's bounds (torch.sort and torch.searchsorted as glue);
//   * one block per node stages its rows in shared memory and each thread
//     sums one column over the run in that order, starting from 0.0, with
//     explicitly rounded multiply and add (no FMA contraction).
// The result is the sequential row-order sum the TPU kernel and XLA's CPU
// scatter produce, bit for bit, on every run. Every element of the partial
// is written, so the output needs no zeroing. Indices outside [0, xy) are
// never visited, as XLA drops out-of-range scatter updates.
//
// What bounds it on the H100: at the flagship chunk (16384 rows, D = 64,
// 16384 nodes) it moves ~4.3 MB of rows and ~4.3 MB of partial, so memory
// latency bounds it: the gathers through `perm` are scattered rows, each
// read once with coalesced loads, and a node's run is one serial add chain
// per column, so the longest run sets a floor on the kernel's time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE_FLOATS = 4096;  // 16 KB shared tile of augmented rows
constexpr int MAX_ROWS = 64;       // rows staged per step

// One block per node; the wrapper gives each node's run [lo, hi) of the
// sorted rows. Per step the block stages up to MAX_ROWS augmented rows
// [x_row | 1] of the run in shared memory with coalesced loads from all
// threads, then thread c adds column c over the staged rows in row order.
// A node with a long run (early training sends ~1e3 rows of a chunk to one
// node) thus keeps a whole block's loads in flight, and its time is set by
// the add chain, not by one memory latency per row.
__global__ void __launch_bounds__(THREADS)
scatter_stats_kernel(const float* __restrict__ x, const float* __restrict__ m,
                     const int64_t* __restrict__ perm,
                     const int* __restrict__ offsets, int d, int xy,
                     float* __restrict__ acc) {
  __shared__ float tile[TILE_FLOATS];
  __shared__ int64_t rows[MAX_ROWS];
  __shared__ float ms[MAX_ROWS];

  const int node = blockIdx.x;
  const int tid = threadIdx.x;
  const int width = d + 1;
  const int lo = offsets[node];
  const int hi = offsets[node + 1];
  // columns pass: thread tid owns column cbase + tid
  for (int cbase = 0; cbase < width; cbase += THREADS) {
    const int c = cbase + tid;
    const int pass_w = min(THREADS, width - cbase);
    const int step_rows = min(MAX_ROWS, TILE_FLOATS / pass_w);
    float s = 0.0f;
    for (int r0 = lo; r0 < hi; r0 += step_rows) {
      const int cnt = min(step_rows, hi - r0);
      if (tid < cnt) {
        const int64_t row = perm[r0 + tid];
        rows[tid] = row;
        ms[tid] = m[row];
      }
      __syncthreads();
      // all of a thread's loads are issued before any of its stores, so
      // a step costs about one memory latency, not one per element
      const int total = cnt * pass_w;
      float vals[TILE_FLOATS / THREADS];
#pragma unroll
      for (int k = 0; k < TILE_FLOATS / THREADS; ++k) {
        const int e = tid + k * THREADS;
        vals[k] = 1.0f;
        if (e < total) {
          const int cc = cbase + e % pass_w;
          if (cc < d) vals[k] = x[rows[e / pass_w] * d + cc];
        }
      }
#pragma unroll
      for (int k = 0; k < TILE_FLOATS / THREADS; ++k) {
        const int e = tid + k * THREADS;
        if (e < total) tile[e] = vals[k];
      }
      __syncthreads();
      if (tid < pass_w) {
#pragma unroll 8
        for (int r = 0; r < cnt; ++r)
          s = __fadd_rn(s, __fmul_rn(tile[r * pass_w + tid], ms[r]));
      }
      __syncthreads();
    }
    if (tid < pass_w) acc[(size_t)node * width + c] = s;
  }
}

}  // namespace

extern "C" {

// x: (n, d) f32; m: (n,) f32; perm: (n,) int64, the rows in stable order
// of their node; offsets: (xy + 1,) int32, node b's rows are
// perm[offsets[b] : offsets[b + 1]]; acc: (xy, d + 1) f32 output.
// Returns cudaGetLastError() after the launch.
int xps_scatter_stats(const void* x, const void* m, const void* perm,
                      const void* offsets, int d, int xy, void* acc,
                      void* stream) {
  if (xy > 0) {
    scatter_stats_kernel<<<xy, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(m),
        static_cast<const int64_t*>(perm), static_cast<const int*>(offsets), d,
        xy, static_cast<float*>(acc));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
