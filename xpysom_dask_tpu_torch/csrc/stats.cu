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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_THREAD = 8;                    // idx entries per thread per scan step
constexpr int SCAN_ROWS = THREADS * ROWS_PER_THREAD;  // 2048 rows per scan step
constexpr int LIST_CAP = SCAN_ROWS;                   // listed rows between groupings
constexpr int STAGE_FLOATS = 8192;                    // 32 KB per staging buffer
constexpr int STAGE_ROWS = 512;                       // rows per staging batch, at most
constexpr int MAX_COLS = 128;                         // columns per pass
constexpr int MAX_NODES = 128;                        // nodes per block (a uint8 node id)

// Shared memory past the (nodes x cols) sums (90.5 KB).
constexpr int FIXED_BYTES = 2 * 4 * STAGE_FLOATS      // two staging buffers of x
                            + 2 * 4 * STAGE_ROWS      // and of m
                            + 4 * LIST_CAP            // listed rows
                            + 4 * LIST_CAP            // grouped rows
                            + LIST_CAP                // listed node ids
                            + 4 * WARPS * MAX_NODES   // per-warp node counts
                            + 4 * (MAX_NODES + 1)     // node offsets
                            + 4 * WARPS;              // scan scratch
static_assert(MAX_NODES <= 256, "node ids are uint8");
static_assert(4 * MAX_NODES * MAX_COLS + FIXED_BYTES <= 227 * 1024,
              "the largest node range and column pass fit a Hopper block's shared memory");
static_assert(LIST_CAP >= SCAN_ROWS, "a scan step's hits fit an empty list");

struct Smem {
  float* acc;          // [nodes * cols] running sums of this column pass
  float* xs;           // [2][STAGE_FLOATS] staged x columns, stride cols
  float* ms;           // [2][STAGE_ROWS] staged m
  int* list_row;       // [LIST_CAP] rows in range, in row order
  int* grouped;        // [LIST_CAP] the same rows grouped by node
  int* cnt;            // [WARPS][MAX_NODES]
  int* off;            // [MAX_NODES + 1]
  int* scratch;        // [WARPS]
  uint8_t* list_node;  // [LIST_CAP] node - node0 of each listed row
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}

// Exclusive scan of v over the block; *total gets the sum. Two barriers.
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int pre = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int t = scratch[w];
    pre += (w < warp) ? t : 0;
    tot += t;
  }
  __syncthreads();
  *total = tot;
  return pre + incl - v;
}

// The last node b in [0, nodes) whose run starts at or before position k.
__device__ __forceinline__ int node_at(const int* off, int nodes, int k) {
  int lo = 0, hi = nodes - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= k) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// One column pass [c0, c0 + cols) of a block: which columns are x's
// (the rest is the ones column), the staging stride, whether rows are
// copied in 16-byte pieces, and each thread's first (node, column) pair
// and its stride through the (nodes x cols) pairs.
struct Pass {
  int c0, cols, xcols, ld;
  bool vec;
  int q, rc, sq, sr;
};

// Copy batch kb of the grouped rows (x's columns of the pass and m) into
// staging buffer `buf`, one half-warp per row, with cp.async.
__device__ __forceinline__ void stage(const Smem& s, const Pass& ps, int k0, int rows, int buf,
                                      const float* __restrict__ x, const float* __restrict__ m,
                                      int d) {
  const int hl = threadIdx.x & 15;
  float* xs = s.xs + buf * STAGE_FLOATS;
  float* ms = s.ms + buf * STAGE_ROWS;
  for (int r = threadIdx.x >> 4; r < rows; r += 2 * WARPS) {
    const int row = s.grouped[k0 + r];
    const float* src = x + (size_t)row * d + ps.c0;
    if (ps.vec) {
      for (int c = 4 * hl; c < ps.xcols; c += 64) cp_async16(xs + r * ps.ld + c, src + c);
    } else {
      for (int c = hl; c < ps.xcols; c += 16) cp_async4(xs + r * ps.ld + c, src + c);
    }
    if (hl == 0) cp_async4(ms + r, m + row);
  }
}

// Group the list [0, len) by node (stable), then stage and sum it into the
// pass's running sums. Begins and ends with every thread past a barrier.
__device__ void flush(const Smem& s, const Pass& ps, int len, const float* __restrict__ x,
                      const float* __restrict__ m, int d, int nodes) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < WARPS * MAX_NODES; i += THREADS) s.cnt[i] = 0;
  __syncthreads();
  // each warp owns one segment of the list, the segments in list order,
  // and counts it 32 entries a step: the lowest lane of each set of equal
  // nodes adds their number
  const int seg = ((len + WARPS - 1) / WARPS + 31) & ~31;
  const int lo = warp * seg;
  const int hi = min(len, lo + seg);
  const unsigned lt = (1u << lane) - 1u;
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const bool valid = i < hi;
    const int b = valid ? s.list_node[i] : 0x100 + lane;  // invalid lanes match nobody
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (valid && (peers & lt) == 0) s.cnt[warp * MAX_NODES + b] += __popc(peers);
  }
  __syncthreads();
  // node offsets, then each warp's start inside each node's run
  int total_b = 0;
  if (tid < nodes)
    for (int w = 0; w < WARPS; ++w) total_b += s.cnt[w * MAX_NODES + tid];
  int sum;
  const int start = block_exclusive_scan(total_b, s.scratch, &sum);
  if (tid < nodes) {
    s.off[tid] = start;
    int run = start;
    for (int w = 0; w < WARPS; ++w) {
      const int c = s.cnt[w * MAX_NODES + tid];
      s.cnt[w * MAX_NODES + tid] = run;
      run += c;
    }
  }
  if (tid == 0) s.off[nodes] = len;
  __syncthreads();
  // stable placement: equal nodes within a 32-entry step ranked by lane
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const bool valid = i < hi;
    const int b = valid ? s.list_node[i] : 0x100 + lane;  // invalid lanes match nobody
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (valid) s.grouped[s.cnt[warp * MAX_NODES + b] + __popc(peers & lt)] = s.list_row[i];
    __syncwarp();
    if (valid && (peers & lt) == 0) s.cnt[warp * MAX_NODES + b] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // batches of whole grouped rows, double-buffered: batch kb + 1 is
  // issued once batch kb has landed (no copy waits behind another) and is
  // in flight while the threads of batch kb's nodes add
  const int batch = min(STAGE_ROWS, STAGE_FLOATS / ps.ld);
  const int nb = (len + batch - 1) / batch;
  stage(s, ps, 0, min(batch, len), 0, x, m, d);
  asm volatile("cp.async.commit_group;");
  for (int kb = 0; kb < nb; ++kb) {
    const int k0 = kb * batch;
    const int rows = min(batch, len - k0);
    asm volatile("cp.async.wait_group 0;");
    // batch kb is visible to all, and every thread is done with batch
    // kb - 1, whose buffer batch kb + 1 takes
    __syncthreads();
    if (kb + 1 < nb) {
      stage(s, ps, k0 + batch, min(batch, len - k0 - batch), (kb + 1) & 1, x, m, d);
      asm volatile("cp.async.commit_group;");
    }
    const float* xs = s.xs + (kb & 1) * STAGE_FLOATS;
    const float* ms = s.ms + (kb & 1) * STAGE_ROWS;
    // the batch holds the runs of nodes b_lo .. b_hi (grouped by node)
    const int b_lo = node_at(s.off, nodes, k0);
    const int b_hi = node_at(s.off, nodes, k0 + rows - 1);
    int b = b_lo + ps.q, c = ps.rc;
    while (b <= b_hi) {
      const int r0 = max(s.off[b], k0);
      const int r1 = min(s.off[b + 1], k0 + rows);
      if (r0 < r1) {
        const float* mr = ms + (r0 - k0);
        const int len = r1 - r0;
        float a = s.acc[b * ps.cols + c];
        // eight rows' loads before their adds: one shared-memory latency
        // per eight links of the chain
        if (c < ps.xcols) {
          const float* xr = xs + (r0 - k0) * ps.ld + c;
          int r = 0;
          for (; r + 8 <= len; r += 8) {
            float xv[8], mv[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              xv[j] = xr[(r + j) * ps.ld];
              mv[j] = mr[r + j];
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) a = __fadd_rn(a, __fmul_rn(xv[j], mv[j]));
          }
          for (; r < len; ++r) a = __fadd_rn(a, __fmul_rn(xr[r * ps.ld], mr[r]));
        } else {  // the ones column: 1 * m == m
          int r = 0;
          for (; r + 8 <= len; r += 8) {
            float mv[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) mv[j] = mr[r + j];
#pragma unroll
            for (int j = 0; j < 8; ++j) a = __fadd_rn(a, mv[j]);
          }
          for (; r < len; ++r) a = __fadd_rn(a, mr[r]);
        }
        s.acc[b * ps.cols + c] = a;
      }
      b += ps.sq;
      c += ps.sr;
      if (c >= ps.cols) {
        c -= ps.cols;
        ++b;
      }
    }
  }
  __syncthreads();
}

// Block b owns nodes [b * nodes_per_block, +nodes_per_block) of [0, xy).
// Two blocks per SM lets ptxas use up to 128 registers, enough to keep the
// chain's eight rows of loads in flight.
__global__ void __launch_bounds__(THREADS, 2)
scatter_stats_kernel(const float* __restrict__ x, const float* __restrict__ m,
                     const int* __restrict__ idx, int n, int d, int xy,
                     int nodes_per_block, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int width = d + 1;
  const int cols_max = min(width, MAX_COLS);
  Smem s;
  s.acc = reinterpret_cast<float*>(smem_raw);
  s.xs = s.acc + ((nodes_per_block * cols_max + 3) & ~3);  // 16-byte aligned
  s.ms = s.xs + 2 * STAGE_FLOATS;
  s.list_row = reinterpret_cast<int*>(s.ms + 2 * STAGE_ROWS);
  s.grouped = s.list_row + LIST_CAP;
  s.cnt = s.grouped + LIST_CAP;
  s.off = s.cnt + WARPS * MAX_NODES;
  s.scratch = s.off + MAX_NODES + 1;
  s.list_node = reinterpret_cast<uint8_t*>(s.scratch + WARPS);

  const int tid = threadIdx.x;
  const int node0 = blockIdx.x * nodes_per_block;
  const int nodes = min(nodes_per_block, xy - node0);
  const bool vec = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  // x's rows in 16-byte pieces (c0 is a multiple of 128)
  const bool vec_x = d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  for (int c0 = 0; c0 < width; c0 += MAX_COLS) {
    const int cols = min(MAX_COLS, width - c0);
    const int xcols = min(cols, d - c0);
    const Pass ps{c0, cols, xcols, vec_x ? (cols + 3) & ~3 : cols, vec_x,
                  tid / cols, tid % cols, THREADS / cols, THREADS % cols};
    for (int p = tid; p < nodes * cols; p += THREADS) s.acc[p] = 0.0f;
    int count = 0;  // listed rows, the same in every thread
    for (int base = 0; base < n; base += SCAN_ROWS) {
      const int r0 = base + tid * ROWS_PER_THREAD;
      int v[ROWS_PER_THREAD];
      if (vec && r0 + ROWS_PER_THREAD <= n) {
        const int4 a = *reinterpret_cast<const int4*>(idx + r0);
        const int4 b = *reinterpret_cast<const int4*>(idx + r0 + 4);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      } else {
#pragma unroll
        for (int j = 0; j < ROWS_PER_THREAD; ++j) v[j] = r0 + j < n ? idx[r0 + j] : -1;
      }
      unsigned hit = 0;
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        if (static_cast<unsigned>(v[j] - node0) < static_cast<unsigned>(nodes)) hit |= 1u << j;
      int total;
      int pos = block_exclusive_scan(__popc(hit), s.scratch, &total);
      if (total == 0) continue;
      if (count + total > LIST_CAP) {
        flush(s, ps, count, x, m, d, nodes);
        count = 0;
      }
      pos += count;
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j) {
        if (hit >> j & 1u) {
          s.list_row[pos] = r0 + j;
          s.list_node[pos] = static_cast<uint8_t>(v[j] - node0);
          ++pos;
        }
      }
      count += total;
      __syncthreads();
    }
    __syncthreads();
    if (count > 0) flush(s, ps, count, x, m, d, nodes);
    for (int p = tid; p < nodes * cols; p += THREADS) {
      const int b = p / cols;
      out[(size_t)(node0 + b) * width + c0 + (p - b * cols)] = s.acc[p];
    }
    __syncthreads();
  }
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
  const int cols = min(d + 1, MAX_COLS);
  const int smem = 4 * ((nodes_per_block * cols + 3) & ~3) + FIXED_BYTES;
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
