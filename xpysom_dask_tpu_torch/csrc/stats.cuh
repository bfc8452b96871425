// The per-BMU statistics scatter of stats.cu (its design note says what
// it computes and why it is built so) as a device function over one node
// range: scatter_stats_kernel runs it once per block, and K10
// (fused_stats.cu) runs it after its grid barrier for the node ranges of
// each group of 256 threads of its persistent blocks. One copy of the
// scatter serves both.
//
// It runs on a group of 256 threads. Which threads, and how they meet, is
// a policy: K9's own block of 256 threads (OwnBlock), or one of the two
// groups of 256 of K10's block (FusedGroup: threads 0-255 and 256-511,
// each on its own named barrier, the indices read through L2, since the
// same launch wrote them).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace xps_stats {

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

// The dynamic shared memory of a block whose ranges hold at most `nodes`
// nodes, for width d + 1.
__host__ __device__ constexpr int smem_bytes(int nodes, int d) {
  return 4 * ((nodes * (d + 1 < MAX_COLS ? d + 1 : MAX_COLS) + 3) & ~3) + FIXED_BYTES;
}

// K9's own block: every thread of it takes part.
struct OwnBlock {
  static __device__ __forceinline__ int tid() { return threadIdx.x; }
  static __device__ __forceinline__ void sync() { __syncthreads(); }
  static __device__ __forceinline__ int4 idx4(const int* p) {
    return *reinterpret_cast<const int4*>(p);
  }
  static __device__ __forceinline__ int idx1(const int* p) { return *p; }
};

// A group of 256 threads of K10's block after its grid barrier: group
// threadIdx.x / 256 meets on named barrier 1 + group, and reads idx
// (written by the same launch's first phase) with ld.global.cg, never
// through the read-only, non-coherent path.
struct FusedGroup {
  static __device__ __forceinline__ int tid() { return threadIdx.x % THREADS; }
  static __device__ __forceinline__ void sync() {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + threadIdx.x / THREADS), "n"(THREADS) : "memory");
  }
  static __device__ __forceinline__ int4 idx4(const int* p) {
    return __ldcg(reinterpret_cast<const int4*>(p));
  }
  static __device__ __forceinline__ int idx1(const int* p) { return __ldcg(p); }
};

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
template <class P>
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = P::tid() & 31;
  const int warp = P::tid() >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  P::sync();
  int pre = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int t = scratch[w];
    pre += (w < warp) ? t : 0;
    tot += t;
  }
  P::sync();
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
template <class P>
__device__ __forceinline__ void stage(const Smem& s, const Pass& ps, int k0, int rows, int buf,
                                      const float* __restrict__ x, const float* __restrict__ m,
                                      int d) {
  const int hl = P::tid() & 15;
  float* xs = s.xs + buf * STAGE_FLOATS;
  float* ms = s.ms + buf * STAGE_ROWS;
  for (int r = P::tid() >> 4; r < rows; r += 2 * WARPS) {
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
template <class P>
__device__ void flush(const Smem& s, const Pass& ps, int len, const float* __restrict__ x,
                      const float* __restrict__ m, int d, int nodes) {
  const int tid = P::tid();
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < WARPS * MAX_NODES; i += THREADS) s.cnt[i] = 0;
  P::sync();
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
  P::sync();
  // node offsets, then each warp's start inside each node's run
  int total_b = 0;
  if (tid < nodes)
    for (int w = 0; w < WARPS; ++w) total_b += s.cnt[w * MAX_NODES + tid];
  int sum;
  const int start = block_exclusive_scan<P>(total_b, s.scratch, &sum);
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
  P::sync();
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
  P::sync();

  // batches of whole grouped rows, double-buffered: batch kb + 1 is
  // issued once batch kb has landed (no copy waits behind another) and is
  // in flight while the threads of batch kb's nodes add
  const int batch = min(STAGE_ROWS, STAGE_FLOATS / ps.ld);
  const int nb = (len + batch - 1) / batch;
  stage<P>(s, ps, 0, min(batch, len), 0, x, m, d);
  asm volatile("cp.async.commit_group;");
  for (int kb = 0; kb < nb; ++kb) {
    const int k0 = kb * batch;
    const int rows = min(batch, len - k0);
    asm volatile("cp.async.wait_group 0;");
    // batch kb is visible to all, and every thread is done with batch
    // kb - 1, whose buffer batch kb + 1 takes
    P::sync();
    if (kb + 1 < nb) {
      stage<P>(s, ps, k0 + batch, min(batch, len - k0 - batch), (kb + 1) & 1, x, m, d);
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
  P::sync();
}

// The statistics of nodes [node0, node0 + nodes) into their rows of out
// ((xy, d + 1) f32), every element written, with the shared memory laid
// out for ranges of nodes_cap >= nodes nodes (smem_bytes(nodes_cap, d)).
// Runs on a group of 256 threads under policy P; ends with them past a
// barrier, so a caller may run it again for another range.
template <class P>
__device__ __forceinline__ void scatter_range(unsigned char* smem_raw,
                                              const float* __restrict__ x,
                                              const float* __restrict__ m,
                                              const int* __restrict__ idx, int n, int d,
                                              int node0, int nodes, int nodes_cap,
                                              float* __restrict__ out) {
  const int width = d + 1;
  const int cols_max = min(width, MAX_COLS);
  Smem s;
  s.acc = reinterpret_cast<float*>(smem_raw);
  s.xs = s.acc + ((nodes_cap * cols_max + 3) & ~3);  // 16-byte aligned
  s.ms = s.xs + 2 * STAGE_FLOATS;
  s.list_row = reinterpret_cast<int*>(s.ms + 2 * STAGE_ROWS);
  s.grouped = s.list_row + LIST_CAP;
  s.cnt = s.grouped + LIST_CAP;
  s.off = s.cnt + WARPS * MAX_NODES;
  s.scratch = s.off + MAX_NODES + 1;
  s.list_node = reinterpret_cast<uint8_t*>(s.scratch + WARPS);

  const int tid = P::tid();
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
        const int4 a = P::idx4(idx + r0);
        const int4 b = P::idx4(idx + r0 + 4);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      } else {
#pragma unroll
        for (int j = 0; j < ROWS_PER_THREAD; ++j) v[j] = r0 + j < n ? P::idx1(idx + r0 + j) : -1;
      }
      unsigned hit = 0;
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        if (static_cast<unsigned>(v[j] - node0) < static_cast<unsigned>(nodes)) hit |= 1u << j;
      int total;
      int pos = block_exclusive_scan<P>(__popc(hit), s.scratch, &total);
      if (total == 0) continue;
      if (count + total > LIST_CAP) {
        flush<P>(s, ps, count, x, m, d, nodes);
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
      P::sync();
    }
    P::sync();
    if (count > 0) flush<P>(s, ps, count, x, m, d, nodes);
    for (int p = tid; p < nodes * cols; p += THREADS) {
      const int b = p / cols;
      out[(size_t)(node0 + b) * width + c0 + (p - b * cols)] = s.acc[p];
    }
    P::sync();
  }
}

}  // namespace xps_stats
