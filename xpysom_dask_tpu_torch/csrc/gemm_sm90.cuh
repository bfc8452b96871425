// The wgmma BMU search of gemm_sm90.cu (its design note says what each
// variant computes and why the pipeline is built so) as a device function
// over one 128-row block of samples: gemm_sm90_kernel runs it once per
// block, and K10 (fused_stats.cu) runs it in a persistent loop over row
// blocks before its grid barrier. One copy of the search serves both.
//
// A caller that runs several row blocks in one block gives each a fresh
// ring (ring_reset behind a block barrier). Carrying the ring's stage
// count from one row block to the next instead made the stage index a
// run-time value, and on one H100 the search ran slower with it, even on
// a single row block, than with a reset's pipeline drain.
//
// K1 and K2 take one of three feeds (gemm_sm90.cu's design note says which
// and why): A streamed beside each codebook chunk; pairs, where a launch of
// clusters of CLUSTER blocks runs search_rows<S, CLUSTER> in every block,
// one row block each, the blocks walking the same codebook chunks in the
// same order, each reading one laid-out tile's part of every stage from L2
// and multicasting it into the same stage of every block of the cluster;
// and A in registers (search_rows<S, 1, RA>), the ring carrying the
// codebook alone. On the first two (the deep feeds, search_rows<S, CLUSTER,
// 0, true>) a tile is WIDE_BN codebook rows, two laid-out tiles side by
// side in each stage, so that a block reads its A chunks once for every
// WIDE_BN rows of the codebook.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "sm90.cuh"  // bulk copies, mbarriers, descriptors, fences

namespace xps_gemm {

using namespace xps_sm90;

constexpr int BM = 128;           // sample rows per block (two warpgroups of 64)
constexpr int BK = 64;            // depth of a layout chunk and of a stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;    // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int RESIDENT_K = 256;   // A stays resident up to this padded depth
constexpr int LBO_BYTES = 128;    // between the core matrices adjacent along K
constexpr int PAIR = 2;           // blocks of a cluster of K1 and K2 on the pairs' feed
constexpr int REGISTER_K = 256;   // K1 and K2 hold A in registers up to this padded depth
constexpr int REG_STAGES = 8;     // the ring's stages with A in registers (codebook chunks alone)
constexpr int WIDE_BN = 256;      // K1's and K2's codebook tile on the deep feeds

// K1's and K2's feeds (ops/kernels/bmu.py search_feed picks one from the
// shape): A streamed beside each codebook chunk, one block a row block;
// pairs of row blocks that share each codebook chunk (a cluster of PAIR);
// A held in registers, one block a row block (k16 <= REGISTER_K)
enum Feed { FEED_STREAMED = 0, FEED_PAIRS = 1, FEED_REGISTERS = 2 };

// The searches: K1's argmin, K3's three products, K2's top two, K1-kb's
// slab sums; and FEED, K1's ring alone (its consumers wait for each stage
// and release it), which measures what the copies can feed
enum class Search { ARGMIN, SPLIT3, TOP2, KBLOCKED, FEED };

template <int BN_, int OPS_, int NACC_, int LAID_ = BN_>
struct Shape {
  static constexpr int BN = BN_;      // codebook rows per tile
  static constexpr int LAID = LAID_;  // codebook rows per laid-out tile
  static constexpr int PARTS = BN / LAID;  // laid-out tiles per tile, side by side in a stage
  static constexpr int OPS = OPS_;    // operand halves (hi, lo)
  static constexpr int NACC = NACC_;  // wgmma accumulator sets
  static constexpr int REGS = BN / 2;  // f32 accumulators per set
  static constexpr int A_CHUNK = BM * BK * 2;  // bytes of one half's A chunk
  static constexpr int B_CHUNK = BN * BK * 2;
  // the dynamic shared memory of a ring of ns stages, resident (the A
  // tile, then the ring of W chunks) or streamed ((A chunk, W chunk) stages)
  static constexpr int smem_bytes(int ns) {
    return OPS * BM * RESIDENT_K * 2 + ns * OPS * B_CHUNK > ns * OPS * (A_CHUNK + B_CHUNK)
               ? OPS * BM * RESIDENT_K * 2 + ns * OPS * B_CHUNK
               : ns * OPS * (A_CHUNK + B_CHUNK);
  }
  static constexpr int SMEM_BYTES = smem_bytes(STAGES);
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
// K1 and K2 on the deep feeds, and K1's ring alone (FEED): a tile of
// WIDE_BN codebook rows, two of K1's laid-out tiles whose chunks lie side
// by side in a stage (128 accumulator registers, one wgmma m64n256k16 a
// 16-deep step)
struct Wide : Shape<WIDE_BN, 1, 1, Cfg<Search::ARGMIN>::BN> {};
template <Search S, bool WIDE>
using CfgOf = std::conditional_t<WIDE, Wide, Cfg<S>>;
static_assert(Cfg<Search::SPLIT3>::SMEM_BYTES <= 227 * 1024, "shared memory of K3");
static_assert(Cfg<Search::ARGMIN>::SMEM_BYTES <= 227 * 1024, "shared memory of K1");
static_assert(Wide::SMEM_BYTES <= 227 * 1024, "shared memory of K1 and K2 on the deep feeds");

// The ring's mbarriers (a ring of NS stages), in a block's static shared
// memory
template <int NS = STAGES>
struct RingOf {
  uint64_t full[NS];   // stage landed
  uint64_t empty[NS];  // stage released by every consumer warp (of the cluster)
  uint64_t a_full;     // resident A landed
};
using Ring = RingOf<>;

// One thread initialises the ring; the block (the cluster) then passes a
// barrier before any thread uses it. In a cluster every block's producer
// writes into every block's stages, so a stage is free once the consumer
// warps of all CLUSTER blocks have released it.
template <int CLUSTER = 1, int NS>
__device__ __forceinline__ void ring_init(RingOf<NS>& bar) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    mbar_init(&bar.full[s], 1);
    mbar_init(&bar.empty[s], CLUSTER * CONSUMERS / 32);
  }
  mbar_init(&bar.a_full, 1);
  mbar_fence_init();
}

// One thread re-initialises a used ring, once every thread that searched
// on it is past a barrier behind its last search (every copy landed, every
// stage released); they then pass a barrier before any of them uses it.
__device__ __forceinline__ void ring_reset(Ring& bar) {
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    mbar_inval(&bar.full[s]);
    mbar_inval(&bar.empty[s]);
  }
  mbar_inval(&bar.a_full);
  ring_init(bar);
}

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

// the same with 256 codebook rows (128 f32 accumulators a thread), A read
// once for all of them
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128, f32) = A . B^T + (acc ? d : 0) with A from registers: the
// thread's fragment of its warp's 16 rows x 16 of depth (rows g, g + 8;
// depth 2q, 2q + 1 and 2q + 8, 2q + 9, the lower index in the low half)
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
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

// A consumer warp releases stage `it`: one arrival on the stage's empty
// barrier of every block of the cluster (lane r on block r's)
template <int CLUSTER, int NS>
__device__ __forceinline__ void release_stage(RingOf<NS>& bar, int it, int lane) {
  if constexpr (CLUSTER == 1) {
    if (lane == 0) mbar_arrive(&bar.empty[it % NS]);
  } else {
    if (lane < CLUSTER) mbar_arrive_cluster(&bar.empty[it % NS], lane);
  }
}

// The search of row block rb (rows rb * BM .. +BM - 1) by the first
// THREADS threads of a block over a fresh ring `bar` (initialised, then a
// barrier) and `smem` (CfgOf<S, WIDE>::SMEM_BYTES of dynamic shared memory).
// Every thread returns; the producer warp's lanes return once the copies
// are issued, the consumers once the rows are written. No block barrier
// inside. slab: K1-kb's chunks per slab (kblock / BK); unused by the
// others. idx2_out, val2_out: K2's runner-up; unused by the others.
// RA > 0: A in registers, RA chunks deep (nk == RA); the ring carries the
// codebook chunks alone.
// WIDE: tiles of WIDE_BN codebook rows (CfgOf), each stage holding chunk c
// of two consecutive laid-out tiles back to back (the second missing from
// the last tile where the laid-out tiles are odd in number).
// CLUSTER > 1 (WIDE, CLUSTER == Wide::PARTS): the block is one of a
// cluster launched with one row block each (its ring from
// ring_init<CLUSTER>, behind a cluster barrier, and a cluster barrier
// after the search, so that no block exits while another can still arrive
// on its barriers); the producer of rank r copies laid-out tile r of each
// stage's tile into every block's stage. A block whose row block lies past
// the rows (the last of an odd count: the laid-out A ends at the last row
// block) loads no A and writes nothing, but feeds the others their parts
// and releases its stages.
template <Search S, int CLUSTER = 1, int RA = 0, bool WIDE = false, int NS>
__device__ __forceinline__ void search_rows(
    RingOf<NS>& bar, unsigned char* smem, int rb, const __nv_bfloat16* __restrict__ a,
    const __nv_bfloat16* __restrict__ a_lo, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ w_lo, const float* __restrict__ w_sq, int n, int k16,
    int xy, int resident, int slab, int* __restrict__ idx_out, float* __restrict__ val_out,
    int* __restrict__ idx2_out, float* __restrict__ val2_out) {
  using C = CfgOf<S, WIDE>;
  constexpr int BN = C::BN;
  static_assert(CLUSTER == 1 || CLUSTER == C::PARTS, "a cluster's ranks copy a laid-out tile each");
  static_assert(!(WIDE && RA), "A in registers keeps K1's laid-out tile");
  constexpr bool SPLIT3 = S == Search::SPLIT3;
  constexpr bool TOP2 = S == Search::TOP2;
  constexpr bool KB = S == Search::KBLOCKED;
  constexpr bool FEED = S == Search::FEED;
  constexpr bool REGA = RA > 0;  // A in registers, RA chunks deep (nk == RA)
  uint64_t* full = bar.full;
  uint64_t* empty = bar.empty;
  const bool rows = CLUSTER == 1 || rb * BM < n;  // the block has rows to search

  const int tid = threadIdx.x;
  // the warpgroup (2: the producer warp), read through a shuffle so the
  // compiler sees it uniform across the warp: the wgmmas then lie on a
  // uniform path, and ptxas does not serialize them
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int nk = (k16 + BK - 1) / BK;
  const int ntiles = (xy + BN - 1) / BN;
  const int laid = (xy + C::LAID - 1) / C::LAID;  // the codebook's laid-out tiles
  const int total = nk * ntiles;
  // resident: A tile (OPS halves of BM x k16), then the ring of W chunks
  const int a_bytes = BM * k16 * 2;  // one half's A tile
  unsigned char* ring = resident && !REGA ? smem + C::OPS * a_bytes : smem;
  const int stage_bytes = C::OPS * (C::B_CHUNK + (resident || REGA ? 0 : C::A_CHUNK));

  if (wg == CONSUMERS / 128) {  // the producer warp: one thread issues every copy
    if (tid != CONSUMERS) return;
    const __nv_bfloat16* ga[2] = {a, a_lo};
    const __nv_bfloat16* gw[2] = {w, w_lo};
    const size_t a_tile = (size_t)rb * BM * k16;  // this row block's A tile
    // the laid-out tile of each stage's tile this block reads (of CLUSTER)
    const int rank = CLUSTER > 1 ? static_cast<int>(cluster_rank()) : 0;
    if (resident && rows && !REGA) {
      mbar_expect_tx(&bar.a_full, C::OPS * a_bytes);
#pragma unroll
      for (int h = 0; h < C::OPS; ++h) bulk_copy(smem + h * a_bytes, ga[h] + a_tile, a_bytes, &bar.a_full);
    }
    for (int it = 0; it < total; ++it) {
      const int s = it % NS;
      if (it >= NS) mbar_wait(&empty[s], ((it / NS) - 1) & 1);
      const int tile = it / nk, c = it - (it / nk) * nk;
      const int dc = min(BK, k16 - c * BK);
      // the tile's laid-out tiles (the last tile may lack its second) and
      // the bytes of one's chunk
      const int parts = C::PARTS == 1 ? 1 : min(C::PARTS, laid - tile * C::PARTS);
      const int part_bytes = C::LAID * dc * 2, ac_bytes = BM * dc * 2;
      unsigned char* st = ring + s * stage_bytes;
      // the tile's whole B chunk lands in every block, A only where there
      // are rows
      mbar_expect_tx(&full[s],
                     C::OPS * (parts * part_bytes + (resident || REGA || !rows ? 0 : ac_bytes)));
#pragma unroll
      for (int h = 0; h < C::OPS; ++h) {
        // part p's chunk lands at p * part_bytes: its 8-row groups follow
        // part p - 1's at their stride (16 dc bytes), so the stage holds
        // the tile's BN rows in the canonical layout
#pragma unroll
        for (int p = 0; p < C::PARTS; ++p) {
          if (p >= parts || (CLUSTER > 1 && p != rank)) continue;
          const __nv_bfloat16* chunk =
              gw[h] + (size_t)(tile * C::PARTS + p) * C::LAID * k16 + (size_t)C::LAID * c * BK;
          unsigned char* dst = st + h * C::B_CHUNK + p * part_bytes;
          if constexpr (CLUSTER > 1) {
            bulk_copy_multicast(dst, chunk, part_bytes, &full[s],
                                static_cast<uint16_t>((1u << CLUSTER) - 1));
          } else {
            bulk_copy(dst, chunk, part_bytes, &full[s]);
          }
        }
        if (!resident && !REGA && rows)
          bulk_copy(st + C::OPS * C::B_CHUNK + h * C::A_CHUNK, ga[h] + a_tile + (size_t)BM * c * BK,
                    ac_bytes, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg*64 .. +63 of the block
  const int lane = tid & 31;
  auto release = [&](int it) { release_stage<CLUSTER>(bar, it, lane); };
  if (FEED || !rows) {
    // every stage waited for and released at once: no rows to search
    for (int it = 0; it < total; ++it) {
      mbar_wait(&full[it % NS], (it / NS) & 1);
      release(it);
    }
    return;
  }
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

  // K1-kb: chunk c is the last of its slab (K's last chunk is checked apart)
  auto slab_end = [&](int c) { return KB && c % slab == slab - 1; };

  // wait for stage it (chunk c of its tile) and issue its wgmmas into ac,
  // as one commit group
  auto issue = [&](Acc& ac, int it, int c) {
    const int s = it % NS;
    const int dc = min(BK, k16 - c * BK);
    const uint32_t sbo = 16u * dc;  // bytes between 8-row groups of this chunk
    mbar_wait(&full[s], (it / NS) & 1);
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

  if constexpr (REGA) {
    // this thread's A fragment of each 16-deep step j (rows row_w and
    // row_w + 8, depth 2q, 2q + 1 and 2q + 8, 2q + 9), read once from the
    // laid-out A: value (r, k) of the block's tile lies in chunk
    // c = k / BK, 8-row group r / 8 (dc values a row), core matrix
    // (k % BK) / 8
    uint32_t af[RA * 4][4];
    const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
#pragma unroll
    for (int j = 0; j < RA * 4; ++j) {
      const int c = j / 4;
      const int dc = min(BK, k16 - c * BK);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = row_w + (h & 1) * 8;
        const int k = j * 16 + (h >> 1) * 8 + 2 * q;
        const size_t off = (size_t)rb * BM * k16 + (size_t)c * BM * BK + (r >> 3) * 8 * dc +
                           ((k % BK) >> 3) * 64 + (r & 7) * 8 + (k & 7);
        af[j][h] = j * 16 < k16 ? __ldg(a32 + off / 2) : 0u;
      }
    }
    // K1's loop with the chunks unrolled, so that each step's fragment is
    // a register
    for (int tile = 0; tile < ntiles; ++tile) {
#pragma unroll
      for (int c = 0; c < RA; ++c) {
        const int it = tile * RA + c;
        const int s = it % NS;
        const int dc = min(BK, k16 - c * BK);
        const uint32_t sbo = 16u * dc;
        mbar_wait(&full[s], (it / NS) & 1);
        const unsigned char* st = ring + s * stage_bytes;
        fence_acc(acc[0]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          if (ks * 16 < dc) {
            const uint64_t db = smem_desc(st + ks * 2 * LBO_BYTES, LBO_BYTES, sbo);
            wgmma_bf16_rs(acc[0], af[c * 4 + ks], db, c != 0 || ks != 0);
          }
        }
        wgmma_commit();
        if (c == RA - 1) {
          wgmma_wait<0>();
        } else {
          wgmma_wait<1>();
        }
        if (c != 0) release(it - 1);
        if (c == RA - 1) {
          release(it);
          finish(acc, tile);
        }
      }
    }
  } else {
    if (resident) mbar_wait(&bar.a_full, 0);
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
  }

  if (q == 0) {
    const int row0 = rb * BM;
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

}  // namespace xps_gemm
