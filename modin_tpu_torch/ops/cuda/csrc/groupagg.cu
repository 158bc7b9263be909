// Grouped aggregation of many columns by a slot column, for Hopper (sm_90a).
//
// Replaces the tail of the XLA program that modin_tpu/ops/groupby.py::
// fused_group_agg (:1288, its scatter body :1313-1385) builds for a whole-
// plan fused groupby, and carries the eager int-key groupby of
// modin_tpu_torch/ops/groupby.py::groupby_reduce: every row's slot (an int32
// or int64 column; rows in the overflow slot G = g1 - 1 are dropped) and up
// to 32 value columns (bool, int8/16/32/64, uint8, float32, float64) give
// per-slot sizes, and per column a table of sum, product, count, mean's sum,
// min or max, and its non-NaN count.
//
// Bound: bytes.  Each row's slot and values are read once (an int32 slot
// and one 8-byte column: 12 B a row, 0.358 ms at 1e8 rows at 3.35 TB/s).
// The design:
//
// - blocks of 8 warps over a fixed grid of (chunk, slot range) blocks, the
//   range the fastest-varying index, so that the blocks of one chunk re-read
//   its slot column from L2.  At most 1024 blocks;
// - the tables sit in shared memory at every width: as many as 8 copies of
//   the range's table a block, fewer as the table widens, and above one
//   block's table the slots split into ranges.  Copy p folds the p-th
//   contiguous sub-chunk of the chunk.  With fewer copies than warps, the
//   warps of a copy take its stages in turn (warp w of W the stages w, w +
//   W, ...), so every row is read once a block; they match and combine side
//   by side and commit their values in rounds, warp by warp between block
//   barriers, which is the copy's row order.  Sizes and counts are 4-byte
//   entries inside a block (a chunk has fewer than 2^31 rows) that the
//   leaders add by shared-memory atomics (exact in any order), the values 8
//   bytes;
// - each warp streams its sub-chunk through a ring of stages in shared
//   memory, S - 1 stages ahead of the one it folds: for one or two columns,
//   stages of 128 rows, each column one TMA bulk copy completing on the
//   stage's mbarrier; for more columns, stages of 64 or 32 rows that the
//   lanes copy with 16-byte cp.async (a bulk copy that short does not pay).
//   Each lane loads its own row from the stage once;
// - within a group of 32 rows, __match_any_sync finds the lanes of a slot
//   and they combine by __shfl_sync in a fixed tree over their ranks (rank r
//   takes rank r + 2^d at level d), nothing reloaded; the group's lowest
//   lane folds the result into the table.  The groups of a stage run side by
//   side and commit in row order, a __syncwarp between two groups' commits.
//   NaN takes part as the fold's identity and is not counted;
// - float folds are committed in an order fixed by n, g1 and the column
//   count alone: the tree, the groups of a copy in row order, the copies in
//   order, then a merge kernel in which lane l of an entry's warp folds
//   chunks [l * per, (l + 1) * per) in order and the 32 lanes combine in a
//   fixed tree.  That order is row order wherever it chooses between equal
//   values, so min/max keep the earliest of equal values (-0.0 against 0.0
//   included).  groupagg_kernels.groupagg_plain reproduces it bit for bit;
// - ints fold in int64 (sums and products wrap as uint64 arithmetic, so an
//   unsigned column's uint64 result has the same bits), floats in float64 (a
//   float32 column is widened exactly); a mean folds every column in
//   float64, an int column's values widened first, as pandas adds them.
//   Int folds take the same tree: 64-bit shared-memory atomics measured
//   slower on the card.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxCols = 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMergeWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

enum Dt : uint8_t { DT_BOOL, DT_I8, DT_I16, DT_I32, DT_I64, DT_U8, DT_F32, DT_F64 };
enum Agg { AGG_SUM, AGG_PROD, AGG_COUNT, AGG_MEAN, AGG_MIN, AGG_MAX };

struct GroupAggParams {
  int64_t n;            // rows
  int64_t chunk;        // rows a chunk: a multiple of 2048 (8 copies' whole groups)
  int32_t g1;           // table slots: G + 1, the overflow slot last
  int32_t n_cols;
  int32_t agg;
  int32_t copies;       // table copies a block: 1, 2, 4 or 8
  int32_t range_slots;  // slots a block's table covers
  int32_t ranges;       // blocks a chunk
  int32_t chunks;
  int32_t slot_bytes;   // 4 (int32 slots) or 8 (int64)
  int32_t stages;       // a warp's ring: 4 stages (bulk) or 2 (per lane)
  int32_t stage_groups; // groups of 32 rows a stage: 1, 2 or 4
  int32_t bulk;         // a stage's columns come by TMA bulk copies (else by the lanes' cp.async)
  int32_t stage_bytes;  // one stage: the slot segment, then each column's
  int32_t copy_bytes;   // one table copy: values [n_cols][range_slots] of 8 B,
                        // then sizes and counts [1 + n_cols][range_slots] of 4 B
  int32_t smem_bytes;   // 8 warps' rings and the copies
  const void* slot;
  void* partial;        // [chunks][1 + 2 * n_cols][g1] of 8 bytes
  const void* col[kMaxCols];
  uint32_t col_off[kMaxCols];  // byte offset of column j's segment in a stage (a multiple of 16)
  uint8_t col_dt[kMaxCols];
};

union Val {
  long long i;
  double d;
};

__device__ __forceinline__ bool is_f(int dt) { return dt >= DT_F32; }

__device__ __forceinline__ int esize_of(int dt) {
  switch (dt) {
    case DT_I64:
    case DT_F64: return 8;
    case DT_I32:
    case DT_F32: return 4;
    case DT_I16: return 2;
    default: return 1;
  }
}

// whether a column's values fold as float64 (a mean's always do)
template <int AGG>
__device__ __forceinline__ bool folds_float(int dt) { return AGG == AGG_MEAN || is_f(dt); }

template <int AGG>
__device__ __forceinline__ Val identity(bool fl) {
  Val v;
  v.i = 0;  // sums start at 0 (0.0 has the same bits)
  if (AGG == AGG_PROD) {
    if (fl) v.d = 1.0; else v.i = 1;
  } else if (AGG == AGG_MIN) {
    if (fl) v.d = INFINITY; else v.i = INT64_MAX;
  } else if (AGG == AGG_MAX) {
    if (fl) v.d = -INFINITY; else v.i = INT64_MIN;
  }
  return v;
}

// v (earlier rows) folded with x (later rows); min/max keep v on a tie
template <int AGG>
__device__ __forceinline__ Val fold(bool fl, Val v, Val x) {
  if (AGG == AGG_SUM || AGG == AGG_MEAN) {
    if (fl) v.d = __dadd_rn(v.d, x.d);
    else v.i = (long long)((unsigned long long)v.i + (unsigned long long)x.i);
  } else if (AGG == AGG_PROD) {
    if (fl) v.d = __dmul_rn(v.d, x.d);
    else v.i = (long long)((unsigned long long)v.i * (unsigned long long)x.i);
  } else if (AGG == AGG_MIN) {
    if (fl) { if (x.d < v.d) v = x; } else if (x.i < v.i) v = x;
  } else if (AGG == AGG_MAX) {
    if (fl) { if (v.d < x.d) v = x; } else if (v.i < x.i) v = x;
  }
  return v;
}

__device__ __forceinline__ Val load_staged(const unsigned char* t, int dt, int i) {
  Val v;
  switch (dt) {
    case DT_BOOL:
    case DT_U8: v.i = t[i]; break;
    case DT_I8: v.i = ((const signed char*)t)[i]; break;
    case DT_I16: v.i = ((const short*)t)[i]; break;
    case DT_I32: v.i = ((const int*)t)[i]; break;
    case DT_I64: v.i = ((const long long*)t)[i]; break;
    case DT_F32: v.d = (double)((const float*)t)[i]; break;
    default: v.d = ((const double*)t)[i]; break;
  }
  return v;
}

constexpr int kMaxStages = 4;
constexpr int kBarBytes = kWarps * kMaxStages * 8;  // each warp's ring barriers, first in shared memory

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// a wait that never ends traps (the launch then fails) instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  unsigned done = 0;
  for (long long spins = 0; !done; ++spins) {
    if (spins > (1ll << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}

// one TMA bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// whether a column's rows [r0, r0 + rows) go by one bulk copy: aligned and
// below n (else the lanes copy them one element each: the ragged end, or a
// column off a 16-byte boundary)
__device__ __forceinline__ bool bulk_ok(const unsigned char* src, int esize, long long r0, int rows, long long n) {
  return r0 + rows <= n && (reinterpret_cast<uintptr_t>(src + r0 * esize) & 15) == 0;
}

__device__ __forceinline__ void lane_copy(unsigned char* dst, const unsigned char* src, int esize, long long r0,
                                          int rows, long long n, int lane) {
  for (int i = lane; i < rows && r0 + i < n; i += 32) {
    const int o = i * esize;
    const unsigned char* g = src + r0 * esize;
    switch (esize) {
      case 8: *(long long*)(dst + o) = *(const long long*)(g + o); break;
      case 4: *(int*)(dst + o) = *(const int*)(g + o); break;
      case 2: *(short*)(dst + o) = *(const short*)(g + o); break;
      default: dst[o] = g[o]; break;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most one of this thread's copy groups is pending: the
// per-lane ring has two stages
__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// A stage of ``rows`` rows from r0 into a warp's ring, by one of two
// routes.  Bulk (four groups a stage, one or two columns): lane 0 arms the
// stage's barrier with the bytes of its TMA bulk copies and issues one a
// column.  Per lane (one or two groups a stage, more columns): each lane
// issues 16-byte cp.async copies, one commit group a stage.  Either way the lanes
// copy by hand what no copy takes (the ragged end, a column off a 16-byte
// boundary).
__device__ void stage_rows(const GroupAggParams& p, unsigned char* st, uint64_t* bar, long long r0, int rows,
                           int lane) {
  const int C = p.n_cols;
  const bool bulk = p.bulk;
  if (bulk && lane == 0) {
    unsigned bytes = 0;
    for (int j = -1; j < C; ++j) {
      const unsigned char* cs = (const unsigned char*)(j < 0 ? p.slot : p.col[j]);
      const int es = j < 0 ? p.slot_bytes : esize_of(p.col_dt[j]);
      if (bulk_ok(cs, es, r0, rows, p.n)) bytes += rows * es;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the lanes' reads of the stage come first
    mbar_expect(bar, bytes);
  }
  for (int j = -1; j < C; ++j) {
    const unsigned char* cs = (const unsigned char*)(j < 0 ? p.slot : p.col[j]);
    const int es = j < 0 ? p.slot_bytes : esize_of(p.col_dt[j]);
    unsigned char* dst = j < 0 ? st : st + p.col_off[j];
    if (!bulk_ok(cs, es, r0, rows, p.n)) {
      lane_copy(dst, cs, es, r0, rows, p.n, lane);
    } else if (!bulk) {
      for (int b = lane * 16; b < rows * es; b += 32 * 16) cp_async16(dst + b, cs + r0 * es + b);
    } else if (lane == 0) {
      bulk_copy(dst, cs + r0 * es, rows * es, bar);
    }
  }
  if (!bulk) cp_async_commit();
}

// wait for a stage: its barrier's phase (bulk), or all but the newest
// commit group (per lane)
__device__ __forceinline__ void stage_wait(const GroupAggParams& p, uint64_t* bar, unsigned phase) {
  if (p.bulk) mbar_wait(bar, phase);
  else cp_async_wait_prior();
}

// Folds the K groups of 32 rows of one stage into this warp's table copy:
// ``ngroups`` of them hold rows (none where the warp has no stage this
// round), the first row ``row0``.  The K groups' matches, trees and column
// loads run side by side, B columns at a time.  Sizes and counts go in by
// shared-memory atomics; the values are committed in ``owners`` turns, one
// for each warp of the copy in row order (``own`` is this warp's), with a
// block barrier after each turn where a copy has more than one warp, and
// within a turn group by group: a slot's entry takes its groups in row order.
template <int AGG, int K, int B>
__device__ __forceinline__ void fold_stage(const GroupAggParams& p, const unsigned char* st, int ngroups,
                                           long long row0, int lo, int hi, int owners, int own, int lane, Val* tv,
                                           int* tsize, int* tcount) {
  const int RS = p.range_slots, C = p.n_cols;
  int ls[K];
  bool act[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    ls[u] = -1;
    if (u < ngroups && row0 + 32 * u + lane < p.n) {
      const int i = 32 * u + lane;
      const long long s = p.slot_bytes == 4 ? (long long)((const int*)st)[i] : ((const long long*)st)[i];
      if (s >= lo && s < hi) ls[u] = (int)(s - lo);
    }
    act[u] = __any_sync(kFull, ls[u] >= 0);
  }
  // the lanes of a slot in each group, and their tree: nx[u][d] is the lane
  // of rank + 2^d in this lane's slot (32: none)
  unsigned peers[K];
  bool leader[K];
  int rank[K], nx[K][5];
  unsigned widest = 0;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    peers[u] = act[u] ? __match_any_sync(kFull, ls[u]) : 0u;
    leader[u] = ls[u] >= 0 && (__ffs(peers[u]) - 1) == lane;
    rank[u] = __popc(peers[u] & ((1u << lane) - 1));
    const unsigned above = lane == 31 ? 0u : peers[u] & (kFull << (lane + 1));
    nx[u][0] = above ? __ffs(above) - 1 : 32;
    if (ls[u] >= 0) widest = max(widest, (unsigned)__popc(peers[u]));
  }
  widest = __reduce_max_sync(kFull, widest);
  const int levels = widest > 1 ? 32 - __clz(widest - 1) : 0;
#pragma unroll
  for (int d = 1; d < 5; ++d) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      nx[u][d] = 32;
      if (d < levels) {
        const int far = __shfl_sync(kFull, nx[u][d - 1], nx[u][d - 1] & 31);
        nx[u][d] = nx[u][d - 1] >= 32 ? 32 : far;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < K; ++u)
    if (leader[u]) atomicAdd(tsize + ls[u], __popc(peers[u]));
  for (int j0 = 0; j0 < C; j0 += B) {
    Val x[K][B];
    bool fl[B];
#pragma unroll
    for (int v = 0; v < B; ++v) {
      const int j = j0 + v;
      if (j >= C) continue;
      const int dt = p.col_dt[j];
      fl[v] = folds_float<AGG>(dt);
#pragma unroll
      for (int u = 0; u < K; ++u) {
        if (!act[u]) continue;
        x[u][v] = load_staged(st + p.col_off[j], dt, 32 * u + lane);
        if (is_f(dt)) {
          // a float column counts its non-NaN values; a NaN folds the
          // identity in its rank (an int column's count is its size)
          const bool ok = !isnan(x[u][v].d);
          const unsigned okm = __ballot_sync(kFull, ls[u] >= 0 && ok) & peers[u];
          if (leader[u]) atomicAdd(tcount + j * RS + ls[u], __popc(okm));
          if (!ok) x[u][v] = identity<AGG>(true);
        } else if (AGG == AGG_MEAN) {
          x[u][v].d = (double)x[u][v].i;
        }
      }
    }
    if (AGG == AGG_COUNT) continue;
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      if (d >= levels) break;
#pragma unroll
      for (int u = 0; u < K; ++u) {
        if (!act[u]) continue;
        const bool take = (rank[u] & ((2 << d) - 1)) == 0 && nx[u][d] < 32;
#pragma unroll
        for (int v = 0; v < B; ++v) {
          if (j0 + v >= C) continue;
          Val y;
          y.i = __shfl_sync(kFull, x[u][v].i, nx[u][d] & 31);
          if (take) x[u][v] = fold<AGG>(fl[v], x[u][v], y);
        }
      }
    }
    for (int turn = 0; turn < owners; ++turn) {
      if (turn == own) {
#pragma unroll
        for (int u = 0; u < K; ++u) {
          if (leader[u]) {
            Val cur[B];
#pragma unroll
            for (int v = 0; v < B; ++v)
              if (j0 + v < C) cur[v] = tv[(j0 + v) * RS + ls[u]];
#pragma unroll
            for (int v = 0; v < B; ++v)
              if (j0 + v < C) tv[(j0 + v) * RS + ls[u]] = fold<AGG>(fl[v], cur[v], x[u][v]);
          }
          __syncwarp();  // group u + 1's leader of the same slot may be another lane
        }
      }
      if (owners > 1) __syncthreads();
    }
  }
}

template <int AGG, int K, int B>
__global__ void __launch_bounds__(kThreads) groupagg_kernel(const __grid_constant__ GroupAggParams p) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = p.copies, owners = kWarps / P;
  const int cpy = warp % P, own = warp / P;
  const int q = blockIdx.x % p.ranges;
  const long long c = blockIdx.x / p.ranges;
  const int RS = p.range_slots, C = p.n_cols, S = p.stages;
  const int lo = q * RS;
  const int hi_out = min(lo + RS, p.g1);  // the slots this block writes
  const int hi = min(hi_out, p.g1 - 1);   // the slots it folds: not the overflow slot
  const long long n = p.n, sub = p.chunk / P;
  uint64_t* bars = (uint64_t*)sm + warp * kMaxStages;
  unsigned char* ring = sm + kBarBytes + (long long)warp * S * p.stage_bytes;
  unsigned char* tables = sm + kBarBytes + (long long)kWarps * S * p.stage_bytes;

  if (lane == 0) {
    for (int k = 0; k < S; ++k) mbar_init(bars + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int k = threadIdx.x; k < P * RS; k += kThreads) {
    const int cp = k / RS, ls = k - cp * RS;
    unsigned char* base = tables + (long long)cp * p.copy_bytes;
    int* counts = (int*)(base + 8ll * C * RS);
    counts[ls] = 0;
    for (int j = 0; j < C; ++j) {
      ((Val*)base)[j * RS + ls] = identity<AGG>(folds_float<AGG>(p.col_dt[j]));
      counts[(1 + j) * RS + ls] = 0;
    }
  }
  __syncthreads();
  unsigned char* mine_tab = tables + (long long)cpy * p.copy_bytes;
  Val* tv = (Val*)mine_tab;
  int* tsize = (int*)(mine_tab + 8ll * C * RS);
  int* tcount = tsize + RS;

  // the warps of a copy walk its sub-chunk in rounds of stages of K groups
  // of 32 rows, warp ``own`` taking the round's stage own (i * owners + own
  // in round i), S - 1 of its stages streaming in ahead of the one it folds.
  // Every warp of the block runs the same rounds (the barriers of the
  // commit turns), folding nothing where its copy has no stage left.
  const long long base = c * p.chunk + cpy * sub;
  const long long left = n - base;
  const int groups = left <= 0 ? 0 : (int)min(sub / 32, (left + 31) / 32);
  const int n_stages = (groups + K - 1) / K;  // the copy's stages
  const int rounds = (int)((sub / (32 * K) + owners - 1) / owners);
  const bool per_lane = !p.bulk;
  for (int i = 0; i < S - 1; ++i) {
    const int t = i * owners + own;
    if (t < n_stages)
      stage_rows(p, ring + i * p.stage_bytes, bars + i, base + 32ll * K * t, 32 * K, lane);
    else if (per_lane)
      cp_async_commit();  // an empty group keeps the count of pending groups
  }
  for (int i = 0; i < rounds; ++i) {
    const int t = i * owners + own, ahead = (i + S - 1) * owners + own;
    if (ahead < n_stages)
      stage_rows(p, ring + ((i + S - 1) % S) * p.stage_bytes, bars + (i + S - 1) % S, base + 32ll * K * ahead,
                 32 * K, lane);
    else if (per_lane)
      cp_async_commit();
    const bool has = t < n_stages;
    if (has) stage_wait(p, bars + i % S, (i / S) & 1);
    __syncwarp();
    fold_stage<AGG, K, B>(p, ring + (i % S) * p.stage_bytes, has ? min(K, groups - t * K) : 0,
                          base + 32ll * K * t, lo, hi, owners, own, lane, tv, tsize, tcount);
    __syncwarp();  // the stage is read: a later stage refills it
  }
  __syncthreads();

  // the block's partial: the copies folded in order; an int column's count
  // is its slot's size
  const int nsl = hi_out - lo, rows = 1 + 2 * C;
  Val* part = (Val*)p.partial + c * rows * (long long)p.g1;
  for (int e = threadIdx.x; e < rows * nsl; e += kThreads) {
    const int t = e / nsl, ls = e - t * nsl;
    Val v;
    if ((t & 1) == 0) {  // sizes (t = 0) or column (t - 2) / 2's count: int32 rows 0 and 1 + j
      const int srow = t == 0 || !is_f(p.col_dt[(t - 2) / 2]) ? 0 : 1 + (t - 2) / 2;
      long long s = 0;
      for (int cp = 0; cp < P; ++cp)
        s += ((const int*)(tables + (long long)cp * p.copy_bytes + 8ll * C * RS))[srow * RS + ls];
      v.i = s;
    } else {
      const int j = (t - 1) / 2;
      const bool fl = folds_float<AGG>(p.col_dt[j]);
      v = ((const Val*)tables)[j * RS + ls];
      for (int cp = 1; cp < P; ++cp)
        v = fold<AGG>(fl, v, ((const Val*)(tables + (long long)cp * p.copy_bytes))[j * RS + ls]);
    }
    part[(long long)t * p.g1 + lo + ls] = v;
  }
}

// one warp an entry: lane l folds the partials of chunks [l * per, (l + 1) *
// per) in order, then the lanes combine in a fixed tree (lane l takes lane
// l + 2^d at level d)
template <int AGG>
__global__ void __launch_bounds__(kMergeWarps * 32)
groupagg_merge(const __grid_constant__ GroupAggParams p, Val* out) {
  const int rows = 1 + 2 * p.n_cols, lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (e >= (long long)rows * p.g1) return;  // the whole warp
  const int t = (int)(e / p.g1);
  const bool value_row = (t & 1) == 1;
  const bool fl = value_row && folds_float<AGG>(p.col_dt[(t - 1) / 2]);
  const int per = (p.chunks + 31) / 32;
  const int c0 = lane * per, c1 = min(c0 + per, p.chunks);
  const Val* part = (const Val*)p.partial;
  const long long stride = (long long)rows * p.g1;
  Val v;
  v.i = 0;
  if (value_row) v = identity<AGG>(fl);
  for (int c = c0; c < c1; ++c) {
    const Val x = part[c * stride + e];
    if (value_row) v = fold<AGG>(fl, v, x);
    else v.i += x.i;
  }
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    Val y;
    y.i = __shfl_down_sync(kFull, v.i, 1 << d);
    if ((lane & ((2 << d) - 1)) == 0) {
      if (value_row) v = fold<AGG>(fl, v, y);
      else v.i += y.i;
    }
  }
  if (lane == 0) out[e] = v;
}

template <int AGG, int K, int B>
int launch(const GroupAggParams& p, int blocks, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(groupagg_kernel<AGG, K, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  groupagg_kernel<AGG, K, B><<<blocks, kThreads, p.smem_bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <int AGG>
int run(const GroupAggParams& p, int blocks, void* out, cudaStream_t s) {
  int err;
  switch (p.stage_groups) {
    case 4:  // one column a batch where there is one (fewer registers, more blocks an SM)
      err = p.n_cols == 1 ? launch<AGG, 4, 1>(p, blocks, s) : launch<AGG, 4, 2>(p, blocks, s);
      break;
    case 2: err = launch<AGG, 2, 4>(p, blocks, s); break;
    case 1: err = launch<AGG, 1, 4>(p, blocks, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const long long entries = (long long)(1 + 2 * p.n_cols) * p.g1;
  const long long merge_blocks = (entries + kMergeWarps - 1) / kMergeWarps;
  groupagg_merge<AGG><<<(unsigned)merge_blocks, kMergeWarps * 32, 0, s>>>(p, (Val*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int groupagg_params_bytes() { return (int)sizeof(GroupAggParams); }

// Runs the aggregation over p->n rows on ``stream``: ``blocks`` blocks of
// 8 warps (p->smem_bytes of dynamic shared memory each) write the chunk
// partials, then the merge writes ``out`` ([1 + 2 * n_cols][g1] of 8
// bytes).  Returns 0 or the CUDA error of a launch.
int groupagg_run(const void* params, int blocks, void* out, void* stream) {
  const GroupAggParams& p = *(const GroupAggParams*)params;
  cudaStream_t s = (cudaStream_t)stream;
  switch (p.agg) {
    case AGG_SUM: return run<AGG_SUM>(p, blocks, out, s);
    case AGG_PROD: return run<AGG_PROD>(p, blocks, out, s);
    case AGG_COUNT: return run<AGG_COUNT>(p, blocks, out, s);
    case AGG_MEAN: return run<AGG_MEAN>(p, blocks, out, s);
    case AGG_MIN: return run<AGG_MIN>(p, blocks, out, s);
    case AGG_MAX: return run<AGG_MAX>(p, blocks, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* groupagg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
