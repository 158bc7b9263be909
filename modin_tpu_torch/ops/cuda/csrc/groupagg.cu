// Grouped aggregation of many columns by a slot column, for Hopper (sm_90a).
//
// Replaces the tail of the XLA program that modin_tpu/ops/groupby.py::
// fused_group_agg (:1288, its scatter body :1313-1385) builds for a whole-
// plan fused groupby: every kept row's slot (key - kmin; dropped rows carry
// the overflow slot G) and up to 32 value columns (bool, int8/16/32/64,
// uint8, float32, float64) give per-slot sizes, and per column a table of
// sum, product, count, mean's sum, min or max, and its non-NaN count.
//
// Bound: bytes.  Each row's slot and values are read once (a slot and one
// 8-byte column: 12 B a row, 0.358 ms at 1e8 rows at 3.35 TB/s); the tables
// are small beside them.  This first version is built to be right and
// repeatable, not fast:
//
// - determinism without float atomics: block b owns rows [b * chunk,
//   (b + 1) * chunk) and one warp walks them 32 at a time.  __match_any_sync
//   groups the lanes of one slot; the group's lowest lane folds its peers'
//   values into the slot's entry in lane order, i.e. in row order, so each
//   block's entry is the left fold of its rows of that slot in row order.
//   A merge kernel folds the block partials of each entry in block order.
//   The grid and chunk depend on n and the table size alone, so a float
//   result repeats bit for bit on any card, and the plain version
//   (groupagg_kernels.groupagg_plain) reproduces the order;
// - a row in the overflow slot (dropped by the filter) folds nothing, so
//   that slot keeps its initial values, as the reference's masked scatter
//   leaves it;
// - ints fold in int64 (sums and products wrap as uint64 arithmetic, so an
//   unsigned column's uint64 result has the same bits), floats in float64
//   (a float32 column is widened exactly); NaN folds nothing and is not
//   counted; min/max keep the earliest of equal values (-0.0 against 0.0
//   included);
// - a block's tables ([1 + 2 * columns][G + 1] of 8 bytes: the sizes, then
//   each column's value and non-NaN count) sit in shared memory when they
//   fit in 48 KB, else in the block's own region of the partial buffer in
//   device memory (every width up to 65 536 groups runs on the kernel).
//
// Making it fast (TMA loads, the lanes' values shuffled instead of reloaded,
// a second pass for hot slots) is later work.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxCols = 32;
constexpr int kMergeThreads = 256;

enum Dt : uint8_t { DT_BOOL, DT_I8, DT_I16, DT_I32, DT_I64, DT_U8, DT_F32, DT_F64 };
enum Agg { AGG_SUM, AGG_PROD, AGG_COUNT, AGG_MEAN, AGG_MIN, AGG_MAX };

struct GroupAggParams {
  int64_t n;       // rows
  int64_t chunk;   // rows a block (a multiple of 32)
  int32_t g1;      // table slots: G + 1, the overflow slot last
  int32_t n_cols;
  int32_t agg;
  int32_t in_shared;  // the block's tables in shared memory
  const int32_t* slot;
  void* partial;  // [blocks][1 + 2 * n_cols][g1] of 8 bytes
  const void* col[kMaxCols];
  uint8_t col_dt[kMaxCols];
};

union Val {
  long long i;
  double d;
};

__device__ __forceinline__ bool is_f(int dt) { return dt >= DT_F32; }

__device__ __forceinline__ Val load(const void* p, int dt, long long r) {
  Val v;
  switch (dt) {
    case DT_BOOL:
    case DT_U8: v.i = ((const unsigned char*)p)[r]; break;
    case DT_I8: v.i = ((const signed char*)p)[r]; break;
    case DT_I16: v.i = ((const short*)p)[r]; break;
    case DT_I32: v.i = ((const int*)p)[r]; break;
    case DT_I64: v.i = ((const long long*)p)[r]; break;
    case DT_F32: v.d = (double)((const float*)p)[r]; break;
    default: v.d = ((const double*)p)[r]; break;
  }
  return v;
}

// the initial value of table row t (0: sizes; 1 + 2j: column j's value;
// 2 + 2j: its non-NaN count)
__device__ __forceinline__ Val init_of(const GroupAggParams& p, int t) {
  Val v;
  v.i = 0;
  if (t == 0 || (t % 2) == 0) return v;
  const bool fl = is_f(p.col_dt[(t - 1) / 2]);
  switch (p.agg) {
    case AGG_PROD:
      if (fl) v.d = 1.0; else v.i = 1;
      break;
    case AGG_MIN:
      if (fl) v.d = INFINITY; else v.i = INT64_MAX;
      break;
    case AGG_MAX:
      if (fl) v.d = -INFINITY; else v.i = INT64_MIN;
      break;
    default:
      break;  // sums start at 0 (0.0 has the same bits)
  }
  return v;
}

__device__ __forceinline__ Val fold(int agg, bool fl, Val v, Val x) {
  switch (agg) {
    case AGG_SUM:
    case AGG_MEAN:
      if (fl) v.d = __dadd_rn(v.d, x.d);
      else v.i = (long long)((unsigned long long)v.i + (unsigned long long)x.i);
      break;
    case AGG_PROD:
      if (fl) v.d = __dmul_rn(v.d, x.d);
      else v.i = (long long)((unsigned long long)v.i * (unsigned long long)x.i);
      break;
    case AGG_MIN:
      if (fl) { if (x.d < v.d) v = x; } else if (x.i < v.i) v = x;
      break;
    case AGG_MAX:
      if (fl) { if (v.d < x.d) v = x; } else if (v.i < x.i) v = x;
      break;
    default:
      break;
  }
  return v;
}

__global__ void __launch_bounds__(32) groupagg_kernel(const __grid_constant__ GroupAggParams p) {
  extern __shared__ Val sm[];
  const int lane = threadIdx.x;
  const int g1 = p.g1, rows = 1 + 2 * p.n_cols;
  Val* tab = p.in_shared ? sm : (Val*)p.partial + (long long)blockIdx.x * rows * g1;
  for (int i = lane; i < rows * g1; i += 32) tab[i] = init_of(p, i / g1);
  __syncwarp();
  const long long start = (long long)blockIdx.x * p.chunk;
  const long long end = start + p.chunk < p.n ? start + p.chunk : p.n;
  for (long long r0 = start; r0 < end; r0 += 32) {
    const long long r = r0 + lane;
    int s = r < end ? p.slot[r] : -1;
    if (s == g1 - 1) s = -1;  // a dropped row (the overflow slot) folds nothing
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    if (s >= 0 && (__ffs(peers) - 1) == lane) {
      // the group's leader: its peers are rows r0 + l for the set bits l,
      // in row order
      tab[s].i += __popc(peers);
      for (int j = 0; j < p.n_cols; ++j) {
        const int dt = p.col_dt[j];
        const bool fl = is_f(dt);
        Val* vq = tab + (1 + 2 * j) * g1 + s;
        Val* cq = tab + (2 + 2 * j) * g1 + s;
        Val v = *vq;
        long long cnt = cq->i;
        for (unsigned m = peers; m; m &= m - 1) {
          const Val x = load(p.col[j], dt, r0 + (__ffs(m) - 1));
          if (fl && isnan(x.d)) continue;
          ++cnt;
          v = fold(p.agg, fl, v, x);
        }
        *vq = v;
        cq->i = cnt;
      }
    }
    __syncwarp();
  }
  if (p.in_shared) {
    Val* out = (Val*)p.partial + (long long)blockIdx.x * rows * g1;
    for (int i = lane; i < rows * g1; i += 32) out[i] = tab[i];
  }
}

// each table entry: the block partials folded in block order
__global__ void __launch_bounds__(kMergeThreads)
groupagg_merge(const __grid_constant__ GroupAggParams p, int blocks, Val* out) {
  const int rows = 1 + 2 * p.n_cols;
  const long long e = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (e >= (long long)rows * p.g1) return;
  const int t = (int)(e / p.g1);
  const bool value_row = t > 0 && (t % 2) == 1;
  const bool fl = value_row && is_f(p.col_dt[(t - 1) / 2]);
  const Val* part = (const Val*)p.partial;
  Val v = init_of(p, t);
  for (int b = 0; b < blocks; ++b) {
    const Val x = part[(long long)b * rows * p.g1 + e];
    if (value_row) v = fold(p.agg, fl, v, x);
    else v.i += x.i;
  }
  out[e] = v;
}

}  // namespace

extern "C" {

int groupagg_params_bytes() { return (int)sizeof(GroupAggParams); }

// Runs the aggregation over p->n rows on ``stream``: ``blocks`` one-warp
// blocks (``smem`` bytes of shared memory each, 0 unless p->in_shared),
// then the merge into ``out`` ([1 + 2 * n_cols][g1] of 8 bytes).  Returns 0
// or the CUDA error of a launch.
int groupagg_run(const void* params, int blocks, int smem, void* out, void* stream) {
  const GroupAggParams* p = (const GroupAggParams*)params;
  cudaStream_t s = (cudaStream_t)stream;
  groupagg_kernel<<<blocks, 32, smem, s>>>(*p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long entries = (long long)(1 + 2 * p->n_cols) * p->g1;
  const int merge_blocks = (int)((entries + kMergeThreads - 1) / kMergeThreads);
  groupagg_merge<<<merge_blocks, kMergeThreads, 0, s>>>(*p, blocks, (Val*)out);
  err = cudaGetLastError();
  return (int)err;
}

const char* groupagg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
