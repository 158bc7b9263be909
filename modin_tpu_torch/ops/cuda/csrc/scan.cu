// Deterministic prefix scans for Hopper (sm_90a): a first-order linear
// recurrence, and segmented add/mul/max/min over rows sorted by group or cut
// into fixed blocks, forward or in reverse.
//
// Replaces two XLA programs of the JAX package (neither is a Pallas kernel):
// - modin_tpu/ops/window.py::_linear_scan (:209), the blocked associative
//   scan behind every ewm statistic: y_t = a_t * y_{t-1} + b_t, y_{-1} = 0;
// - modin_tpu/ops/groupby.py::_jit_grouped_cum (:1178), the segmented scan of
//   grouped cumsum/cumprod/cummax/cummin, which resets where the sorted group
//   code changes.
// It also gives the block-local prefix and suffix scans of the van Herk split
// behind every rolling min/max/sum/mean/var (modin_tpu_torch/ops/window.py).
// PyTorch has no operation for any of them, and torch.cumsum on CUDA need not
// repeat bit for bit; this kernel combines in an order fixed by n alone.
//
// Modes (one template over a combine operator):
// - linear: float64 maps (a, b), (a1,b1) then (a2,b2) = (a1*a2, a2*b1 + b2);
// - add/mul/max/min over int64 or float64 values with (flag, value) states,
//   (f1,v1) then (f2,v2) = (f1|f2, f2 ? v2 : v1 op v2).  int64 add and mul
//   run in uint64 arithmetic: numpy's wraparound, and no signed overflow.
//   max/min take NaN-free values (the callers fill NaN with the neutral).
//   A segment starts at the first row scanned, where the sorted code differs
//   from the row scanned before, and where the block of `width` rows (rows
//   [k*width, (k+1)*width)) changes.
// - reverse: row n-1-p is the p-th row scanned, read and written in place.
//
// Bound: one pass.  linear reads a and b and writes y, 24 B a row; a
// segmented scan with codes reads values and codes and writes y, 24 B a row;
// without codes 16 B a row.  At n = 1e8: 0.716 ms (24 B) and 0.478 ms
// (16 B) at the H100 SXM's 3.35 TB/s.
//
// Design (one pass, a carry of fixed association and logarithmic depth):
// - Persistent blocks (one per SM) take 6528-row tiles in the order of
//   tickets from an atomic counter, so a tile only ever waits for tiles that
//   were handed out before it.  A block takes its next ticket once its tile
//   has its carry: a block holding tickets it has not started would make
//   later tiles wait behind its own queue, and the tiles would run one after
//   another (measured: 4-12 ms at 1e8 when tickets ran ahead).  Thread 0
//   then copies the next tile's rows into the other of two shared-memory
//   stages with the 1-D bulk async copy (cp.async.bulk, completion on an
//   mbarrier), the 16-byte-aligned middle in one copy, the at most two rows
//   at its edges by plain loads, while this tile's second pass runs.
// - Within a tile, blocked: thread t owns rows 17t..17t+16 (an odd stride,
//   so the 8-byte shared reads of a half-warp hit 16 distinct banks) and
//   folds them serially, one shuffle scan combines the thread totals of a
//   warp, and every thread folds the 12 warp totals; once the carry is in,
//   each thread scans its rows again, seeded with its exclusive prefix,
//   into shared memory, and warps 1-11 write y with coalesced stores.
//   Four barriers a tile.
// - Across tiles, Fenwick partials kept for every 32nd tile.  Tile K
//   (1-based ticket) publishes its total A_K.  With M the multiple of 32
//   before K, its carry is the right fold of F_p over M's Fenwick path
//   (p = M, M - lowbit(M), ...) over the fold of A_{M+1} .. A_{K-1} (a
//   fixed tree of at most 31).  A K that is a multiple of 32 publishes
//   F_K = F_{K-L/2} (+) ... (+) F_{K-32} (+) (A_{K-31} (+) ... (+) A_K),
//   L = lowbit(K), as soon as those are in: F_K never waits for a carry,
//   and a child 2^j tickets back waits at most on children further back,
//   so the waits do not chain from tile to tile.  Lane j of warp 0 reads
//   the j-th aggregate and node, all lanes at once.  The association
//   depends on K alone, and every wait is on an earlier ticket.
// - A record (state, flag) has its own 128-byte line; the state is
//   published by st.release of the flag and read after an ld.acquire of
//   it, through L2; warp 0 issues no stores of y, so its releases wait for
//   nothing else.  The counter and the records are zeroed by
//   cudaMemsetAsync on the caller's stream in scan_run; nothing is kept
//   across launches.  No float atomics, no look-back that depends on
//   timing: the result repeats bit for bit.
// Combine depth of one output (combines an input passes through): at most
// 16 + 5 + 11 to its tile's total, ceil(log2 tiles) + 5 into a carry (the
// tree of aggregates, then the path's nodes, each F_p at most
// log2 lowbit(p) + 1 deep), then 2 + 17 into the row: at most
// ceil(log2 tiles) + 56 (70 at n = 1e8).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 17;  // odd: conflict-free 8-byte shared reads
static_assert(kItems % 2 == 1, "an odd stride keeps shared reads conflict-free");
constexpr int kTile = kThreads * kItems;  // 6528 rows
constexpr int kSlots = kTile + 2;  // one stage of one array, with the alignment slot
// the tile being scanned and the next one, loading during its second pass
constexpr int kStages = 2;

__device__ __forceinline__ double as_f64(uint64_t w) {
  return __longlong_as_double(static_cast<long long>(w));
}
__device__ __forceinline__ uint64_t f64_bits(double d) {
  return static_cast<uint64_t>(__double_as_longlong(d));
}

struct Lin {
  double a, b;
};

template <typename T>
struct Seg {
  T v;
  int f;  // a segment starts inside the range this state covers
};

__device__ __forceinline__ Lin shfl_up(const Lin& s, int d) {
  return {__shfl_up_sync(0xffffffffu, s.a, d), __shfl_up_sync(0xffffffffu, s.b, d)};
}
__device__ __forceinline__ Lin shfl_idx(const Lin& s, int src) {
  return {__shfl_sync(0xffffffffu, s.a, src), __shfl_sync(0xffffffffu, s.b, src)};
}
template <typename T>
__device__ __forceinline__ Seg<T> shfl_up(const Seg<T>& s, int d) {
  return {__shfl_up_sync(0xffffffffu, s.v, d), __shfl_up_sync(0xffffffffu, s.f, d)};
}
template <typename T>
__device__ __forceinline__ Seg<T> shfl_idx(const Seg<T>& s, int src) {
  return {__shfl_sync(0xffffffffu, s.v, src), __shfl_sync(0xffffffffu, s.f, src)};
}
__device__ __forceinline__ Lin shfl_down(const Lin& s, int d) {
  return {__shfl_down_sync(0xffffffffu, s.a, d), __shfl_down_sync(0xffffffffu, s.b, d)};
}
template <typename T>
__device__ __forceinline__ Seg<T> shfl_down(const Seg<T>& s, int d) {
  return {__shfl_down_sync(0xffffffffu, s.v, d), __shfl_down_sync(0xffffffffu, s.f, d)};
}

struct LinearOp {
  using State = Lin;
  static constexpr int kArrays = 2;  // a, b
  static constexpr bool kCodes = false;
  __device__ static State identity() { return {1.0, 0.0}; }
  __device__ static State combine(const State& l, const State& r) {
    return {l.a * r.a, r.a * l.b + r.b};
  }
  __device__ static State make(uint64_t a, uint64_t b, bool) { return {as_f64(a), as_f64(b)}; }
  __device__ static uint64_t out(const State& s) { return f64_bits(s.b); }
  __device__ static ulonglong2 words(const State& s) {
    return make_ulonglong2(f64_bits(s.a), f64_bits(s.b));
  }
  __device__ static State from_words(ulonglong2 w) { return {as_f64(w.x), as_f64(w.y)}; }
};

struct AddI {
  __device__ static int64_t neutral() { return 0; }
  __device__ static int64_t apply(int64_t l, int64_t r) {
    return static_cast<int64_t>(static_cast<uint64_t>(l) + static_cast<uint64_t>(r));
  }
};
struct MulI {
  __device__ static int64_t neutral() { return 1; }
  __device__ static int64_t apply(int64_t l, int64_t r) {
    return static_cast<int64_t>(static_cast<uint64_t>(l) * static_cast<uint64_t>(r));
  }
};
struct MaxI {
  __device__ static int64_t neutral() { return INT64_MIN; }
  __device__ static int64_t apply(int64_t l, int64_t r) { return r > l ? r : l; }
};
struct MinI {
  __device__ static int64_t neutral() { return INT64_MAX; }
  __device__ static int64_t apply(int64_t l, int64_t r) { return r < l ? r : l; }
};
struct AddF {
  __device__ static double neutral() { return 0.0; }
  __device__ static double apply(double l, double r) { return l + r; }
};
struct MulF {
  __device__ static double neutral() { return 1.0; }
  __device__ static double apply(double l, double r) { return l * r; }
};
struct MaxF {
  __device__ static double neutral() { return -CUDART_INF; }
  __device__ static double apply(double l, double r) { return r > l ? r : l; }
};
struct MinF {
  __device__ static double neutral() { return CUDART_INF; }
  __device__ static double apply(double l, double r) { return r < l ? r : l; }
};

template <typename T>
__device__ __forceinline__ T from_bits(uint64_t w);
template <>
__device__ __forceinline__ double from_bits<double>(uint64_t w) { return as_f64(w); }
template <>
__device__ __forceinline__ int64_t from_bits<int64_t>(uint64_t w) { return static_cast<int64_t>(w); }
__device__ __forceinline__ uint64_t to_bits(double v) { return f64_bits(v); }
__device__ __forceinline__ uint64_t to_bits(int64_t v) { return static_cast<uint64_t>(v); }

template <typename T, class F, bool kHasCodes>
struct SegOp {
  using State = Seg<T>;
  static constexpr int kArrays = kHasCodes ? 2 : 1;  // values[, codes]
  static constexpr bool kCodes = kHasCodes;
  __device__ static State identity() { return {F::neutral(), 0}; }
  __device__ static State combine(const State& l, const State& r) {
    return {r.f ? r.v : F::apply(l.v, r.v), l.f | r.f};
  }
  __device__ static State make(uint64_t v, uint64_t, bool start) { return {from_bits<T>(v), start}; }
  __device__ static uint64_t out(const State& s) { return to_bits(s.v); }
  __device__ static ulonglong2 words(const State& s) {
    return make_ulonglong2(to_bits(s.v), static_cast<uint64_t>(s.f));
  }
  __device__ static State from_words(ulonglong2 w) {
    return {from_bits<T>(w.x), static_cast<int>(w.y)};
  }
};

// A published state: its flag turns 1 after the state is visible.  One
// 128-byte line each, so that the polls of recent records spread over L2.
struct __align__(128) Rec {
  ulonglong2 state;
  int flag;
  int pad[27];
};

// Fenwick partials are kept for every kRadix-th tile only; a carry reads
// the aggregates of the at most kRadix - 1 tiles after the last of them.
constexpr int kRadix = 32;

struct Args {
  const uint64_t* in[2];  // values or a; codes or b (8-byte rows)
  uint64_t* y;
  int64_t n, width, tiles;
  int reverse;
  unsigned int* counter;  // tickets handed out
  Rec* aggs;              // aggs[K-1]: A_K, the total of tile K alone
  Rec* nodes;             // nodes[K-1]: F_K, for K a multiple of kRadix
};

// ------------------------------------------------------------------ PTX --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// A wait that has not ended after ~2^26 polls (seconds) traps, so that a
// fault shows as a launch error rather than a hung card.
constexpr int kMaxPolls = 1 << 26;

__device__ __forceinline__ void backoff(int& polls) {
  if (++polls > kMaxPolls) __trap();
  __nanosleep(64);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  int polls = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    backoff(polls);
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// ------------------------------------------------------------- helpers --

// Rows [lo, hi) of ticket k: scan positions [k*kTile, ...) in scan order.
struct Span {
  int64_t lo, hi;
  int m;
};

__device__ __forceinline__ Span span_of(const Args& A, int64_t k) {
  const int64_t first = k * kTile;
  const int64_t m = A.n - first < kTile ? A.n - first : kTile;
  Span s;
  s.m = static_cast<int>(m);
  s.lo = A.reverse ? A.n - first - m : first;
  s.hi = s.lo + m;
  return s;
}

// 1 when row `lo` of array p is not 16-byte aligned (rows are 8 bytes).
__device__ __forceinline__ int misaligned(const uint64_t* p, int64_t lo) {
  return (reinterpret_cast<uintptr_t>(p + lo) & 15) ? 1 : 0;
}

// The bulk copy of ticket k's rows into one stage (thread 0 only).
template <class Op>
__device__ void issue(const Args& A, int64_t k, uint64_t* stage, uint64_t* bar) {
  const Span sp = span_of(A, k);
  uint32_t bytes = 0;
  int64_t first[Op::kArrays], count[Op::kArrays];
#pragma unroll
  for (int a = 0; a < Op::kArrays; ++a) {
    const int mis = misaligned(A.in[a], sp.lo);
    first[a] = sp.lo + mis;
    count[a] = sp.hi - first[a] > 0 ? ((sp.hi - first[a]) & ~int64_t{1}) : 0;
    bytes += static_cast<uint32_t>(count[a] * 8);
  }
  // the stage was last read and written by the generic proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, bytes);
#pragma unroll
  for (int a = 0; a < Op::kArrays; ++a) {
    if (count[a] > 0) {
      const int mis = static_cast<int>(first[a] - sp.lo);
      bulk_load(stage + a * kSlots + 2 * mis, A.in[a] + first[a],
                static_cast<uint32_t>(count[a] * 8), bar);
    }
  }
}

__device__ __forceinline__ int ld_flag(const Rec* r) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(&r->flag) : "memory");
  return v;
}

__device__ __forceinline__ ulonglong2 ld_state(const Rec* r) {
  ulonglong2 w;
  asm volatile("ld.global.cg.v2.u64 {%0, %1}, [%2];\n"
               : "=l"(w.x), "=l"(w.y)
               : "l"(&r->state)
               : "memory");
  return w;
}

// The states of up to kReads records (null: none), each waited for: the
// flags are read with acquire loads, any still 0 polled, then the state
// loads go out together.
constexpr int kReads = 2;

template <class Op>
__device__ __forceinline__ void read_recs(const Rec* const (&r)[kReads],
                                          typename Op::State (&out)[kReads]) {
  int f[kReads];
#pragma unroll
  for (int i = 0; i < kReads; ++i) f[i] = r[i] ? ld_flag(r[i]) : 1;
#pragma unroll
  for (int i = 0; i < kReads; ++i) {
    int polls = 0;
    while (f[i] == 0) {
      backoff(polls);
      f[i] = ld_flag(r[i]);
    }
  }
  ulonglong2 w[kReads];
#pragma unroll
  for (int i = 0; i < kReads; ++i) {
    if (r[i]) w[i] = ld_state(r[i]);
  }
#pragma unroll
  for (int i = 0; i < kReads; ++i) out[i] = r[i] ? Op::from_words(w[i]) : Op::identity();
}

template <class Op>
__device__ __forceinline__ void publish(Rec* r, const typename Op::State& s) {
  const ulonglong2 w = Op::words(s);
  asm volatile("st.global.cg.v2.u64 [%0], {%1, %2};\n" ::"l"(&r->state), "l"(w.x), "l"(w.y)
               : "memory");
  st_release(&r->flag, 1);  // orders the state before the flag
}

// Fold of lanes [0, m) of a warp in index order, a fixed tree of depth 5;
// the result is in lane 0.
template <class Op>
__device__ __forceinline__ typename Op::State tree_fold(typename Op::State v, int m) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const typename Op::State o = shfl_down(v, d);
    if ((lane & (2 * d - 1)) == 0 && lane + d < m) v = Op::combine(v, o);
  }
  return v;
}

// Where a segment starts among one thread's rows: walks rows in scan order.
struct Starts {
  int64_t phase = 0;  // forward: row % width; reverse: (row + 1) % width
  __device__ __forceinline__ void begin(const Args& A, int64_t row) {
    if (A.width > 0) phase = A.reverse ? (row + 1) % A.width : row % A.width;
  }
  __device__ __forceinline__ bool block_start(const Args& A) const {
    return A.width > 0 && phase == 0;
  }
  __device__ __forceinline__ void next(const Args& A) {
    if (A.width > 0) {
      if (A.reverse) phase = phase == 0 ? A.width - 1 : phase - 1;
      else phase = phase + 1 == A.width ? 0 : phase + 1;
    }
  }
};

// ---------------------------------------------------------------- kernel --

// One tile's rows as this thread holds them: kItems consecutive rows in scan
// order from scan position p0 of the tile, their shared slots a step apart.
template <class Op>
struct Rows {
  using S = typename Op::State;
  const uint64_t* x0;  // values (or a) of the first row
  const uint64_t* c0;  // codes (or b) of the first row
  int step, mine;
  int64_t row0;

  __device__ Rows(const Args& A, const uint64_t* stage, const Span& sp, int p0, const int* mis) {
    mine = sp.m - p0 < 0 ? 0 : (sp.m - p0 < kItems ? sp.m - p0 : kItems);
    step = A.reverse ? -1 : 1;
    row0 = A.reverse ? sp.hi - 1 - p0 : sp.lo + p0;
    x0 = stage + (row0 - sp.lo) + mis[0];
    c0 = stage + kSlots + (row0 - sp.lo) + mis[1];
  }

  // The j-th row's state; `st` walks the block starts, `first` marks the
  // column's first row, `prev_code` is the code scanned before row 0.
  __device__ __forceinline__ S item(const Args& A, int j, Starts& st, bool first,
                                    uint64_t prev_code) const {
    bool start = first || st.block_start(A);
    uint64_t w1 = 0;
    if (Op::kArrays > 1) w1 = c0[j * step];
    if (Op::kCodes && !start) start = w1 != (j > 0 ? c0[(j - 1) * step] : prev_code);
    st.next(A);
    return Op::make(x0[j * step], w1, start);
  }
};

template <class Op>
__global__ void __launch_bounds__(kThreads, 1) scan_kernel(const Args A) {
  using S = typename Op::State;
  extern __shared__ __align__(16) uint64_t buf[];  // [kStages][kArrays][kSlots]
  __shared__ __align__(8) uint64_t bars[kStages];
  __shared__ int64_t ticket[kStages];
  __shared__ S warp_tot[kWarps];
  __shared__ S block_carry;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = tid * kItems;
  constexpr int kStageWords = Op::kArrays * kSlots;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    ticket[0] = atomicAdd(A.counter, 1u);
    if (ticket[0] < A.tiles) issue<Op>(A, ticket[0], buf, &bars[0]);
  }
  __syncthreads();

  for (int64_t it = 0;; ++it) {
    const int s = static_cast<int>(it & 1);
    const int64_t k = ticket[s];
    if (k >= A.tiles) break;
    uint64_t* stage = buf + s * kStageWords;
    const Span sp = span_of(A, k);
    const int mis[2] = {misaligned(A.in[0], sp.lo),
                        Op::kArrays > 1 ? misaligned(A.in[1], sp.lo) : 0};
    // the rows at the tile's edges that the bulk copy leaves out
    if (tid < 2 * Op::kArrays) {
      const int a = tid >> 1;
      const int ma = a ? mis[1] : mis[0];
      const int64_t first = sp.lo + ma;
      const int64_t count = sp.hi - first > 0 ? ((sp.hi - first) & ~int64_t{1}) : 0;
      const int64_t row = (tid & 1) ? first + count : sp.lo;
      const bool edge = (tid & 1) ? row < sp.hi : ma == 1;
      if (edge) stage[a * kSlots + (row - sp.lo) + ma] = (a ? A.in[1] : A.in[0])[row];
    }
    uint64_t prev_code = 0;  // code of the row scanned just before the tile
    if (Op::kCodes && tid == 0 && k > 0) prev_code = A.in[1][A.reverse ? sp.hi : sp.lo - 1];
    mbar_wait(&bars[s], static_cast<uint32_t>((it >> 1) & 1));
    __syncthreads();  // 1: the tile is in shared memory

    // first pass: this thread's total, the warp's scan of thread totals
    const Rows<Op> rows(A, stage, sp, p0, mis);
    S excl;
    {
      Starts st;
      st.begin(A, rows.row0);
      S agg = Op::identity();
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (j < rows.mine) {
          const S v = rows.item(A, j, st, j == 0 && k == 0 && p0 == 0,
                                Op::kCodes && p0 > 0 && j == 0 ? rows.c0[-rows.step] : prev_code);
          agg = j == 0 ? v : Op::combine(agg, v);
        }
      }
      S incl = agg;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const S o = shfl_up(incl, d);
        if (lane >= d) incl = Op::combine(o, incl);
      }
      excl = shfl_up(incl, 1);
      if (lane == 31) warp_tot[warp] = incl;
    }
    __syncthreads();  // 2: warp totals
    S wpre = warp_tot[0];
    S total = warp_tot[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const S tw = warp_tot[w];
      if (w < warp) wpre = Op::combine(wpre, tw);
      total = Op::combine(total, tw);
    }

    // the carry.  Tile K = k + 1 publishes its total A_K at once.  With M
    // the multiple of 32 before K (0 if none), its carry is the right fold
    // of the Fenwick partials on M's path (F_p, p = M, M - lowbit(M), ...)
    // over the fold of A_{M+1} .. A_{K-1} (at most 31, a fixed tree).  A K
    // that is a multiple of 32 publishes F_K = F_{K-L/2} (+) ... (+)
    // F_{K-32} (+) (A_{K-31} (+) ... (+) A_K), L = lowbit(K): the fold of
    // (K - L, K]; its children F_{K-32}, F_{K-64}, ... are the first nodes
    // of M = K - 32's path.  Lane j of warp 0 reads A_{M+1+j} and the j-th
    // node of M's path, all lanes at once.  The association depends on K
    // alone.
    const int64_t K = k + 1;
    if (tid == 0) publish<Op>(A.aggs + k, total);
    if (warp == 0) {
      const int64_t M = (K - 1) & ~int64_t{kRadix - 1};
      const int m = static_cast<int>(K - 1 - M);
      const int t = __ffsll(K) - 1;
      const int nc = (K & (kRadix - 1)) == 0 && t > 5 ? t - 5 : 0;
      const int np = __popcll(M);  // at most 31: tiles < 2^31
      int64_t p = M;
      for (int j = 0; j < lane; ++j) p &= p - 1;
      // a K that publishes reads its own states first (the aggregates and
      // its children, the first nc nodes), publishes F_K, then the rest of
      // M's path: the carry's waits never hold up a publication.  Any
      // other K reads all at once.
      const bool radix = (K & (kRadix - 1)) == 0;
      const int first = radix ? nc : np;
      const Rec* const r0[kReads] = {
          lane < m ? A.aggs + (M + lane) : nullptr,
          lane < first ? A.nodes + (p - 1) : nullptr,
      };
      S got[kReads];
      read_recs<Op>(r0, got);
      const S af = shfl_idx(tree_fold<Op>(got[0], m), 0);
      if (radix) {
        S fk = m > 0 ? Op::combine(af, total) : total;
        for (int j = 0; j < nc; ++j) fk = Op::combine(shfl_idx(got[1], j), fk);
        if (tid == 0) publish<Op>(A.nodes + k, fk);
      }
      S node = got[1];
      if (np > first) {
        const Rec* const r1[kReads] = {lane >= first && lane < np ? A.nodes + (p - 1) : nullptr,
                                       nullptr};
        read_recs<Op>(r1, got);
        if (lane >= first) node = got[0];
      }
      bool have = m > 0;
      S carry = af;
      for (int j = 0; j < np; ++j) {
        const S g = shfl_idx(node, j);
        carry = have ? Op::combine(g, carry) : g;
        have = true;
      }
      if (tid == 0) block_carry = carry;
    }
    __syncthreads();  // the carry
    const S carry = block_carry;
    if (tid == 0) {
      // the next ticket and its rows, loading during the second pass (a
      // ticket taken this late keeps the tiles in ticket order: a tile
      // waits only on tiles that are past their first pass or nearly)
      const int ns = s ^ 1;
      ticket[ns] = atomicAdd(A.counter, 1u);
      if (ticket[ns] < A.tiles) issue<Op>(A, ticket[ns], buf + ns * kStageWords, &bars[ns]);
    }

    // second pass: the rows again, seeded with everything before this
    // thread, into shared memory
    if (rows.mine > 0) {
      bool have = k > 0;
      S cur = carry;
      if (warp > 0) {
        cur = have ? Op::combine(cur, wpre) : wpre;
        have = true;
      }
      if (lane > 0) {
        cur = have ? Op::combine(cur, excl) : excl;
        have = true;
      }
      Starts st;
      st.begin(A, rows.row0);
      uint64_t* out = const_cast<uint64_t*>(rows.x0);
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (j < rows.mine) {
          const S v = rows.item(A, j, st, j == 0 && k == 0 && p0 == 0,
                                Op::kCodes && p0 > 0 && j == 0 ? rows.c0[-rows.step] : prev_code);
          cur = have ? Op::combine(cur, v) : v;
          have = true;
          out[j * rows.step] = Op::out(cur);
        }
      }
    }
    __syncthreads();  // 3: the tile's outputs are in shared memory
    // warp 0 stores nothing: its lane 0 publishes, and a release waits for
    // the thread's earlier stores
    if (warp > 0) {
      for (int q = tid - 32; q < sp.m; q += kThreads - 32) {
        const int64_t row = A.reverse ? sp.hi - 1 - q : sp.lo + q;
        A.y[row] = stage[(row - sp.lo) + mis[0]];
      }
    }
  }
}

// Scratch: the ticket counter, then an aggregate and a node record per tile.
int64_t records_bytes(int64_t tiles) { return 128 + tiles * 2 * static_cast<int64_t>(sizeof(Rec)); }

template <class Op>
cudaError_t launch(Args A, void* scratch, cudaStream_t s) {
  A.tiles = (A.n + kTile - 1) / kTile;
  if (A.tiles > 0x7fffffff) return cudaErrorInvalidValue;
  auto* base = static_cast<unsigned char*>(scratch);
  A.counter = reinterpret_cast<unsigned int*>(base);
  A.aggs = reinterpret_cast<Rec*>(base + 128);
  A.nodes = A.aggs + A.tiles;
  cudaError_t err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(records_bytes(A.tiles)), s);
  if (err != cudaSuccess) return err;
  const int smem = kStages * Op::kArrays * kSlots * static_cast<int>(sizeof(uint64_t));
  // blocks that fit on the card, per device, found at the first launch
  static int resident[64] = {0};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(scan_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_kernel<Op>, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  const int64_t grid = A.tiles < resident[dev] ? A.tiles : resident[dev];
  scan_kernel<Op><<<static_cast<unsigned int>(grid), kThreads, smem, s>>>(A);
  return cudaGetLastError();
}

template <typename T, class F>
cudaError_t launch_seg(Args A, bool codes, void* scratch, cudaStream_t s) {
  if (codes) return launch<SegOp<T, F, true>>(A, scratch, s);
  return launch<SegOp<T, F, false>>(A, scratch, s);
}

}  // namespace

extern "C" {

// Rows of one tile.
int64_t scan_tile_rows(void) { return kTile; }

// Bytes of the scratch of a scan of n rows (zeroed by scan_run itself).
int64_t scan_scratch_bytes(int64_t n) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  return records_bytes(tiles);
}

// mode 0: linear, x = a, aux = b (float64), codes unused, width ignored;
// mode 1-4: add, mul, max, min over x (dtype 0 = int64, 1 = float64), codes
// the sorted int64 group codes or NULL, aux unused; a segment also starts
// at every block of `width` rows (0: no blocks).  reverse != 0 scans from
// row n-1 down.  y has n elements of x's type; scratch holds
// scan_scratch_bytes(n) bytes.  Launches on `stream` (a cudaStream_t)
// without synchronising; returns the first failing call's cudaError_t.
int scan_run(int mode, int dtype, const void* x, const void* aux, const void* codes, void* y,
             int64_t n, int64_t width, int reverse, void* scratch, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (width < 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  Args A{};
  A.in[0] = static_cast<const uint64_t*>(x);
  A.in[1] = static_cast<const uint64_t*>(mode == 0 ? aux : codes);
  A.y = static_cast<uint64_t*>(y);
  A.n = n;
  A.width = mode == 0 ? 0 : width;
  A.reverse = reverse != 0;
  if (mode == 0) {
    if (dtype != 1) return cudaErrorInvalidValue;
    return launch<LinearOp>(A, scratch, s);
  }
  const bool has_codes = codes != nullptr;
  if (dtype == 0) {
    switch (mode) {
      case 1: return launch_seg<int64_t, AddI>(A, has_codes, scratch, s);
      case 2: return launch_seg<int64_t, MulI>(A, has_codes, scratch, s);
      case 3: return launch_seg<int64_t, MaxI>(A, has_codes, scratch, s);
      case 4: return launch_seg<int64_t, MinI>(A, has_codes, scratch, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (mode) {
      case 1: return launch_seg<double, AddF>(A, has_codes, scratch, s);
      case 2: return launch_seg<double, MulF>(A, has_codes, scratch, s);
      case 3: return launch_seg<double, MaxF>(A, has_codes, scratch, s);
      case 4: return launch_seg<double, MinF>(A, has_codes, scratch, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

const char* scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
