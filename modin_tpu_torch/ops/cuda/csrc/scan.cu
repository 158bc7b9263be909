// Deterministic prefix scans for Hopper (sm_90a): a first-order linear
// recurrence, and segmented add/mul/max/min over rows sorted by group.
//
// Replaces two XLA programs of the JAX package (neither is a Pallas kernel):
// - modin_tpu/ops/window.py::_linear_scan (:209), the blocked associative
//   scan behind every ewm statistic: y_t = a_t * y_{t-1} + b_t, y_{-1} = 0;
// - modin_tpu/ops/groupby.py::_jit_grouped_cum (:1178), the segmented scan of
//   grouped cumsum/cumprod/cummax/cummin, which resets where the sorted group
//   code changes (a row whose code differs from the one before it starts a
//   segment; without codes the whole column is one segment).
// PyTorch has no operation for either, and torch.cumsum on CUDA need not
// repeat bit for bit; this kernel combines in an order fixed by the shapes
// alone, so every run gives the same bits.
//
// Modes (one template over a combine operator):
// - linear: float64 maps (a, b), (a1,b1) then (a2,b2) = (a1*a2, a2*b1 + b2);
// - add/mul/max/min over int64 or float64 values with (flag, value) states,
//   (f1,v1) then (f2,v2) = (f1|f2, f2 ? v2 : v1 op v2).  int64 add and mul
//   run in uint64 arithmetic: numpy's wraparound, and no signed overflow.
//   max/min take NaN-free values (the callers fill NaN with the neutral).
//
// Bound: linear reads a and b and writes y, 24 B a row; a segmented scan
// with codes reads values and codes and writes y, 24 B a row.  At n = 1e8
// that is 2.4 GB, 0.716 ms at the H100 SXM's 3.35 TB/s.
//
// Design (reduce, then scan; no atomics, no look-back, so the combine order
// depends on n alone and the result repeats bit for bit):
// 1. every block reduces one tile of kTile rows to its aggregate: kRows rows
//    of kThreads elements, each row scanned by warp shuffles and one pass
//    over the warp totals, the rows folded in order;
// 2. one block scans the tile aggregates in order, in place (inclusive);
// 3. every block scans its tile again, seeded with the aggregate of the
//    tiles before it, and writes y.
// Loads are coalesced (neighbouring threads, neighbouring rows) and each
// thread has its kRows loads in flight before it scans.  The tile is read
// twice, so the traffic is 40 B a row against the bound's 24 (a single-pass
// scan with decoupled look-back would reach 24; a later change).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;
constexpr int64_t kTile = static_cast<int64_t>(kThreads) * kRows;

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

template <typename T>
__device__ __forceinline__ Seg<T> shfl_up(const Seg<T>& s, int d) {
  return {__shfl_up_sync(0xffffffffu, s.v, d), __shfl_up_sync(0xffffffffu, s.f, d)};
}

struct LinearOp {
  using State = Lin;
  const double* a;
  const double* b;
  double* y;
  __device__ State identity() const { return {1.0, 0.0}; }
  __device__ static State combine(const State& l, const State& r) {
    return {l.a * r.a, r.a * l.b + r.b};
  }
  __device__ State load(int64_t i) const { return {a[i], b[i]}; }
  __device__ void store(int64_t i, const State& s) const { y[i] = s.b; }
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

template <typename T, class F, bool kCodes>
struct SegOp {
  using State = Seg<T>;
  const T* x;
  const int64_t* codes;
  T* y;
  __device__ State identity() const { return {F::neutral(), 0}; }
  __device__ static State combine(const State& l, const State& r) {
    return {r.f ? r.v : F::apply(l.v, r.v), l.f | r.f};
  }
  __device__ State load(int64_t i) const {
    int f = i == 0;
    if (kCodes && i > 0) f = codes[i] != codes[i - 1];
    return {x[i], f};
  }
  __device__ void store(int64_t i, const State& s) const { y[i] = s.v; }
};

// The tile aggregates of step 2, read and written in place.
template <class Op>
struct AggOp {
  using State = typename Op::State;
  Op op;
  State* agg;
  __device__ State identity() const { return op.identity(); }
  __device__ static State combine(const State& l, const State& r) {
    return Op::combine(l, r);
  }
  __device__ State load(int64_t i) const { return agg[i]; }
  __device__ void store(int64_t i, const State& s) const { agg[i] = s; }
};

// Inclusive scan of one row of kThreads states, seeded with `carry`; the
// row's total (carry folded in) goes to *total.  Every thread of the block
// calls it.
template <class Op>
__device__ __forceinline__ typename Op::State scan_row(
    typename Op::State v, const typename Op::State& carry,
    typename Op::State* warp_tot, const Op& op, typename Op::State* total) {
  using S = typename Op::State;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const S o = shfl_up(v, d);
    if (lane >= d) v = Op::combine(o, v);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    S w = lane < kWarps ? warp_tot[lane] : op.identity();
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const S o = shfl_up(w, d);
      if (lane >= d) w = Op::combine(o, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const S prefix = warp == 0 ? carry : Op::combine(carry, warp_tot[warp - 1]);
  *total = Op::combine(carry, warp_tot[kWarps - 1]);
  __syncthreads();  // the next row rewrites warp_tot
  return Op::combine(prefix, v);
}

// Scan the kTile rows from `base` (rows at or past n are identities),
// seeded with `carry`; writes them when kWrite and returns the tile's
// total.
template <class Op, bool kWrite>
__device__ __forceinline__ typename Op::State scan_tile(
    const Op& op, int64_t base, int64_t n, typename Op::State carry,
    typename Op::State* warp_tot) {
  using S = typename Op::State;
  S vals[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t i = base + static_cast<int64_t>(r) * kThreads + threadIdx.x;
    vals[r] = i < n ? op.load(i) : op.identity();
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    S total;
    const S out = scan_row(vals[r], carry, warp_tot, op, &total);
    if (kWrite) {
      const int64_t i = base + static_cast<int64_t>(r) * kThreads + threadIdx.x;
      if (i < n) op.store(i, out);
    }
    carry = total;
  }
  return carry;
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
scan_reduce_kernel(const Op op, int64_t n, typename Op::State* agg) {
  __shared__ typename Op::State warp_tot[kWarps];
  const auto total = scan_tile<Op, false>(
      op, static_cast<int64_t>(blockIdx.x) * kTile, n, op.identity(), warp_tot);
  if (threadIdx.x == 0) agg[blockIdx.x] = total;
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
scan_carry_kernel(const Op op, int64_t tiles, typename Op::State* agg) {
  __shared__ typename Op::State warp_tot[kWarps];
  const AggOp<Op> aop{op, agg};
  auto carry = op.identity();
  for (int64_t base = 0; base < tiles; base += kTile) {
    carry = scan_tile<AggOp<Op>, true>(aop, base, tiles, carry, warp_tot);
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
scan_apply_kernel(const Op op, int64_t n, const typename Op::State* agg) {
  __shared__ typename Op::State warp_tot[kWarps];
  const auto carry = blockIdx.x == 0 ? op.identity() : agg[blockIdx.x - 1];
  scan_tile<Op, true>(op, static_cast<int64_t>(blockIdx.x) * kTile, n, carry, warp_tot);
}

template <class Op>
cudaError_t launch(const Op& op, int64_t n, void* scratch, cudaStream_t s) {
  using S = typename Op::State;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  auto* agg = static_cast<S*>(scratch);
  const auto grid = static_cast<unsigned int>(tiles);
  scan_reduce_kernel<Op><<<grid, kThreads, 0, s>>>(op, n, agg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_carry_kernel<Op><<<1, kThreads, 0, s>>>(op, tiles, agg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_apply_kernel<Op><<<grid, kThreads, 0, s>>>(op, n, agg);
  return cudaGetLastError();
}

template <typename T, class F>
cudaError_t launch_seg(const void* x, const void* codes, void* y, int64_t n,
                       void* scratch, cudaStream_t s) {
  const auto* xv = static_cast<const T*>(x);
  const auto* cv = static_cast<const int64_t*>(codes);
  auto* yv = static_cast<T*>(y);
  if (codes != nullptr) return launch(SegOp<T, F, true>{xv, cv, yv}, n, scratch, s);
  return launch(SegOp<T, F, false>{xv, cv, yv}, n, scratch, s);
}

}  // namespace

extern "C" {

// Rows of one tile; the scratch of a scan of n rows is
// ceil(n / scan_tile_rows()) * scan_state_bytes() bytes.
int64_t scan_tile_rows(void) { return kTile; }

int64_t scan_state_bytes(void) {
  static_assert(sizeof(Lin) == 16 && sizeof(Seg<double>) == 16 &&
                    sizeof(Seg<int64_t>) == 16,
                "scan states are 16 bytes");
  return 16;
}

// mode 0: linear, x = a, aux = b (float64), codes unused;
// mode 1-4: add, mul, max, min over x (dtype 0 = int64, 1 = float64), codes
// the sorted int64 group codes or NULL for one segment, aux unused.
// y has n elements of x's type; scratch holds the tile states.  Launches on
// `stream` (a cudaStream_t) without synchronising; returns the launches'
// cudaError_t.
int scan_run(int mode, int dtype, const void* x, const void* aux,
             const void* codes, void* y, int64_t n, void* scratch,
             void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    if (dtype != 1) return cudaErrorInvalidValue;
    return launch(LinearOp{static_cast<const double*>(x),
                           static_cast<const double*>(aux),
                           static_cast<double*>(y)},
                  n, scratch, s);
  }
  if (dtype == 0) {
    switch (mode) {
      case 1: return launch_seg<int64_t, AddI>(x, codes, y, n, scratch, s);
      case 2: return launch_seg<int64_t, MulI>(x, codes, y, n, scratch, s);
      case 3: return launch_seg<int64_t, MaxI>(x, codes, y, n, scratch, s);
      case 4: return launch_seg<int64_t, MinI>(x, codes, y, n, scratch, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (mode) {
      case 1: return launch_seg<double, AddF>(x, codes, y, n, scratch, s);
      case 2: return launch_seg<double, MulF>(x, codes, y, n, scratch, s);
      case 3: return launch_seg<double, MaxF>(x, codes, y, n, scratch, s);
      case 4: return launch_seg<double, MinF>(x, codes, y, n, scratch, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

const char* scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
