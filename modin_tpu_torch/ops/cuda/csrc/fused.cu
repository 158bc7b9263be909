// Fused elementwise programs with optional reduction tails, for Hopper (sm_90a).
//
// Replaces the XLA programs that modin_tpu/ops/lazy.py::run_fused (:288)
// compiles per expression fingerprint over modin_tpu/ops/elementwise.py::
// _build_ops (:63): a deferred DAG of elementwise ops, plus an optional
// reduction "tail", run as one program.  Here one kernel, built once,
// interprets a small register program (ops/cuda/fused_program.py compiles
// it on the host): no compile per expression.
//
// Shape: a grid-stride loop over rows; each thread runs the whole program
// for its row, its registers in a per-thread array (local memory), and
// stores every output, so neighbouring threads touch neighbouring
// addresses of each column.  The kernel is bound by interpreting, not by
// the latency of its loads: a trial with four rows a thread (four loads in
// flight per fetch) ran slower on the H100.  Every thread runs the same instruction stream
// (the opcode switch does not diverge within a warp), read from the
// kernel's parameters (__grid_constant__: one constant-bank read broadcast
// to the warp).  The program, the leaf and output pointers and the scalars
// are one struct passed by value (< 4 KB): nothing is uploaded per call.
//
// Numerics follow the eager torch ops, so a fused result equals the eager
// one bit for bit: adds, multiplies and divisions are __*_rn intrinsics
// (never contracted into an fma, as nvcc would contract a * b + c); ints
// add, subtract and multiply in uint64_t and wrap to their width as numpy
// does; float floor division and modulo are ATen's div_floor_floating and
// remainder (fmod-based, sign-fixed); int floor division and modulo floor
// toward -inf and give 0 for a zero divisor (INT64_MIN // -1 wraps);
// round is ATen's round_decimals (scale, nearbyint, unscale); pow by a
// scalar takes torch's special cases (0, 1, 2, 3, 0.5, -0.5, -1, -2).
//
// Tails: column reductions fold each root into per-thread accumulators
// (sum, product, min, max, nonzero count, or the three power sums about a
// mean given by a first pass) with counts of valid and NaN rows; each block
// reduces them in shared memory in a fixed tree order into partials, and a
// merge kernel reduces the partials in block order.  The grid depends on
// n alone, so a float result repeats bit for bit; there are no atomics.
//
// Bound: bytes.  The inputs are read once and the outputs written once
// (a * b + c over float64: 32 B a row, 0.955 ms at 1e8 rows at 3.35 TB/s;
// with a sum tail, 24 B a row).

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kMaxInstr = 160;
constexpr int kMaxRegs = 32;
constexpr int kMaxLeaves = 64;
constexpr int kMaxOut = 32;
constexpr int kMaxScalars = 32;
constexpr int kScalarBase = 64;
constexpr int kLeafBase = 128;

enum Dt : uint8_t { DT_BOOL, DT_I8, DT_I16, DT_I32, DT_I64, DT_U8, DT_F32, DT_F64 };

enum Op : uint8_t {
  OP_CAST = 1, OP_ADD, OP_SUB, OP_MUL, OP_TDIV, OP_FDIV, OP_MOD, OP_POW,
  OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE, OP_AND, OP_OR, OP_XOR,
  OP_NEG, OP_ABS, OP_INV, OP_ISNAN, OP_NOTNAN, OP_EQI, OP_NEI,
  OP_SQRT, OP_EXP, OP_LOG, OP_LOG2, OP_LOG10, OP_SIN, OP_COS, OP_TAN, OP_TANH,
  OP_FLOOR, OP_CEIL, OP_SIGN, OP_ROUND, OP_ROUNDI, OP_FILLNA, OP_CLIPLO,
  OP_CLIPHI, OP_SEL, OP_NANTO, OP_MIN, OP_MAX, OP_STORE, OP_ACC
};

enum Tail { TAIL_NONE, TAIL_SUM, TAIL_PROD, TAIL_MIN, TAIL_MAX, TAIL_NZ, TAIL_M1, TAIL_M2 };

struct Instr {
  uint8_t op, dt, dst, a, b, c;
  uint16_t aux;
  int64_t imm;
};
static_assert(sizeof(Instr) == 16, "Instr is 16 bytes");

struct FusedParams {
  int64_t n;
  int32_t n_instr;
  int32_t n_out;
  int32_t tail;
  int32_t pad0;
  const void* mean_src;  // TAIL_M2: the first pass's merged accumulators
  void* partial;         // block partials: [blocks][n_out][3] of 8 bytes
  const void* leaf[kMaxLeaves];
  void* out[kMaxOut];
  int64_t scalar[kMaxScalars];
  Instr code[kMaxInstr];
  uint8_t leaf_dt[kMaxLeaves];
  uint8_t out_dt[kMaxOut];
};
static_assert(sizeof(FusedParams) <= 4096, "the program fits the classic 4 KB of kernel parameters");

union Val {
  long long i;
  double d;
  float f;
};

__device__ __forceinline__ bool is_f(uint8_t dt) { return dt >= DT_F32; }

__device__ __forceinline__ long long wrap(long long v, uint8_t dt) {
  switch (dt) {
    case DT_BOOL: return v != 0;
    case DT_I8: return (long long)(signed char)v;
    case DT_I16: return (long long)(short)v;
    case DT_I32: return (long long)(int)v;
    case DT_U8: return (long long)(unsigned char)v;
    default: return v;
  }
}

__device__ __forceinline__ long long uadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ long long usub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}
__device__ __forceinline__ long long umul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}

// correctly rounded float arithmetic that nvcc never contracts
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rdiv(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ float mfmod(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double mfmod(double a, double b) { return fmod(a, b); }
__device__ __forceinline__ float mfloor(float a) { return floorf(a); }
__device__ __forceinline__ double mfloor(double a) { return floor(a); }
__device__ __forceinline__ float mcopysign(float a, float b) { return copysignf(a, b); }
__device__ __forceinline__ double mcopysign(double a, double b) { return copysign(a, b); }
__device__ __forceinline__ float msqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double msqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float mrsqrt(float a) { return rsqrtf(a); }
__device__ __forceinline__ double mrsqrt(double a) { return rsqrt(a); }
__device__ __forceinline__ float mpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double mpow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float mnearbyint(float a) { return nearbyintf(a); }
__device__ __forceinline__ double mnearbyint(double a) { return nearbyint(a); }

// ATen's div_floor_floating (c10/util/generic_math.h)
template <typename T>
__device__ __forceinline__ T div_floor_f(T a, T b) {
  if (b == T(0)) return rdiv(a, b);
  T mod = mfmod(a, b);
  T div = rdiv(rsub(a, mod), b);
  if ((mod != T(0)) && ((b < T(0)) != (mod < T(0)))) div = rsub(div, T(1));
  T fl;
  if (div != T(0)) {
    fl = mfloor(div);
    if (rsub(div, fl) > T(0.5)) fl = radd(fl, T(1));
  } else {
    fl = mcopysign(T(0), rdiv(a, b));
  }
  return fl;
}

// ATen's remainder of floats
template <typename T>
__device__ __forceinline__ T mod_f(T a, T b) {
  T m = mfmod(a, b);
  if ((m != T(0)) && ((b < T(0)) != (m < T(0)))) m = radd(m, b);
  return m;
}

__device__ __forceinline__ long long div_floor_i(long long a, long long b) {
  if (b == 0) return 0;
  if (b == -1) return usub(0, a);  // INT64_MIN // -1 wraps, as numpy gives
  long long q = a / b;
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) q -= 1;
  return q;
}

__device__ __forceinline__ long long mod_i(long long a, long long b) {
  if (b == 0 || b == -1) return 0;
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// torch.pow of a tensor by a scalar exponent (its special cases), or by a column
template <typename T>
__device__ __forceinline__ T pow_f(T base, T e, bool scalar_exp) {
  if (scalar_exp) {
    if (e == T(0)) return T(1);
    if (e == T(1)) return base;
    if (e == T(0.5)) return msqrt(base);
    if (e == T(-0.5)) return mrsqrt(base);
    if (e == T(-1)) return rdiv(T(1), base);
    if (e == T(2)) return rmul(base, base);
    if (e == T(3)) return rmul(rmul(base, base), base);
    if (e == T(-2)) return (T)__ddiv_rn(1.0, (double)rmul(base, base));
  }
  return mpow(base, e);
}

template <typename T>
__device__ __forceinline__ T sign_f(T a) {
  if (isnan(a)) return a;
  return (T)((T(0) < a) - (a < T(0)));
}

// ATen's round_decimals: scale, nearbyint, unscale
template <typename T>
__device__ __forceinline__ T round_f(T a, int decimals, double scale) {
  T s = (T)scale;
  if (decimals > 0) return rdiv(mnearbyint(rmul(a, s)), s);
  if (decimals < 0) return rmul(mnearbyint(rdiv(a, s)), s);
  return mnearbyint(a);
}

// elementwise.py::_round_int: to the nearest multiple of unit, half to even
__device__ __forceinline__ long long round_i(long long v, long long unit) {
  long long q = v / unit;
  if ((v % unit) != 0 && v < 0) q -= 1;
  long long twice_r = 2 * (v - q * unit);
  bool up = twice_r > unit || (twice_r == unit && (q & 1));
  return umul(q + (up ? 1 : 0), unit);
}

template <typename T>
__device__ __forceinline__ T fmin_nan(T a, T b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return (b < a) ? b : a;
}
template <typename T>
__device__ __forceinline__ T fmax_nan(T a, T b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return (a < b) ? b : a;
}

__device__ __forceinline__ Val load_leaf(const void* ptr, uint8_t dt, long long row) {
  Val v;
  v.i = 0;
  switch (dt) {
    case DT_BOOL:
    case DT_U8: v.i = ((const unsigned char*)ptr)[row]; break;
    case DT_I8: v.i = ((const signed char*)ptr)[row]; break;
    case DT_I16: v.i = ((const short*)ptr)[row]; break;
    case DT_I32: v.i = ((const int*)ptr)[row]; break;
    case DT_I64: v.i = ((const long long*)ptr)[row]; break;
    case DT_F32: v.f = ((const float*)ptr)[row]; break;
    default: v.d = ((const double*)ptr)[row]; break;
  }
  return v;
}

__device__ __forceinline__ void store_out(void* ptr, uint8_t dt, long long row, Val v) {
  switch (dt) {
    case DT_BOOL: ((unsigned char*)ptr)[row] = (unsigned char)(v.i != 0); break;
    case DT_U8: ((unsigned char*)ptr)[row] = (unsigned char)v.i; break;
    case DT_I8: ((signed char*)ptr)[row] = (signed char)v.i; break;
    case DT_I16: ((short*)ptr)[row] = (short)v.i; break;
    case DT_I32: ((int*)ptr)[row] = (int)v.i; break;
    case DT_I64: ((long long*)ptr)[row] = v.i; break;
    case DT_F32: ((float*)ptr)[row] = v.f; break;
    default: ((double*)ptr)[row] = v.d; break;
  }
}

// a float cast to an int width as torch's CUDA cast does: straight from
// the source type (c10's static_cast_with_inter_type), uint8 through int64;
// out of range and NaN, which C++ leaves undefined, as the card converts
template <typename T>
__device__ __forceinline__ long long float_to_int(T x, uint8_t to) {
  switch (to) {
    case DT_I8: return (long long)(signed char)x;
    case DT_I16: return (long long)(short)x;
    case DT_I32: return (long long)(int)x;
    case DT_U8: return (long long)(unsigned char)(long long)x;
    default: return (long long)x;
  }
}

__device__ __forceinline__ Val cast_val(Val a, uint8_t from, uint8_t to) {
  Val r;
  r.i = 0;
  if (is_f(from)) {
    double x = from == DT_F32 ? (double)a.f : a.d;  // float32 to float64 is exact
    if (to == DT_F64) r.d = x;
    else if (to == DT_F32) r.f = from == DT_F32 ? a.f : __double2float_rn(a.d);
    else if (to == DT_BOOL) r.i = x != 0.0;  // NaN is truthy
    else r.i = from == DT_F32 ? float_to_int(a.f, to) : float_to_int(a.d, to);
  } else {
    if (to == DT_F64) r.d = __ll2double_rn(a.i);
    else if (to == DT_F32) r.f = __ll2float_rn(a.i);
    else r.i = wrap(a.i, to);
  }
  return r;
}

__device__ __forceinline__ Val fetch(const FusedParams& p, const Val* regs, uint8_t o, long long row) {
  if (o < kScalarBase) return regs[o];
  if (o < kLeafBase) {
    Val v;
    v.i = p.scalar[o - kScalarBase];
    return v;
  }
  return load_leaf(p.leaf[o - kLeafBase], p.leaf_dt[o - kLeafBase], row);
}

// one instruction over operands of dtype dt (the result's dtype for the
// arithmetic ops, bool for the comparisons and predicates)
__device__ __forceinline__ Val exec(const Instr& in, Val a, Val b, Val c) {
  Val r;
  r.i = 0;
  const uint8_t dt = in.dt;
  const bool f32 = dt == DT_F32, f64 = dt == DT_F64;
#define FBIN(EXPR32, EXPR64) \
  if (f32) { float x = a.f, y = b.f; r.f = (EXPR32); } else { double x = a.d, y = b.d; r.d = (EXPR64); }
#define FUN(EXPR32, EXPR64) \
  if (f32) { float x = a.f; r.f = (EXPR32); } else { double x = a.d; r.d = (EXPR64); }
#define CMP(OPER) \
  if (f32) r.i = a.f OPER b.f; else if (f64) r.i = a.d OPER b.d; else r.i = a.i OPER b.i;
  switch (in.op) {
    case OP_CAST: return cast_val(a, dt, (uint8_t)in.aux);
    case OP_ADD:
      if (is_f(dt)) { FBIN(radd(x, y), radd(x, y)) } else r.i = wrap(uadd(a.i, b.i), dt);
      break;
    case OP_SUB:
      if (is_f(dt)) { FBIN(rsub(x, y), rsub(x, y)) } else r.i = wrap(usub(a.i, b.i), dt);
      break;
    case OP_MUL:
      if (is_f(dt)) { FBIN(rmul(x, y), rmul(x, y)) } else r.i = wrap(umul(a.i, b.i), dt);
      break;
    case OP_TDIV: FBIN(rdiv(x, y), rdiv(x, y)) break;
    case OP_FDIV:
      if (is_f(dt)) { FBIN(div_floor_f(x, y), div_floor_f(x, y)) } else r.i = wrap(div_floor_i(a.i, b.i), dt);
      break;
    case OP_MOD:
      if (is_f(dt)) { FBIN(mod_f(x, y), mod_f(x, y)) } else r.i = wrap(mod_i(a.i, b.i), dt);
      break;
    case OP_POW: {
      const bool scalar_exp = in.b >= kScalarBase && in.b < kLeafBase;
      FBIN(pow_f(x, y, scalar_exp), pow_f(x, y, scalar_exp))
      break;
    }
    case OP_EQ: CMP(==) break;
    case OP_NE: CMP(!=) break;
    case OP_LT: CMP(<) break;
    case OP_LE: CMP(<=) break;
    case OP_GT: CMP(>) break;
    case OP_GE: CMP(>=) break;
    case OP_AND: r.i = a.i & b.i; break;
    case OP_OR: r.i = a.i | b.i; break;
    case OP_XOR: r.i = a.i ^ b.i; break;
    case OP_NEG:
      if (is_f(dt)) { FUN(-x, -x) } else r.i = wrap(usub(0, a.i), dt);
      break;
    case OP_ABS:
      if (is_f(dt)) { FUN(fabsf(x), fabs(x)) } else r.i = wrap(a.i < 0 ? usub(0, a.i) : a.i, dt);
      break;
    case OP_INV: r.i = dt == DT_BOOL ? !a.i : wrap(~a.i, dt); break;
    case OP_ISNAN: r.i = f32 ? isnan(a.f) : (f64 ? isnan(a.d) : 0); break;
    case OP_NOTNAN: r.i = f32 ? !isnan(a.f) : (f64 ? !isnan(a.d) : 1); break;
    case OP_EQI: r.i = a.i == in.imm; break;
    case OP_NEI: r.i = a.i != in.imm; break;
    case OP_SQRT: FUN(sqrtf(x), sqrt(x)) break;
    case OP_EXP: FUN(expf(x), exp(x)) break;
    case OP_LOG: FUN(logf(x), log(x)) break;
    case OP_LOG2: FUN(log2f(x), log2(x)) break;
    case OP_LOG10: FUN(log10f(x), log10(x)) break;
    case OP_SIN: FUN(sinf(x), sin(x)) break;
    case OP_COS: FUN(cosf(x), cos(x)) break;
    case OP_TAN: FUN(tanf(x), tan(x)) break;
    case OP_TANH: FUN(tanhf(x), tanh(x)) break;
    case OP_FLOOR: FUN(floorf(x), floor(x)) break;
    case OP_CEIL: FUN(ceilf(x), ceil(x)) break;
    case OP_SIGN:
      if (is_f(dt)) { FUN(sign_f(x), sign_f(x)) } else r.i = (0 < a.i) - (a.i < 0);
      break;
    case OP_ROUND: {
      const int decimals = (int)(int16_t)in.aux;
      Val s;
      s.i = in.imm;
      FUN(round_f(x, decimals, s.d), round_f(x, decimals, s.d))
      break;
    }
    case OP_ROUNDI: r.i = wrap(round_i(a.i, in.imm), dt); break;
    case OP_FILLNA: FBIN(isnan(x) ? y : x, isnan(x) ? y : x) break;
    case OP_CLIPLO:
      if (is_f(dt)) { FBIN(x < y ? y : x, x < y ? y : x) } else r.i = a.i < b.i ? b.i : a.i;
      break;
    case OP_CLIPHI:
      if (is_f(dt)) { FBIN(x > y ? y : x, x > y ? y : x) } else r.i = a.i > b.i ? b.i : a.i;
      break;
    case OP_SEL: return a.i ? b : c;
    case OP_NANTO: {
      Val fill;
      fill.i = in.imm;
      FUN(isnan(x) ? (float)fill.d : x, isnan(x) ? fill.d : x)
      break;
    }
    case OP_MIN:
      if (is_f(dt)) { FBIN(fmin_nan(x, y), fmin_nan(x, y)) } else r.i = b.i < a.i ? b.i : a.i;
      break;
    case OP_MAX:
      if (is_f(dt)) { FBIN(fmax_nan(x, y), fmax_nan(x, y)) } else r.i = a.i < b.i ? b.i : a.i;
      break;
    default: break;
  }
#undef FBIN
#undef FUN
#undef CMP
  return r;
}

// the accumulator slots of one output: (value, valid count, NaN count), or
// for TAIL_M2 the sums of d^2, d^3 and d^4
__device__ __forceinline__ Val acc_init(int tail, bool fl, int slot) {
  Val v;
  v.i = 0;
  if (tail == TAIL_M2 || (slot == 0 && (tail == TAIL_SUM || tail == TAIL_M1) && fl)) {
    v.d = 0.0;
  } else if (slot == 0 && tail == TAIL_PROD) {
    if (fl) v.d = 1.0; else v.i = 1;
  } else if (slot == 0 && tail == TAIL_MIN) {
    if (fl) v.d = INFINITY; else v.i = INT64_MAX;
  } else if (slot == 0 && tail == TAIL_MAX) {
    if (fl) v.d = -INFINITY; else v.i = INT64_MIN;
  }
  return v;
}

__device__ __forceinline__ Val acc_combine(int tail, bool fl, int slot, Val x, Val y) {
  Val r;
  if (tail == TAIL_M2) { r.d = __dadd_rn(x.d, y.d); return r; }
  if (slot != 0 || tail == TAIL_NZ) { r.i = x.i + y.i; return r; }
  switch (tail) {
    case TAIL_PROD:
      if (fl) r.d = __dmul_rn(x.d, y.d); else r.i = umul(x.i, y.i);
      break;
    case TAIL_MIN:
      if (fl) r.d = (y.d < x.d) ? y.d : x.d; else r.i = (y.i < x.i) ? y.i : x.i;
      break;
    case TAIL_MAX:
      if (fl) r.d = (x.d < y.d) ? y.d : x.d; else r.i = (x.i < y.i) ? y.i : x.i;
      break;
    default:  // TAIL_SUM, TAIL_M1
      if (fl) r.d = __dadd_rn(x.d, y.d); else r.i = uadd(x.i, y.i);
      break;
  }
  return r;
}

// one row's value folded into output j's accumulators
__device__ __forceinline__ void acc_row(int tail, uint8_t dt, Val x, Val* acc, double mean) {
  const bool fl = is_f(dt);
  if (tail == TAIL_M2) {
    if (isnan(x.d)) return;
    const double d = __dsub_rn(x.d, mean);
    const double d2 = __dmul_rn(d, d);
    const double d3 = __dmul_rn(d2, d);
    const double d4 = __dmul_rn(d3, d);
    acc[0].d = __dadd_rn(acc[0].d, d2);
    acc[1].d = __dadd_rn(acc[1].d, d3);
    acc[2].d = __dadd_rn(acc[2].d, d4);
    return;
  }
  Val v;
  if (fl) {
    v.d = dt == DT_F32 ? (double)x.f : x.d;
    if (isnan(v.d)) {
      acc[2].i += 1;
      return;
    }
  } else {
    v.i = x.i;
  }
  acc[1].i += 1;
  if (tail == TAIL_NZ) {
    acc[0].i += fl ? (v.d != 0.0) : (v.i != 0);
    return;
  }
  acc[0] = acc_combine(tail, fl, 0, acc[0], v);
}

__global__ void __launch_bounds__(kThreads) fused_kernel(const __grid_constant__ FusedParams p) {
  Val regs[kMaxRegs];
  Val acc[kMaxOut][3];
  double mean[kMaxOut] = {};
  const int tail = p.tail;
  if (tail != TAIL_NONE) {
    for (int j = 0; j < p.n_out; ++j) {
      const bool fl = is_f(p.out_dt[j]);
      for (int s = 0; s < 3; ++s) acc[j][s] = acc_init(tail, fl, s);
      if (tail == TAIL_M2) {
        const Val* src = (const Val*)p.mean_src + 3 * j;
        mean[j] = __ddiv_rn(src[0].d, __ll2double_rn(src[1].i));
      }
    }
  }
  const long long n = p.n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    for (int pc = 0; pc < p.n_instr; ++pc) {
      const Instr& in = p.code[pc];
      if (in.op == OP_STORE) {
        store_out(p.out[in.aux], in.dt, row, fetch(p, regs, in.a, row));
      } else if (in.op == OP_ACC) {
        acc_row(tail, in.dt, fetch(p, regs, in.a, row), acc[in.aux], mean[in.aux]);
      } else {
        const Val a = fetch(p, regs, in.a, row);
        const Val b = in.b == 255 ? a : fetch(p, regs, in.b, row);
        const Val c = in.c == 255 ? a : fetch(p, regs, in.c, row);
        regs[in.dst] = exec(in, a, b, c);
      }
    }
  }
  if (tail == TAIL_NONE) return;
  __shared__ Val sh[kThreads];
  Val* partial = (Val*)p.partial;
  for (int j = 0; j < p.n_out; ++j) {
    const bool fl = is_f(p.out_dt[j]);
    for (int s = 0; s < 3; ++s) {
      sh[threadIdx.x] = acc[j][s];
      __syncthreads();
      for (int w = kThreads / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) sh[threadIdx.x] = acc_combine(tail, fl, s, sh[threadIdx.x], sh[threadIdx.x + w]);
        __syncthreads();
      }
      if (threadIdx.x == 0) partial[((long long)blockIdx.x * p.n_out + j) * 3 + s] = sh[0];
      __syncthreads();
    }
  }
}

// one block per output: the block partials in block order, then a tree
__global__ void __launch_bounds__(kThreads)
fused_merge(const __grid_constant__ FusedParams p, int blocks, Val* acc_out) {
  __shared__ Val sh[kThreads];
  const int j = blockIdx.x;
  const bool fl = is_f(p.out_dt[j]);
  const Val* partial = (const Val*)p.partial;
  for (int s = 0; s < 3; ++s) {
    Val m = acc_init(p.tail, fl, s);
    for (int b = threadIdx.x; b < blocks; b += kThreads) {
      m = acc_combine(p.tail, fl, s, m, partial[((long long)b * p.n_out + j) * 3 + s]);
    }
    sh[threadIdx.x] = m;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) sh[threadIdx.x] = acc_combine(p.tail, fl, s, sh[threadIdx.x], sh[threadIdx.x + w]);
      __syncthreads();
    }
    if (threadIdx.x == 0) acc_out[3 * j + s] = sh[0];
    __syncthreads();
  }
}

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (int)b;
}

}  // namespace

extern "C" {

int fused_params_bytes() { return (int)sizeof(FusedParams); }

long long fused_scratch_bytes(long long n, int n_out) {
  return (long long)blocks_for(n) * n_out * 3 * 8;
}

// Runs one program over p->n rows on ``stream``; with a tail, also merges
// the block partials into ``acc_out`` ([n_out][3] of 8 bytes).  Returns 0
// or the CUDA error of a launch.
int fused_run(const void* params, void* acc_out, void* stream) {
  const FusedParams* p = (const FusedParams*)params;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = blocks_for(p->n);
  fused_kernel<<<blocks, kThreads, 0, s>>>(*p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (p->tail != TAIL_NONE && p->n_out > 0) {
    fused_merge<<<p->n_out, kThreads, 0, s>>>(*p, blocks, (Val*)acc_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* fused_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
