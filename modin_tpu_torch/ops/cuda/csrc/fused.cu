// Fused elementwise programs with optional reduction tails, for Hopper (sm_90a).
//
// Replaces the XLA programs that modin_tpu/ops/lazy.py::run_fused (:288)
// compiles per expression fingerprint over modin_tpu/ops/elementwise.py::
// _build_ops (:63): a deferred DAG of elementwise ops, plus an optional
// reduction "tail", run as one program.  Here one kernel, built once,
// interprets a small register program (ops/cuda/fused_program.py compiles
// it on the host and lowers it to this kernel's encoding): no compile per
// expression.
//
// Bound: bytes.  The inputs are read once and the outputs written once
// (a * b + c over float64: 32 B a row, 0.955 ms at 1e8 rows at 3.35 TB/s;
// with a sum tail, 24 B a row).  An interpreter pays for decoding, so the
// design keeps decoding cheap, the operands on chip and the loads in flight:
//
// - typed opcodes: the host specialises every op by its operand class
//   (float64, float32, or an int in an int64 wrapped to its width after the
//   op), a cast by its classes, a load by the leaf's dtype, a store by the
//   output's and an accumulation by the tail mode and class, so no case
//   branches on a dtype; an instruction is one 8-byte word, and the opcodes
//   dispatch in groups of at most ~40 (nvcc builds a compare tree for a
//   switch, not a jump table, so smaller switches mean fewer levels);
// - every operand is a slot of the register file, a constant or the
//   previous result, fetched before the case (a case is its arithmetic
//   alone); the runtime scalars and the static arguments sit in a constant
//   area (shared memory, read once for all rows); the previous
//   instruction's result stays in hardware registers, and a result that
//   only the next instructions read never goes to shared memory, so a chain
//   e = e <op> x moves one operand through it, not three;
// - the register file lives in dynamic shared memory, [slot][rows in
//   flight] of 8 bytes, so a warp's access to one slot is 256 contiguous
//   bytes (no bank conflict); the host sizes it from the program's slot
//   count and picks the rows each thread runs per decoded instruction (K =
//   1, 2 or 4; rows tile + tid + k * 256, so every load and store stays
//   coalesced) against the shared memory it needs;
// - each leaf is loaded once a row, by the load instructions at the head of
//   the code (one per run of leaves of one dtype); the float64, int64 and
//   float32 leaves of the next tile arrive by asynchronous copies
//   (cp.async) into a second copy of the leaf slots while this tile runs,
//   so a short program does not wait on device memory once a tile;
// - the long math routines (floor division, modulo, pow, the
//   transcendentals) run out of line, one row a call, so their registers do
//   not cut the whole interpreter's occupancy;
// - the instruction stream is in the kernel's parameters (__grid_constant__:
//   one constant-bank read, broadcast to the warp; every thread runs the same
//   stream, so the dispatch never diverges within a warp).  The parameters
//   are one struct passed by value (< 4 KB): nothing is uploaded per call.
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
// Tails: column reductions fold each root into per-thread accumulators in
// shared memory (sum, product, min, max, nonzero count, or the three power
// sums about a mean given by a first pass) with counts of valid and NaN
// rows, each thread its rows in order (a masked tail, the counterpart of
// modin_tpu/ops/reductions.py::reduce_columns_masked (:546) and of
// modin_tpu/ops/groupby.py::fused_group_probe (:1248), names a bool mask
// as each accumulation's second operand: a row folds only where it is
// true, so a filter and its reduction are one launch with no compaction); each block reduces all of them in one
// fixed tree (log2(blockDim) barriers for every output together) into
// partials, and a merge kernel reduces the partials in block order.  The grid
// depends on n and the program alone, so a float result repeats bit for bit
// on any card; there are no atomics.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMergeThreads = 256;
constexpr int kMaxCode = 224;  // 160 instructions and 64 leaf loads
constexpr int kMaxLeaves = 64;
constexpr int kMaxOut = 32;
constexpr int kMaxConsts = 96;
constexpr uint8_t kConst = 0x80;  // an operand >= 0x80 is constant (o & 0x7f)
constexpr uint8_t kAcc = 0xfe;    // the previous result: an operand, or a dst kept there alone
constexpr uint8_t kNone = 0xff;   // no operand, no result

enum Dt : uint8_t { DT_BOOL, DT_I8, DT_I16, DT_I32, DT_I64, DT_U8, DT_F32, DT_F64 };

enum Tail { TAIL_NONE, TAIL_SUM, TAIL_PROD, TAIL_MIN, TAIL_MAX, TAIL_NZ, TAIL_M1, TAIL_M2 };

// the kernel's opcodes, in the order of fused_program.KOPS (from 1)
#define FUSED_KOPS(X)                                                                       \
  X(LD_U8) X(LD_I8) X(LD_I16) X(LD_I32) X(LD_I64) X(LD_F32) X(LD_F64)                         \
  X(ST_B) X(ST_I8) X(ST_I16) X(ST_I32) X(ST_I64) X(ST_U8) X(ST_F32) X(ST_F64)                 \
  X(MOV) X(CVT_D_F) X(CVT_F_D) X(CVT_I_D) X(CVT_I_F) X(CVT_D_B) X(CVT_F_B) X(CVT_I_B) X(WRAP) \
  X(CVT_D_I8) X(CVT_D_I16) X(CVT_D_I32) X(CVT_D_I64) X(CVT_D_U8)                              \
  X(CVT_F_I8) X(CVT_F_I16) X(CVT_F_I32) X(CVT_F_I64) X(CVT_F_U8)                              \
  X(ADD_D) X(ADD_F) X(ADD_I) X(SUB_D) X(SUB_F) X(SUB_I) X(MUL_D) X(MUL_F) X(MUL_I)            \
  X(DIV_D) X(DIV_F) X(FDIV_D) X(FDIV_F) X(FDIV_I) X(MOD_D) X(MOD_F) X(MOD_I)                  \
  X(POW_D) X(POW_F) X(POWS_D) X(POWS_F)                                                       \
  X(EQ_D) X(EQ_F) X(EQ_I) X(NE_D) X(NE_F) X(NE_I) X(LT_D) X(LT_F) X(LT_I)                     \
  X(LE_D) X(LE_F) X(LE_I) X(GT_D) X(GT_F) X(GT_I) X(GE_D) X(GE_F) X(GE_I)                     \
  X(AND) X(OR) X(XOR)                                                                         \
  X(NEG_D) X(NEG_F) X(NEG_I) X(ABS_D) X(ABS_F) X(ABS_I) X(NOT_B) X(INV_I)                     \
  X(ISNAN_D) X(ISNAN_F) X(ISNAN_I) X(NOTNAN_D) X(NOTNAN_F) X(NOTNAN_I)                        \
  X(SQRT_D) X(SQRT_F) X(EXP_D) X(EXP_F) X(LOG_D) X(LOG_F) X(LOG2_D) X(LOG2_F)                 \
  X(LOG10_D) X(LOG10_F) X(SIN_D) X(SIN_F) X(COS_D) X(COS_F) X(TAN_D) X(TAN_F)                 \
  X(TANH_D) X(TANH_F) X(FLOOR_D) X(FLOOR_F) X(CEIL_D) X(CEIL_F)                               \
  X(SIGN_D) X(SIGN_F) X(SIGN_I)                                                               \
  X(RUP_D) X(RUP_F) X(RDN_D) X(RDN_F) X(RINT_D) X(RINT_F) X(ROUNDI)                           \
  X(FILLNA_D) X(FILLNA_F)                                                                     \
  X(CLIPLO_D) X(CLIPLO_F) X(CLIPLO_I) X(CLIPHI_D) X(CLIPHI_F) X(CLIPHI_I)                     \
  X(SEL) X(MIN_D) X(MIN_F) X(MIN_I) X(MAX_D) X(MAX_F) X(MAX_I)                                \
  X(ACC_SUM_D) X(ACC_SUM_F) X(ACC_SUM_I) X(ACC_PROD_D) X(ACC_PROD_F) X(ACC_PROD_I)            \
  X(ACC_MIN_D) X(ACC_MIN_F) X(ACC_MIN_I) X(ACC_MAX_D) X(ACC_MAX_F) X(ACC_MAX_I)               \
  X(ACC_NZ_D) X(ACC_NZ_F) X(ACC_NZ_I) X(ACC_M2_D)

enum KOp : uint8_t {
  K_NONE = 0,
#define FUSED_ENUM(name) K_##name,
  FUSED_KOPS(FUSED_ENUM)
#undef FUSED_ENUM
};

// dst, a, b, c: register-file slots (< 0x80), constants (0x80 | k), the
// previous result (kAcc) or none (kNone); dt: the semantic dtype code (the
// width an int result wraps to); aux: a leaf or output index, a cast's
// target, a round's decimals
struct KInstr {
  uint8_t op, dt, dst, a, b, c;
  uint16_t aux;
};
static_assert(sizeof(KInstr) == 8, "KInstr is 8 bytes");

struct FusedParams {
  int64_t n;
  int32_t n_code;
  int32_t n_out;
  int32_t n_const;
  int32_t tail;
  int32_t n_slots;
  int32_t n_load;    // the load instructions at the head of the code
  int32_t prefetch;  // the next tile's wide leaves arrive while this one runs
  int32_t pad0;
  const void* mean_src;  // TAIL_M2: the first pass's merged accumulators
  void* partial;         // block partials: [blocks][n_out][3] of 8 bytes
  const void* leaf[kMaxLeaves];
  void* out[kMaxOut];
  int64_t konst[kMaxConsts];
  unsigned long long code[kMaxCode];  // KInstr words, read as one 8-byte load each
  uint8_t out_dt[kMaxOut];
};
static_assert(sizeof(FusedParams) <= 4096, "the program fits the classic 4 KB of kernel parameters");

union Val {
  long long i;
  double d;
  float f;
};

__device__ __forceinline__ bool is_f(uint8_t dt) { return dt >= DT_F32; }

// an int64 cut to the width of dtype dt (bool is never wrapped: its ops
// give 0 or 1), as numpy wraps: a shift left and back, arithmetic for the
// signed widths, logical for uint8
constexpr unsigned long long kWrapShift = 0x0000380020303800ULL;  // bytes by dtype code
__device__ __forceinline__ long long wrapc(long long v, uint8_t dt) {
  const int sh = (int)((kWrapShift >> (8 * dt)) & 0xff);
  const unsigned long long u = (unsigned long long)v << sh;
  return dt == DT_U8 ? (long long)(u >> sh) : ((long long)u >> sh);
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

// torch.pow of a tensor by a scalar exponent: its special cases
template <typename T>
__device__ __forceinline__ T pow_scalar(T base, T e) {
  if (e == T(0)) return T(1);
  if (e == T(1)) return base;
  if (e == T(0.5)) return msqrt(base);
  if (e == T(-0.5)) return mrsqrt(base);
  if (e == T(-1)) return rdiv(T(1), base);
  if (e == T(2)) return rmul(base, base);
  if (e == T(3)) return rmul(rmul(base, base), base);
  if (e == T(-2)) return (T)__ddiv_rn(1.0, (double)rmul(base, base));
  return mpow(base, e);
}

template <typename T>
__device__ __forceinline__ T sign_f(T a) {
  if (isnan(a)) return a;
  return (T)((T(0) < a) - (a < T(0)));
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

// The long float routines (floor division and modulo, pow, the
// transcendentals), one row a call and out of line: inlined K times over,
// their registers would set the whole interpreter's and cut its occupancy.
__device__ __noinline__ Val slow_op(int op, Val a, Val b, int dt) {
  Val r;
  r.i = 0;
  switch (op) {
    case K_FDIV_D: r.d = div_floor_f(a.d, b.d); break;
    case K_FDIV_F: r.f = div_floor_f(a.f, b.f); break;
    case K_MOD_D: r.d = mod_f(a.d, b.d); break;
    case K_MOD_F: r.f = mod_f(a.f, b.f); break;
    case K_POW_D: r.d = mpow(a.d, b.d); break;
    case K_POW_F: r.f = mpow(a.f, b.f); break;
    case K_POWS_D: r.d = pow_scalar(a.d, b.d); break;
    case K_POWS_F: r.f = pow_scalar(a.f, b.f); break;
#define MATH(NAME, FN64, FN32)                       \
  case K_##NAME##_D: r.d = FN64(a.d); break;         \
  case K_##NAME##_F: r.f = FN32(a.f); break;
    MATH(EXP, exp, expf)
    MATH(LOG, log, logf)
    MATH(LOG2, log2, log2f)
    MATH(LOG10, log10, log10f)
    MATH(SIN, sin, sinf)
    MATH(COS, cos, cosf)
    MATH(TAN, tan, tanf)
    MATH(TANH, tanh, tanhf)
#undef MATH
    default: break;
  }
  return r;
}

// asynchronous copies of 8 and 4 bytes from device memory into shared
// memory (zeros where src_bytes is 0), a commit of those issued, and a wait
// for all of this thread's
__device__ __forceinline__ void cp_async8(void* smem, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"((unsigned)__cvta_generic_to_shared(smem)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"((unsigned)__cvta_generic_to_shared(smem)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// A tile's leaves into the leaf slots from `to`: the 8- and 4-byte ones
// (float64, int64, float32, int32) by asynchronous copies (async: for the
// next tile while this one runs, with prefetch), the narrower ones by loads
// at the tile's start.  A load instruction brings dt leaves from leaf aux
// into slots from dst.
template <int K, int B>
__device__ __forceinline__ void load_leaves(const FusedParams& p, Val* to, long long row0, long long n, bool async) {
  for (int i = 0; i < p.n_load; ++i) {
    const unsigned long long w = p.code[i];
    const int op = (int)(w & 0xff), cnt = (int)((w >> 8) & 0xff), dst = (int)((w >> 16) & 0xff);
    const int aux = (int)(w >> 48);
    const bool wide = op == K_LD_F64 || op == K_LD_I64 || op == K_LD_F32 || op == K_LD_I32;
    if (wide != async) continue;
#define EACH_ROW(BODY)                                                        \
  for (int j = 0; j < cnt; ++j) {                                            \
    const void* src = p.leaf[aux + j];                                       \
    Val* d = to + (dst + j) * (B * K);                                       \
    _Pragma("unroll") for (int k = 0; k < K; ++k) {                          \
      const long long r = row0 + k * B;                                      \
      const bool ok = r < n;                                                 \
      const long long at = ok ? r : 0;                                       \
      BODY;                                                                  \
    }                                                                        \
  }                                                                          \
  break;
    switch (op) {
      case K_LD_F64:
      case K_LD_I64: EACH_ROW(cp_async8(d + k * B, (const long long*)src + at, ok ? 8 : 0))
      case K_LD_F32:
      case K_LD_I32: EACH_ROW(cp_async4(d + k * B, (const float*)src + at, ok ? 4 : 0))
      case K_LD_U8: EACH_ROW(d[k * B].i = ok ? __ldg((const unsigned char*)src + at) : 0)
      case K_LD_I8: EACH_ROW(d[k * B].i = ok ? __ldg((const signed char*)src + at) : 0)
      case K_LD_I16: EACH_ROW(d[k * B].i = ok ? __ldg((const short*)src + at) : 0)
      default: break;
    }
#undef EACH_ROW
  }
  if (async) cp_async_commit();
}

// An int32 leaf arrives as its 4 bytes in the low half of its slots: sign
// extend them in place, once this tile's copies are in.
template <int K, int B>
__device__ __forceinline__ void widen_int32(const FusedParams& p, Val* to) {
  for (int i = 0; i < p.n_load; ++i) {
    const unsigned long long w = p.code[i];
    if ((int)(w & 0xff) != K_LD_I32) continue;
    const int cnt = (int)((w >> 8) & 0xff), dst = (int)((w >> 16) & 0xff);
    for (int j = 0; j < cnt; ++j) {
      Val* d = to + (dst + j) * (B * K);
#pragma unroll
      for (int k = 0; k < K; ++k) d[k * B].i = (long long)(int)(unsigned)d[k * B].i;
    }
  }
}

// One operand of K rows: the previous result, a constant (the same for
// every row) or a register-file slot (a leaf slot, o < n_leaf, in this
// tile's leaf copy: `shift` on); nothing for kNone.
template <int K, int B>
__device__ __forceinline__ void fetch(int o, Val (&x)[K], const Val (&prev)[K], const Val* konst, const Val* regs,
                                      int n_leaf, int shift) {
  if (o == kAcc) {
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = prev[k];
  } else if (o == kNone) {
  } else if (o & kConst) {
    const Val v = konst[o & 0x7f];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = v;
  } else {
    const Val* src = regs + o * (B * K) + (o < n_leaf ? shift : 0);
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = src[k * B];
  }
}

// The interpreter: B threads a block, K rows a thread per decoded
// instruction (row row0 + k * B of the tile, k < K); a row past n (the
// last tile) is loaded as 0, computed and never stored or folded.  Each
// instruction's operands are fetched before its case, so a case is its
// arithmetic alone.
template <int K, int B>
__global__ void __launch_bounds__(B) fused_kernel(const __grid_constant__ FusedParams p) {
  extern __shared__ Val sm[];
  constexpr int R = B * K;
  const int tid = threadIdx.x;
  const int n_out = p.n_out, tail = p.tail;
  Val* const konst = sm;
  Val* const means = konst + p.n_const;
  Val* const acc = means + (tail == TAIL_M2 ? n_out : 0);  // [n_out * 3][B]
  Val* const regs = acc + (tail != TAIL_NONE ? 3 * n_out * B : 0) + tid;  // [slots][R], this thread's column
  for (int i = tid; i < p.n_const; i += B) konst[i].i = p.konst[i];
  if (tail != TAIL_NONE) {
    for (int q = 0; q < 3 * n_out; ++q) acc[q * B + tid] = acc_init(tail, is_f(p.out_dt[q / 3]), q % 3);
    if (tail == TAIL_M2) {
      for (int j = tid; j < n_out; j += B) {
        const Val* src = (const Val*)p.mean_src + 3 * j;
        means[j].d = __ddiv_rn(src[0].d, __ll2double_rn(src[1].i));
      }
    }
  }
  __syncthreads();

  const long long n = p.n;
  const int n_code = p.n_code;
  const long long tile_stride = (long long)gridDim.x * R;
  // the leaves take slots [0, n_leaf); with prefetch, a second copy of
  // those slots, after the register file, receives the next tile's leaves
  // while this one runs (the host asks for it where a tile's work is short
  // against a load's latency, and not where the copy would cost occupancy)
  int n_leaf = 0;
  for (int i = 0; i < p.n_load; ++i) n_leaf += (int)((p.code[i] >> 8) & 0xff);
  const bool prefetch = p.prefetch != 0;
  const int other = prefetch ? p.n_slots * R : 0;
  Val prev[K];  // the previous result of each row
  long long row0 = (long long)blockIdx.x * R + tid;
  if (prefetch && row0 - tid < n) load_leaves<K, B>(p, regs, row0, n, true);
  for (int parity = 0; row0 - tid < n; row0 += tile_stride, parity ^= 1) {
    const long long rem = n - row0;  // row k is valid where k * B < rem
    const int shift = parity ? other : 0;
    if (!prefetch) load_leaves<K, B>(p, regs, row0, n, true);
    load_leaves<K, B>(p, regs + shift, row0, n, false);
    cp_async_wait();
    widen_int32<K, B>(p, regs + shift);
    if (prefetch && row0 + tile_stride - tid < n) {
      load_leaves<K, B>(p, regs + (other - shift), row0 + tile_stride, n, true);
    }
    unsigned long long next = p.code[p.n_load];
    for (int pc = p.n_load; pc < n_code; ++pc) {
      const unsigned long long w = next;  // the next instruction's read overlaps this one
      next = p.code[pc + 1 < kMaxCode ? pc + 1 : pc];
      const int op = (int)(w & 0xff), dt = (int)((w >> 8) & 0xff), dst = (int)((w >> 16) & 0xff);
      const int aux = (int)(w >> 48);
      // operands a and b (c, SEL's alone, in its case); the result goes
      // straight into prev
      Val xa[K], xb[K];
      const int ob = (int)((w >> 32) & 0xff);
      const bool masked = ob != kNone;  // an accumulation's mask
      fetch<K, B>((int)((w >> 24) & 0xff), xa, prev, konst, regs, n_leaf, shift);
      fetch<K, B>(ob, xb, prev, konst, regs, n_leaf, shift);
#define ROWS _Pragma("unroll") for (int k = 0; k < K; ++k)
#define A xa[k]
#define BB xb[k]
#define D prev[k]
#define STORE(T, EXPR)                                                       \
  {                                                                          \
    T* to = (T*)p.out[aux] + row0;                                           \
    ROWS if (k * B < rem) to[k * B] = (T)(EXPR);                             \
  }                                                                          \
  continue;
      // the opcodes in groups of at most ~40, each its own switch: a short
      // chain of range tests, then a small table or tree
      if (op <= K_ST_F64) {  // the loads ran at the tile's start
      switch (op) {
        case K_ST_B: STORE(unsigned char, A.i != 0)
        case K_ST_I8: STORE(signed char, A.i)
        case K_ST_I16: STORE(short, A.i)
        case K_ST_I32: STORE(int, A.i)
        case K_ST_I64: STORE(long long, A.i)
        case K_ST_U8: STORE(unsigned char, A.i)
        case K_ST_F32: STORE(float, A.f)
        case K_ST_F64: STORE(double, A.d)
        default: continue;
      }
      } else if (op <= K_CVT_F_U8) {
      switch (op) {

        // casts; a float into an int width as torch's CUDA cast does:
        // straight from the source type, uint8 through int64
        case K_MOV: ROWS D = A; break;
        case K_CVT_D_F: ROWS D.f = __double2float_rn(A.d); break;
        case K_CVT_F_D: ROWS D.d = (double)A.f; break;
        case K_CVT_I_D: ROWS D.d = __ll2double_rn(A.i); break;
        case K_CVT_I_F: ROWS D.f = __ll2float_rn(A.i); break;
        case K_CVT_D_B: ROWS D.i = A.d != 0.0; break;  // NaN is truthy
        case K_CVT_F_B: ROWS D.i = A.f != 0.0f; break;
        case K_CVT_I_B: ROWS D.i = A.i != 0; break;
        case K_WRAP: ROWS D.i = wrapc(A.i, (uint8_t)aux); break;
        case K_CVT_D_I8: ROWS D.i = (long long)(signed char)A.d; break;
        case K_CVT_D_I16: ROWS D.i = (long long)(short)A.d; break;
        case K_CVT_D_I32: ROWS D.i = (long long)(int)A.d; break;
        case K_CVT_D_I64: ROWS D.i = (long long)A.d; break;
        case K_CVT_D_U8: ROWS D.i = (long long)(unsigned char)(long long)A.d; break;
        case K_CVT_F_I8: ROWS D.i = (long long)(signed char)A.f; break;
        case K_CVT_F_I16: ROWS D.i = (long long)(short)A.f; break;
        case K_CVT_F_I32: ROWS D.i = (long long)(int)A.f; break;
        case K_CVT_F_I64: ROWS D.i = (long long)A.f; break;
        case K_CVT_F_U8: ROWS D.i = (long long)(unsigned char)(long long)A.f; break;
        default: continue;
      }
      } else if (op <= K_XOR) {
      switch (op) {
        case K_ADD_D: ROWS D.d = radd(A.d, BB.d); break;
        case K_ADD_F: ROWS D.f = radd(A.f, BB.f); break;
        case K_ADD_I: ROWS D.i = wrapc(uadd(A.i, BB.i), (uint8_t)dt); break;
        case K_SUB_D: ROWS D.d = rsub(A.d, BB.d); break;
        case K_SUB_F: ROWS D.f = rsub(A.f, BB.f); break;
        case K_SUB_I: ROWS D.i = wrapc(usub(A.i, BB.i), (uint8_t)dt); break;
        case K_MUL_D: ROWS D.d = rmul(A.d, BB.d); break;
        case K_MUL_F: ROWS D.f = rmul(A.f, BB.f); break;
        case K_MUL_I: ROWS D.i = wrapc(umul(A.i, BB.i), (uint8_t)dt); break;
        case K_DIV_D: ROWS D.d = rdiv(A.d, BB.d); break;
        case K_DIV_F: ROWS D.f = rdiv(A.f, BB.f); break;
        // the int division runs inline (K rows' divisions interleave); the
        // float routines out of line
        case K_FDIV_I:
          ROWS D.i = wrapc(div_floor_i(A.i, BB.i), (uint8_t)dt);
          break;
        case K_MOD_I:
          ROWS D.i = wrapc(mod_i(A.i, BB.i), (uint8_t)dt);
          break;
        case K_FDIV_D:
        case K_FDIV_F:
        case K_MOD_D:
        case K_MOD_F:
        case K_POW_D:
        case K_POW_F:
        case K_POWS_D:
        case K_POWS_F:
          ROWS D = slow_op(op, A, BB, dt);
          break;

#define CMP(NAME, OPER)                                     \
  case K_##NAME##_D: ROWS D.i = A.d OPER BB.d; break;       \
  case K_##NAME##_F: ROWS D.i = A.f OPER BB.f; break;       \
  case K_##NAME##_I: ROWS D.i = A.i OPER BB.i; break;
        CMP(EQ, ==)
        CMP(NE, !=)
        CMP(LT, <)
        CMP(LE, <=)
        CMP(GT, >)
        CMP(GE, >=)
#undef CMP
        case K_AND: ROWS D.i = A.i & BB.i; break;
        case K_OR: ROWS D.i = A.i | BB.i; break;
        case K_XOR: ROWS D.i = A.i ^ BB.i; break;
        default: continue;
      }
      } else if (op <= K_SIGN_I) {
      switch (op) {

        case K_NEG_D: ROWS D.d = -A.d; break;
        case K_NEG_F: ROWS D.f = -A.f; break;
        case K_NEG_I: ROWS D.i = wrapc(usub(0, A.i), (uint8_t)dt); break;
        case K_ABS_D: ROWS D.d = fabs(A.d); break;
        case K_ABS_F: ROWS D.f = fabsf(A.f); break;
        case K_ABS_I: ROWS D.i = wrapc(A.i < 0 ? usub(0, A.i) : A.i, (uint8_t)dt); break;
        case K_NOT_B: ROWS D.i = !A.i; break;
        case K_INV_I: ROWS D.i = wrapc(~A.i, (uint8_t)dt); break;
        case K_ISNAN_D: ROWS D.i = isnan(A.d); break;
        case K_ISNAN_F: ROWS D.i = isnan(A.f); break;
        case K_ISNAN_I: ROWS D.i = 0; break;
        case K_NOTNAN_D: ROWS D.i = !isnan(A.d); break;
        case K_NOTNAN_F: ROWS D.i = !isnan(A.f); break;
        case K_NOTNAN_I: ROWS D.i = 1; break;

#define MATH(NAME, FN64, FN32)                              \
  case K_##NAME##_D: ROWS D.d = FN64(A.d); break;          \
  case K_##NAME##_F: ROWS D.f = FN32(A.f); break;
        MATH(SQRT, sqrt, sqrtf)
        MATH(FLOOR, floor, floorf)
        MATH(CEIL, ceil, ceilf)
#undef MATH
#define SLOW(NAME) case K_##NAME##_D: case K_##NAME##_F:
        SLOW(EXP) SLOW(LOG) SLOW(LOG2) SLOW(LOG10) SLOW(SIN) SLOW(COS) SLOW(TAN) SLOW(TANH)
          ROWS D = slow_op(op, A, BB, dt);
          break;
#undef SLOW
        case K_SIGN_D: ROWS D.d = sign_f(A.d); break;
        case K_SIGN_F: ROWS D.f = sign_f(A.f); break;
        case K_SIGN_I: ROWS D.i = (0 < A.i) - (A.i < 0); break;
        default: continue;
      }
      } else if (op <= K_MAX_I) {
      switch (op) {

        // ATen's round_decimals: b is the scale 10^|decimals|
        case K_RUP_D: ROWS D.d = rdiv(mnearbyint(rmul(A.d, BB.d)), BB.d); break;
        case K_RUP_F: ROWS D.f = rdiv(mnearbyint(rmul(A.f, BB.f)), BB.f); break;
        case K_RDN_D: ROWS D.d = rmul(mnearbyint(rdiv(A.d, BB.d)), BB.d); break;
        case K_RDN_F: ROWS D.f = rmul(mnearbyint(rdiv(A.f, BB.f)), BB.f); break;
        case K_RINT_D: ROWS D.d = mnearbyint(A.d); break;
        case K_RINT_F: ROWS D.f = mnearbyint(A.f); break;
        case K_ROUNDI:
          ROWS D.i = wrapc(round_i(A.i, BB.i), (uint8_t)dt);
          break;

        case K_FILLNA_D: ROWS D.d = isnan(A.d) ? BB.d : A.d; break;
        case K_FILLNA_F: ROWS D.f = isnan(A.f) ? BB.f : A.f; break;
        case K_CLIPLO_D: ROWS D.d = A.d < BB.d ? BB.d : A.d; break;
        case K_CLIPLO_F: ROWS D.f = A.f < BB.f ? BB.f : A.f; break;
        case K_CLIPLO_I: ROWS D.i = A.i < BB.i ? BB.i : A.i; break;
        case K_CLIPHI_D: ROWS D.d = A.d > BB.d ? BB.d : A.d; break;
        case K_CLIPHI_F: ROWS D.f = A.f > BB.f ? BB.f : A.f; break;
        case K_CLIPHI_I: ROWS D.i = A.i > BB.i ? BB.i : A.i; break;
        case K_SEL: {
          Val xc[K];
          fetch<K, B>((int)((w >> 40) & 0xff), xc, prev, konst, regs, n_leaf, shift);
          ROWS D = A.i ? BB : xc[k];
          break;
        }
        case K_MIN_D: ROWS D.d = fmin_nan(A.d, BB.d); break;
        case K_MIN_F: ROWS D.f = fmin_nan(A.f, BB.f); break;
        case K_MIN_I: ROWS D.i = BB.i < A.i ? BB.i : A.i; break;
        case K_MAX_D: ROWS D.d = fmax_nan(A.d, BB.d); break;
        case K_MAX_F: ROWS D.f = fmax_nan(A.f, BB.f); break;
        case K_MAX_I: ROWS D.i = A.i < BB.i ? BB.i : A.i; break;
        default: continue;
      }
      } else {
      switch (op) {

        // accumulations: output aux's (value, valid count, NaN count)
        // of this thread, its rows folded in order; operand b, where there
        // is one, is a mask, and a row where it is false folds nothing
#define KEEP (k * B < rem && (!masked || BB.i != 0))
#define ACC_FLOAT(NAME, X, FOLD)                                             \
  case K_ACC_##NAME: {                                                       \
    Val* q = acc + 3 * aux * B + tid;                                     \
    double v = q[0].d;                                                       \
    long long cnt = q[B].i, nan = q[2 * B].i;                                \
    ROWS if (KEEP) {                                                         \
      const double x = (X);                                                  \
      if (isnan(x)) {                                                        \
        ++nan;                                                               \
      } else {                                                               \
        ++cnt;                                                               \
        v = (FOLD);                                                          \
      }                                                                      \
    }                                                                        \
    q[0].d = v;                                                              \
    q[B].i = cnt;                                                            \
    q[2 * B].i = nan;                                                        \
    continue;                                                                \
  }
#define ACC_INT(NAME, FOLD)                                                  \
  case K_ACC_##NAME: {                                                       \
    Val* q = acc + 3 * aux * B + tid;                                     \
    long long v = q[0].i, cnt = q[B].i;                                      \
    ROWS if (KEEP) {                                                         \
      const long long x = A.i;                                               \
      ++cnt;                                                                 \
      v = (FOLD);                                                            \
    }                                                                        \
    q[0].i = v;                                                              \
    q[B].i = cnt;                                                            \
    continue;                                                                \
  }
        ACC_FLOAT(SUM_D, A.d, __dadd_rn(v, x))
        ACC_FLOAT(SUM_F, (double)A.f, __dadd_rn(v, x))
        ACC_INT(SUM_I, uadd(v, x))
        ACC_FLOAT(PROD_D, A.d, __dmul_rn(v, x))
        ACC_FLOAT(PROD_F, (double)A.f, __dmul_rn(v, x))
        ACC_INT(PROD_I, umul(v, x))
        ACC_FLOAT(MIN_D, A.d, (x < v) ? x : v)
        ACC_FLOAT(MIN_F, (double)A.f, (x < v) ? x : v)
        ACC_INT(MIN_I, (x < v) ? x : v)
        ACC_FLOAT(MAX_D, A.d, (v < x) ? x : v)
        ACC_FLOAT(MAX_F, (double)A.f, (v < x) ? x : v)
        ACC_INT(MAX_I, (v < x) ? x : v)
        case K_ACC_NZ_D:
        case K_ACC_NZ_F: {
          Val* q = acc + 3 * aux * B + tid;
          long long v = q[0].i, cnt = q[B].i, nan = q[2 * B].i;
          ROWS if (KEEP) {
            const double x = op == K_ACC_NZ_D ? A.d : (double)A.f;
            if (isnan(x)) {
              ++nan;
            } else {
              ++cnt;
              v += x != 0.0;
            }
          }
          q[0].i = v;
          q[B].i = cnt;
          q[2 * B].i = nan;
          continue;
        }
        ACC_INT(NZ_I, v + (x != 0))
        case K_ACC_M2_D: {
          Val* q = acc + 3 * aux * B + tid;
          const double mean = means[aux].d;
          double s2 = q[0].d, s3 = q[B].d, s4 = q[2 * B].d;
          ROWS if (KEEP && !isnan(A.d)) {
            const double e = __dsub_rn(A.d, mean);
            const double e2 = __dmul_rn(e, e);
            const double e3 = __dmul_rn(e2, e);
            const double e4 = __dmul_rn(e3, e);
            s2 = __dadd_rn(s2, e2);
            s3 = __dadd_rn(s3, e3);
            s4 = __dadd_rn(s4, e4);
          }
          q[0].d = s2;
          q[B].d = s3;
          q[2 * B].d = s4;
          continue;
        }
#undef ACC_FLOAT
#undef ACC_INT
#undef KEEP
        default: continue;
      }
      }
      // every other instruction gave a result: it is the previous result
      // now, and goes to its register-file slot unless only the register
      // is read
      if (dst != kAcc) {
        Val* to = regs + dst * R + (dst < n_leaf ? shift : 0);
        ROWS to[k * B] = prev[k];
      }
#undef ROWS
#undef A
#undef BB
#undef D
#undef STORE
    }
  }
  if (tail == TAIL_NONE) return;
  // one tree over every accumulator row at once: at width w, thread
  // slot t of row q takes row q's t + w (log2(B) barriers in all)
  const int items = 3 * n_out;
  for (int w = B / 2, lw = __ffs(B) - 2; w > 0; w >>= 1, --lw) {
    __syncthreads();
    for (int it = tid; it < items * w; it += B) {
      const int q = it >> lw, t = it & (w - 1);
      Val* row = acc + q * B;
      row[t] = acc_combine(tail, is_f(p.out_dt[q / 3]), q % 3, row[t], row[t + w]);
    }
  }
  __syncthreads();
  // items (3 * n_out, up to 96) may exceed a small block's threads
  Val* partial = (Val*)p.partial;
  for (int q = tid; q < items; q += B) partial[(long long)blockIdx.x * items + q] = acc[q * B];
}

// one block per output: the block partials in block order, then a tree
__global__ void __launch_bounds__(kMergeThreads)
fused_merge(const __grid_constant__ FusedParams p, int blocks, Val* acc_out) {
  __shared__ Val sh[kMergeThreads];
  const int j = blockIdx.x;
  const bool fl = is_f(p.out_dt[j]);
  const Val* partial = (const Val*)p.partial;
  for (int s = 0; s < 3; ++s) {
    Val m = acc_init(p.tail, fl, s);
    for (int b = threadIdx.x; b < blocks; b += kMergeThreads) {
      m = acc_combine(p.tail, fl, s, m, partial[((long long)b * p.n_out + j) * 3 + s]);
    }
    sh[threadIdx.x] = m;
    __syncthreads();
    for (int w = kMergeThreads / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) sh[threadIdx.x] = acc_combine(p.tail, fl, s, sh[threadIdx.x], sh[threadIdx.x + w]);
      __syncthreads();
    }
    if (threadIdx.x == 0) acc_out[3 * j + s] = sh[0];
    __syncthreads();
  }
}

template <int K, int B>
cudaError_t launch(const FusedParams& p, int blocks, int smem, cudaStream_t s) {
  // the opt-in above 48 KB of dynamic shared memory (an attribute of the
  // current device's function: set at each such launch)
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(fused_kernel<K, B>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  fused_kernel<K, B><<<blocks, B, smem, s>>>(p);
  return cudaGetLastError();
}

// the launch shapes built (fused_program.launch_shape): 256 threads with 1,
// 2 or 4 rows a thread, and smaller blocks of one row a thread for programs
// whose shared memory needs them
cudaError_t launch_shape(const FusedParams& p, int blocks, int threads, int rows_per_thread, int smem,
                         cudaStream_t s) {
  if (threads == 256 && rows_per_thread == 4) return launch<4, 256>(p, blocks, smem, s);
  if (threads == 256 && rows_per_thread == 2) return launch<2, 256>(p, blocks, smem, s);
  if (threads == 256 && rows_per_thread == 1) return launch<1, 256>(p, blocks, smem, s);
  if (threads == 128 && rows_per_thread == 1) return launch<1, 128>(p, blocks, smem, s);
  if (threads == 64 && rows_per_thread == 1) return launch<1, 64>(p, blocks, smem, s);
  if (threads == 32 && rows_per_thread == 1) return launch<1, 32>(p, blocks, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int fused_params_bytes() { return (int)sizeof(FusedParams); }

// Runs one program over p->n rows on ``stream``: ``blocks`` blocks of
// ``threads`` threads, each thread ``rows_per_thread`` (1, 2 or 4) rows a
// decoded instruction, ``smem`` bytes of dynamic shared memory a block
// (fused_program.launch_shape); with a tail, also merges the block partials
// into ``acc_out`` ([n_out][3] of 8 bytes).  Returns 0 or the CUDA error of
// a launch.
int fused_run(const void* params, int blocks, int threads, int rows_per_thread, int smem, void* acc_out,
              void* stream) {
  const FusedParams* p = (const FusedParams*)params;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_shape(*p, blocks, threads, rows_per_thread, smem, s);
  if (err != cudaSuccess) return (int)err;
  if (p->tail != TAIL_NONE && p->n_out > 0) {
    fused_merge<<<p->n_out, kMergeThreads, 0, s>>>(*p, blocks, (Val*)acc_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* fused_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
