"""The program compiler of the fused elementwise kernel (host only).

A deferred chain of elementwise ops (``ops/lazy.py``) is linearized into a
postorder list of nodes; this module turns such a forest, plus an optional
reduction tail, into a small register program (``Program.instrs``, the
semantic program that ``fused_kernels.run_program_plain`` walks with torch
tensors as registers), and lowers it into the encoding that
``csrc/fused.cu`` interprets, one launch per consumer (:func:`lower`:
typed opcodes, leaves loaded once, a register file in shared memory; the
section at the end of this module).

An instruction is ``(op, dt, dst, a, b, c, aux, imm)``: an opcode, the dtype
code its operands are in (its operand class follows: ``i64`` for bool and
the ints, ``f32``, ``f64``), a destination register, up to three sources and
a static argument.  A source is a register (``0 <= s < 64``), a scalar slot
(``64 + k``: a runtime scalar, or a constant of the program) or a leaf column
(``128 + k``).  Promotion is explicit: where numpy's result dtype (NEP 50,
the eager ops' ``_result_dtype``) differs from an operand's, a ``CAST``
instruction converts it first, and a result narrower than 64 bits wraps to
its width after the op, as numpy wraps.  A scalar slot holds its value
already converted to the dtype of its use, so ``df * 2`` and ``df * 3`` run
one program with other slot values.

Registers are allocated by liveness over the postorder: a value's register
is freed after its last use, and each root is stored (``STORE``) or folded
into its reduction accumulator (``ACC``) as soon as it is computed.  The
kernel's caps (:data:`MAX_INSTR`, :data:`MAX_REGS`, :data:`MAX_LEAVES`,
:data:`MAX_OUTPUTS`, :data:`MAX_SCALARS`) bound a program; a forest over a
cap is split into several programs by root, and a single root over a cap
asks for some of its inner nodes to be materialized first
(:class:`Cut`), as ``lazy._MAX_NODES`` bounds a chain.

Tails: ``None`` writes the roots; ``("reduce", op, skipna, ddof,
cast_bool)`` folds each root into per-column accumulators (the kernel's
deterministic block partials and merge); ``("rows", op, skipna,
cast_bool)`` folds the roots of each row into one output column with plain
instructions (the row-wise sum/mean/min/max/count of ``reduce_axis1``).
A masked reduction tail, ``("reduce", op, skipna, ddof, cast_bool,
True)``, takes the forest's last root as a bool mask: every accumulation
names the mask as its second operand and folds only the rows where it is
true, and one more output, the mask folded under itself, carries the
kept-row count in its count slot (the whole-plan fusion of ``plan/fuse.py``:
a filter, its map chain and the reduction in one launch, no compaction).
"""

from __future__ import annotations

import functools
import struct
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

# dtype codes of the kernel (csrc/fused.cu: enum Dt)
DTYPE_CODES: Dict[torch.dtype, int] = {
    torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
    torch.int64: 4, torch.uint8: 5, torch.float32: 6, torch.float64: 7,
}
CODE_DTYPES = {v: k for k, v in DTYPE_CODES.items()}
F32, F64, I64, BOOL = 6, 7, 4, 0

# opcodes (csrc/fused.cu: enum Op)
(CAST, ADD, SUB, MUL, TDIV, FDIV, MOD, POW, EQ, NE, LT, LE, GT, GE, AND, OR,
 XOR, NEG, ABS, INV, ISNAN, NOTNAN, EQI, NEI, SQRT, EXP, LOG, LOG2, LOG10,
 SIN, COS, TAN, TANH, FLOOR, CEIL, SIGN, ROUND, ROUNDI, FILLNA, CLIPLO,
 CLIPHI, SEL, NANTO, MIN, MAX, STORE, ACC) = range(1, 48)
OP_NAMES = {v: k for k, v in list(globals().items()) if k.isupper() and isinstance(v, int) and 1 <= v <= 47
            and k not in ("F32", "F64", "I64", "BOOL")}

# the kernel's caps: instructions, registers, leaves, outputs, scalar slots
MAX_INSTR = 160
MAX_REGS = 32
MAX_LEAVES = 64
MAX_OUTPUTS = 32
MAX_SCALARS = 32
SCALAR_BASE = 64
LEAF_BASE = 128
NO_OPERAND = 255

# reduction-tail modes of the kernel (csrc/fused.cu: enum Tail)
TAIL_NONE, TAIL_SUM, TAIL_PROD, TAIL_MIN, TAIL_MAX, TAIL_NZ, TAIL_M1, TAIL_M2 = range(8)
REDUCE_MODES = {
    "sum": TAIL_SUM, "count": TAIL_SUM, "prod": TAIL_PROD, "min": TAIL_MIN,
    "max": TAIL_MAX, "any": TAIL_NZ, "all": TAIL_NZ, "mean": TAIL_M1,
    "var": TAIL_M1, "std": TAIL_M1, "sem": TAIL_M1, "skew": TAIL_M1, "kurt": TAIL_M1,
}
MOMENT_OPS = frozenset(["var", "std", "sem", "skew", "kurt"])
ROW_OPS = frozenset(["sum", "mean", "min", "max", "count"])

_BINARY = {
    "add": (ADD, False), "radd": (ADD, True), "sub": (SUB, False), "rsub": (SUB, True),
    "mul": (MUL, False), "rmul": (MUL, True), "truediv": (TDIV, False),
    "rtruediv": (TDIV, True), "floordiv": (FDIV, False), "rfloordiv": (FDIV, True),
    "mod": (MOD, False), "rmod": (MOD, True), "pow": (POW, False), "rpow": (POW, True),
    "eq": (EQ, False), "ne": (NE, False), "lt": (LT, False), "le": (LE, False),
    "gt": (GT, False), "ge": (GE, False), "__and__": (AND, False), "__or__": (OR, False),
    "__xor__": (XOR, False), "__rand__": (AND, True), "__ror__": (OR, True),
    "__rxor__": (XOR, True),
}
_MATH = {
    "sqrt": SQRT, "exp": EXP, "log": LOG, "log2": LOG2, "log10": LOG10, "sin": SIN,
    "cos": COS, "tan": TAN, "tanh": TANH, "floor": FLOOR, "ceil": CEIL, "sign": SIGN,
}
# ops that stay eager: the scan-kernel cumulative ops (a lazy node of one of
# these is a barrier: its inputs materialize, it runs, its result is a leaf)
BARRIER_OPS = frozenset(["cumsum", "cumprod", "cummax", "cummin"])


def is_float(code: int) -> bool:
    return code in (F32, F64)


_MAPS = frozenset(["isna", "notna", "isna_nat", "notna_nat", "round", "fillna",
                   "clip_lower", "clip_upper", "astype", "where"])


def fusable(op: str, arg_dtypes: Sequence[torch.dtype], out_dtype: torch.dtype) -> bool:
    """Whether the fused kernel computes ``op`` over columns of
    ``arg_dtypes`` into ``out_dtype``; any other node is a barrier."""
    if op in BARRIER_OPS or out_dtype not in DTYPE_CODES:
        return False
    if any(d not in DTYPE_CODES for d in arg_dtypes):
        return False
    out = DTYPE_CODES[out_dtype]
    if op in _BINARY:
        kop = _BINARY[op][0]
        if kop == POW:
            return is_float(out)
        if kop in (FDIV, MOD, SUB):
            return out != BOOL
        return True
    if op in ("abs", "negative"):
        return out != BOOL
    if op == "invert":
        return not is_float(out)
    if op in _MATH:
        return is_float(out) or op == "sign"
    if op == "fillna":
        return is_float(out)  # the builders pass int and bool columns through
    if op in ("isna_nat", "notna_nat"):
        return list(arg_dtypes) == [torch.int64]  # the NaT sentinel of int64 ticks
    return op in _MAPS


class Cut(NamedTuple):
    """A root does not fit one program: materialize these nodes (postorder
    indices) first, then compile again with them as leaves."""

    nodes: Tuple[int, ...]


class Program(NamedTuple):
    """One launch: the instructions and what they read and write."""

    instrs: Tuple[Tuple[int, ...], ...]  # (op, dt, dst, a, b, c, aux, imm)
    leaves: Tuple[int, ...]  # forest leaf index of each program leaf
    leaf_dtypes: Tuple[int, ...]
    slots: Tuple[Tuple[str, Any, int], ...]  # ("scalar", forest index, dt) or ("const", value, dt)
    roots: Tuple[int, ...]  # forest root index of each output
    out_dtypes: Tuple[int, ...]  # STORE dtype, or the ACC class dtype
    n_regs: int
    tail: Optional[Tuple]
    kernel: "Lowered"  # the kernel's encoding (its first pass for a moments tail)
    kernel_m2: Optional["Lowered"]  # a moments tail's second pass


def double_bits(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", x))[0]


def bits_double(b: int) -> float:
    return struct.unpack("<d", struct.pack("<q", b))[0]


def _wrap_int(v: int, code: int) -> int:
    """A Python int cut to the width of int dtype ``code`` (as a C cast)."""
    if code == BOOL:
        return int(bool(v))
    bits = {1: 8, 2: 16, 3: 32, 4: 64, 5: 8}[code]
    v &= (1 << bits) - 1
    if code != 5 and v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def scalar_value(value: Any, code: int) -> Any:
    """``value`` converted to dtype ``code`` as torch converts a Python
    scalar operand (an int wraps, an int64 rounds once to float32), as a
    Python scalar of that dtype's kind."""
    if isinstance(value, np.generic):
        value = value.item()
    if code == BOOL:
        return bool(value)
    if not is_float(code):
        return _wrap_int(int(value), code)
    if code == F64:
        return float(value)
    with np.errstate(over="ignore"):
        if isinstance(value, (bool, int)):
            return float(np.array(_wrap_int(int(value), I64), np.int64).astype(np.float32))
        return float(np.float32(value))


def scalar_bits(value: Any, code: int) -> int:
    """The 8 bytes of a scalar slot (csrc/fused.cu: union Val) as an int64."""
    v = scalar_value(value, code)
    if code == F64:
        return double_bits(v)
    if code == F32:
        return struct.unpack("<i", struct.pack("<f", v))[0] & 0xFFFFFFFF
    return int(v)


def _meta(code: int) -> torch.Tensor:
    return torch.empty(0, dtype=CODE_DTYPES[code])


def _result_code(x: Any, y: Any, kop: int) -> int:
    from modin_tpu_torch.ops.elementwise import _result_dtype
    from modin_tpu_torch.utils import torch_dtype

    out_of_range = "widen" if kop in (EQ, NE, LT, LE, GT, GE) else "ignore" if kop == TDIV else "raise"
    return DTYPE_CODES[torch_dtype(_result_dtype(x, y, out_of_range))]


class _Overflow(Exception):
    pass


class _Builder:
    """Emits one program; raises :class:`_Overflow` past a cap."""

    def __init__(self, nodes, node_codes, leaf_codes, scalar_tags, uses):
        self.nodes, self.node_codes, self.leaf_codes = nodes, node_codes, leaf_codes
        self.scalar_tags = scalar_tags
        self.uses = dict(uses)  # node index -> remaining uses in this program
        self.instrs: List[Tuple[int, ...]] = []
        self.leaves: List[int] = []
        self.leaf_pos: Dict[int, int] = {}
        self.slots: List[Tuple[str, Any, int]] = []
        self.reg_of: Dict[int, int] = {}  # node index -> register
        self.free = list(range(MAX_REGS))
        self.n_regs = 0
        self.roots: List[int] = []
        self.out_dtypes: List[int] = []
        self.imm_consts: Dict[int, None] = {}  # the lowering's constants for static arguments

    # -- resources -------------------------------------------------- #

    def alloc(self) -> int:
        if not self.free:
            raise _Overflow("registers")
        r = min(self.free)
        self.free.remove(r)
        self.n_regs = max(self.n_regs, r + 1)
        return r

    def release(self, operand: int) -> None:
        if operand < SCALAR_BASE and operand not in self.free:
            self.free.append(operand)

    def emit(self, op, dt, dst, a=NO_OPERAND, b=NO_OPERAND, c=NO_OPERAND, aux=0, imm=0) -> None:
        if len(self.instrs) >= MAX_INSTR:
            raise _Overflow("instructions")
        k = _imm_const(op, dt, aux, imm)
        if k is not None and k not in self.imm_consts:
            if len(self.imm_consts) >= MAX_CONSTS - MAX_SCALARS:
                raise _Overflow("constants")
            self.imm_consts[k] = None
        self.instrs.append((op, dt, dst, a, b, c, aux, imm))

    def leaf(self, i: int) -> int:
        k = self.leaf_pos.get(i)
        if k is None:
            if len(self.leaves) >= MAX_LEAVES:
                raise _Overflow("leaves")
            k = len(self.leaves)
            self.leaves.append(i)
            self.leaf_pos[i] = k
        return LEAF_BASE + k

    def slot(self, kind: str, value: Any, code: int) -> int:
        if len(self.slots) >= MAX_SCALARS:
            raise _Overflow("scalars")
        self.slots.append((kind, value, code))
        return SCALAR_BASE + len(self.slots) - 1

    def const(self, value: Any, code: int) -> int:
        return self.slot("const", value, code)

    # -- operands --------------------------------------------------- #

    def code_of(self, ref) -> Any:
        kind, i = ref
        if kind == "n":
            return self.node_codes[i]
        if kind == "l":
            return self.leaf_codes[i]
        return None

    def meta_of(self, ref) -> Any:
        """What numpy's promotion sees of an operand: a dtype or the scalar."""
        kind, i = ref
        if kind == "s":
            return self.scalar_tags[i][1]
        return _meta(self.code_of(ref))

    def raw(self, ref) -> int:
        """The operand of a ref in its own dtype (a scalar must be given a
        dtype by :meth:`operand`)."""
        kind, i = ref
        if kind == "n":
            return self.reg_of[i]
        return self.leaf(i)

    def operand(self, ref, code: int) -> Tuple[int, bool]:
        """(operand, is a temporary) of ``ref`` converted to dtype ``code``."""
        kind, i = ref
        if kind == "s":
            return self.slot("scalar", i, code), False
        src = self.raw(ref)
        have = self.code_of(ref)
        if have == code:
            return src, False
        t = self.alloc()
        self.emit(CAST, have, t, src, aux=code)
        return t, True

    def cast_value(self, operand: int, have: int, code: int, temp: bool) -> Tuple[int, bool]:
        """A computed operand converted to ``code`` (a new temporary)."""
        if have == code:
            return operand, temp
        if temp:
            self.release(operand)
        t = self.alloc()
        self.emit(CAST, have, t, operand, aux=code)
        return t, True

    def done_with(self, refs) -> None:
        """Free the registers of nodes whose last use this was."""
        for kind, i in refs:
            if kind != "n":
                continue
            self.uses[i] -= 1
            if self.uses[i] == 0:
                self.release(self.reg_of[i])

    # -- nodes ------------------------------------------------------ #

    def node(self, idx: int) -> None:
        op, refs, static = self.nodes[idx]
        out = self.node_codes[idx]
        kw = dict(static)
        temps: List[int] = []

        def opnd(ref, code):
            o, t = self.operand(ref, code)
            if t:
                temps.append(o)
            return o

        def finish(op_code, dt, *srcs, aux=0, imm=0):
            for t in temps:
                self.release(t)
            self.done_with(refs)
            dst = self.alloc()
            srcs = list(srcs) + [NO_OPERAND] * (3 - len(srcs))
            self.emit(op_code, dt, dst, *srcs, aux=aux, imm=imm)
            self.reg_of[idx] = dst

        if op in _BINARY:
            kop, swap = _BINARY[op]
            x, y = (refs[1], refs[0]) if swap else (refs[0], refs[1])
            dt = _result_code(self.meta_of(x), self.meta_of(y), kop)
            if kop == TDIV and not is_float(dt):
                dt = F64
            if dt == BOOL and kop in (ADD, MUL):
                kop = OR if kop == ADD else AND  # numpy and torch: bool + is or, * is and
            a, b = opnd(x, dt), opnd(y, dt)
            finish(kop, dt, a, b)
        elif op in ("abs", "negative", "invert"):
            a = opnd(refs[0], out)
            finish({"abs": ABS, "negative": NEG, "invert": INV}[op], out, a)
        elif op in ("isna", "notna"):
            src = self.code_of(refs[0])
            a = opnd(refs[0], src)
            finish(ISNAN if op == "isna" else NOTNAN, src, a)
        elif op in ("isna_nat", "notna_nat"):
            a = opnd(refs[0], I64)
            finish(EQI if op == "isna_nat" else NEI, I64, a, imm=int(np.iinfo(np.int64).min))
        elif op in _MATH:
            src = self.code_of(refs[0])
            if op == "sign" and not is_float(out):
                a = opnd(refs[0], src)
                finish(SIGN, src, a)  # the sign of an int column stays int
            else:
                a = opnd(refs[0], out)
                finish(_MATH[op], out, a)
        elif op == "round":
            d = int(kw["decimals"])
            a = opnd(refs[0], out)
            if is_float(out):
                finish(ROUND, out, a, aux=d & 0xFFFF, imm=double_bits(float(10.0 ** abs(d))))
            elif d < 0 and out != BOOL:
                finish(ROUNDI, out, a, aux=d & 0xFFFF, imm=10 ** (-d))
            else:
                finish(CAST, out, a, aux=out)  # round leaves these as they are
        elif op == "fillna":
            a, b = opnd(refs[0], out), opnd(refs[1], out)
            finish(FILLNA, out, a, b)
        elif op in ("clip_lower", "clip_upper"):
            a, b = opnd(refs[0], out), opnd(refs[1], out)
            finish(CLIPLO if op == "clip_lower" else CLIPHI, out, a, b)
        elif op == "astype":
            src = self.code_of(refs[0])
            a = opnd(refs[0], src)
            finish(CAST, src, a, aux=out)
        elif op == "where":
            m = opnd(refs[0], BOOL)
            a, b = opnd(refs[1], out), opnd(refs[2], out)
            finish(SEL, out, m, a, b)
        else:
            raise NotImplementedError(f"fused programs do not take {op!r}")

    def value(self, ref) -> Tuple[int, int, bool]:
        """(operand, dtype code, is a register this program may free) of a
        root: a node's register or a leaf column."""
        kind, i = ref
        if kind == "n":
            return self.reg_of[i], self.node_codes[i], False
        if kind == "l":
            return self.leaf(i), self.leaf_codes[i], False
        raise NotImplementedError("a scalar root")


def _node_order(nodes, roots) -> List[List[int]]:
    """Per root, the nodes of its subtree in postorder (each node once per
    root; a node shared with an earlier root appears again)."""
    out = []
    for ref in roots:
        seen: Dict[int, None] = {}

        def visit(r):
            if r[0] != "n" or r[1] in seen:
                return
            for a in nodes[r[1]][1]:
                visit(a)
            seen[r[1]] = None

        visit(ref)
        out.append(list(seen))
    return out


def _uses(nodes, order: Sequence[int], root_refs) -> Dict[int, int]:
    uses: Dict[int, int] = {}
    for i in order:
        uses.setdefault(i, 0)
        for kind, j in nodes[i][1]:
            if kind == "n":
                uses[j] = uses.get(j, 0) + 1
    for kind, j in root_refs:
        if kind == "n":
            uses[j] = uses.get(j, 0) + 1
    return uses


def is_masked(tail: Optional[Tuple]) -> bool:
    """Whether ``tail`` is a masked reduction tail."""
    return tail is not None and tail[0] == "reduce" and len(tail) > 5 and bool(tail[5])


def _fold_reduce(b: _Builder, ref, tail, mask=None) -> None:
    """Fold one root into its column accumulator (``mask``: the operand and
    ref of a masked tail's mask, its second operand)."""
    op, cast_bool = tail[1], tail[4]
    operand, code, _ = b.value(ref)
    tmp = False
    if cast_bool and code == BOOL:
        operand, tmp = b.cast_value(operand, code, I64, tmp)
        code = I64
    if REDUCE_MODES[op] == TAIL_M1:
        operand, tmp = b.cast_value(operand, code, F64, tmp)
        code = F64
    if len(b.roots) >= MAX_OUTPUTS:
        raise _Overflow("outputs")
    b.emit(ACC, code, NO_OPERAND, operand, NO_OPERAND if mask is None else mask[0], aux=len(b.roots))
    if tmp:
        b.release(operand)
    b.done_with([ref] if mask is None else [ref, mask[1]])
    b.out_dtypes.append(code)


def _common_code(codes: Sequence[int]) -> int:
    common = CODE_DTYPES[codes[0]]
    for c in codes[1:]:
        common = torch.promote_types(common, CODE_DTYPES[c])
    return DTYPE_CODES[common]


def _compile_rows(b: _Builder, nodes, roots, order_by_root, tail) -> None:
    """The row-wise reduction of ``reduce_axis1`` as instructions: each root
    is cast to the columns' common dtype (torch's promotion, as the eager
    path stacks them) and folded into running registers in column order."""
    _, op, skipna, cast_bool = tail
    codes = [b.code_of(r) for r in roots]
    if cast_bool:
        codes = [I64 if c == BOOL else c for c in codes]
    common = _common_code(codes)
    fl = is_float(common)
    nan_skip = fl and skipna
    acc = cnt = allnan = None
    for k, (ref, order) in enumerate(zip(roots, order_by_root)):
        for i in order:
            if i not in b.reg_of:
                b.node(i)
        x, code, _ = b.value(ref)
        tmp = False
        if cast_bool and code == BOOL:
            x, tmp = b.cast_value(x, code, I64, tmp)
            code = I64
        x, tmp = b.cast_value(x, code, common, tmp)
        code = common
        if op == "mean":
            x, tmp = b.cast_value(x, code, F64, tmp)
            code = F64
        elif op == "sum" and not fl:
            x, tmp = b.cast_value(x, code, I64, tmp)
            code = I64
        # count counts the non-NaN values whatever skipna says
        if (op == "count" and fl) or (op == "mean" and nan_skip):
            one = b.alloc()
            b.emit(NOTNAN, code, one, x)
            c64 = b.alloc()
            b.emit(CAST, BOOL, c64, one, aux=I64)
            b.release(one)
            if cnt is None:
                cnt = c64
            else:
                b.emit(ADD, I64, cnt, cnt, c64)
                b.release(c64)
        if op in ("min", "max") and nan_skip:
            isn = b.alloc()
            b.emit(ISNAN, code, isn, x)
            if allnan is None:
                allnan = isn
            else:
                b.emit(AND, BOOL, allnan, allnan, isn)
                b.release(isn)
        if op != "count":
            v = x
            if nan_skip:
                fill = {"sum": 0.0, "mean": 0.0, "min": float("inf"), "max": float("-inf")}[op]
                v = b.alloc()
                b.emit(NANTO, code, v, x, imm=double_bits(fill))
                if tmp:
                    b.release(x)
                tmp = True
            if acc is None:
                if tmp:
                    acc = v
                else:
                    acc = b.alloc()
                    b.emit(CAST, code, acc, v, aux=code)  # a copy into a register
            else:
                kop = {"sum": ADD, "mean": ADD, "min": MIN, "max": MAX}[op]
                b.emit(kop, code, acc, acc, v)
                if tmp:
                    b.release(v)
        elif tmp:
            b.release(x)
        b.done_with([ref])
    if op == "count":
        res, res_code = cnt, I64
    elif op == "mean":
        if nan_skip:
            cf = b.alloc()
            b.emit(CAST, I64, cf, cnt, aux=F64)
            b.emit(TDIV, F64, acc, acc, cf)
        else:
            b.emit(TDIV, F64, acc, acc, b.const(float(len(roots)), F64))
        res, res_code = acc, F64
    else:
        res, res_code = acc, common
        if op in ("min", "max") and nan_skip:
            b.emit(SEL, common, acc, allnan, b.const(float("nan"), common), acc)
    b.emit(STORE, res_code, NO_OPERAND, res, aux=0)
    b.roots.append(0)
    b.out_dtypes.append(res_code)


def compile_forest(
    nodes: Sequence[Tuple],
    node_codes: Sequence[int],
    out_refs: Sequence[Tuple[str, int]],
    leaf_codes: Sequence[int],
    scalar_tags: Sequence[Tuple[str, Any]],
    tail: Optional[Tuple] = None,
):
    """Programs for a linearized forest (``lazy._linearize``'s nodes and
    refs; ``node_codes``/``leaf_codes`` their dtype codes; ``scalar_tags``
    each scalar's (tag, value for promotion)), or a :class:`Cut`.

    Roots go to programs in order, as many to a program as its caps take;
    a root that fits no program alone gives a Cut of the values live where
    it overflowed.  A ``rows`` tail needs the whole forest in one program
    and raises :class:`OverflowError` otherwise.
    """
    order_by_root = _node_order(nodes, out_refs)
    if tail is not None and tail[0] == "rows":
        flat = [i for order in order_by_root for i in order]
        b = _Builder(nodes, node_codes, leaf_codes, scalar_tags, _uses(nodes, flat, out_refs))
        try:
            # each node once: the builder skips a node already in a register
            _compile_rows(b, nodes, out_refs, order_by_root, tail)
        except _Overflow as err:
            raise OverflowError(f"a row-wise reduction over {len(out_refs)} columns exceeds "
                                f"the fused kernel's {err}") from None
        return [_program(b, tail)]
    mask = None
    if is_masked(tail):
        # the mask (the last root) comes first in every program
        mask = (out_refs[-1], order_by_root[-1])
        out_refs, order_by_root = out_refs[:-1], order_by_root[:-1]
    programs: List[Program] = []
    start = 0
    while start < len(out_refs):
        b = None
        end = start
        while end < len(out_refs):
            trial = _try_group(nodes, node_codes, leaf_codes, scalar_tags, out_refs,
                               order_by_root, start, end + 1, tail, mask)
            if isinstance(trial, _Builder):
                b, end = trial, end + 1
                continue
            if b is None:  # root ``start`` alone does not fit
                return trial
            break
        for k in range(len(b.roots)):
            if b.roots[k] >= 0:  # -1: a masked tail's kept-row count
                b.roots[k] += start
        programs.append(_program(b, tail))
        start = end
    return programs


def _try_group(nodes, node_codes, leaf_codes, scalar_tags, out_refs, order_by_root,
               start, end, tail, mask=None):
    """A builder holding roots ``[start, end)``, or a :class:`Cut` when
    root ``end - 1`` overflowed it alone (``start == end - 1``), or None.
    ``mask`` (a masked tail's (ref, postorder)) is computed first, read by
    every accumulation, and folded last as the kept-row count."""
    flat: List[int] = []
    seen = set()
    orders = ([mask[1]] if mask is not None else []) + list(order_by_root[start:end])
    for order in orders:
        for i in order:
            if i not in seen:
                seen.add(i)
                flat.append(i)
    root_refs = tuple(out_refs[start:end])
    if mask is not None:
        # read by each accumulation and folded once more itself
        root_refs += (mask[0],) * (end - start + 2)
    b = _Builder(nodes, node_codes, leaf_codes, scalar_tags, _uses(nodes, flat, root_refs))
    emitted: List[int] = []
    m = None
    try:
        if mask is not None:
            for i in mask[1]:
                if i not in b.reg_of:
                    b.node(i)
                    emitted.append(i)
            m = (b.value(mask[0])[0], mask[0])
            if len(b.roots) + (end - start) >= MAX_OUTPUTS:
                raise _Overflow("outputs")
        for ref, order in zip(out_refs[start:end], order_by_root[start:end]):
            for i in order:
                if i not in b.reg_of:
                    b.node(i)
                    emitted.append(i)
            if tail is None:
                operand, code, _ = b.value(ref)
                if len(b.roots) >= MAX_OUTPUTS:
                    raise _Overflow("outputs")
                b.emit(STORE, code, NO_OPERAND, operand, aux=len(b.roots))
                b.done_with([ref])
                b.out_dtypes.append(code)
            else:
                _fold_reduce(b, ref, tail, m)
            b.roots.append(len(b.roots))
        if m is not None:
            _fold_reduce(b, mask[0], tail, m)  # the kept-row count
            b.roots.append(-1)
    except _Overflow:
        if end - start > 1:
            return None
        # values computed so far that a later node still needs: materialize
        # them, then they are leaves (at least one node was emitted, and a
        # node takes at most three operands, so the cut makes progress)
        live = [i for i in emitted if b.uses.get(i, 0) > 0]
        return Cut(tuple(live[-MAX_OUTPUTS:]) if live else tuple(emitted[-1:]))
    return b


def tail_mode(tail: Optional[Tuple], second_pass: bool = False) -> int:
    """The kernel's tail mode of a program's tail (``TAIL_M2`` for the
    second pass of a moments tail)."""
    if tail is None or tail[0] != "reduce":
        return TAIL_NONE
    return TAIL_M2 if second_pass else REDUCE_MODES[tail[1]]


def _program(b: _Builder, tail) -> Program:
    instrs = tuple(b.instrs)
    leaf_dtypes = tuple(b.leaf_codes[i] for i in b.leaves)
    out_dtypes = tuple(b.out_dtypes)
    mode = tail_mode(tail)

    def low(m):
        return lower(instrs, leaf_dtypes, len(b.slots), len(out_dtypes), m)

    return Program(
        instrs=instrs,
        leaves=tuple(b.leaves),
        leaf_dtypes=leaf_dtypes,
        slots=tuple(b.slots),
        roots=tuple(b.roots),
        out_dtypes=out_dtypes,
        n_regs=b.n_regs,
        tail=tail,
        kernel=low(mode),
        kernel_m2=low(TAIL_M2) if mode == TAIL_M1 and tail[1] in MOMENT_OPS else None,
    )


def slot_values(program: Program, scalars: Sequence[Any]) -> List[Any]:
    """Each slot's value in its dtype (Python scalars), for this launch."""
    out = []
    for kind, v, code in program.slots:
        out.append(scalar_value(scalars[v] if kind == "scalar" else v, code))
    return out


def slot_bits(program: Program, scalars: Sequence[Any]) -> List[int]:
    return [scalar_bits(scalars[v] if kind == "scalar" else v, code) for kind, v, code in program.slots]


# ---------------------------------------------------------------------- #
# The kernel's encoding: the last step of the compiler
# ---------------------------------------------------------------------- #
#
# ``Program.instrs`` is the semantic program (the plain version walks it).
# :func:`lower` turns it into the code that ``csrc/fused.cu`` runs:
#
# - typed opcodes: each op is specialised by its operand class (``_D``
#   float64, ``_F`` float32, ``_I`` the ints and bool in an int64, wrapped
#   after the op to the width of the instruction's dtype code), a cast by its
#   source class and target, a load by the leaf's dtype, a store by the
#   output's, an accumulation by the tail mode and the class: one switch
#   dispatches and no case branches on a dtype again;
# - each leaf loaded once a row, at the top of the code: one typed load for
#   each run of leaves of one dtype (its ``dt`` is the count), into the
#   first slots;
# - the scalar slots, then the constants that stand for static arguments
#   (``EQI``'s sentinel, ``ROUND``'s scale, ``NANTO``'s fill, ``ROUNDI``'s
#   unit), in one constant area; every operand is a register-file slot
#   (``0 <= o < 128``) or a constant (``0x80 | k``) and nothing else;
# - the previous result in a hardware register: an operand that is the value
#   the last result-producing instruction gave reads that register
#   (``ACC_OPERAND``), and a value that no later instruction reads from the
#   register file is never written there (its ``dst`` is ``ACC_OPERAND``),
#   so a chain ``e = e <op> x`` moves one operand through shared memory, not
#   three;
# - register-file slots allocated by liveness over the typed code (a leaf's
#   slot is freed after its last use like any value's).
#
# The kernel keeps its register file in shared memory, ``[slot][rows in
# flight]`` of 8 bytes, and runs each decoded instruction over
# ``rows_per_thread`` rows of its thread (rows ``tile + tid + k * threads``);
# :func:`lower` picks the block size and ``rows_per_thread`` against the
# shared memory the program needs.

KOPS = (
    "LD_U8", "LD_I8", "LD_I16", "LD_I32", "LD_I64", "LD_F32", "LD_F64",
    "ST_B", "ST_I8", "ST_I16", "ST_I32", "ST_I64", "ST_U8", "ST_F32", "ST_F64",
    "MOV", "CVT_D_F", "CVT_F_D", "CVT_I_D", "CVT_I_F", "CVT_D_B", "CVT_F_B", "CVT_I_B", "WRAP",
    "CVT_D_I8", "CVT_D_I16", "CVT_D_I32", "CVT_D_I64", "CVT_D_U8",
    "CVT_F_I8", "CVT_F_I16", "CVT_F_I32", "CVT_F_I64", "CVT_F_U8",
    "ADD_D", "ADD_F", "ADD_I", "SUB_D", "SUB_F", "SUB_I", "MUL_D", "MUL_F", "MUL_I",
    "DIV_D", "DIV_F", "FDIV_D", "FDIV_F", "FDIV_I", "MOD_D", "MOD_F", "MOD_I",
    "POW_D", "POW_F", "POWS_D", "POWS_F",
    "EQ_D", "EQ_F", "EQ_I", "NE_D", "NE_F", "NE_I", "LT_D", "LT_F", "LT_I",
    "LE_D", "LE_F", "LE_I", "GT_D", "GT_F", "GT_I", "GE_D", "GE_F", "GE_I",
    "AND", "OR", "XOR",
    "NEG_D", "NEG_F", "NEG_I", "ABS_D", "ABS_F", "ABS_I", "NOT_B", "INV_I",
    "ISNAN_D", "ISNAN_F", "ISNAN_I", "NOTNAN_D", "NOTNAN_F", "NOTNAN_I",
    "SQRT_D", "SQRT_F", "EXP_D", "EXP_F", "LOG_D", "LOG_F", "LOG2_D", "LOG2_F",
    "LOG10_D", "LOG10_F", "SIN_D", "SIN_F", "COS_D", "COS_F", "TAN_D", "TAN_F",
    "TANH_D", "TANH_F", "FLOOR_D", "FLOOR_F", "CEIL_D", "CEIL_F",
    "SIGN_D", "SIGN_F", "SIGN_I",
    "RUP_D", "RUP_F", "RDN_D", "RDN_F", "RINT_D", "RINT_F", "ROUNDI",
    "FILLNA_D", "FILLNA_F",
    "CLIPLO_D", "CLIPLO_F", "CLIPLO_I", "CLIPHI_D", "CLIPHI_F", "CLIPHI_I",
    "SEL", "MIN_D", "MIN_F", "MIN_I", "MAX_D", "MAX_F", "MAX_I",
    "ACC_SUM_D", "ACC_SUM_F", "ACC_SUM_I", "ACC_PROD_D", "ACC_PROD_F", "ACC_PROD_I",
    "ACC_MIN_D", "ACC_MIN_F", "ACC_MIN_I", "ACC_MAX_D", "ACC_MAX_F", "ACC_MAX_I",
    "ACC_NZ_D", "ACC_NZ_F", "ACC_NZ_I", "ACC_M2_D",
)
KOP = {name: i + 1 for i, name in enumerate(KOPS)}
_KOP_NAMES = {v: k for k, v in KOP.items()}

# the kernel's caps and launch shape (csrc/fused.cu)
MAX_CODE = MAX_INSTR + MAX_LEAVES  # the leaf loads come on top of a program
MAX_CONSTS = 96  # scalar slots, then the constants of static arguments
MAX_SLOTS = 128
CONST_BIT = 0x80
ACC_OPERAND = 0xFE  # the previous result (an operand), or a result kept there alone (a dst)
NONE_OPERAND = 0xFF
THREADS = 256
MERGE_THREADS = 256
MAX_BLOCKS = 8192
ROWS_PER_THREAD = (4, 2, 1)
# a launch takes the most rows a thread (two at most for a program with a
# long routine) whose block stays within SMEM_TARGET bytes of shared memory;
# past SMEM_MAX (an H100 block's opt-in shared memory) the block shrinks
SMEM_TARGET = 96 * 1024
SMEM_MAX = 232448
# the long opcodes (csrc/fused.cu: slow_op's, and the int division that the
# kernel runs inline), and the weight
# of one against an inline instruction when a program's work is set against
# its loads (a program prefetches the next tile's leaves where its work is
# at most PREFETCH_WORK a leaf)
SLOW_KOPS = frozenset(["FDIV_D", "FDIV_F", "FDIV_I", "MOD_D", "MOD_F", "MOD_I", "POW_D", "POW_F", "POWS_D",
                       "POWS_F", "ROUNDI"] + [f"{m}_{c}" for m in ("EXP", "LOG", "LOG2", "LOG10", "SIN", "COS",
                                                                "TAN", "TANH") for c in "DF"])
SLOW_WEIGHT = 8
PREFETCH_WORK = 4

_NAME = {BOOL: "B", 1: "I8", 2: "I16", 3: "I32", I64: "I64", 5: "U8", F32: "F32", F64: "F64"}
_TYPED = {
    ADD: "ADD", SUB: "SUB", MUL: "MUL", TDIV: "DIV", FDIV: "FDIV", MOD: "MOD", EQ: "EQ", NE: "NE",
    LT: "LT", LE: "LE", GT: "GT", GE: "GE", NEG: "NEG", ABS: "ABS", ISNAN: "ISNAN", NOTNAN: "NOTNAN",
    SQRT: "SQRT", EXP: "EXP", LOG: "LOG", LOG2: "LOG2", LOG10: "LOG10", SIN: "SIN", COS: "COS",
    TAN: "TAN", TANH: "TANH", FLOOR: "FLOOR", CEIL: "CEIL", SIGN: "SIGN", FILLNA: "FILLNA",
    CLIPLO: "CLIPLO", CLIPHI: "CLIPHI", MIN: "MIN", MAX: "MAX",
}
_UNTYPED = {AND: "AND", OR: "OR", XOR: "XOR", SEL: "SEL", ROUNDI: "ROUNDI"}
_ACC_MODE = {TAIL_SUM: "SUM", TAIL_M1: "SUM", TAIL_PROD: "PROD", TAIL_MIN: "MIN", TAIL_MAX: "MAX",
             TAIL_NZ: "NZ", TAIL_M2: "M2"}


def op_class(code: int) -> str:
    """The operand class of a dtype code: D, F or I."""
    return "D" if code == F64 else "F" if code == F32 else "I"


def _cast_kop(frm: int, to: int) -> str:
    cf, ct = op_class(frm), op_class(to)
    if frm == to:
        return "MOV"
    if to == BOOL:
        return f"CVT_{cf}_B"
    if ct == "I":
        return "WRAP" if cf == "I" else f"CVT_{cf}_{_NAME[to]}"
    return f"CVT_{cf}_{ct}"


def _imm_const(op: int, dt: int, aux: int, imm: int) -> Optional[int]:
    """The 8 bytes (as an int64) of the constant that the kernel's code
    reads for an instruction's static argument, or None."""
    if op in (EQI, NEI, ROUNDI):
        return imm
    if (op == ROUND and aux != 0) or op == NANTO:
        return scalar_bits(bits_double(imm), dt)
    return None


class Lowered(NamedTuple):
    """A program in the kernel's encoding, with the launch shape."""

    code: bytes  # 8 bytes an instruction: op, dt, dst, a, b, c, aux (u16)
    n_code: int
    n_load: int  # the leaf loads at the head of the code
    slow: bool  # it has an opcode of SLOW_KOPS
    prefetch: bool  # the next tile's wide leaves arrive while a tile runs
    fixed: Tuple[int, ...]  # the constants after the program's scalar slots
    n_slots: int  # register-file slots
    mode: int  # the tail mode the accumulations are typed by
    threads: int
    rows_per_thread: int
    smem_bytes: int


def pack_kinstr(op: int, dt: int, dst: int, a: int, b: int, c: int, aux: int) -> bytes:
    """The 8 bytes of one kernel instruction (csrc/fused.cu: struct KInstr)."""
    return struct.pack("<6BH", op, dt, dst, a, b, c, aux)


def launch_shape(n_slots: int, n_leaves: int, n_consts: int, n_out: int, mode: int,
                 rows_per_thread: Optional[int] = None, prefetch: bool = False,
                 slow: bool = True, threads: Optional[int] = None) -> Tuple[int, int, int]:
    """(threads, rows a thread, shared bytes) of a block: 256 threads with
    the most rows a thread (of :data:`ROWS_PER_THREAD`, at most two with a
    long routine, or the one given) whose block stays within
    :data:`SMEM_TARGET`; a program that needs more than :data:`SMEM_MAX` at
    one row a thread takes blocks of 128, 64 or 32 threads (the shapes
    ``csrc/fused.cu`` is built for), or of the ``threads`` given (one row a
    thread below 256).  Shared memory holds the constants, a moments tail's
    means, the accumulators (three a thread and output) and the register
    file (a slot a row in flight, and with ``prefetch`` a second copy of the
    leaves' slots that receives the next tile's leaves), 8 bytes each."""

    def smem(threads, k):
        acc = 3 * n_out * threads if mode != TAIL_NONE else 0
        copy = n_leaves if prefetch else 0
        return 8 * (n_consts + (n_out if mode == TAIL_M2 else 0) + acc + (n_slots + copy) * threads * k)

    if threads is not None and threads != THREADS:
        if threads not in (128, 64, 32) or rows_per_thread not in (None, 1) or smem(threads, 1) > SMEM_MAX:
            raise ValueError(f"fused program: no build of {threads} threads and {rows_per_thread} rows a "
                             f"thread within {SMEM_MAX} bytes of shared memory")
        return threads, 1, smem(threads, 1)
    choices = ROWS_PER_THREAD[1:] if slow else ROWS_PER_THREAD
    for k in (rows_per_thread,) if rows_per_thread else choices:
        if smem(THREADS, k) <= SMEM_TARGET:
            break
    if smem(THREADS, k) <= SMEM_MAX:
        return THREADS, k, smem(THREADS, k)
    if k != 1:
        raise ValueError(f"fused program: {k} rows a thread need {smem(THREADS, k)} bytes of shared memory")
    threads = THREADS
    while threads > 32 and smem(threads, 1) > SMEM_MAX:
        threads //= 2
    return threads, 1, smem(threads, 1)


def grid(n: int, low: Lowered) -> int:
    """The kernel's blocks for ``n`` rows: one tile of ``threads *
    rows_per_thread`` rows a block, at most :data:`MAX_BLOCKS` (it depends
    on n and the program alone, never on the card)."""
    tile = low.threads * low.rows_per_thread
    return int(min(max(-(-n // tile), 1), MAX_BLOCKS))


def lower(instrs: Sequence[Tuple[int, ...]], leaf_dtypes: Sequence[int], n_scalar_slots: int,
          n_out: int, mode: int, rows_per_thread: Optional[int] = None, threads: Optional[int] = None,
          prefetch: Optional[bool] = None) -> Lowered:
    """The kernel's code for a semantic program (its ``instrs``, leaf dtypes,
    number of scalar slots and outputs) run with tail ``mode``.  The launch
    shape (``rows_per_thread``, ``threads``) and ``prefetch`` are chosen
    unless given."""
    fixed: Dict[int, int] = {}  # constant bits -> index in the constant area
    code: List[List[Any]] = []  # [kop, dt, dst, a, b, c, aux]; operands ("v", id) / ("c", k) / None
    n_values = 0

    def new_value():
        nonlocal n_values
        n_values += 1
        return ("v", n_values - 1)

    def const(bits: int):
        if bits not in fixed:
            fixed[bits] = n_scalar_slots + len(fixed)
        return ("c", fixed[bits])

    leaf_value: Dict[int, Tuple] = {}
    for ins in instrs:  # each leaf once (the program numbers them by first use)
        for o in ins[3:6]:
            if o != NO_OPERAND and o >= LEAF_BASE and o - LEAF_BASE not in leaf_value:
                leaf_value[o - LEAF_BASE] = new_value()
    loads: List[Tuple[str, int]] = []  # (load, first leaf) of each run of leaves of one dtype
    for k in sorted(leaf_value):
        ld = "LD_U8" if leaf_dtypes[k] == BOOL else "LD_" + _NAME[leaf_dtypes[k]]
        if not loads or loads[-1][0] != ld:
            loads.append((ld, k))
    for j, (ld, k) in enumerate(loads):
        end = loads[j + 1][1] if j + 1 < len(loads) else len(leaf_value)
        # one load of leaves k..end-1 into consecutive slots: its dt is the count
        code.append([KOP[ld], end - k, leaf_value[k], None, None, None, k])
        code[-1].append([leaf_value[i] for i in range(k, end)])
    reg_value: Dict[int, Tuple] = {}

    def ref(o):
        if o == NO_OPERAND:
            return None
        if o >= LEAF_BASE:
            return leaf_value[o - LEAF_BASE]
        if o >= SCALAR_BASE:
            return ("c", o - SCALAR_BASE)
        return reg_value[o]

    for op, dt, dst, a, b, c, aux, imm in instrs:
        cls = op_class(dt)
        ra, rb, rc = ref(a), ref(b), ref(c)
        if op == STORE:
            code.append([KOP["ST_" + _NAME[dt]], dt, None, ra, None, None, aux])
            continue
        if op == ACC:  # b: a masked tail's mask
            code.append([KOP[f"ACC_{_ACC_MODE[mode]}_{cls}"], dt, None, ra, rb, None, aux])
            continue
        if op == CAST:
            name = _cast_kop(dt, aux)
        elif op in (EQI, NEI):
            name, rb = ("EQ_I" if op == EQI else "NE_I"), const(imm)
        elif op == INV:
            name = "NOT_B" if dt == BOOL else "INV_I"
        elif op == POW:
            name = ("POWS_" if rb is not None and rb[0] == "c" else "POW_") + cls
        elif op == ROUND:
            d = aux - (1 << 16) if aux >= 1 << 15 else aux
            name = ("RUP_" if d > 0 else "RDN_" if d < 0 else "RINT_") + cls
            rb = const(_imm_const(op, dt, aux, imm)) if d else None
        elif op == ROUNDI:
            name, rb = "ROUNDI", const(imm)
        elif op == NANTO:
            name, rb = "FILLNA_" + cls, const(_imm_const(op, dt, aux, imm))
        elif op in _UNTYPED:
            name = _UNTYPED[op]
        else:
            name = f"{_TYPED[op]}_{cls}"
        v = new_value()
        code.append([KOP[name], dt, v, ra, rb, rc, aux])
        reg_value[dst] = v

    # an operand that is the previous result reads the kernel's register
    # (a load writes the register file alone)
    n_loads = len(loads)
    prev = None
    for ins in code[n_loads:]:
        for j in (3, 4, 5):
            if ins[j] is not None and ins[j] == prev:
                ins[j] = ("acc", prev[1])
        if ins[2] is not None:
            prev = ins[2]

    # slots by liveness over the typed code: an operand's slot is free for
    # the value that the same instruction defines (each row of a thread reads
    # its operands before it writes the result); a value read only from the
    # register gets no slot
    last = {}
    for i, ins in enumerate(code):
        for r in ins[3:6]:
            if r is not None and r[0] == "v":
                last[r[1]] = i
    free: List[int] = []
    slot_of: Dict[int, int] = {}
    for ins in code[:n_loads]:  # the leaves take the first slots, in order
        for v in ins.pop():
            slot_of[v[1]] = len(slot_of)
    n_slots = len(slot_of)
    for i, ins in enumerate(code):
        if i < n_loads:
            continue
        for r in ins[3:6]:
            if r is not None and r[0] == "v" and last[r[1]] == i and r[1] in slot_of:
                if slot_of[r[1]] not in free:
                    free.append(slot_of[r[1]])
        if ins[2] is not None and ins[2][1] in last:
            vid = ins[2][1]
            if free:
                s = min(free)
                free.remove(s)
            else:
                s, n_slots = n_slots, n_slots + 1
            slot_of[vid] = s
    if n_slots > MAX_SLOTS or len(code) > MAX_CODE or n_scalar_slots + len(fixed) > MAX_CONSTS:
        raise ValueError(f"fused program: {n_slots} slots, {len(code)} instructions, "
                         f"{n_scalar_slots + len(fixed)} constants exceed the kernel's caps")

    def enc(r):
        if r is None:
            return NONE_OPERAND
        if r[0] == "acc":
            return ACC_OPERAND
        return CONST_BIT | r[1] if r[0] == "c" else slot_of[r[1]]

    def enc_dst(r):
        return NONE_OPERAND if r is None else slot_of.get(r[1], ACC_OPERAND)

    packed = b"".join(
        pack_kinstr(kop, dt, enc_dst(dst), enc(a), enc(b), enc(c), aux) for kop, dt, dst, a, b, c, aux in code
    )
    # a program whose work is short against its loads prefetches the next
    # tile's wide (float64, int64, float32, int32) leaves; a long one would only
    # lose occupancy to the second copy of its leaf slots
    slow = any(_KOP_NAMES[ins[0]] in SLOW_KOPS for ins in code)
    if prefetch is None:
        work = sum(SLOW_WEIGHT if _KOP_NAMES[ins[0]] in SLOW_KOPS else 1 for ins in code[n_loads:])
        wide = any(_KOP_NAMES[ins[0]] in ("LD_F64", "LD_I64", "LD_F32", "LD_I32") for ins in code[:n_loads])
        prefetch = wide and work <= PREFETCH_WORK * len(leaf_value)
    threads, k, smem = launch_shape(n_slots, len(leaf_value), n_scalar_slots + len(fixed), n_out, mode,
                                    rows_per_thread, prefetch, slow, threads)
    return Lowered(packed, len(code), n_loads, slow, prefetch, tuple(fixed), n_slots, mode, threads, k, smem)


def relower(program: Program, second_pass: bool = False, **shape: Any) -> Lowered:
    """A program's kernel encoding, with the launch shape or the prefetch
    given by ``shape`` (:func:`lower`'s ``rows_per_thread``, ``threads`` and
    ``prefetch``) instead of chosen: for measurements and tests, which hold
    each shape against the plain version (kept, so a timed launch does not
    lower again)."""
    if all(v is None for v in shape.values()):
        return program.kernel_m2 if second_pass else program.kernel
    return _relowered(program, second_pass, tuple(sorted(shape.items())))


@functools.lru_cache(maxsize=64)
def _relowered(program: Program, second_pass: bool, shape: Tuple[Tuple[str, Any], ...]) -> Lowered:
    mode = (program.kernel_m2 if second_pass else program.kernel).mode
    return lower(program.instrs, program.leaf_dtypes, len(program.slots), len(program.out_dtypes), mode,
                 **dict(shape))


_SEMANTIC = {**{v: k for k, v in _TYPED.items()}, **{v: k for k, v in _UNTYPED.items()},
             "NOT_B": INV, "INV": INV, "POWS": POW, "POW": POW}


def decode(low: Lowered, n_scalar_slots: int) -> List[Tuple]:
    """The semantic instructions that a lowered program computes:
    ``(op, dt, dst, a, b, c, aux, imm)`` with each operand as ``("r",
    slot)``, ``("a", i)`` (the value of instruction i kept in the kernel's
    register alone), ``("s", scalar slot)`` or ``("l", leaf)`` (a leaf
    load's value reads as its leaf), the leaf loads themselves left out; the
    inverse of :func:`lower` up to the naming of registers."""
    out: List[Tuple] = []
    slot_leaf: Dict[int, int] = {}
    prev = None  # what the kernel's register holds

    def opnd(o):
        if o == NONE_OPERAND:
            return None
        if o == ACC_OPERAND:
            return prev
        if o & CONST_BIT:
            return ("s", o & 0x7F)
        return ("l", slot_leaf[o]) if o in slot_leaf else ("r", o)

    def const_bits(o):
        return low.fixed[(o & 0x7F) - n_scalar_slots]

    def is_fixed(o):
        return o not in (NONE_OPERAND, ACC_OPERAND) and o & CONST_BIT and (o & 0x7F) >= n_scalar_slots

    for i in range(low.n_code):
        kop, dt, dst, a, b, c, aux = struct.unpack_from("<6BH", low.code, 8 * i)
        name = _KOP_NAMES[kop]
        ra, rb, rc = opnd(a), opnd(b), opnd(c)
        slot_leaf.pop(dst, None)
        if name.startswith("LD_"):
            for j in range(dt):  # dt leaves from leaf aux into slots from dst
                slot_leaf[dst + j] = aux + j
            continue
        imm, d_ref = 0, ("r", dst) if dst != ACC_OPERAND else ("a", i)
        if dst != NONE_OPERAND:
            prev = d_ref
        if name.startswith("ST_"):
            out.append((STORE, dt, None, ra, None, None, aux, 0))
            continue
        if name.startswith("ACC_"):
            out.append((ACC, dt, None, ra, rb, None, aux, 0))
            continue
        base = name.rsplit("_", 1)[0] if name[-2:] in ("_D", "_F", "_I") else name
        if name == "MOV" or name == "WRAP" or name.startswith("CVT_"):
            op = CAST
        elif base in ("RUP", "RDN", "RINT"):
            op = ROUND
            d = aux - (1 << 16) if aux >= 1 << 15 else aux
            imm = double_bits(float(10.0 ** abs(d)))
            rb = None
        elif base in ("EQ", "NE") and is_fixed(b):
            op, imm, rb = (EQI if base == "EQ" else NEI), const_bits(b), None
        elif name == "ROUNDI":
            op, imm, rb = ROUNDI, const_bits(b), None
        elif base == "FILLNA" and is_fixed(b):
            bits = const_bits(b)
            fill = bits_double(bits) if dt == F64 else struct.unpack("<f", struct.pack("<I", bits & 0xFFFFFFFF))[0]
            op, imm, rb = NANTO, double_bits(fill), None
        else:
            op = _SEMANTIC[base]
        out.append((op, dt, d_ref, ra, rb, rc, aux, imm))
    return out
