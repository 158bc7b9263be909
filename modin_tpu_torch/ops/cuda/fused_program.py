"""The program compiler of the fused elementwise kernel (host only).

A deferred chain of elementwise ops (``ops/lazy.py``) is linearized into a
postorder list of nodes; this module turns such a forest, plus an optional
reduction tail, into a small register program that ``csrc/fused.cu``
interprets (one launch per consumer) and that
``fused_kernels.run_program_plain`` walks with torch tensors as registers.

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
"""

from __future__ import annotations

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
                   "clip_lower", "clip_upper", "astype"])


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

    @property
    def code(self) -> bytes:
        return b"".join(pack_instr(i) for i in self.instrs)


def pack_instr(ins: Tuple[int, ...]) -> bytes:
    """The 16 bytes of one instruction (csrc/fused.cu: struct Instr)."""
    op, dt, dst, a, b, c, aux, imm = ins
    return struct.pack("<6BHq", op, dt, dst, a, b, c, aux, imm)


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


def _result_code(x: Any, y: Any) -> int:
    from modin_tpu_torch.ops.elementwise import _result_dtype
    from modin_tpu_torch.utils import torch_dtype

    return DTYPE_CODES[torch_dtype(_result_dtype(x, y))]


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
            dt = _result_code(self.meta_of(x), self.meta_of(y))
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


def _fold_reduce(b: _Builder, ref, tail) -> None:
    """Fold one root into its column accumulator."""
    _, op, _skipna, _ddof, cast_bool = tail
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
    b.emit(ACC, code, NO_OPERAND, operand, aux=len(b.roots))
    if tmp:
        b.release(operand)
    b.done_with([ref])
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
    programs: List[Program] = []
    start = 0
    while start < len(out_refs):
        b = None
        end = start
        while end < len(out_refs):
            trial = _try_group(nodes, node_codes, leaf_codes, scalar_tags, out_refs,
                               order_by_root, start, end + 1, tail)
            if isinstance(trial, _Builder):
                b, end = trial, end + 1
                continue
            if b is None:  # root ``start`` alone does not fit
                return trial
            break
        for k in range(len(b.roots)):
            b.roots[k] += start
        programs.append(_program(b, tail))
        start = end
    return programs


def _try_group(nodes, node_codes, leaf_codes, scalar_tags, out_refs, order_by_root,
               start, end, tail):
    """A builder holding roots ``[start, end)``, or a :class:`Cut` when
    root ``end - 1`` overflowed it alone (``start == end - 1``), or None."""
    flat: List[int] = []
    seen = set()
    for order in order_by_root[start:end]:
        for i in order:
            if i not in seen:
                seen.add(i)
                flat.append(i)
    b = _Builder(nodes, node_codes, leaf_codes, scalar_tags, _uses(nodes, flat, out_refs[start:end]))
    emitted: List[int] = []
    try:
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
                _fold_reduce(b, ref, tail)
            b.roots.append(len(b.roots))
    except _Overflow:
        if end - start > 1:
            return None
        # values computed so far that a later node still needs: materialize
        # them, then they are leaves (at least one node was emitted, and a
        # node takes at most three operands, so the cut makes progress)
        live = [i for i in emitted if b.uses.get(i, 0) > 0]
        return Cut(tuple(live[-MAX_OUTPUTS:]) if live else tuple(emitted[-1:]))
    return b


def _program(b: _Builder, tail) -> Program:
    return Program(
        instrs=tuple(b.instrs),
        leaves=tuple(b.leaves),
        leaf_dtypes=tuple(b.leaf_codes[i] for i in b.leaves),
        slots=tuple(b.slots),
        roots=tuple(b.roots),
        out_dtypes=tuple(b.out_dtypes),
        n_regs=b.n_regs,
        tail=tail,
    )


def slot_values(program: Program, scalars: Sequence[Any]) -> List[Any]:
    """Each slot's value in its dtype (Python scalars), for this launch."""
    out = []
    for kind, v, code in program.slots:
        out.append(scalar_value(scalars[v] if kind == "scalar" else v, code))
    return out


def slot_bits(program: Program, scalars: Sequence[Any]) -> List[int]:
    return [scalar_bits(scalars[v] if kind == "scalar" else v, code) for kind, v, code in program.slots]
