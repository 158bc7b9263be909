"""CUDA kernel for fused elementwise chains: one launch runs a register program.

:func:`run_program` runs a :class:`~modin_tpu_torch.ops.cuda.fused_program.
Program` (the compiled form of a deferred chain, ``ops/lazy.py``) over ``n``
rows: ``csrc/fused.cu`` interprets its kernel encoding (``Program.kernel``:
typed opcodes, each leaf loaded once a row, every operand a slot of a
register file in shared memory or a constant), each thread running the
program for ``rows_per_thread`` rows at a time.  It replaces the XLA
programs that the JAX package's ``modin_tpu/ops/lazy.py::run_fused``
compiles per expression over ``modin_tpu/ops/elementwise.py::_build_ops``.
Without a tail it writes the program's outputs; with a reduction tail it
gives each output's merged accumulators, ``[n_out, 3]`` int64 (the bits of
``(value, valid count, NaN count)``, or of the three power sums for
``TAIL_M2``), from deterministic block partials and one merge launch.

On a CUDA tensor :func:`run_program` launches the kernel (building it on
first use) and raises when it cannot; on CPU tensors it computes the plain
version, :func:`run_program_plain`, which walks the semantic instructions
(``Program.instrs``) with torch tensors as registers through the eager ops'
own formulas, and takes the reductions in the kernel's order (each thread
its rows in order, a tree over each block's threads, the blocks in order, a
tree over the merge's threads), so the two agree bit for bit.  ``LAUNCHES``
counts kernel launches (a reduction's merge included), ``ROWS`` the rows
they read, ``PROGRAMS_RUN`` programs run on either route.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from modin_tpu_torch.ops.cuda import fused_program as fp

LAUNCHES = 0
#: rows the launches read
ROWS = 0
PROGRAMS_RUN = 0

_LIB_NAME = "fused"
_bound = False


class FusedParams(ctypes.Structure):
    """csrc/fused.cu: struct FusedParams, passed to the kernel by value."""

    _fields_ = [
        ("n", ctypes.c_int64), ("n_code", ctypes.c_int32), ("n_out", ctypes.c_int32),
        ("n_const", ctypes.c_int32), ("tail", ctypes.c_int32), ("n_slots", ctypes.c_int32),
        ("n_load", ctypes.c_int32), ("prefetch", ctypes.c_int32), ("pad0", ctypes.c_int32),
        ("mean_src", ctypes.c_void_p), ("partial", ctypes.c_void_p),
        ("leaf", ctypes.c_void_p * fp.MAX_LEAVES), ("out", ctypes.c_void_p * fp.MAX_OUTPUTS),
        ("konst", ctypes.c_int64 * fp.MAX_CONSTS), ("code", ctypes.c_uint8 * (8 * fp.MAX_CODE)),
        ("out_dt", ctypes.c_uint8 * fp.MAX_OUTPUTS),
    ]


def _lib() -> ctypes.CDLL:
    global _bound
    from modin_tpu_torch.ops.cuda.build import load

    lib = load(_LIB_NAME)
    if not _bound:
        lib.fused_run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p]
        lib.fused_run.restype = ctypes.c_int
        lib.fused_params_bytes.argtypes = []
        lib.fused_params_bytes.restype = ctypes.c_int
        lib.fused_error_string.argtypes = [ctypes.c_int]
        lib.fused_error_string.restype = ctypes.c_char_p
        size = lib.fused_params_bytes()
        if size != ctypes.sizeof(FusedParams):
            raise RuntimeError(f"fused kernel: the C parameter block is {size} bytes, "
                               f"the ctypes one {ctypes.sizeof(FusedParams)}")
        _bound = True
    return lib


def _outputs(program: fp.Program, n: int, device) -> List[torch.Tensor]:
    if fp.tail_mode(program.tail) != fp.TAIL_NONE:
        return []
    return [torch.empty(n, dtype=fp.CODE_DTYPES[c], device=device) for c in program.out_dtypes]


def _check(leaves: Sequence[torch.Tensor], program: fp.Program, n: int) -> None:
    for t, code in zip(leaves, program.leaf_dtypes):
        if t.device.type != "cuda":
            raise ValueError(f"fused kernel: a leaf is on {t.device}, not on a CUDA device")
        if t.device != leaves[0].device:
            raise ValueError("fused kernel: leaves lie on different devices")
        if fp.DTYPE_CODES.get(t.dtype) != code:
            raise ValueError(f"fused kernel: a leaf is {t.dtype}, the program reads "
                             f"{fp.CODE_DTYPES[code]}")
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"fused kernel: a leaf must be 1-D, contiguous and of {n} rows, "
                             f"got {tuple(t.shape)}")


def run_program(
    program: fp.Program,
    leaves: Sequence[torch.Tensor],
    scalars: Sequence[Any],
    n: int,
    *,
    second_pass: bool = False,
    first: Optional[torch.Tensor] = None,
    device: Optional[torch.device] = None,
    _shape: Optional[Dict[str, Any]] = None,
) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """(outputs, accumulators) of one run of ``program`` over ``n`` rows:
    ``leaves`` are its leaf columns (in ``program.leaves`` order), ``scalars``
    the forest's runtime scalars.  ``second_pass`` runs a moments tail's
    power sums about the means of ``first`` (its first pass's
    accumulators).  ``device`` places a program without leaves.
    ``_shape`` is for measurement only: it overrides the launch shape or the
    prefetch (``fused_program.relower``'s keywords; a tail's order follows it
    on both routes)."""
    global LAUNCHES, PROGRAMS_RUN, ROWS
    dev = leaves[0].device if leaves else (device or torch.device("cpu"))
    PROGRAMS_RUN += 1
    if dev.type == "cpu":
        return run_program_plain(program, leaves, scalars, n, second_pass=second_pass, first=first,
                                 _shape=_shape)
    if dev.type != "cuda":
        raise ValueError(f"fused kernel: unsupported device {dev}")
    _check(leaves, program, n)
    low = fp.relower(program, second_pass, **(_shape or {}))
    outs = _outputs(program, n, dev)
    lib = _lib()
    n_out = len(program.out_dtypes)
    p = FusedParams()
    p.n, p.n_code, p.n_load, p.n_out, p.tail, p.n_slots = n, low.n_code, low.n_load, n_out, low.mode, low.n_slots
    p.prefetch = low.prefetch
    ctypes.memmove(ctypes.addressof(p.code), low.code, len(low.code))
    for k, t in enumerate(leaves):
        p.leaf[k] = t.data_ptr()
    for k, t in enumerate(outs):
        p.out[k] = t.data_ptr()
    for k, code_ in enumerate(program.out_dtypes):
        p.out_dt[k] = code_
    konst = fp.slot_bits(program, scalars) + list(low.fixed)
    p.n_const = len(konst)
    for k, bits in enumerate(konst):
        p.konst[k] = bits
    n_blocks = fp.grid(n, low)
    acc = None
    scratch = None
    if low.mode != fp.TAIL_NONE:
        acc = torch.empty((n_out, 3), dtype=torch.int64, device=dev)
        scratch = torch.empty((n_blocks, n_out, 3), dtype=torch.int64, device=dev)
        p.partial = scratch.data_ptr()
        if low.mode == fp.TAIL_M2:
            if first is None or first.device != dev:
                raise ValueError("fused kernel: the second pass needs the first pass's accumulators")
            p.mean_src = first.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_run(ctypes.byref(p), n_blocks, low.threads, low.rows_per_thread, low.smem_bytes,
                            ctypes.c_void_p(acc.data_ptr() if acc is not None else None),
                            ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.fused_error_string(int(err)).decode(errors="replace")
        raise RuntimeError(f"fused kernel: launch failed with CUDA error {err}: {msg}")
    LAUNCHES += 1
    ROWS += n
    return outs, acc


# ---------------------------------------------------------------------- #
# The plain version
# ---------------------------------------------------------------------- #


def _plain_exec(op, dt, aux, imm, a, b, c, b_is_scalar):
    from modin_tpu_torch.ops import elementwise as ew

    if op == fp.CAST:
        return a.to(fp.CODE_DTYPES[aux])
    if op in (fp.ADD, fp.OR) and dt == fp.BOOL:
        return a | b
    if op == fp.MUL and dt == fp.BOOL:
        return a & b
    if op == fp.ADD:
        return a + b
    if op == fp.SUB:
        return a - b
    if op == fp.MUL:
        return a * b
    if op == fp.TDIV:
        return ew._truediv(a, b)
    if op == fp.FDIV:
        return ew._floordiv(a, b)
    if op == fp.MOD:
        return ew._mod(a, b)
    if op == fp.POW:
        return a ** b
    if op == fp.EQ:
        return a == b
    if op == fp.NE:
        return a != b
    if op == fp.LT:
        return a < b
    if op == fp.LE:
        return a <= b
    if op == fp.GT:
        return a > b
    if op == fp.GE:
        return a >= b
    if op == fp.AND:
        return a & b
    if op == fp.OR:
        return a | b
    if op == fp.XOR:
        return a ^ b
    if op == fp.NEG:
        return torch.neg(a)
    if op == fp.ABS:
        return torch.abs(a)
    if op == fp.INV:
        return torch.bitwise_not(a)
    if op == fp.ISNAN:
        return ew._isna_one(a, False)
    if op == fp.NOTNAN:
        return ~ew._isna_one(a, False)
    if op == fp.EQI:
        return a == imm
    if op == fp.NEI:
        return a != imm
    if op in _MATH_NAMES:
        return ew._MATH_FN[_MATH_NAMES[op]](a)
    if op == fp.ROUND:
        return torch.round(a, decimals=_signed16(aux))
    if op == fp.ROUNDI:
        return ew._round_int(a, _signed16(aux))
    if op == fp.FILLNA:
        return torch.where(torch.isnan(a), b, a)
    if op == fp.CLIPLO:
        return torch.where(a < b, b, a)
    if op == fp.CLIPHI:
        return torch.where(a > b, b, a)
    if op == fp.SEL:
        return torch.where(a, b, c)
    if op == fp.NANTO:
        return torch.where(torch.isnan(a), fp.bits_double(imm), a)
    if op in (fp.MIN, fp.MAX):
        pick_b = (b < a) if op == fp.MIN else (a < b)
        r = torch.where(pick_b, b, a)
        if fp.is_float(dt):
            r = torch.where(torch.isnan(b), b, r)
            r = torch.where(torch.isnan(a), a, r)
        return r
    raise ValueError(f"fused program: unknown opcode {op}")


_MATH_NAMES = {code: name for name, code in fp._MATH.items()}


def _signed16(v: int) -> int:
    return v - (1 << 16) if v >= 1 << 15 else v


def _tree(x: torch.Tensor, combine, init, low: fp.Lowered) -> torch.Tensor:
    """The kernel's reduction of one column of per-row contributions ``x``
    (length n, ``init`` where a row adds nothing): block b takes tiles b, b
    + blocks, ... of ``threads * rows_per_thread`` rows, thread t of it rows
    ``tile + t + k * threads`` for k in order, and folds them in that order;
    each block's threads fold in a tree, then the merge folds the blocks by
    its threads and in a tree.  Returns a 0-d tensor."""
    threads, per = low.threads, low.rows_per_thread
    n_blocks = fp.grid(x.shape[0], low)
    g = n_blocks * threads * per
    m = max(-(-x.shape[0] // g), 1)
    pad = torch.full((m * g,), init, dtype=x.dtype, device=x.device)
    pad[: x.shape[0]] = x
    rows = pad.view(m, n_blocks, per, threads)
    acc = torch.full((n_blocks, threads), init, dtype=x.dtype, device=x.device)
    for i in range(m):
        for k in range(per):
            acc = combine(acc, rows[i, :, k])
    w = threads // 2
    while w:
        acc = combine(acc[:, :w], acc[:, w: 2 * w])
        w //= 2
    part = acc[:, 0]
    km = -(-n_blocks // fp.MERGE_THREADS)
    padm = torch.full((km * fp.MERGE_THREADS,), init, dtype=x.dtype, device=x.device)
    padm[:n_blocks] = part
    mm = torch.full((fp.MERGE_THREADS,), init, dtype=x.dtype, device=x.device)
    for row in padm.view(km, fp.MERGE_THREADS):
        mm = combine(mm, row)
    w = fp.MERGE_THREADS // 2
    while w:
        mm = combine(mm[:w], mm[w: 2 * w])
        w //= 2
    return mm[0]


def _i64_bits(x: torch.Tensor) -> torch.Tensor:
    """A 0-d value as the int64 of its 8 bytes (a float as float64)."""
    if x.dtype.is_floating_point:
        return x.to(torch.float64).reshape(1).view(torch.int64)[0]
    return x.to(torch.int64)


def _plain_acc(mode: int, code: int, x: torch.Tensor, n: int, low: fp.Lowered,
               mean: Optional[torch.Tensor], m: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One output's accumulators, ``[3]`` int64 bits, in the kernel's order
    (``m``: a masked tail's mask; a row where it is false adds nothing)."""
    dev = x.device
    if m is not None:
        m = m.to(dev).expand(x.shape[0]) if m.dim() == 0 else m.to(dev)
    if mode == fp.TAIL_M2:
        ok = ~torch.isnan(x)
        if m is not None:
            ok = ok & m
        d = x - mean
        d2 = d * d
        d3 = d2 * d
        d4 = d3 * d
        return torch.stack([
            _i64_bits(_tree(torch.where(ok, p, 0.0), torch.add, 0.0, low)) for p in (d2, d3, d4)
        ])
    fl = fp.is_float(code)
    if fl:
        xd = x.to(torch.float64)
        isn = torch.isnan(xd)
        # nan: the rows that add nothing (NaN, or masked out)
        nan = isn if m is None else isn | ~m
        cnt, n_nan = (~nan).sum(), (isn if m is None else isn & m).sum()
    else:
        xd = x.to(torch.int64)
        nan = None if m is None else ~m
        cnt = torch.tensor(n, dtype=torch.int64, device=dev) if m is None else m.sum()
        n_nan = torch.tensor(0, dtype=torch.int64, device=dev)
    if mode == fp.TAIL_NZ:
        nz = xd != 0
        v = (nz if nan is None else nz & ~nan).sum()
    elif mode in (fp.TAIL_MIN, fp.TAIL_MAX):
        lo = mode == fp.TAIL_MIN
        if fl:
            init = math.inf if lo else -math.inf
        else:
            init = torch.iinfo(torch.int64).max if lo else torch.iinfo(torch.int64).min
        filled = xd if nan is None else torch.where(nan, init, xd)
        v = (torch.amin if lo else torch.amax)(filled) if n else torch.tensor(init, dtype=xd.dtype)
    elif fl:
        prod = mode == fp.TAIL_PROD
        init = 1.0 if prod else 0.0
        v = _tree(torch.where(nan, init, xd), torch.mul if prod else torch.add, init, low)
    else:  # int sums and products wrap, so their order does not matter
        prod = mode == fp.TAIL_PROD
        if nan is not None:
            xd = torch.where(nan, 1 if prod else 0, xd)
        v = xd.prod() if prod else xd.sum()
    return torch.stack([_i64_bits(v.to(dev)), cnt.to(torch.int64), n_nan.to(torch.int64)])


def run_program_plain(
    program: fp.Program,
    leaves: Sequence[torch.Tensor],
    scalars: Sequence[Any],
    n: Optional[int] = None,
    *,
    second_pass: bool = False,
    first: Optional[torch.Tensor] = None,
    _shape: Optional[Dict[str, Any]] = None,
) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """Plain torch version of :func:`run_program` on the leaves' device
    (its reductions in the order of the launch shape ``_shape`` gives)."""
    if n is None:
        n = leaves[0].shape[0] if leaves else 0
    slots = fp.slot_values(program, scalars)
    regs: List[Any] = [None] * fp.MAX_REGS
    outs: List[Optional[torch.Tensor]] = [None] * len(program.out_dtypes)
    folded: List[Optional[torch.Tensor]] = [None] * len(program.out_dtypes)
    dev = leaves[0].device if leaves else (first.device if first is not None else torch.device("cpu"))

    def get(o):
        if o == fp.NO_OPERAND:
            return None
        if o >= fp.LEAF_BASE:
            return leaves[o - fp.LEAF_BASE]
        if o >= fp.SCALAR_BASE:
            return slots[o - fp.SCALAR_BASE]
        return regs[o]

    for op, dt, dst, a, b, c, aux, imm in program.instrs:
        if op == fp.STORE:
            v = get(a)
            outs[aux] = v.clone() if any(v is t for t in leaves) else v.contiguous()
        elif op == fp.ACC:
            folded[aux] = (get(a), get(b))
        else:
            regs[dst] = _plain_exec(op, dt, aux, imm, get(a), get(b), get(c),
                                    fp.SCALAR_BASE <= b < fp.LEAF_BASE)
    low = fp.relower(program, second_pass, **(_shape or {}))
    mode = low.mode
    if mode == fp.TAIL_NONE:
        return [o if o.dtype == fp.CODE_DTYPES[c] else o.to(fp.CODE_DTYPES[c])
                for o, c in zip(outs, program.out_dtypes)], None
    means = None
    if mode == fp.TAIL_M2:
        means = first[:, 0].contiguous().view(torch.float64) / first[:, 1].to(torch.float64)
    rows = []
    for j, ((x, m), code) in enumerate(zip(folded, program.out_dtypes)):
        mean = means[j] if means is not None else None
        rows.append(_plain_acc(mode, code, x.to(dev), n, low, mean, m))
    return [], torch.stack(rows) if rows else torch.empty((0, 3), dtype=torch.int64, device=dev)
