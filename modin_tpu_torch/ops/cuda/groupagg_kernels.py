"""CUDA kernel for the whole-plan fused groupby: grouped aggregation by slot.

:func:`groupagg` aggregates up to 32 value columns by an int32 slot column
(``key - kmin`` for kept rows, the overflow slot ``G`` for dropped ones) in
one launch of ``csrc/groupagg.cu`` plus its merge, the counterpart of the
scatter body of ``modin_tpu/ops/groupby.py::fused_group_agg``.  It returns
the merged tables, ``[1 + 2 * columns, G + 1]`` int64: the slot sizes, then
for each column the bits of its aggregate (an int64, or a float64 for a
float column) and its non-NaN count.  Rows in the overflow slot fold
nothing: that slot keeps its initial values.

The order is fixed by :func:`launch_geometry` (it depends on n and the table
size alone): block b folds its chunk of rows in row order, slot by slot, and
the merge folds the block partials in block order.  On a CUDA tensor
:func:`groupagg` launches the kernel (building it on first use) and raises
when it cannot; on CPU tensors it computes the plain version,
:func:`groupagg_plain`, which takes the same order (a stable sort by chunk
and slot, a left fold of each run of rows, the chunks folded in order) where
the result depends on it, so the two agree bit for bit.  ``LAUNCHES`` counts
kernel launches (the merge included).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from modin_tpu_torch.ops.cuda.fused_program import DTYPE_CODES

LAUNCHES = 0

AGGS = ("sum", "prod", "count", "mean", "min", "max")
MAX_COLS = 32
MAX_BLOCKS = 4096
MIN_CHUNK = 2048  # the fewest rows a block takes
SMEM_TABLES = 48 * 1024  # tables up to this size sit in shared memory

_LIB_NAME = "groupagg"
_bound = False


class GroupAggParams(ctypes.Structure):
    """csrc/groupagg.cu: struct GroupAggParams, passed by value."""

    _fields_ = [
        ("n", ctypes.c_int64), ("chunk", ctypes.c_int64), ("g1", ctypes.c_int32),
        ("n_cols", ctypes.c_int32), ("agg", ctypes.c_int32), ("in_shared", ctypes.c_int32),
        ("slot", ctypes.c_void_p), ("partial", ctypes.c_void_p),
        ("col", ctypes.c_void_p * MAX_COLS), ("col_dt", ctypes.c_uint8 * MAX_COLS),
    ]


def _lib() -> ctypes.CDLL:
    global _bound
    from modin_tpu_torch.ops.cuda.build import load

    lib = load(_LIB_NAME)
    if not _bound:
        lib.groupagg_run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
        lib.groupagg_run.restype = ctypes.c_int
        lib.groupagg_params_bytes.argtypes = []
        lib.groupagg_params_bytes.restype = ctypes.c_int
        lib.groupagg_error_string.argtypes = [ctypes.c_int]
        lib.groupagg_error_string.restype = ctypes.c_char_p
        size = lib.groupagg_params_bytes()
        if size != ctypes.sizeof(GroupAggParams):
            raise RuntimeError(f"groupagg kernel: the C parameter block is {size} bytes, "
                               f"the ctypes one {ctypes.sizeof(GroupAggParams)}")
        _bound = True
    return lib


def launch_geometry(n: int, g1: int, n_cols: int) -> Tuple[int, int, bool]:
    """(blocks, rows a block, tables in shared memory) for ``n`` rows,
    ``g1`` slots and ``n_cols`` columns: at most :data:`MAX_BLOCKS` blocks
    of at least :data:`MIN_CHUNK` rows (a multiple of 32), and no more
    blocks than keep the partial tables within ``max(2 n, 2^24)`` entries."""
    rows = 1 + 2 * n_cols
    budget = max(2 * n, 1 << 24)
    blocks = max(1, min(MAX_BLOCKS, -(-n // MIN_CHUNK), budget // (rows * g1)))
    chunk = -(-max(n, 1) // blocks)
    chunk = -(-chunk // 32) * 32
    blocks = max(1, -(-n // chunk))
    return blocks, chunk, rows * g1 * 8 <= SMEM_TABLES


def _check(slot: torch.Tensor, cols: Sequence[torch.Tensor], agg: str, g1: int) -> None:
    if agg not in AGGS:
        raise ValueError(f"groupagg: no aggregation {agg!r} (one of {AGGS})")
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"groupagg: 1 to {MAX_COLS} value columns, got {len(cols)}")
    if slot.dtype != torch.int32 or slot.dim() != 1:
        raise ValueError(f"groupagg: the slot column must be 1-D int32, got {slot.dtype} {tuple(slot.shape)}")
    if g1 < 2:
        raise ValueError(f"groupagg: at least two table slots, got {g1}")
    n = slot.shape[0]
    for c in cols:
        if c.dtype not in DTYPE_CODES:
            raise ValueError(f"groupagg: a value column of {c.dtype} is not taken")
        if c.dim() != 1 or c.shape[0] != n:
            raise ValueError(f"groupagg: a value column must be 1-D of {n} rows, got {tuple(c.shape)}")
        if c.device != slot.device:
            raise ValueError("groupagg: the columns lie on different devices")


def groupagg(agg: str, slot: torch.Tensor, cols: Sequence[torch.Tensor], g1: int) -> torch.Tensor:
    """The merged tables ``[1 + 2 * len(cols), g1]`` int64 of aggregation
    ``agg`` of ``cols`` by ``slot`` (values in ``[0, g1)``)."""
    global LAUNCHES
    _check(slot, cols, agg, g1)
    if slot.device.type == "cpu":
        return groupagg_plain(agg, slot, cols, g1)
    if slot.device.type != "cuda":
        raise ValueError(f"groupagg kernel: unsupported device {slot.device}")
    n = slot.shape[0]
    blocks, chunk, in_shared = launch_geometry(n, g1, len(cols))
    rows = 1 + 2 * len(cols)
    slot = slot.contiguous()
    cols = [c.contiguous() for c in cols]
    partial = torch.empty((blocks, rows, g1), dtype=torch.int64, device=slot.device)
    out = torch.empty((rows, g1), dtype=torch.int64, device=slot.device)
    p = GroupAggParams()
    p.n, p.chunk, p.g1, p.n_cols = n, chunk, g1, len(cols)
    p.agg, p.in_shared = AGGS.index(agg), int(in_shared)
    p.slot, p.partial = slot.data_ptr(), partial.data_ptr()
    for k, c in enumerate(cols):
        p.col[k] = c.data_ptr()
        p.col_dt[k] = DTYPE_CODES[c.dtype]
    lib = _lib()
    with torch.cuda.device(slot.device):
        stream = torch.cuda.current_stream(slot.device).cuda_stream
        err = lib.groupagg_run(ctypes.byref(p), blocks, rows * g1 * 8 if in_shared else 0,
                               ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.groupagg_error_string(int(err)).decode(errors="replace")
        raise RuntimeError(f"groupagg kernel: launch failed with CUDA error {err}: {msg}")
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------------- #
# The plain version
# ---------------------------------------------------------------------- #


def _init(agg: str, fl: bool) -> float:
    if agg == "prod":
        return 1.0 if fl else 1
    if agg == "min":
        return float("inf") if fl else torch.iinfo(torch.int64).max
    if agg == "max":
        return float("-inf") if fl else torch.iinfo(torch.int64).min
    return 0.0 if fl else 0


def _fold(agg: str, v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if agg in ("sum", "mean"):
        return v + x
    if agg == "prod":
        return v * x
    if agg == "min":
        return torch.where(x < v, x, v)
    return torch.where(v < x, x, v)


def _ordered_float(agg: str, x: torch.Tensor, slot: torch.Tensor, pos: torch.Tensor, g1: int,
                   chunk: int, blocks: int) -> torch.Tensor:
    """A float64 sum or product by slot in the kernel's order (``pos``: each
    value's row): each chunk's rows of a slot folded left in row order, then
    the chunks in order."""
    dev = x.device
    key = (pos // chunk) * g1 + slot.to(torch.int64)
    order = torch.argsort(key, stable=True)
    ks, xs = key[order], x[order]
    part = torch.full((blocks * g1,), _init(agg, True), dtype=torch.float64, device=dev)
    if ks.shape[0]:
        new = torch.ones_like(ks, dtype=torch.bool)
        new[1:] = ks[1:] != ks[:-1]
        starts = torch.nonzero(new).flatten()
        lengths = torch.diff(torch.cat([starts, torch.tensor([ks.shape[0]], device=dev)]))
        acc = torch.full((starts.shape[0],), _init(agg, True), dtype=torch.float64, device=dev)
        for j in range(int(lengths.max())):
            alive = torch.nonzero(lengths > j).flatten()
            acc[alive] = _fold(agg, acc[alive], xs[starts[alive] + j])
        part[ks[starts]] = acc
    part = part.view(blocks, g1)
    v = torch.full((g1,), _init(agg, True), dtype=torch.float64, device=dev)
    for b in range(blocks):
        v = _fold(agg, v, part[b])
    return v


def _first_extreme(agg: str, x: torch.Tensor, slot: torch.Tensor, g1: int) -> torch.Tensor:
    """float64 min/max by slot, the earliest row of equal values kept (the
    sign of a zero, as the kernel's order keeps it)."""
    n = x.shape[0]
    init = _init(agg, True)
    idx = slot.to(torch.int64)
    ext = torch.full((g1,), init, dtype=torch.float64, device=x.device)
    ext.scatter_reduce_(0, idx, x, "amin" if agg == "min" else "amax", include_self=True)
    at = x == ext[idx]
    rows = torch.arange(n, device=x.device)
    first = torch.full((g1,), n, dtype=torch.int64, device=x.device)
    first.scatter_reduce_(0, idx[at], rows[at], "amin", include_self=True)
    found = first < n
    return torch.where(found, x[first.clamp(max=max(n - 1, 0))] if n else ext, ext)


def groupagg_plain(agg: str, slot: torch.Tensor, cols: Sequence[torch.Tensor], g1: int) -> torch.Tensor:
    """Plain torch version of :func:`groupagg` on the columns' device."""
    _check(slot, cols, agg, g1)
    n = slot.shape[0]
    dev = slot.device
    blocks, chunk, _ = launch_geometry(n, g1, len(cols))
    idx = slot.to(torch.int64)
    kept = idx != g1 - 1  # the overflow slot's rows fold nothing
    out: List[torch.Tensor] = [torch.bincount(idx[kept], minlength=g1)[:g1].to(torch.int64)]
    for c in cols:
        fl = c.dtype.is_floating_point
        x = c.to(torch.float64 if fl else torch.int64)
        ok = kept & ~torch.isnan(x) if fl else kept
        xi, ii = x[ok], idx[ok]
        nn = torch.bincount(ii, minlength=g1)[:g1].to(torch.int64)
        init = _init(agg, fl)
        if agg == "count":
            value = torch.full((g1,), init, dtype=x.dtype, device=dev)
        elif not fl:
            # int folds are exact in any order (sums and products wrap)
            value = torch.full((g1,), init, dtype=torch.int64, device=dev)
            if agg in ("sum", "mean"):
                value.index_add_(0, ii, xi)
            else:
                how = {"prod": "prod", "min": "amin", "max": "amax"}[agg]
                value.scatter_reduce_(0, ii, xi, how, include_self=True)
        elif agg in ("min", "max"):
            value = _first_extreme(agg, xi, ii, g1)
        else:
            pos = torch.arange(n, device=dev)[ok]
            value = _ordered_float(agg, xi, ii, pos, g1, chunk, blocks)
        out += [value.view(torch.int64) if fl else value, nn]
    return torch.stack(out)


def finish(agg: str, table: torch.Tensor, dtypes: Sequence[torch.dtype]
           ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """(sizes, per-column aggregates, per-column non-NaN counts) from the
    merged tables, on their device: a float aggregate as float64 (NaN for a
    slot with no value, except sum/prod, which give 0/1 there), an int one
    as int64; a mean divides the sum by the count (float64)."""
    sizes = table[0]
    values, counts = [], []
    for j, dt in enumerate(dtypes):
        raw, nn = table[1 + 2 * j], table[2 + 2 * j]
        fl = dt.is_floating_point
        if agg == "count":
            v = nn
        elif agg == "mean":
            s = raw.view(torch.float64) if fl else raw.to(torch.float64)
            v = torch.where(nn > 0, s / nn.to(torch.float64), float("nan"))
        elif fl:
            v = raw.view(torch.float64)
            if agg in ("min", "max"):
                v = torch.where(nn > 0, v, float("nan"))
        else:
            v = raw
        values.append(v)
        counts.append(nn)
    return sizes, values, counts

