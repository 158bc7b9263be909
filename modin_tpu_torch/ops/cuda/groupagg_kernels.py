"""CUDA kernel for grouped aggregation by slot: the fused and the eager groupby.

:func:`groupagg` aggregates up to 32 value columns by an int32 or int64 slot
column (``key - kmin`` for the rows a fused groupby keeps and the overflow
slot ``G`` for the ones it drops; the factorized codes of an eager groupby,
``num_groups`` for a NaN key) in one launch of ``csrc/groupagg.cu`` plus its
merge, the counterpart of the scatter body of
``modin_tpu/ops/groupby.py::fused_group_agg``.  It returns the merged
tables, ``[1 + 2 * columns, G + 1]`` int64: the slot sizes, then for each
column the bits of its aggregate (an int64, or a float64 for a float column
and for every column of a mean) and its non-NaN count.  Rows in the overflow
slot fold nothing: that slot keeps its initial values.

The order is fixed by :func:`launch_geometry`, which depends on n, the
table size and the column count alone: within each group of 32 rows the
rows of a slot combine in a tree over their ranks; each table copy folds
its groups in row order; a block folds its copies in order; the merge folds
the chunks in 32 runs and the runs in a tree.  On a CUDA tensor
:func:`groupagg` launches the kernel (building it on first use) and raises
when it cannot; on CPU tensors it computes the plain version,
:func:`groupagg_plain`, which takes the same order where the result depends
on it, so the two agree bit for bit.  ``LAUNCHES`` counts kernel launches
(the merge included), ``ROWS`` the rows they read; while the launch ledger
is on, each launch is reported to it (``observability/compile_ledger.py``).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from modin_tpu_torch.observability import compile_ledger as _ledger
from modin_tpu_torch.ops.cuda.fused_program import DTYPE_CODES

LAUNCHES = 0
#: rows the launches read (slots and value columns)
ROWS = 0

AGGS = ("sum", "prod", "count", "mean", "min", "max")
MAX_COLS = 32
WARPS = 8  # warps a block
CHUNK_ALIGN = 2048  # a chunk splits into up to 8 copies' sub-chunks of whole groups of 32 rows
MAX_BLOCKS = 1024
MIN_CHUNK = 4096  # the fewest rows a chunk takes
MAX_CHUNK = 1 << 30  # block sizes and counts are int32
SMEM_MAX = 232448  # an H100 block's opt-in shared memory (227 KB)

_LIB_NAME = "groupagg"
_bound = False


class Geometry(NamedTuple):
    """A launch: ``chunks`` chunks of ``chunk`` rows times ``ranges`` slot
    ranges of ``range_slots`` slots, ``copies`` table copies a block, each
    warp streaming ``stages`` stages of ``stage_groups`` groups of 32 rows
    through its ring, by TMA bulk copies (``bulk``) or the lanes'
    cp.async."""

    blocks: int
    chunks: int
    chunk: int
    copies: int
    range_slots: int
    ranges: int
    stages: int
    stage_groups: int
    bulk: bool


class GroupAggParams(ctypes.Structure):
    """csrc/groupagg.cu: struct GroupAggParams, passed by value."""

    _fields_ = [
        ("n", ctypes.c_int64), ("chunk", ctypes.c_int64), ("g1", ctypes.c_int32),
        ("n_cols", ctypes.c_int32), ("agg", ctypes.c_int32), ("copies", ctypes.c_int32),
        ("range_slots", ctypes.c_int32), ("ranges", ctypes.c_int32), ("chunks", ctypes.c_int32),
        ("slot_bytes", ctypes.c_int32), ("stages", ctypes.c_int32), ("stage_groups", ctypes.c_int32),
        ("bulk", ctypes.c_int32), ("stage_bytes", ctypes.c_int32),
        ("copy_bytes", ctypes.c_int32), ("smem_bytes", ctypes.c_int32),
        ("slot", ctypes.c_void_p), ("partial", ctypes.c_void_p),
        ("col", ctypes.c_void_p * MAX_COLS), ("col_off", ctypes.c_uint32 * MAX_COLS),
        ("col_dt", ctypes.c_uint8 * MAX_COLS),
    ]


def _lib() -> ctypes.CDLL:
    global _bound
    from modin_tpu_torch.ops.cuda.build import load

    lib = load(_LIB_NAME)
    if not _bound:
        lib.groupagg_run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
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


def table_bytes(slots: int, n_cols: int) -> int:
    """Shared memory of one table copy: 8-byte values, 4-byte sizes and
    counts."""
    return -(-slots * (12 * n_cols + 4) // 16) * 16


BAR_BYTES = WARPS * 4 * 8  # each warp's ring barriers (csrc/groupagg.cu: kBarBytes)


def ring_shape(n_cols: int) -> Tuple[int, int, bool]:
    """(stages, groups of 32 rows a stage, bulk copies) of a warp's ring:
    four stages of four groups, each column one TMA bulk copy, for one or
    two columns; two stages of two groups, copied by the lanes' cp.async, up
    to 12 columns (there a stage is too short for a bulk copy to pay, and
    measured slower on the card); two stages of one group past 12."""
    if n_cols <= 2:
        return 4, 4, True
    return (2, 2, False) if n_cols <= 12 else (2, 1, False)


def _stage_bytes(n_cols: int) -> int:
    """Eight warps' rings of 8-byte slots and columns: the most any dtypes
    take, so that the geometry, and the order, do not depend on the
    dtypes."""
    stages, groups, _ = ring_shape(n_cols)
    return BAR_BYTES + WARPS * stages * groups * 32 * 8 * (1 + n_cols)


def launch_geometry(n: int, g1: int, n_cols: int) -> Geometry:
    """The launch for ``n`` rows, ``g1`` slots and ``n_cols`` columns: the
    most table copies (8, 4, 2 or 1) whose tables fit a block's shared
    memory beside the warps' rings, else one copy of a slot range of the
    table, as many ranges as the width needs; then up to
    ``MAX_BLOCKS // ranges`` chunks of at least ``MIN_CHUNK`` rows (a
    multiple of ``CHUNK_ALIGN``), no more than keep the partial tables within
    ``max(2 n, 2^24)`` entries, and none over ``MAX_CHUNK`` rows."""
    avail = SMEM_MAX - _stage_bytes(n_cols)
    copies = next((k for k in (8, 4, 2, 1) if k * table_bytes(g1, n_cols) <= avail), 0)
    if copies:
        ranges, range_slots = 1, g1
    else:
        copies = 1
        most = (avail // 16 * 16) // (12 * n_cols + 4)
        ranges = -(-g1 // most)
        range_slots = -(-g1 // ranges)
    rows = 1 + 2 * n_cols
    budget = max(2 * n, 1 << 24)
    chunks = max(1, min(MAX_BLOCKS // ranges, -(-n // MIN_CHUNK), budget // (rows * g1)), -(-n // MAX_CHUNK))
    chunk = -(-max(n, 1) // chunks)
    chunk = -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN
    chunks = max(1, -(-n // chunk))
    return Geometry(chunks * ranges, chunks, chunk, copies, range_slots, ranges, *ring_shape(n_cols))


def _check_geometry(geo: Geometry, n: int, g1: int, n_cols: int) -> None:
    """A forced geometry (the kernel check's) must cover the rows and
    slots and fit shared memory."""
    ok = (geo.copies in (1, 2, 4, 8) and geo.chunk % CHUNK_ALIGN == 0 and geo.chunks >= 1
          and (geo.chunks - 1) * geo.chunk < max(n, 1) <= geo.chunks * geo.chunk
          and geo.ranges * geo.range_slots >= g1 and (geo.ranges - 1) * geo.range_slots < g1
          and geo.blocks == geo.chunks * geo.ranges and geo.chunk <= MAX_CHUNK
          and (geo.stages, geo.stage_groups, geo.bulk) == ring_shape(n_cols)
          and geo.copies * table_bytes(geo.range_slots, n_cols) + _stage_bytes(n_cols) <= SMEM_MAX)
    if not ok:
        raise ValueError(f"groupagg: geometry {geo} does not cover {n} rows and {g1} slots")


def _check(slot: torch.Tensor, cols: Sequence[torch.Tensor], agg: str, g1: int) -> None:
    if agg not in AGGS:
        raise ValueError(f"groupagg: no aggregation {agg!r} (one of {AGGS})")
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"groupagg: 1 to {MAX_COLS} value columns, got {len(cols)}")
    if slot.dtype not in (torch.int32, torch.int64) or slot.dim() != 1:
        raise ValueError(f"groupagg: the slot column must be 1-D int32 or int64, got {slot.dtype} "
                         f"{tuple(slot.shape)}")
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


def groupagg(agg: str, slot: torch.Tensor, cols: Sequence[torch.Tensor], g1: int, *,
             _geometry: Optional[Geometry] = None) -> torch.Tensor:
    """The merged tables ``[1 + 2 * len(cols), g1]`` int64 of aggregation
    ``agg`` of ``cols`` by ``slot`` (values in ``[0, g1)``).  ``_geometry``
    forces a launch (the kernel check's, held to the plain version with the
    same geometry)."""
    global LAUNCHES, ROWS
    _check(slot, cols, agg, g1)
    if slot.device.type == "cpu":
        return groupagg_plain(agg, slot, cols, g1, _geometry=_geometry)
    if slot.device.type != "cuda":
        raise ValueError(f"groupagg kernel: unsupported device {slot.device}")
    n, C = slot.shape[0], len(cols)
    geo = _geometry or launch_geometry(n, g1, C)
    _check_geometry(geo, n, g1, C)
    rows = 1 + 2 * C
    slot = slot.contiguous()
    cols = [c.contiguous() for c in cols]
    partial = torch.empty((geo.chunks, rows, g1), dtype=torch.int64, device=slot.device)
    out = torch.empty((rows, g1), dtype=torch.int64, device=slot.device)
    p = GroupAggParams()
    p.n, p.chunk, p.g1, p.n_cols, p.agg = n, geo.chunk, g1, C, AGGS.index(agg)
    p.copies, p.range_slots, p.ranges, p.chunks = geo.copies, geo.range_slots, geo.ranges, geo.chunks
    p.slot_bytes = slot.element_size()
    rows_a_stage = 32 * geo.stage_groups
    offset = rows_a_stage * p.slot_bytes
    for k, c in enumerate(cols):
        p.col[k] = c.data_ptr()
        p.col_dt[k] = DTYPE_CODES[c.dtype]
        p.col_off[k] = offset
        offset += rows_a_stage * c.element_size()  # a multiple of 16
    p.stages, p.stage_groups, p.bulk, p.stage_bytes = geo.stages, geo.stage_groups, int(geo.bulk), offset
    p.copy_bytes = table_bytes(geo.range_slots, C)
    p.smem_bytes = BAR_BYTES + WARPS * geo.stages * p.stage_bytes + geo.copies * p.copy_bytes
    p.slot, p.partial = slot.data_ptr(), partial.data_ptr()
    lib = _lib()
    start = _ledger.launch_begin(slot.device) if _ledger.LEDGER_ON else None
    with torch.cuda.device(slot.device):
        stream = torch.cuda.current_stream(slot.device).cuda_stream
        err = lib.groupagg_run(ctypes.byref(p), geo.blocks, ctypes.c_void_p(out.data_ptr()),
                               ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.groupagg_error_string(int(err)).decode(errors="replace")
        raise RuntimeError(f"groupagg kernel: launch failed with CUDA error {err}: {msg}")
    LAUNCHES += 1
    ROWS += n
    if _ledger.LEDGER_ON:
        # the slots and the columns read once, the merged tables written once;
        # one fold a row and column
        nbytes = n * (slot.element_size() + sum(c.element_size() for c in cols)) + out.numel() * 8
        _ledger.note_launch("groupagg", slot.device, start, n, nbytes, n * C)
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


def _runs(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sorted order, run starts, run lengths) of ``key`` sorted stably."""
    order = torch.argsort(key, stable=True)
    ks = key[order]
    new = torch.ones_like(ks, dtype=torch.bool)
    new[1:] = ks[1:] != ks[:-1]
    starts = torch.nonzero(new).flatten()
    ends = torch.cat([starts[1:], torch.tensor([ks.shape[0]], device=key.device)])
    return order, starts, ends - starts


def _left_fold_runs(agg: str, key: torch.Tensor, val: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys, each key's values folded left from the identity in their
    order), the keys ascending."""
    order, starts, lengths = _runs(key)
    vs = val[order]
    acc = torch.full((starts.shape[0],), _init(agg, True), dtype=torch.float64, device=val.device)
    for j in range(int(lengths.max()) if lengths.numel() else 0):
        alive = torch.nonzero(lengths > j).flatten()
        acc[alive] = _fold(agg, acc[alive], vs[starts[alive] + j])
    return key[order][starts], acc


def _ordered_float(agg: str, x: torch.Tensor, idx: torch.Tensor, kept: torch.Tensor, ok: torch.Tensor,
                   g1: int, geo: Geometry) -> torch.Tensor:
    """A float64 sum or product by slot in the kernel's order (``x``: every
    row's value; ``kept``: rows in a folded slot; ``ok``: kept and not NaN;
    a kept NaN takes part as the identity)."""
    dev = x.device
    init = _init(agg, True)
    rows = torch.nonzero(kept).flatten()
    if rows.numel() == 0:
        return torch.full((g1,), init, dtype=torch.float64, device=dev)
    v = torch.where(ok[rows], x[rows], init)
    # 1. within each group of 32 rows, a slot's rows combine in a tree over
    #    their ranks: rank r takes rank r + 2^d at level d
    order, starts, lengths = _runs((rows // 32) * g1 + idx[rows])
    vs = v[order]
    run = torch.repeat_interleave(torch.arange(starts.shape[0], device=dev), lengths)
    rank = torch.arange(vs.shape[0], device=dev) - starts[run]
    length = lengths[run]
    for d in range(5):
        sel = torch.nonzero(((rank & ((2 << d) - 1)) == 0) & (rank + (1 << d) < length)).flatten()
        if sel.numel():
            vs[sel] = _fold(agg, vs[sel], vs[sel + (1 << d)])
    first = rows[order][starts]
    slot = idx[first]
    tree = vs[starts]
    # 2. each copy folds its groups in row order, from the identity
    c = first // geo.chunk
    copy = (first % geo.chunk) // (geo.chunk // geo.copies)
    key2, l2 = _left_fold_runs(agg, (c * geo.copies + copy) * g1 + slot, tree)
    # 3. a block folds its copies in order
    key3, l3 = _left_fold_runs(agg, (key2 // (geo.copies * g1)) * g1 + key2 % g1, l2)
    # 4. the merge: lane l folds chunks [l * per, (l + 1) * per) in order,
    #    then lane l takes lane l + 2^d at level d
    per = -(-geo.chunks // 32)
    dense = torch.full((32 * per * g1,), init, dtype=torch.float64, device=dev)
    dense[key3] = l3
    dense = dense.view(32, per, g1)
    acc = torch.full((32, g1), init, dtype=torch.float64, device=dev)
    for i in range(per):
        acc = _fold(agg, acc, dense[:, i])
    for d in range(5):
        step = 1 << d
        acc[0::2 * step] = _fold(agg, acc[0::2 * step], acc[step::2 * step])
    return acc[0]


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


def groupagg_plain(agg: str, slot: torch.Tensor, cols: Sequence[torch.Tensor], g1: int, *,
                   _geometry: Optional[Geometry] = None) -> torch.Tensor:
    """Plain torch version of :func:`groupagg` on the columns' device."""
    _check(slot, cols, agg, g1)
    n = slot.shape[0]
    dev = slot.device
    geo = _geometry or launch_geometry(n, g1, len(cols))
    _check_geometry(geo, n, g1, len(cols))
    idx = slot.to(torch.int64)
    kept = (idx >= 0) & (idx < g1 - 1)  # the overflow slot's rows fold nothing
    out: List[torch.Tensor] = [torch.bincount(idx[kept], minlength=g1)[:g1].to(torch.int64)]
    for c in cols:
        nanable = c.dtype.is_floating_point
        fl = nanable or agg == "mean"  # a mean adds every column in float64
        x = c.to(torch.float64 if fl else torch.int64)
        ok = kept & ~torch.isnan(x) if nanable else kept
        xi, ii = x[ok], idx[ok]
        nn = torch.bincount(ii, minlength=g1)[:g1].to(torch.int64)
        init = _init(agg, fl)
        if agg == "count":
            value = torch.full((g1,), init, dtype=x.dtype, device=dev)
        elif not fl:
            # int folds are exact in any order (sums and products wrap)
            value = torch.full((g1,), init, dtype=torch.int64, device=dev)
            if agg == "sum":
                value.index_add_(0, ii, xi)
            else:
                how = {"prod": "prod", "min": "amin", "max": "amax"}[agg]
                value.scatter_reduce_(0, ii, xi, how, include_self=True)
        elif agg in ("min", "max"):
            value = _first_extreme(agg, xi, ii, g1)
        else:
            value = _ordered_float(agg, x, idx, kept, ok, g1, geo)
        out += [value.view(torch.int64) if fl else value, nn]
    return torch.stack(out)


def finish(agg: str, table: torch.Tensor, dtypes: Sequence[torch.dtype]
           ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """(sizes, per-column aggregates, per-column non-NaN counts) from the
    merged tables, on their device: a float aggregate as float64 (NaN for a
    slot with no value, except sum/prod, which give 0/1 there), an int one
    as int64; a mean divides the float64 sum by the count (float64)."""
    sizes = table[0]
    values, counts = [], []
    for j, dt in enumerate(dtypes):
        raw, nn = table[1 + 2 * j], table[2 + 2 * j]
        fl = dt.is_floating_point
        if agg == "count":
            v = nn
        elif agg == "mean":
            v = torch.where(nn > 0, raw.view(torch.float64) / nn.to(torch.float64), float("nan"))
        elif fl:
            v = raw.view(torch.float64)
            if agg in ("min", "max"):
                v = torch.where(nn > 0, v, float("nan"))
        else:
            v = raw
        values.append(v)
        counts.append(nn)
    return sizes, values, counts
