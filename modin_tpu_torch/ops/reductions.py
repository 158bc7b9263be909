"""Column reductions with pandas NaN semantics, row-wise reductions, and the
sort-shaped family (median, quantile, nunique, mode).

The port's counterpart of ``modin_tpu/ops/reductions.py``: ``_reduce_one``
and ``reduce_columns``; ``reduce_axis1``; ``ColumnPlan``/``plan_sort_reduce``
with the histogram and sorted-representation executors behind
``nunique_planned``, ``mode_planned``, ``quantile_columns`` and
``median_columns``; ``nunique_axis1`` and ``mode_axis1``.  Columns are
unpadded on one device, so the validity masks of the JAX package are gone;
NaN handling, result dtypes and the float64 accumulation are the same.
Torch's full reductions on CUDA take a fixed order, so a result repeats bit
for bit from run to run.

The O(n) histogram of ``nunique``/``mode`` on bounded-range int columns
(the JAX package's XLA scatter-add ``_jit_hist``) is the hand-written
bincount kernel here (``ops/cuda/groupby_kernels.bincount``): one launch per
column.  The rest composes torch library operations, as the JAX package's
XLA programs do.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.ops.lazy import is_lazy, materialize, materialize_exprs, run_fused
from modin_tpu_torch.parallel.engine import materialize as _engine_materialize

REDUCTIONS = frozenset(
    ["sum", "mean", "count", "min", "max", "prod", "var", "std", "sem", "skew",
     "kurt", "any", "all"]
)
AXIS1_REDUCTIONS = frozenset(["sum", "mean", "min", "max", "count", "var", "std", "median"])

# rows of the (rows, columns) matrix that one step of a row-wise sort takes:
# it bounds the device memory of median/nunique/mode along axis 1
AXIS1_CHUNK_ROWS = 10_000_000


def _extreme(c: torch.Tensor, op: str, skipna: bool, nan_mask, n: int) -> torch.Tensor:
    reducer = torch.amin if op == "min" else torch.amax
    if nan_mask is None:
        if c.dtype == torch.bool:
            return reducer(c.to(torch.uint8)).to(torch.bool)
        return reducer(c)
    neutral = float("inf") if op == "min" else float("-inf")
    r = reducer(torch.where(nan_mask, neutral, c))
    n_use = n - nan_mask.sum()
    nan = torch.full_like(r, float("nan"))
    if not skipna:
        r = torch.where(nan_mask.any(), nan, r)
    return torch.where(n_use == 0, nan, r)


MOMENT_OPS = ("mean", "var", "std", "sem", "skew", "kurt")


def moment_result(op: str, mean, n_use, m2s, m3s, m4s, poisoned, ddof: int) -> torch.Tensor:
    """mean/var/std/sem/skew/kurt of a column from its mean, its valid count
    ``n_use`` and its power sums about the mean (0-d tensors; ``m3s`` for
    skew, ``m4s`` for kurt), NaN where ``poisoned`` (a NaN under
    ``skipna=False``): pandas' rules, for the torch reductions and the fused
    tails alike."""
    nan = torch.full_like(mean, float("nan"))
    if op == "mean":
        return torch.where(poisoned | (n_use == 0), nan, mean)
    if op in ("var", "std", "sem"):
        var = m2s / torch.clamp(n_use - ddof, min=1)
        var = torch.where((n_use - ddof > 0) & ~poisoned, var, nan)
        if op == "var":
            return var
        if op == "std":
            return torch.sqrt(var)
        return torch.sqrt(var / n_use)
    # pandas' nanskew (sample skewness G1) and nankurt (sample excess
    # kurtosis G2), with its rules: sums below 1e-14 are rounding and
    # count as 0, a zero variance gives 0, fewer than 3 (4) values NaN
    nf = n_use.to(torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=mean.device)

    def zero_out(v: torch.Tensor) -> torch.Tensor:
        return torch.where(v.abs() < 1e-14, zero, v)

    m2s = zero_out(m2s)
    if op == "skew":
        m3s = zero_out(m3s)
        res = nf * torch.sqrt(nf - 1.0) / (nf - 2.0) * (m3s / m2s**1.5)
        res = torch.where(m2s == 0, zero, res)
        res = torch.where(nf < 3, nan, res)
    else:
        numer = zero_out(nf * (nf + 1.0) * (nf - 1.0) * m4s)
        denom = zero_out((nf - 2.0) * (nf - 3.0) * m2s * m2s)
        adj = 3.0 * (nf - 1.0) ** 2 / ((nf - 2.0) * (nf - 3.0))
        res = torch.where(denom == 0, zero, numer / denom - adj)
        res = torch.where(nf < 4, nan, res)
    return torch.where(poisoned, nan, res)


def _reduce_one(op: str, c: torch.Tensor, n: int, skipna: bool, ddof: int = 1) -> torch.Tensor:
    """Reduce one column of ``n`` rows to a 0-d tensor."""
    is_f = c.dtype.is_floating_point
    nan_mask = torch.isnan(c) if is_f else None
    use = ~nan_mask if (skipna and is_f) else None
    if use is not None:
        n_use = use.sum()
    else:
        n_use = torch.tensor(n, dtype=torch.int64, device=c.device)

    def sel(x: torch.Tensor, neutral: float) -> torch.Tensor:
        return x if use is None else torch.where(use, x, torch.full((), neutral, dtype=x.dtype, device=x.device))

    if op == "count":
        if nan_mask is None:
            return torch.tensor(n, dtype=torch.int64, device=c.device)
        return (~nan_mask).sum()
    if op == "sum":
        return sel(c, 0).sum()
    if op == "prod":
        return sel(c, 1).prod()
    if op in ("min", "max"):
        return _extreme(c, op, skipna, nan_mask, n)
    if op in MOMENT_OPS:
        x = sel(c.to(torch.float64), 0.0)
        mean = x.sum() / n_use
        poisoned = nan_mask.any() if (is_f and not skipna) else torch.zeros((), dtype=torch.bool, device=c.device)
        if op == "mean":
            return moment_result(op, mean, n_use, None, None, None, poisoned, ddof)
        d = sel(x - mean, 0.0)
        m2s = (d * d).sum()
        m3s = (d * d * d).sum() if op == "skew" else None
        m4s = (d * d * d * d).sum() if op == "kurt" else None
        return moment_result(op, mean, n_use, m2s, m3s, m4s, poisoned, ddof)
    if op == "any":
        truthy = torch.where(nan_mask, not skipna, c != 0) if is_f else (c if c.dtype == torch.bool else c != 0)
        return truthy.any()
    if op == "all":
        truthy = torch.where(nan_mask, True, c != 0) if is_f else (c if c.dtype == torch.bool else c != 0)
        return truthy.all()
    raise ValueError(op)


def reduce_columns(
    op_name: str,
    cols: List[Any],
    n: int,
    skipna: bool = True,
    ddof: int = 1,
    cast_bool: bool = False,
) -> list:
    """Reduce each column (``n`` rows) to a scalar; returns 0-d numpy arrays
    after one fetch.

    ``cols`` may mix tensors and deferred LazyExprs: the lazy ones reduce as
    the tail of one fused run (``ops/lazy.py``), so ``(a * b + c).sum()``
    reads its columns once and writes none; the tensors take the torch
    reductions below.  ``cast_bool`` applies the pandas bool->int promotion
    of the arithmetic aggregations.
    """
    if op_name not in REDUCTIONS:
        raise ValueError(f"reduction {op_name!r} is not ported")
    n, skipna, ddof = int(n), bool(skipna), int(ddof)
    lazy_pos = [i for i, c in enumerate(cols) if is_lazy(c)]
    fused = {}
    if lazy_pos:
        exprs = [cols[i] for i in lazy_pos]
        tail = ("reduce", op_name, skipna, ddof, bool(cast_bool))
        values = run_fused(exprs, tail, lambda first, second: _finish_fused(
            op_name, exprs, first, second, n, skipna, ddof, cast_bool))
        fused = dict(zip(lazy_pos, values))
    results = []
    for i, c in enumerate(cols):
        if i in fused:
            continue
        c = materialize(c)
        if cast_bool and c.dtype == torch.bool:
            c = c.to(torch.int64)
        results.append(_reduce_one(op_name, c, n, skipna, ddof))
    eager = iter(np.asarray(r) for r in _engine_materialize(results))
    return [fused[i] if i in fused else next(eager) for i in range(len(cols))]


def pandas_result_dtype(op: str, dtype: Any) -> np.dtype:
    """pandas' dtype of column reduction ``op`` over a column of numpy
    ``dtype``: count is int64 and any/all bool; a float column keeps its
    float dtype; an int or bool column keeps it for min/max, sums and
    products it in int64 (uint64 when unsigned) and takes every other op
    in float64."""
    if op == "count":
        return np.dtype(np.int64)
    if op in ("any", "all"):
        return np.dtype(bool)
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return dtype
    if op in ("min", "max"):
        return dtype
    if op in ("sum", "prod"):
        return np.dtype(np.uint64 if dtype.kind == "u" else np.int64)
    return np.dtype(np.float64)


def pandas_result_array(op: str, values: List[Any], dtypes: List[Any]) -> np.ndarray:
    """The values of a frame's column reductions (0-d arrays, one per
    column of ``dtypes``) as pandas gives them: each in its column's result
    dtype, then all in the common dtype (object where bools meet numbers)."""
    out_dtypes = [pandas_result_dtype(op, d) for d in dtypes]
    typed = []
    with np.errstate(all="ignore"):
        for v, dt in zip(values, out_dtypes):
            v = np.asarray(v)
            # an unsigned sum or product comes as its int64 bits
            typed.append(v.view(dt) if dt.kind == "u" and v.dtype.itemsize == dt.itemsize else v.astype(dt))
    # pandas' find_common_type over numpy dtypes: bool beside another
    # dtype is object, else numpy's promotion
    kinds = {dt.kind == "b" for dt in out_dtypes}
    common = np.dtype(object) if len(kinds) > 1 else np.result_type(*out_dtypes)
    if common == object:
        out = np.empty(len(typed), dtype=object)
        out[:] = [v[()] for v in typed]  # numpy scalars, as pandas keeps them
        return out
    with np.errstate(all="ignore"):
        return np.asarray([v.astype(common) for v in typed], dtype=common)


_RESULT_DTYPES: dict = {}


def _result_dtype(op: str, dtype: torch.dtype, skipna: bool, ddof: int) -> np.dtype:
    """The numpy dtype of the eager reduction of a column of ``dtype``."""
    key = (op, dtype, skipna, ddof)
    if key not in _RESULT_DTYPES:
        from modin_tpu_torch.utils import numpy_dtype

        _RESULT_DTYPES[key] = numpy_dtype(_reduce_one(op, torch.zeros(1, dtype=dtype), 1, skipna, ddof).dtype)
    return _RESULT_DTYPES[key]


def _finish_fused(op: str, exprs, first: torch.Tensor, second, n: int, skipna: bool,
                  ddof: int, cast_bool: bool) -> list:
    """0-d numpy results of a fused reduction tail, from the kernel's merged
    accumulators (one fetch): ``first`` is ``(value, valid, NaN)`` per column
    (the value a sum, product, min, max or nonzero count), ``second`` the
    power sums about the means of a moments op.  The scalar rules are
    :func:`_reduce_one`'s."""
    host = _engine_materialize(first if second is None else torch.cat([first, second], dim=1))
    out = []
    for k, e in enumerate(exprs):
        dtype = torch.int64 if (cast_bool and e.dtype == torch.bool) else e.dtype
        fl = dtype.is_floating_point
        row = host[k]
        bits = row[:3]
        float_acc = op in MOMENT_OPS or (fl and op in ("sum", "prod", "min", "max"))
        value = bits[0:1].view(np.float64)[0] if float_acc else bits[0]
        cnt, nans = int(bits[1]), int(bits[2])
        res_dtype = _result_dtype(op, dtype, skipna, ddof)
        with np.errstate(all="ignore"):
            r = _finish_one(op, value, cnt, nans, row[3:6].view(np.float64) if second is not None else None,
                            n, fl, skipna, ddof, dtype)
        out.append(np.asarray(r).astype(res_dtype))
    return out


def _finish_one(op, value, cnt, nans, powers, n, fl, skipna, ddof, dtype):
    """One column's result from its accumulators, by ``_reduce_one``'s rules
    (the moments through :func:`moment_result`)."""
    nan = np.float64("nan")
    poisoned = fl and not skipna and nans > 0
    if op == "count":
        return np.int64(cnt if fl else n)
    if op in ("sum", "prod"):
        if poisoned:
            return nan
        return np.float64(value) if fl else np.int64(value)
    if op in ("min", "max"):
        if dtype == torch.bool:
            return np.bool_(value)
        if not fl:
            return np.int64(value)
        if poisoned or cnt == 0:
            return nan
        return np.float64(value)
    if op == "any":
        return np.bool_(value > 0 or (fl and not skipna and nans > 0))
    if op == "all":
        return np.bool_(value == cnt)
    n_use = torch.tensor(cnt if fl and skipna else n, dtype=torch.int64)
    power = [None] * 3 if powers is None else [torch.tensor(float(v), dtype=torch.float64) for v in powers]
    mean = torch.tensor(float(value), dtype=torch.float64) / n_use
    return moment_result(op, mean, n_use, *power, torch.tensor(poisoned), ddof).numpy()


def idx_minmax(op_name: str, cols: List[torch.Tensor], n: int) -> Tuple[List[int], List[int]]:
    """(positions, valid counts) of each column's skipna ``idxmin`` or
    ``idxmax``, after one fetch.  NaN reads as +inf for idxmin and -inf for
    idxmax, as pandas' ``nanargmin``/``nanargmax`` fill it
    (``torch.argmax`` would take NaN as the extreme); ties take the first
    row, as ``torch.argmin``/``argmax`` promise.  A column with no valid
    value (count 0) has no answer: pandas raises there."""
    if op_name not in ("idxmin", "idxmax"):
        raise ValueError(f"idx_minmax computes idxmin or idxmax, not {op_name!r}")
    arg = torch.argmin if op_name == "idxmin" else torch.argmax
    fill = float("inf") if op_name == "idxmin" else float("-inf")
    out = []
    for c in cols:
        if c.shape[0] != n:
            raise ValueError(f"column of {c.shape[0]} rows for {n} rows")
        if c.dtype.is_floating_point:
            nan = torch.isnan(c)
            out += [arg(torch.where(nan, fill, c)), n - nan.sum()]
        else:
            out += [arg(c), torch.tensor(n, dtype=torch.int64, device=c.device)]
    fetched = _engine_materialize(torch.stack(out)) if out else []
    return [int(v) for v in fetched[0::2]], [int(v) for v in fetched[1::2]]


# --------------------------------------------------------------------- #
# Row-wise reductions (axis=1)
# --------------------------------------------------------------------- #


def _common_dtype(cols: List[torch.Tensor]) -> torch.dtype:
    common = cols[0].dtype
    for c in cols[1:]:
        common = torch.promote_types(common, c.dtype)
    return common


def _sorted_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row sorted ascending with NaN at its tail, and the non-NaN count
    per row (int64)."""
    xs = torch.sort(x, dim=1).values  # torch sorts NaN above every value
    if xs.dtype.is_floating_point:
        nv = (~torch.isnan(xs)).sum(dim=1)
    else:
        nv = torch.full((xs.shape[0],), xs.shape[1], dtype=torch.int64, device=xs.device)
    return xs, nv


def _median_rows(x: torch.Tensor, skipna: bool) -> torch.Tensor:
    """Row medians in float64: the mean of the two middle values, as numpy's
    (nan)median takes it."""
    out = torch.empty(x.shape[0], dtype=torch.float64, device=x.device)
    for start in range(0, x.shape[0], AXIS1_CHUNK_ROWS):
        part = x[start:start + AXIS1_CHUNK_ROWS].to(torch.float64)
        xs, nv = _sorted_rows(part)
        lo = torch.clamp((nv - 1) // 2, min=0)
        hi = torch.clamp(nv // 2, min=0)
        vlo = torch.gather(xs, 1, lo[:, None])[:, 0]
        vhi = torch.gather(xs, 1, hi[:, None])[:, 0]
        med = (vlo + vhi) / 2.0
        bad = nv == 0
        if not skipna:
            bad = bad | (nv < xs.shape[1])
        out[start:start + part.shape[0]] = torch.where(bad, float("nan"), med)
    return out


def reduce_axis1(
    op_name: str,
    cols: List[torch.Tensor],
    skipna: bool = True,
    ddof: int = 1,
    cast_bool: bool = False,
) -> torch.Tensor:
    """Row-wise reduction across columns -> one device column, in pandas'
    result dtype (the columns' common dtype for sum/min/max, float64 for
    mean/var/std/median, int64 for count)."""
    if op_name not in AXIS1_REDUCTIONS:
        raise ValueError(f"row-wise reduction {op_name!r} is not ported")
    skipna, ddof = bool(skipna), int(ddof)
    if any(is_lazy(c) for c in cols):
        fused = _fused_axis1(op_name, cols, skipna, cast_bool)
        if fused is not None:
            return fused
        cols = materialize_exprs(cols)
    if cast_bool:
        cols = [c.to(torch.int64) if c.dtype == torch.bool else c for c in cols]
    common = _common_dtype(cols)
    k = len(cols)
    if op_name == "count" and not common.is_floating_point:
        return torch.full((cols[0].shape[0],), k, dtype=torch.int64, device=cols[0].device)
    x = torch.stack([c.to(common) for c in cols], dim=1)
    is_f = x.dtype.is_floating_point
    if op_name == "count":
        return (~torch.isnan(x)).sum(dim=1)
    if op_name == "median":
        return _median_rows(x, skipna)
    nan_mask = torch.isnan(x) if (is_f and skipna) else None
    if op_name == "sum":
        return (x if nan_mask is None else torch.where(nan_mask, 0.0, x)).sum(dim=1)
    if op_name in ("min", "max"):
        if nan_mask is None:
            if x.dtype == torch.bool:
                return (torch.amin if op_name == "min" else torch.amax)(x.to(torch.uint8), dim=1).to(torch.bool)
            return (torch.amin if op_name == "min" else torch.amax)(x, dim=1)
        neutral = float("inf") if op_name == "min" else float("-inf")
        r = (torch.amin if op_name == "min" else torch.amax)(torch.where(nan_mask, neutral, x), dim=1)
        return torch.where(nan_mask.all(dim=1), float("nan"), r)
    xf = x.to(torch.float64)
    if nan_mask is None:
        n_use = torch.full((x.shape[0],), float(k), dtype=torch.float64, device=x.device)
    else:
        xf = torch.where(nan_mask, 0.0, xf)
        n_use = (~nan_mask).sum(dim=1).to(torch.float64)
    mean = xf.sum(dim=1) / n_use
    if op_name == "mean":
        return mean
    d = xf - mean[:, None]
    if nan_mask is not None:
        d = torch.where(nan_mask, 0.0, d)
    var = (d * d).sum(dim=1) / (n_use - ddof)
    var = torch.where(n_use - ddof > 0, var, float("nan"))
    return var if op_name == "var" else torch.sqrt(var)


def _fused_axis1(op_name: str, cols: List[Any], skipna: bool, cast_bool: bool) -> Optional[torch.Tensor]:
    """sum/mean/min/max/count across the columns of each row as the tail of
    one fused run over the lazy and concrete columns; None where the fused
    kernel does not take it (var/std/median, or a forest past one
    program's caps): the caller materializes and takes the torch path."""
    from modin_tpu_torch.ops.cuda import fused_program as fp

    if op_name not in fp.ROW_OPS:
        return None
    dtypes = [torch.int64 if cast_bool and c.dtype == torch.bool else c.dtype for c in cols]
    meta = [torch.empty(0, dtype=d) for d in dtypes]
    if op_name == "count" and not _common_dtype(meta).is_floating_point:
        n = cols[0].shape[0]
        device = cols[0].device
        return torch.full((n,), len(cols), dtype=torch.int64, device=device)
    if any(d not in fp.DTYPE_CODES for d in dtypes):
        return None
    try:
        return run_fused(list(cols), ("rows", op_name, skipna, bool(cast_bool)))
    except OverflowError:
        return None


# --------------------------------------------------------------------- #
# Sort-shaped reductions (median / quantile / nunique / mode) over the
# shared sorted representation, and the O(n) histogram fast path
# --------------------------------------------------------------------- #
#
# Three strategies per column, planned before any work:
#
# - "dict":   the answer is on the host already: a dictionary-coded string
#             column's categories are its distinct values (ops/dictionary.py);
# - "hist":   bounded-range ints and dictionary codes count occurrences with
#             one O(n) histogram (the bincount kernel) — no sort;
# - "cached"/"sort": the (sorted, n_valid) prefix is built once per column
#             through ops/sort.sorted_valid and cached on the DeviceColumn
#             (ops/sorted_cache.py), so median + quantile + nunique + mode
#             on one column pay ONE O(n log n) sort, not four.
#
# The query compiler asks the calibrated kernel router (ops/router.py)
# whether the planned device work beats pandas: ``forced_host`` before any
# device work, ``decide`` with the plans' strategies after planning.


class ColumnPlan(NamedTuple):
    col: Any  # DeviceColumn carrying the values (dictionary codes included)
    strategy: str  # "dict", "hist", "cached" or "sort"
    span: int  # histogram value-bin count (hist strategy only)
    base: int  # histogram base value: bin = value - base (0 for codes)
    n_categories: int = 0  # dictionary columns: distinct non-missing values
    has_nan: bool = False  # dictionary columns: whether a row is missing


def plan_sort_reduce(op: str, specs: List[dict], n: int) -> List[ColumnPlan]:
    """One :class:`ColumnPlan` per column spec for a sort-shaped ``op``:
    ``{"col": DeviceColumn}`` for a numeric column, ``{"col": codes,
    "n_categories": k, "has_nan": b}`` for a dictionary-coded one.  Int and
    bool columns of ``nunique``/``mode`` are probed (one min/max pass each,
    one fetch) for a value range within ``KernelRouterHistBound``; columns
    with a live sorted representation plan as "cached"."""
    from modin_tpu_torch.config import KernelRouterHistBound
    from modin_tpu_torch.ops import sorted_cache

    hist_bound = int(KernelRouterHistBound.get())
    hist_ok = op in ("nunique", "mode")
    plans: List[Any] = [None] * len(specs)
    probe: List[int] = []
    for i, spec in enumerate(specs):
        col = spec["col"]
        if "n_categories" in spec:
            k, has_nan = int(spec["n_categories"]), bool(spec["has_nan"])
            if op == "nunique":
                strategy, span = "dict", 0
            elif hist_ok and k + 2 <= hist_bound:
                # span floor 1: an all-missing column has no categories
                strategy, span = "hist", max(k, 1)
            else:
                strategy, span = ("cached" if sorted_cache.peek(col) else "sort"), 0
            plans[i] = ColumnPlan(col, strategy, span, 0, k, has_nan)
        elif sorted_cache.peek(col):
            plans[i] = ColumnPlan(col, "cached", 0, 0)
        elif hist_ok and col.pandas_dtype.kind in "biu":
            probe.append(i)
        else:
            plans[i] = ColumnPlan(col, "sort", 0, 0)
    if probe:
        ranges = []
        for i in probe:
            c = specs[i]["col"].data
            if c.dtype == torch.bool:
                c = c.to(torch.int8)
            ranges.append(torch.stack([c.min().to(torch.int64), c.max().to(torch.int64)]))
        for i, (cmin, cmax) in zip(probe, _engine_materialize(ranges)):
            cmin, cmax = int(cmin), int(cmax)
            span = cmax - cmin + 1
            if 0 < span <= hist_bound:
                plans[i] = ColumnPlan(specs[i]["col"], "hist", span, cmin)
            else:
                plans[i] = ColumnPlan(specs[i]["col"], "sort", 0, 0)
    return plans


def _sorted_inputs(plans: List[ColumnPlan], n: int) -> dict:
    """{plan index: (sorted values, n_valid)} for every sorted-strategy
    plan; missing representations are built and cached on their columns."""
    from modin_tpu_torch.ops import sorted_cache
    from modin_tpu_torch.ops.sort import sorted_valid_columns

    reps: dict = {}
    missing = []
    for i, p in enumerate(plans):
        if p.strategy not in ("cached", "sort"):
            continue
        got = sorted_cache.get(p.col)
        if got is None:
            missing.append(i)
        else:
            reps[i] = got
    if not missing:
        return reps
    with _spans.span("sortcache.build", "QUERY-COMPILER", cols=len(missing)):
        built = sorted_valid_columns([plans[i].col.data for i in missing], int(n))
    for i, pair in zip(missing, built):
        sorted_cache.attach(plans[i].col, *pair)
        reps[i] = pair
    return reps


def _nunique_sorted(xs: torch.Tensor, n_valid: torch.Tensor, n: int, dropna: bool) -> torch.Tensor:
    idx = torch.arange(xs.shape[0], device=xs.device)
    firsts = torch.ones_like(xs, dtype=torch.bool)
    firsts[1:] = xs[1:] != xs[:-1]
    count = (firsts & (idx < n_valid)).sum()
    if xs.dtype.is_floating_point and not dropna:
        count = count + (n_valid < n).to(count.dtype)
    return count


def _quantile_from_sorted(xs: torch.Tensor, n_valid: torch.Tensor, qs: torch.Tensor, interpolation: str) -> torch.Tensor:
    """Quantiles of one column's (sorted, n_valid) representation — the one
    interpolation behind both the quantile and the median paths (the JAX
    package's formula, so the two agree bit for bit)."""
    is_f = xs.dtype.is_floating_point
    # fractional position of each q over the valid prefix
    pos = qs * torch.clamp(n_valid - 1, min=0).to(torch.float64)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    if interpolation in ("lower", "higher", "nearest"):
        # pandas keeps the column's own dtype here (int64 stays int64)
        if interpolation == "lower":
            idx = lo
        elif interpolation == "higher":
            idx = hi
        else:  # nearest: half to even, as numpy
            idx = torch.round(pos).to(torch.int64)
        v = xs[idx]
        if is_f:
            v = torch.where(n_valid > 0, v, float("nan"))
        return v
    xs64 = xs.to(torch.float64)
    vlo = xs64[lo]
    vhi = xs64[hi]
    if interpolation == "linear":
        v = vlo + (vhi - vlo) * (pos - lo)
    else:  # midpoint
        v = (vlo + vhi) / 2.0
    return torch.where(n_valid > 0, v, float("nan"))


def _mode_sorted(xs: torch.Tensor, n_valid: torch.Tensor, k_bound: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(modal values in ``k_bound`` slots, ascending; how many there are)
    by one run-length pass over the sorted values."""
    n_pad = xs.shape[0]
    idx = torch.arange(n_pad, device=xs.device)
    valid = idx < n_valid
    firsts = torch.ones_like(xs, dtype=torch.bool)
    firsts[1:] = xs[1:] != xs[:-1]
    firsts = firsts & valid
    # run id per element; run lengths by a scatter-add of the valid rows
    rid = torch.cumsum(firsts, 0) - 1
    rid = torch.clamp(rid, min=0)
    run_counts = torch.zeros(n_pad, dtype=torch.int64, device=xs.device)
    run_counts.index_add_(0, rid, valid.to(torch.int64))
    count_of = run_counts[rid]
    max_count = torch.where(valid, count_of, 0).max()
    is_modal = firsts & (count_of == max_count)
    m = is_modal.sum()
    # the modal values (already ascending) into k_bound slots; the rest land
    # in a spare slot that is cut off
    slot = torch.where(is_modal, torch.cumsum(is_modal, 0) - 1, k_bound)
    slot = torch.clamp(slot, max=k_bound)
    vals = torch.zeros(k_bound + 1, dtype=xs.dtype, device=xs.device)
    vals.scatter_(0, slot, xs)
    return vals[:k_bound], m


def _hist_counts(p: ColumnPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value counts over the ``span`` bins, count of NaN rows) of one
    hist-planned column: the bincount kernel on the card, its plain version
    on the CPU.  Dictionary codes (float64, NaN for a missing value) count
    their NaN rows in one slot past the value bins."""
    from modin_tpu_torch.ops.cuda.groupby_kernels import bincount

    c = p.col.data
    span = int(p.span)
    if c.dtype.is_floating_point:
        ids = torch.where(torch.isnan(c), float(span), c).to(torch.int64).contiguous()
        counts = bincount(ids, span + 1)
        return counts[:span], counts[span]
    if c.dtype == torch.bool:
        c = c.to(torch.int8)
    counts = bincount((c.to(torch.int64) - int(p.base)).contiguous(), span)
    return counts, torch.zeros((), dtype=counts.dtype, device=counts.device)


def nunique_planned(plans: List[ColumnPlan], n: int, dropna: bool = True) -> List[int]:
    """Distinct count per planned column: the category count for dictionary
    columns, one O(n) histogram for bounded-range ints, the sorted adjacent
    difference for the rest."""
    n, dropna = int(n), bool(dropna)
    out: List[Any] = []
    reps = _sorted_inputs(plans, n)
    for i, p in enumerate(plans):
        if p.strategy == "dict":
            out.append(torch.tensor(p.n_categories + (0 if dropna else int(p.has_nan))))
        elif p.strategy == "hist":
            counts, nan_count = _hist_counts(p)
            cnt = (counts > 0).sum()
            out.append(cnt if dropna else cnt + (nan_count > 0).to(cnt.dtype))
        else:
            out.append(_nunique_sorted(*reps[i], n, dropna))
    return [int(v) for v in _engine_materialize(out)]


def mode_planned(plans: List[ColumnPlan], n: int, dropna: bool = True, k_bound: int = 1024) -> List[Any]:
    """Per-column modal values, ascending (pandas' order).

    Returns per column ``(values, nan_modal)`` — a host array of the modal
    values (code indices for dictionary columns; the caller decodes) and
    whether NaN ties the max count (``dropna=False`` histograms only) — or
    ``None`` where the device cannot represent the answer (the sorted
    path's empty or over-``k_bound`` mode set); the caller defaults.  The
    histogram path has no cap: the modal values fall out of the bin mask.
    """
    n, dropna = int(n), bool(dropna)
    reps = _sorted_inputs(plans, n)
    pending = []
    for i, p in enumerate(plans):
        if p.strategy == "hist":
            counts, nan_count = _hist_counts(p)
            max_all = counts.max()
            if not dropna:
                max_all = torch.maximum(max_all, nan_count)
            nan_modal = (nan_count == max_all) & (nan_count > 0) & (not dropna)
            pending.append(((counts == max_all) & (counts > 0), torch.stack([max_all, nan_modal.to(max_all.dtype)])))
        else:
            pending.append(_mode_sorted(*reps[i], int(k_bound)))
    results: List[Any] = []
    for p, (a, b) in zip(plans, _engine_materialize(pending)):
        if p.strategy == "hist":
            if int(b[0]) <= 0:
                results.append(None)  # no rows: pandas' empty mode
                continue
            values = np.nonzero(np.asarray(a))[0].astype(np.int64) + int(p.base)
            results.append((values, bool(b[1])))
        else:
            m = int(b)
            results.append((np.asarray(a[:m]), False) if 0 < m <= int(k_bound) else None)
    return results


def quantile_columns(cols: List[Any], n: int, qs: List[float], interpolation: str = "linear") -> list:
    """Quantiles per device COLUMN (the sorted representation caches on the
    column) -> one ``(len(qs),)`` host array per column, in pandas' result
    dtype: float64 for 'linear'/'midpoint', the column's own dtype for the
    element-selecting 'lower'/'higher'/'nearest'."""
    plans = [ColumnPlan(c, "sort", 0, 0) for c in cols]
    reps = _sorted_inputs(plans, int(n))
    results = []
    for i, c in enumerate(cols):
        q_t = torch.as_tensor(np.asarray(qs, dtype=np.float64), device=c.data.device)
        results.append(_quantile_from_sorted(*reps[i], q_t, str(interpolation)))
    return [np.asarray(r) for r in _engine_materialize(results)]


def median_columns(cols: List[Any], n: int, skipna: bool = True) -> list:
    """Median per device column over the shared sorted representation, with
    pandas' ``skipna=False`` (any NaN -> NaN)."""
    n = int(n)
    plans = [ColumnPlan(c, "sort", 0, 0) for c in cols]
    reps = _sorted_inputs(plans, n)
    results = []
    for i, c in enumerate(cols):
        xs, n_valid = reps[i]
        q_t = torch.tensor([0.5], dtype=torch.float64, device=xs.device)
        v = _quantile_from_sorted(xs, n_valid, q_t, "linear")[0].to(torch.float64)
        if not skipna:
            v = torch.where(n_valid < n, float("nan"), v)
        results.append(v)
    return [np.asarray(r) for r in _engine_materialize(results)]


def _axis1_matrix(cols: List[torch.Tensor]) -> torch.Tensor:
    """Columns stacked into a (rows, k) matrix in their numpy common dtype
    (pandas' axis-1 upcast rule; bool counts as int8)."""
    from modin_tpu_torch.utils import numpy_dtype, torch_dtype

    common = np.result_type(*[numpy_dtype(c.dtype) for c in cols])
    if common.kind == "b":
        common = np.dtype(np.int8)
    t = torch_dtype(common)
    return torch.stack([c.to(t) for c in cols], dim=1)


def nunique_axis1(cols: List[torch.Tensor], n: int, dropna: bool = True) -> torch.Tensor:
    """Row-wise distinct count across columns -> device int64 column: the
    rows sorted, then their adjacent differences, ``AXIS1_CHUNK_ROWS`` rows
    at a time."""
    n = int(n)
    out = torch.empty(n, dtype=torch.int64, device=cols[0].device)
    for start in range(0, n, AXIS1_CHUNK_ROWS):
        x = _axis1_matrix([c[start:start + AXIS1_CHUNK_ROWS] for c in cols])
        xs, nv = _sorted_rows(x)
        k = xs.shape[1]
        j = torch.arange(1, k, device=xs.device)
        news = (xs[:, 1:] != xs[:, :-1]) & (j[None, :] < nv[:, None])
        distinct = torch.where(nv > 0, 1 + news.sum(dim=1), 0)
        if not dropna and xs.dtype.is_floating_point:
            distinct = distinct + (nv < k).to(distinct.dtype)
        out[start:start + x.shape[0]] = distinct
    return out


def _mode_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each row of ``x``: its modal values in ascending order in the
    first slots (zeros after), which slots hold one, and how many."""
    nrow, k = x.shape
    xs, nv = _sorted_rows(x)
    j = torch.arange(k, device=x.device)
    valid = j[None, :] < nv[:, None]
    firsts = torch.ones_like(xs, dtype=torch.bool)
    firsts[:, 1:] = xs[:, 1:] != xs[:, :-1]
    firsts = firsts & valid
    rid = torch.cumsum(firsts, dim=1) - 1
    # run lengths without a 2-D scatter: k equality folds
    run_counts = torch.stack([((rid == q) & valid).sum(dim=1) for q in range(k)], dim=1)
    count_of = torch.gather(run_counts, 1, torch.clamp(rid, min=0))
    max_count = torch.where(valid, count_of, 0).max(dim=1).values
    is_modal = firsts & (count_of == max_count[:, None])
    m = is_modal.sum(dim=1)
    slot = torch.where(is_modal, torch.cumsum(is_modal, dim=1) - 1, k)
    vals = torch.zeros((nrow, k + 1), dtype=xs.dtype, device=x.device)
    vals.scatter_(1, slot, xs)
    placed = torch.zeros((nrow, k + 1), dtype=torch.bool, device=x.device)
    placed.scatter_(1, slot, torch.ones_like(is_modal))
    return vals[:, :k], placed[:, :k], m


def mode_axis1(cols: List[torch.Tensor], n: int) -> Tuple[List[torch.Tensor], int, bool]:
    """Row-wise modes (``dropna=True``), ``AXIS1_CHUNK_ROWS`` rows at a time
    so that the device memory stays bounded.

    Returns (the result columns, the most modes of any row, whether every
    row has that many).  Uniform rows keep the columns' dtype (no padding);
    ragged ones come as float64 padded with NaN, as pandas upcasts them.
    """
    n = int(n)
    k = len(cols)
    device = cols[0].device
    vals_t = placed_t = None
    m_all = torch.empty(n, dtype=torch.int64, device=device)
    for start in range(0, n, AXIS1_CHUNK_ROWS):
        x = _axis1_matrix([c[start:start + AXIS1_CHUNK_ROWS] for c in cols])
        vals, placed, m = _mode_rows(x)
        if vals_t is None:
            # column-major: each result column is one contiguous row
            vals_t = torch.empty((k, n), dtype=vals.dtype, device=device)
            placed_t = torch.empty((k, n), dtype=torch.bool, device=device)
        stop = start + x.shape[0]
        vals_t[:, start:stop] = vals.T
        placed_t[:, start:stop] = placed.T
        m_all[start:stop] = m
        del x, vals, placed, m
    m_max, uniform = _engine_materialize([m_all.max(), (m_all == m_all.max()).all()])
    m_max, uniform = int(m_max), bool(uniform)
    if m_max == 0:
        return [], 0, uniform
    if uniform:
        out = vals_t[:m_max]
    else:
        out = torch.where(placed_t[:m_max], vals_t[:m_max].to(torch.float64), float("nan"))
    del vals_t, placed_t
    return [out[j] for j in range(m_max)], m_max, uniform


# --------------------------------------------------------------------- #
# Whole-plan fusion: a filter fused into its reduction
# --------------------------------------------------------------------- #


def donation_map(roots: List[Any], donate_cols: Optional[List[Any]]) -> dict:
    """``{id(tensor): column}`` of the ``donate_cols`` (proved donation-safe
    by the caller) whose tensors the expression forest ``roots`` reads."""
    if not donate_cols:
        return {}
    from modin_tpu_torch.ops.lazy import leaf_buffer_ids

    consumed = leaf_buffer_ids(roots)
    return {
        id(col._data): col
        for col in donate_cols
        if isinstance(col._data, torch.Tensor) and id(col._data) in consumed
    }


def mark_donated(donated: dict) -> None:
    """The launches that read the donated columns are enqueued: drop their
    tensors (``DeviceColumn.mark_donated``).  The caching allocator reuses a
    freed block in the order of the stream that allocated it, so a tensor
    read on another stream is recorded on that stream first."""
    from modin_tpu_torch.core import memory

    if not donated:
        return
    freed = 0
    for col in donated.values():
        t = col._data
        if t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))
        freed += col.mark_donated()
    memory.count("fuse.donated", len(donated))
    memory.count("fuse.donated_bytes", freed)


def _mark_and_run(roots: List[Any], tail_key: Tuple, tail: Any, donate_cols: Optional[List[Any]]):
    """``run_fused`` with buffer donation (the JAX package's
    ``_mark_and_run``): the ``donate_cols`` whose tensors the forest reads
    are marked donated once its launches are enqueued (the tail's result
    fetched), never before: a failed run donates nothing."""
    donated = donation_map(roots, donate_cols)
    out = run_fused(roots, tail_key, tail, donated=bool(donated))
    mark_donated(donated)
    return out


def reduce_columns_masked(
    op_name: str,
    cols: List[Any],
    keep: Any,
    n: int,
    skipna: bool = True,
    ddof: int = 1,
    cast_bool: bool = False,
    donate_cols: Optional[List[Any]] = None,
) -> Tuple[list, int]:
    """Reduce each column over the rows where ``keep`` is true: the masked
    tail of the fused kernel (``modin_tpu/ops/reductions.py::
    reduce_columns_masked``).  ``keep`` is a bool column or a deferred bool
    expression over the same ``n`` uncompacted rows, so the filter, its map
    chain and the reduction run as one launch (two for a moments op) with no
    compaction.  Returns ``(values, kept_rows)``: 0-d numpy results by
    :func:`reduce_columns`' rules over the kept rows, and the kept-row count
    (the caller declines when it is 0: pandas' empty-frame answers stay with
    the staged path).  ``donate_cols`` are the scan's columns the fused leg
    proved donation-safe (``plan/fuse._donation_candidates``)."""
    if op_name not in REDUCTIONS:
        raise ValueError(f"reduction {op_name!r} is not ported")
    skipna, ddof = bool(skipna), int(ddof)
    tail = ("reduce", op_name, skipna, ddof, bool(cast_bool), True)

    def finish(first: torch.Tensor, second: Optional[torch.Tensor]):
        kept = int(_engine_materialize(first[-1, 1]))
        values = _finish_fused(op_name, cols, first[:-1], second, kept, skipna, ddof, cast_bool)
        return values, kept

    return _mark_and_run(list(cols) + [keep], tail, finish, donate_cols)
