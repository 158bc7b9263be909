"""External (out-of-core) sort and the spill-aware sort-merge join.

The port's counterpart of ``modin_tpu/streaming/external.py``.  The key
column uploads and sorts **one window at a time** with the resident path's
own permutation (``ops/sort.lexsort_permutation``: a stable ``torch.sort``
of the total-order key, NaN past +inf, na_position "last" in either
direction; the reference's is an XLA sort, so the port's stays a torch
sort).  Each window's sorted (merge key, global row id) pair goes to the
host as a sorted **run**, and the runs fold through a stable k-way merge
on the host (:func:`_fold_runs`, O(n log k), the earlier windows winning
ties: exactly a global stable sort).  Payload columns never touch
the device: the final permutation gathers them on the host, and the output
columns are born spilled (``DeviceColumn.spilled``: their exact host copies
are the only copies until a device consumer restores them), so an
out-of-core result claims no more device memory than its consumer touches.

The merge-join takes the same machinery as its build side: the right
key sorts externally into runs folded on the host, the left side probes
them window by window with the resident join's lo/hi ``searchsorted`` and
expand arithmetic, and both sides' columns gather by the positions.  The
output rows are pandas' ``merge`` order for ``sort=False`` (left order,
right ties in the right frame's order), which the stable external sort
keeps as the resident stable device sort does.

Both entry points return None wherever a gate fails, and the caller runs
the resident path: the router (``decide_residency``) chooses the
residency, and these only decline what they cannot reproduce exactly.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import pandas

from modin_tpu_torch.logging.metrics import emit_counted
from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.streaming import window_body
from modin_tpu_torch.streaming import windows as _windows

_I64 = np.iinfo(np.int64)

_count = emit_counted


# ---------------------------------------------------------------------- #
# merge keys: the host mirror of the device comparator
# ---------------------------------------------------------------------- #


def _total_order_np(x: np.ndarray) -> np.ndarray:
    """numpy mirror of ``ops/structural.float_total_order``: monotone
    float64 -> int64, -0.0 equal to 0.0, every NaN one key past +inf."""
    x = np.where(x == 0, 0.0, x)
    x = np.where(np.isnan(x), np.nan, x)  # one NaN bit pattern
    bits = np.ascontiguousarray(np.asarray(x, np.float64)).view(np.int64)
    return np.where(bits >= 0, bits, bits ^ np.int64(_I64.max))


def _merge_key(vals: np.ndarray, ascending: bool) -> np.ndarray:
    """int64 keys whose ascending order is the device sort's row order for
    na_position "last" in either direction (descending: NaN to the low
    sentinel the device sort uses, then a bit complement, which reverses
    the order and keeps ties stable)."""
    if vals.dtype.kind == "f":
        t = _total_order_np(vals.astype(np.float64, copy=False))
        if ascending:
            return t  # NaN's total-order key already sorts past +inf
        return ~np.where(np.isnan(vals), np.int64(_I64.min + 1), t)
    v = vals.astype(np.int64, copy=False)
    return v if ascending else ~v


def _fold_runs(runs: List[Tuple[np.ndarray, np.ndarray]]) -> Tuple[np.ndarray, np.ndarray]:
    """The k-way merge of window-ordered sorted runs: one stable sort of
    their concatenation, which keeps equal keys in window order (the
    earlier windows win ties, a global stable sort).  numpy's stable sort
    of int64 keys is a timsort, which finds the k runs and merges them in
    O(n log k); the reference folds them through a binary tree of
    ``searchsorted`` passes (``_merge_runs``), the same answer in more host
    passes over the keys."""
    with _spans.span("stream.merge", "QUERY-COMPILER", runs=len(runs)):
        keys = np.concatenate([r[0] for r in runs])
        ids = np.concatenate([r[1] for r in runs])
        order = np.argsort(keys, kind="stable")
        return keys[order], ids[order]


# ---------------------------------------------------------------------- #
# sorted runs (the per-window device sort)
# ---------------------------------------------------------------------- #


def _sort_runs(values: np.ndarray, n: int, ascending: bool, window_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """External sort of one key column: a device sort per window, its
    sorted (merge key, global row id) run written to the host, the runs
    folded.  Returns the merged (keys, permutation)."""
    from modin_tpu_torch.ops.sort import lexsort_permutation
    from modin_tpu_torch.parallel.engine import TorchWrapper

    runs: List[Tuple[np.ndarray, np.ndarray]] = []

    @window_body
    def one_window(start: int, stop: int) -> None:
        window = np.ascontiguousarray(values[start:stop])
        dev = TorchWrapper.put(window)
        perm = lexsort_permutation([dev], stop - start, [ascending])
        perm_h = TorchWrapper.materialize(perm).astype(np.int64, copy=False)
        del dev, perm  # the window's tensors go before the next upload
        run = (_merge_key(window[perm_h], ascending), start + perm_h)
        _count("stream.spill.run_bytes", run[0].nbytes + run[1].nbytes)
        runs.append(run)

    for start in range(0, n, window_rows):
        stop = min(start + window_rows, n)
        with _spans.span("stream.window", "QUERY-COMPILER", window=len(runs)):
            one_window(start, stop)
        _count("stream.window.count")
        _count("stream.window.rows", stop - start)
    return _fold_runs(runs)


def _sort_window_rows(itemsize: int = 8) -> int:
    """Rows of one sort window: the key window and the sort's permutation
    and working tensors within the streaming window's bytes."""
    from modin_tpu_torch.config import StreamPrefetch

    window_bytes = _windows.window_bytes_for(int(StreamPrefetch.get()))
    return max(window_bytes // (2 * max(itemsize, 1)), 1024)


def _sortable_key(col: Any) -> bool:
    """A device key column the external kernels compare exactly: a concrete
    bool, int or float column (uint64 would wrap as an int64 merge key)."""
    return (
        col.is_device
        and col.pandas_dtype.kind in "biuf"
        and col.pandas_dtype != np.uint64
        and not col.is_lazy
    )


# ---------------------------------------------------------------------- #
# external sort_values
# ---------------------------------------------------------------------- #


def external_sort_qc(qc: Any, columns: Any, ascending: Any, kwargs: dict) -> Optional[Any]:
    """Out-of-core ``sort_values``: the resident device sort's answer, or
    None where a gate fails (the resident path then runs)."""
    from modin_tpu_torch.core.dataframe.torch.dataframe import DeviceColumn, HostColumn, TorchDataframe
    from modin_tpu_torch.core.dataframe.torch.metadata import LazyIndex

    if kwargs.get("na_position", "last") != "last" or kwargs.get("key") is not None:
        return None
    col_list = list(columns) if isinstance(columns, (list, tuple)) else [columns]
    if len(col_list) != 1:
        return None  # several keys need a composite merge key: resident
    asc = ascending[0] if isinstance(ascending, (list, tuple)) else ascending
    frame = qc._modin_frame
    n = len(frame)
    labels = pandas.Index(frame.columns)
    if n == 0 or not labels.is_unique:
        return None
    pos = frame.column_position(col_list[0])
    if len(pos) != 1:
        return None
    key_col = frame._columns[pos[0]]
    if not _sortable_key(key_col):
        return None
    for c in frame._columns:
        if (c.is_device and c.is_lazy) or (not c.is_device and not hasattr(c.data, "take")):
            return None
    window_rows = _sort_window_rows(key_col.pandas_dtype.itemsize)
    if n <= window_rows:
        return None  # one window is the resident sort

    _keys, perm = _sort_runs(key_col.to_numpy(), n, bool(asc), window_rows)
    device = qc._device()
    new_cols: list = []
    for c in frame._columns:
        if c.is_device:
            new_cols.append(DeviceColumn.spilled(np.ascontiguousarray(c.to_numpy()[perm]), device))
        else:
            new_cols.append(HostColumn(c.data.take(perm)))
    if kwargs.get("ignore_index", False):
        new_index = LazyIndex(None, n)
    else:
        lazy = frame._index
        new_index = LazyIndex(lambda: lazy.get().take(perm), n)
    return type(qc)(TorchDataframe(new_cols, frame.columns, new_index, nrows=n), qc._shape_hint)


# ---------------------------------------------------------------------- #
# the spill-aware merge-join
# ---------------------------------------------------------------------- #


def _single(x: Any) -> Any:
    if isinstance(x, list):
        return x[0] if len(x) == 1 else None
    return x


def _host_gather(col: Any, positions: np.ndarray) -> Any:
    """A host column gathered by join positions (-1: a miss)."""
    values = col.data
    if (positions >= 0).all():
        # a plain take keeps the array's dtype (a StringDtype column stays
        # one, as the resident merge keeps it)
        return values.take(positions)
    # a miss-capable gather on objects, then the original dtype where it
    # takes the misses' NaN (as the resident path's host gather)
    vals = np.asarray(values, dtype=object)
    out = np.empty(positions.size, dtype=object)
    valid = positions >= 0
    out[valid] = vals[positions[valid]]
    out[~valid] = np.nan
    dtype = col.pandas_dtype
    if pandas.api.types.is_object_dtype(dtype):
        return out
    try:
        return pandas.array(out, dtype=dtype)
    except (TypeError, ValueError):
        return out


def external_merge_qc(qc: Any, right: Any, kwargs: dict) -> Optional[Any]:
    """Out-of-core sort-merge join: the right (build) key sorts externally
    into host runs, the left side probes them window by window, and the
    output gathers on the host into columns born spilled.  The resident
    device merge's answer (pandas' ``merge`` row order for ``sort=False``),
    or None where a gate fails."""
    from modin_tpu_torch.core.dataframe.torch.dataframe import DeviceColumn, HostColumn, TorchDataframe
    from modin_tpu_torch.core.dataframe.torch.metadata import LazyIndex
    from modin_tpu_torch.utils import hashable

    how = kwargs.get("how", "inner")
    if how not in ("inner", "left"):
        return None
    if (
        kwargs.get("left_index")
        or kwargs.get("right_index")
        or kwargs.get("sort")
        or kwargs.get("indicator")
        or kwargs.get("validate") is not None
        or not isinstance(right, type(qc))
    ):
        return None
    on = kwargs.get("on")
    if on is not None:
        l_label = r_label = _single(on)
    elif kwargs.get("left_on") is not None and kwargs.get("right_on") is not None:
        l_label, r_label = _single(kwargs["left_on"]), _single(kwargs["right_on"])
    else:
        return None
    if l_label is None or r_label is None or not hashable(l_label) or not hashable(r_label):
        return None
    coalesce = l_label == r_label

    lframe, rframe = qc._modin_frame, right._modin_frame
    l_labels, r_labels = list(lframe.columns), list(rframe.columns)
    if len(set(l_labels)) != len(l_labels) or len(set(r_labels)) != len(r_labels):
        return None
    if len(lframe) == 0 or len(rframe) == 0:
        return None
    lp, rp = lframe.column_position(l_label), rframe.column_position(r_label)
    if len(lp) != 1 or len(rp) != 1:
        return None
    lkey_col, rkey_col = lframe._columns[lp[0]], rframe._columns[rp[0]]
    if not (_sortable_key(lkey_col) and _sortable_key(rkey_col)):
        return None
    if lkey_col.pandas_dtype != rkey_col.pandas_dtype:
        return None  # pandas promotes mixed key dtypes: resident
    # no suffixes here: any non-key label collision declines
    r_out = [i for i in range(rframe.num_cols) if not (coalesce and i == rp[0])]
    if set(l_labels) & {r_labels[i] for i in r_out}:
        return None

    def object_like(c: Any) -> bool:
        return pandas.api.types.is_object_dtype(c.pandas_dtype) or isinstance(c.pandas_dtype, pandas.StringDtype)

    for fr in (lframe, rframe):
        for c in fr._columns:
            if (c.is_device and c.is_lazy) or (not c.is_device and not object_like(c)):
                return None
    if how == "left" and any(rframe._columns[i].is_device and rframe._columns[i].pandas_dtype.kind == "b"
                             for i in r_out):
        return None  # a missed bool becomes object in pandas: resident
    n_left, n_right = len(lframe), len(rframe)
    window_rows = _sort_window_rows(rkey_col.pandas_dtype.itemsize)
    if max(n_left, n_right) <= window_rows:
        return None  # one window: the resident kernels

    # the build side: the right key's externally sorted runs
    r_keys_sorted, r_ids_sorted = _sort_runs(rkey_col.to_numpy(), n_right, True, window_rows)

    # the probe side: searchsorted and expand, a window at a time
    l_values = lkey_col.to_numpy()
    left_parts: List[np.ndarray] = []
    right_parts: List[np.ndarray] = []

    @window_body
    def probe_window(start: int, stop: int) -> None:
        lk = _merge_key(np.ascontiguousarray(l_values[start:stop]), True)
        # the window's keys probe in sorted order (each search starts near
        # the last one's answer) and the bounds scatter back to row order
        order = np.argsort(lk, kind="stable")
        probe = lk[order]
        lo = np.empty(lk.size, dtype=np.int64)
        hi = np.empty(lk.size, dtype=np.int64)
        lo[order] = np.searchsorted(r_keys_sorted, probe, side="left")
        hi[order] = np.searchsorted(r_keys_sorted, probe, side="right")
        counts = hi - lo
        emit = np.maximum(counts, 1) if how == "left" else counts
        total = int(emit.sum())
        if total == 0:
            return
        ends = np.cumsum(emit)
        out = np.arange(total, dtype=np.int64)
        left_idx = np.searchsorted(ends, out, side="right")
        within = out - (ends - emit)[left_idx]
        right_rows = r_ids_sorted[np.minimum(lo[left_idx] + within, r_ids_sorted.size - 1)]
        if how == "left":
            right_rows = np.where(counts[left_idx] > 0, right_rows, -1)
        left_parts.append(start + left_idx)
        right_parts.append(right_rows)

    for start in range(0, n_left, window_rows):
        probe_window(start, min(start + window_rows, n_left))
    left_pos = np.concatenate(left_parts) if left_parts else np.empty(0, np.int64)
    right_pos = np.concatenate(right_parts) if right_parts else np.empty(0, np.int64)
    n_out = left_pos.size
    miss = right_pos < 0
    has_miss = bool(miss.any())

    device = qc._device()
    new_cols: list = []
    labels: list = []
    for i, c in enumerate(lframe._columns):
        labels.append(l_labels[i])
        if c.is_device:
            new_cols.append(DeviceColumn.spilled(np.ascontiguousarray(c.to_numpy()[left_pos]), device))
        else:
            new_cols.append(HostColumn(_host_gather(c, left_pos)))
    safe_right = np.where(miss, 0, right_pos)
    for i in r_out:
        c = rframe._columns[i]
        labels.append(r_labels[i])
        if c.is_device:
            vals = c.to_numpy()[safe_right]
            if has_miss:
                kind = c.pandas_dtype.kind
                if kind in "fmM":
                    vals = vals.copy()
                    vals[miss] = np.nan if kind == "f" else np.array("NaT", dtype=c.pandas_dtype)
                else:  # an int promotes to float64 with NaN, as in pandas
                    vals = vals.astype(np.float64)
                    vals[miss] = np.nan
            new_cols.append(DeviceColumn.spilled(np.ascontiguousarray(vals), device))
        else:
            new_cols.append(HostColumn(_host_gather(c, right_pos)))
    return type(qc)(TorchDataframe(new_cols, pandas.Index(labels), LazyIndex(None, n_out), nrows=n_out))
