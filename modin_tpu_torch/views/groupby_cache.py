"""Groupby results through the artifact registry: small tables reused,
folded over appends.

The port's counterpart of ``modin_tpu/views/groupby_cache.py``.
``groupby_agg`` consults this module before the device groupby.  An
artifact holds the **result table** (a pandas frame of at most
``MODIN_TPU_TORCH_VIEWS_MAX_GROUPS`` rows) under the aggregation's
fingerprint and the identity of every participating column; a **fold**
runs the same device groupby over the appended tail rows only (views of
the columns, no copy) and combines the two tables on the host
(``incremental.combine_groupby``).

The gates are tight: the frame's own columns as keys, a string
aggregation; folding also needs sorted ``as_index=True``, ``dropna=True``
results over numeric device keys and values.  Anything else declines and
the ordinary device path (or pandas) runs as it would.
"""

from __future__ import annotations

import weakref
from typing import Any, List, Optional

from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.views import incremental, registry

_KIND = "groupby"


def _hashable(value: Any) -> bool:
    try:
        hash(value)
    except TypeError:
        return False
    return not hasattr(value, "to_pandas")  # an external key compiler


def _position(frame: Any, label: Any) -> Optional[int]:
    pos = frame.column_position(label)
    return pos[0] if len(pos) == 1 else None


def _participants(qc: Any, by: Any, selection: Any, agg_kwargs: dict):
    """(key positions, value positions) of the columns the aggregation
    reads, or None outside the cacheable gate.  Under ``numeric_only`` the
    values are the device path's own: non-numeric columns drop out, and a
    numeric column the device cannot compute declines."""
    frame = qc._modin_frame
    if not (isinstance(by, list) and by and all(_hashable(b) for b in by)):
        return None
    key_positions = [_position(frame, label) for label in by]
    if None in key_positions:
        return None
    if selection is not None:
        sel_list = [selection] if not isinstance(selection, list) else list(selection)
        if not all(_hashable(s) for s in sel_list):
            return None
        value_positions = [_position(frame, label) for label in sel_list]
        if None in value_positions:
            return None
    else:
        value_positions = [i for i in range(frame.num_cols) if i not in key_positions]
    if agg_kwargs.get("numeric_only", False):
        from pandas.api.types import is_numeric_dtype

        kept = []
        for p in value_positions:
            col = frame._columns[p]
            if col.is_device and col.pandas_dtype.kind in "biuf":
                kept.append(p)
            elif is_numeric_dtype(col.pandas_dtype):
                return None
        value_positions = kept
    return key_positions, value_positions


def _col_ident(col: Any) -> Optional[tuple]:
    if col.is_device:
        t = registry._tensor(col)
        if t is None:
            return None  # spilled or deferred: its identity is in flux
        return ("d", registry.ensure_token(col), id(t), int(t._version), col.length)
    # a host column has no token, and an id can be reused once its object
    # dies: the artifact also keeps weak references (_host_guards)
    return ("h", id(col), id(col.data))


def _host_guards(qc: Any, positions: List[int]) -> tuple:
    """(position index, weak reference) of every host participant: a cached
    result answers only while each still resolves to the object at that
    position."""
    frame = qc._modin_frame
    return tuple(
        (j, weakref.ref(frame._columns[p]))
        for j, p in enumerate(positions)
        if not frame._columns[p].is_device
    )


def _host_guards_hold(qc: Any, positions: List[int], guards: Any) -> bool:
    frame = qc._modin_frame
    for j, ref in guards or ():
        if j >= len(positions) or ref() is not frame._columns[positions[j]]:
            return False
    return True


def _fingerprint(by, agg_func, groupby_kwargs, agg_kwargs, drop, series_groupby, selection) -> Optional[tuple]:
    gk = tuple(sorted(groupby_kwargs.items())) if groupby_kwargs else ()
    ak = tuple(sorted(agg_kwargs.items())) if agg_kwargs else ()
    sel = tuple(selection) if isinstance(selection, list) else selection
    parts = (agg_func, tuple(by), gk, ak, bool(drop), bool(series_groupby), sel)
    try:
        hash(parts)
    except TypeError:
        return None
    return parts


def _anchor(qc: Any, positions: List[int]) -> Any:
    """The first concrete device participant: the artifact lives under its
    token."""
    frame = qc._modin_frame
    for p in positions:
        col = frame._columns[p]
        if col.is_device and registry._tensor(col) is not None:
            return col
    return None


def _idents(qc: Any, positions: List[int]) -> Optional[tuple]:
    out = []
    for p in positions:
        ident = _col_ident(qc._modin_frame._columns[p])
        if ident is None:
            return None
        out.append(ident)
    return tuple(out)


def _rebuild(qc: Any, state: dict) -> Any:
    result = type(qc).from_pandas(state["pdf"], qc._device())
    if state.get("shape_hint"):
        result._shape_hint = state["shape_hint"]
    return result


def _foldable(qc: Any, agg_func: str, groupby_kwargs: dict, positions: List[int]) -> bool:
    if agg_func not in incremental.FOLDABLE_GROUPBYS:
        return False
    if not groupby_kwargs.get("as_index", True) or not groupby_kwargs.get("dropna", True):
        return False
    frame = qc._modin_frame
    return all(
        frame._columns[p].is_device and frame._columns[p].pandas_dtype.kind in "biuf" for p in positions
    )


def _chain_base(col: Any, ident: tuple) -> Optional[int]:
    """The stored ident's length where it names an ancestor of ``col``
    along the append chain (``col[:length]`` is that ancestor's data)."""
    if ident[0] != "d":
        return None
    want_token, want_version, want_len = ident[1], ident[3], ident[4]
    link = col._view_parent
    hops = 0
    while link is not None and hops < registry._max_chain():
        ptok, plen, pver = link
        if ptok == want_token and plen == want_len and pver == want_version:
            return plen
        link = registry._parent_links.get(ptok)
        hops += 1
    return None


def groupby_consult(qc, by, agg_func, groupby_kwargs, agg_kwargs, drop, series_groupby, selection) -> Optional[Any]:
    """A cached or tail-folded groupby result, or None to run the device
    path."""
    if not isinstance(agg_func, str):
        return None
    got = _participants(qc, by, selection, agg_kwargs)
    if got is None:
        return None
    key_positions, value_positions = got
    positions = key_positions + value_positions
    fp = _fingerprint(by, agg_func, groupby_kwargs, agg_kwargs, drop, series_groupby, selection)
    anchor = _anchor(qc, positions) if fp is not None else None
    idents = _idents(qc, positions) if anchor is not None else None
    if idents is None:
        return None
    outcome, state, _base = registry.lookup(anchor, _KIND, fp)
    if (
        outcome == "hit"
        and state.get("idents") == idents
        and _host_guards_hold(qc, positions, state.get("host_guards"))
    ):
        return _rebuild(qc, state)
    if outcome == "fold" and _foldable(qc, agg_func, groupby_kwargs, positions):
        return _fold(qc, by, agg_func, groupby_kwargs, agg_kwargs, drop, series_groupby, selection,
                     positions, fp, state, idents, anchor)
    return None


def _fold(qc, by, agg_func, groupby_kwargs, agg_kwargs, drop, series_groupby, selection,
          positions, fp, state, idents, anchor):
    n0 = state.get("n")
    with _spans.span(
        "view.fold", "QUERY-COMPILER", op=f"groupby.{agg_func}", cols=len(positions),
        base=n0, tail=len(qc._modin_frame) - n0 if n0 is not None else None,
    ):
        return _fold_groups(qc, by, agg_func, groupby_kwargs, agg_kwargs, drop, series_groupby, selection,
                            positions, fp, state, idents, anchor)


def _fold_groups(qc, by, agg_func, groupby_kwargs, agg_kwargs, drop, series_groupby, selection,
                 positions, fp, state, idents, anchor):
    from modin_tpu_torch.config import ViewsMaxGroups
    from modin_tpu_torch.core.dataframe.torch.dataframe import DeviceColumn, TorchDataframe

    frame = qc._modin_frame
    n = len(frame)
    n0 = state.get("n")
    old_idents = state.get("idents")
    if n0 is None or old_idents is None or len(old_idents) != len(idents):
        return None
    for p, old_ident in zip(positions, old_idents):
        if _chain_base(frame._columns[p], old_ident) != n0:
            return None
    n_tail = n - n0
    if n_tail < 0:
        return None
    source = anchor._data
    datas = [frame._columns[p].data for p in positions]
    labels = list(frame.columns)

    def slice_qc(start: int, stop: int) -> Any:
        # views of the columns' rows: no copy
        cols = [
            DeviceColumn(d[start:stop], frame._columns[p].pandas_dtype, length=stop - start)
            for p, d in zip(positions, datas)
        ]
        return type(qc)(TorchDataframe(cols, [labels[p] for p in positions], None, nrows=stop - start))

    def run_groupby(sub_qc: Any, agg: str, kwargs: dict) -> Any:
        return sub_qc._try_device_groupby(
            list(by), agg, 0, groupby_kwargs, (), kwargs, drop, series_groupby, selection,
        )

    if n_tail == 0:
        combined, combined_count = state["pdf"], state.get("count_pdf")
        tail_shape_hint = state.get("shape_hint")
    else:
        old_count = state.get("count_pdf")
        if agg_func == "mean" and old_count is None:
            # built at the first fold, over the prefix rows (the
            # artifact's own rows), and written back to the ancestor so
            # later folds from it skip this pass
            prefix_count = run_groupby(slice_qc(0, n0), "count", {})
            if prefix_count is None:
                return None
            old_count = prefix_count.to_pandas()
            registry.amend_ancestor_state(
                anchor, _KIND, fp, n0, "count_pdf", old_count, extra_bytes=_pdf_bytes(old_count),
            )
        tail_qc = slice_qc(n0, n)
        tail_result = run_groupby(tail_qc, agg_func, agg_kwargs)
        if tail_result is None:
            return None
        tail_pdf = tail_result.to_pandas()
        tail_shape_hint = tail_result._shape_hint
        tail_count = None
        if agg_func == "mean":
            tail_count_result = run_groupby(tail_qc, "count", {})
            if tail_count_result is None:
                return None
            tail_count = tail_count_result.to_pandas()
        try:
            combined, combined_count = incremental.combine_groupby(
                agg_func, state["pdf"], tail_pdf, old_count, tail_count,
            )
        except (ValueError, TypeError):
            return None
    if len(combined) > int(ViewsMaxGroups.get()):
        # the combined table outgrew the bound: this chain can never fold
        # again, so the ancestor goes (else every later query would pay the
        # tail pass before recomputing in full)
        registry.invalidate_ancestor(anchor, _KIND, fp, "not_incremental")
        return None
    new_state = {
        "pdf": combined,
        "count_pdf": combined_count,
        "shape_hint": tail_shape_hint or state.get("shape_hint"),
        "idents": idents,
        "host_guards": (),  # the fold gate admits device columns only
        "n": n,
    }
    registry.store(
        anchor, _KIND, fp, new_state, can_fold=True,
        host_bytes=_pdf_bytes(combined) + _pdf_bytes(combined_count), folded=True, source=source,
    )
    return _rebuild(qc, new_state)


def groupby_record(qc, result, by, agg_func, groupby_kwargs, agg_kwargs, drop, series_groupby, selection) -> None:
    """Cache a freshly computed device-groupby result (bounded tables)."""
    from modin_tpu_torch.config import ViewsMaxGroups

    if not isinstance(agg_func, str):
        return
    got = _participants(qc, by, selection, agg_kwargs)
    if got is None:
        return
    key_positions, value_positions = got
    positions = key_positions + value_positions
    fp = _fingerprint(by, agg_func, groupby_kwargs, agg_kwargs, drop, series_groupby, selection)
    anchor = _anchor(qc, positions) if fp is not None else None
    idents = _idents(qc, positions) if anchor is not None else None
    if idents is None:
        return
    # the bound before any fetch: a result knows its row count
    if len(result._modin_frame) > int(ViewsMaxGroups.get()):
        return
    # fetched now, not deferred: callers routinely drop the result, and the
    # table is bounded by ViewsMaxGroups rows
    pdf = result.to_pandas()
    state = {
        "pdf": pdf,
        # the mean fold's per-group valid counts: built at the first fold
        "count_pdf": None,
        "shape_hint": result._shape_hint,
        "idents": idents,
        "host_guards": _host_guards(qc, positions),
        "n": len(qc._modin_frame),
    }
    registry.store(
        anchor, _KIND, fp, state, can_fold=_foldable(qc, agg_func, groupby_kwargs, positions),
        host_bytes=_pdf_bytes(pdf),
    )


def _pdf_bytes(pdf: Any) -> int:
    if pdf is None:
        return 0
    try:
        return int(pdf.memory_usage(deep=False).sum())
    except (AttributeError, TypeError, ValueError):
        return 1024
