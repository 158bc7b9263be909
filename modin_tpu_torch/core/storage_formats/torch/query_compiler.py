"""``TorchQueryCompiler`` — the device query compiler of the torch port.

The port's counterpart of ``modin_tpu/core/storage_formats/tpu/
query_compiler.py``, cut to the slices ported so far:

- ``from_pandas``/``to_pandas``/``from_numpy_columns``;
- elementwise binary ops incl. the logical ``&``/``|``/``^``
  (``_try_device_binary``), ``abs``/``negative``/``invert``;
- column reductions (``_try_device_reduce``) and groupby aggregations on
  key columns (``groupby_agg`` -> ``_try_device_groupby``);
- the relational paths: boolean-mask and positional row selection
  (``getitem_array``, ``getitem_row_array``, ``row_slice``,
  ``take_2d_positional``), ``setitem``/``insert``, ``rowwise_query``
  (``df.query``), ``concat``, ``isin``, ``merge`` (the device sort-merge
  join) and ``sort_rows_by_column_values``.

Each device path gates on the dtypes and arguments it can honor exactly as
the JAX compiler's gates do, and declines by returning None.  A declined
operation defaults to pandas: the frame goes to pandas, pandas computes the
result, and the result comes back through ``from_pandas``.  That is modin's
correctness floor, not a device fallback; ``DEFAULTS_TO_PANDAS`` counts it.
Where the JAX compiler has a device path the port does not have yet (string
keys through dictionary codes, host-column payloads of sorts and joins,
``axis=1`` reductions, ``as_index=False``, the planner, out-of-core and
range-partition variants of sort and merge), the port defaults to pandas.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from modin_tpu_torch.core.dataframe.torch.dataframe import (
    DeviceColumn,
    TorchDataframe,
    _is_device_dtype,
)
from modin_tpu_torch.core.dataframe.torch.metadata import LazyIndex
from modin_tpu_torch.ops import elementwise, reductions
from modin_tpu_torch.ops import groupby as gb_ops
from modin_tpu_torch.ops import join as join_ops
from modin_tpu_torch.ops import sort as sort_ops
from modin_tpu_torch.ops.structural import gather_columns_device
from modin_tpu_torch.utils import (
    MODIN_UNNAMED_SERIES_LABEL,
    hashable,
    numpy_dtype,
    torch_dtype,
)

# operations that went to pandas because no device path took them
DEFAULTS_TO_PANDAS = 0


def _is_numeric_dtype(dtype: Any) -> bool:
    if isinstance(dtype, np.dtype):
        return dtype.kind in "biufc"
    return bool(getattr(dtype, "_is_numeric", False))


def _insert_label(labels: Sequence[Any], loc: int, label: Any) -> Sequence[Any]:
    """``labels`` with ``label`` at ``loc``: a new list, or a pandas Index's
    own ``insert`` (the method pandas' setitem/insert use)."""
    if isinstance(labels, (list, tuple)):
        labels = list(labels)
        return labels[:loc] + [label] + labels[loc:]
    return labels.insert(loc, label)


class TorchQueryCompiler:
    """Query compiler over a :class:`TorchDataframe`.

    ``_shape_hint == "column"`` marks a compiler that stands for a Series.
    """

    def __init__(self, frame: TorchDataframe, shape_hint: Optional[str] = None):
        self._modin_frame = frame
        self._shape_hint = shape_hint

    # ------------------------------------------------------------------ #
    # Data exchange
    # ------------------------------------------------------------------ #

    @classmethod
    def from_pandas(cls, df: Any, device: Optional[torch.device] = None) -> "TorchQueryCompiler":
        return cls(TorchDataframe.from_pandas(df, device))

    @classmethod
    def from_numpy_columns(
        cls, columns: dict, index: Any = None, device: Optional[torch.device] = None
    ) -> "TorchQueryCompiler":
        return cls(TorchDataframe.from_numpy_columns(columns, index, device))

    def to_pandas(self) -> Any:
        return self._modin_frame.to_pandas()

    def to_pandas_object(self) -> Any:
        """A pandas Series for a column-shaped compiler, else a DataFrame."""
        df = self.to_pandas()
        if self._shape_hint != "column":
            return df
        s = df.iloc[:, 0]
        if s.name == MODIN_UNNAMED_SERIES_LABEL:
            s.name = None
        return s

    def execute(self) -> None:
        self._modin_frame.finalize()

    # ------------------------------------------------------------------ #
    # Metadata
    # ------------------------------------------------------------------ #

    def get_columns(self) -> Sequence[Any]:
        return self._modin_frame.columns

    def get_index(self) -> Any:
        return self._modin_frame.index

    def __len__(self) -> int:
        return len(self._modin_frame)

    def getitem_column_array(self, labels: Sequence[Any]) -> "TorchQueryCompiler":
        frame = self._modin_frame
        positions = []
        for label in labels:
            pos = frame.column_position(label)
            if len(pos) != 1:
                raise KeyError(label)
            positions.append(pos[0])
        return type(self)(frame.select_columns_by_position(positions))

    def _device(self) -> torch.device:
        for col in self._modin_frame._columns:
            if col.is_device:
                return col.data.device
        from modin_tpu_torch.parallel.mesh import get_device

        return get_device()

    # ------------------------------------------------------------------ #
    # Default to pandas (the correctness floor)
    # ------------------------------------------------------------------ #

    def _from_pandas_result(self, result: Any) -> Any:
        import pandas

        if isinstance(result, pandas.Series):
            name = result.name if result.name is not None else MODIN_UNNAMED_SERIES_LABEL
            qc = type(self).from_pandas(result.to_frame(name), self._device())
            qc._shape_hint = "column"
            return qc
        if isinstance(result, pandas.DataFrame):
            return type(self).from_pandas(result, self._device())
        return result

    def _default_to_pandas(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        """Run ``fn(pandas_obj, *args, **kwargs)`` in pandas; compilers
        among the arguments go to pandas too."""
        global DEFAULTS_TO_PANDAS
        DEFAULTS_TO_PANDAS += 1
        args = tuple(
            a.to_pandas_object() if isinstance(a, TorchQueryCompiler) else a
            for a in args
        )
        return self._from_pandas_result(fn(self.to_pandas_object(), *args, **kwargs))

    # ================================================================== #
    # Device hot paths
    # ================================================================== #

    _ARITH_KINDS = frozenset("iuf")
    _CMP_OPS = frozenset(["eq", "ne", "lt", "le", "gt", "ge"])

    def _device_raw(self) -> Optional[List[torch.Tensor]]:
        """All columns as device tensors, or None if any column is host-only."""
        cols = self._modin_frame._columns
        if all(c.is_device for c in cols):
            return [c.data for c in cols]
        return None

    def _fast_index_match(self, other: "TorchQueryCompiler") -> bool:
        return self._modin_frame._index.equals(other._modin_frame._index)

    def _wrap_device_result(
        self,
        datas: List[torch.Tensor],
        col_labels: Optional[Sequence[Any]] = None,
    ) -> "TorchQueryCompiler":
        frame = self._modin_frame
        cols = [
            DeviceColumn(d, numpy_dtype(d.dtype), length=len(frame)) for d in datas
        ]
        return type(self)(
            frame.with_columns(cols, col_labels if col_labels is not None else frame.columns),
            self._shape_hint,
        )

    # ------------------------------- binary --------------------------- #

    def _try_device_binary(self, op: str, other: Any, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        if op not in elementwise.BINARY_OPS:
            return None
        if kwargs.get("level") is not None or kwargs.get("fill_value") is not None:
            return None
        frame = self._modin_frame
        if frame.num_cols == 0 or len(frame) == 0:
            return None
        cols = self._device_raw()
        if cols is None:
            return None
        kinds = [c.pandas_dtype.kind for c in frame._columns]
        logical = op in elementwise.LOGICAL_OPS
        if logical:
            if not all(k == "b" for k in kinds):
                return None
        elif op in self._CMP_OPS:
            if not all(k in "biuf" for k in kinds):
                return None
        elif not all(k in self._ARITH_KINDS for k in kinds):
            return None

        # scalar other
        if isinstance(other, (int, float, np.integer, np.floating)) and not isinstance(other, bool):
            if logical:
                return None  # bool & int: pandas' result dtype is not bool's
            if all(k in "iub" for k in kinds) and isinstance(other, (int, np.integer)):
                # pandas 3 promotes int floordiv/mod to float64 (inf/nan)
                # when any divisor is zero — data-dependent result dtype
                if op in ("floordiv", "mod") and int(other) == 0:
                    return None
                if op in ("rfloordiv", "rmod"):
                    return None  # the divisor is the (data) column
            return self._wrap_device_result(elementwise.binary_op_columns(op, cols, other))
        if isinstance(other, (bool, np.bool_)) and (logical or op in self._CMP_OPS):
            return self._wrap_device_result(
                elementwise.binary_op_columns(op, cols, bool(other))
            )

        # frame/series other
        if isinstance(other, TorchQueryCompiler):
            oframe = other._modin_frame
            ocols = other._device_raw()
            if ocols is None or not self._fast_index_match(other):
                return None
            okinds = [c.pandas_dtype.kind for c in oframe._columns]
            if logical:
                if not all(k == "b" for k in okinds):
                    return None
            elif not all(k in "biuf" for k in okinds):
                return None
            if (
                op in ("floordiv", "rfloordiv", "mod", "rmod")
                and all(k in "iub" for k in kinds)
                and all(k in "iub" for k in okinds)
            ):
                # pandas 3: any zero divisor promotes the int result to
                # float64 (inf/nan) — data-dependent dtype
                return None
            axis = kwargs.get("axis", None)
            self_is_col = self._shape_hint == "column"
            other_is_col = other._shape_hint == "column"
            if self_is_col and other_is_col:
                # series <op> series
                datas = elementwise.binary_op_columns(op, cols, ocols)
                a, b = list(frame.columns)[0], list(oframe.columns)[0]
                label = a if a == b else MODIN_UNNAMED_SERIES_LABEL
                return self._wrap_device_result(datas, col_labels=[label])
            if not self_is_col and other_is_col and axis in (0, "index"):
                # df <op> series broadcast down columns
                datas = elementwise.binary_op_columns(op, cols, ocols * frame.num_cols)
                return self._wrap_device_result(datas)
            if not self_is_col and not other_is_col:
                if list(frame.columns) != list(oframe.columns):
                    return None
                return self._wrap_device_result(
                    elementwise.binary_op_columns(op, cols, ocols)
                )
        return None

    # ------------------------------- maps ----------------------------- #

    def _try_device_unary(self, op: str, kinds: str = "iuf") -> Optional["TorchQueryCompiler"]:
        frame = self._modin_frame
        if len(frame) == 0:
            return None
        cols = self._device_raw()
        if cols is None or not all(
            c.pandas_dtype.kind in kinds for c in frame._columns
        ):
            return None
        return self._wrap_device_result(elementwise.unary_op_columns(op, cols))

    def abs(self) -> "TorchQueryCompiler":
        result = self._try_device_unary("abs")
        return result if result is not None else self._default_to_pandas(lambda o: o.abs())

    def negative(self) -> "TorchQueryCompiler":
        result = self._try_device_unary("negative")
        return result if result is not None else self._default_to_pandas(lambda o: -o)

    def invert(self) -> "TorchQueryCompiler":
        """``~``: logical not of bool columns, bitwise not of int ones."""
        result = self._try_device_unary("invert", kinds="biu")
        return result if result is not None else self._default_to_pandas(lambda o: ~o)

    # ----------------------------- reductions ------------------------- #

    def _try_device_reduce(
        self, op: str, axis: Any, skipna: bool, numeric_only: bool, kwargs: dict
    ) -> Optional["TorchQueryCompiler"]:
        if op not in reductions.REDUCTIONS:
            return None
        if kwargs.get("min_count", 0) not in (0, -1):
            return None
        if kwargs.get("bool_only"):
            return None
        frame = self._modin_frame
        if len(frame) == 0 or frame.num_cols == 0:
            return None
        if axis not in (0, None):
            return None
        positions = []
        for i, col in enumerate(frame._columns):
            ok = col.is_device and col.pandas_dtype.kind in "biuf"
            if ok:
                positions.append(i)
            elif not numeric_only or _is_numeric_dtype(col.pandas_dtype):
                # a numeric column we can't run on device, or (without
                # numeric_only) any host column
                return None
        if not positions:
            return None
        labels = frame.columns
        try:
            labels = labels[positions]  # pandas Index
        except TypeError:
            labels = [list(labels)[i] for i in positions]
        arrays = [frame._columns[i].data for i in positions]
        values = reductions.reduce_columns(
            op, arrays, len(frame), skipna=skipna, cast_bool=op in ("sum", "mean")
        )
        out_values = [v.item() for v in values]
        if op == "count":
            result = np.asarray(out_values, dtype=np.int64)
        elif len({isinstance(v, bool) for v in out_values}) > 1:
            # pandas keeps bools mixed with numbers as object
            result = np.asarray(out_values, dtype=object)
        else:
            result = np.asarray(out_values)
        qc = type(self).from_numpy_columns(
            {MODIN_UNNAMED_SERIES_LABEL: result}, index=labels, device=self._device()
        )
        qc._shape_hint = "column"
        return qc

    def _reduce(self, op: str, axis: Any = 0, skipna: bool = True, numeric_only: bool = False, **kwargs: Any):
        result = self._try_device_reduce(op, axis, skipna, numeric_only, kwargs)
        if result is not None:
            return result
        if op == "count":
            return self._default_to_pandas(
                lambda o: o.count(axis=axis, numeric_only=numeric_only, **kwargs)
            )
        return self._default_to_pandas(
            lambda o: getattr(o, op)(
                axis=axis, skipna=skipna, numeric_only=numeric_only, **kwargs
            )
        )

    def sum(self, **kwargs: Any):
        return self._reduce("sum", **kwargs)

    def mean(self, **kwargs: Any):
        return self._reduce("mean", **kwargs)

    def min(self, **kwargs: Any):
        return self._reduce("min", **kwargs)

    def max(self, **kwargs: Any):
        return self._reduce("max", **kwargs)

    def count(self, **kwargs: Any):
        return self._reduce("count", **kwargs)

    # ------------------------------- groupby -------------------------- #

    def groupby_agg(
        self,
        by: Any,
        agg_func: Any,
        axis: int = 0,
        groupby_kwargs: Optional[dict] = None,
        agg_args: tuple = (),
        agg_kwargs: Optional[dict] = None,
        how: str = "axis_wise",
        drop: bool = False,
        series_groupby: bool = False,
        selection: Any = None,
    ) -> "TorchQueryCompiler":
        groupby_kwargs = dict(groupby_kwargs or {})
        agg_kwargs = dict(agg_kwargs or {})
        result = self._try_device_groupby(
            by, agg_func, axis, groupby_kwargs, agg_args, agg_kwargs, drop,
            series_groupby, selection,
        )
        if result is not None:
            return result

        def pandas_groupby(obj, by_obj):
            gb = obj.groupby(by_obj, **groupby_kwargs)
            if selection is not None:
                gb = gb[selection]
            if isinstance(agg_func, str):
                return getattr(gb, agg_func)(*agg_args, **agg_kwargs)
            return gb.agg(agg_func, *agg_args, **agg_kwargs)

        return self._default_to_pandas(pandas_groupby, by)

    def _try_device_groupby(
        self, by, agg_func, axis, groupby_kwargs, agg_args, agg_kwargs, drop,
        series_groupby, selection,
    ) -> Optional["TorchQueryCompiler"]:
        if axis != 0 or agg_args:
            return None
        if not isinstance(agg_func, str) or agg_func not in gb_ops.SEGMENT_AGGS:
            return None
        if groupby_kwargs.get("level") is not None:
            return None
        if not groupby_kwargs.get("sort", True):
            return None
        if not groupby_kwargs.get("as_index", True):
            return None  # key-column reinsertion is not ported
        dropna = groupby_kwargs.get("dropna", True)
        numeric_only = bool(agg_kwargs.get("numeric_only", False))
        if agg_kwargs.get("min_count", 0) not in (0, -1):
            return None
        if agg_kwargs.get("skipna", True) is not True:
            return None
        extra = set(agg_kwargs) - {
            "numeric_only", "min_count", "ddof", "skipna", "engine",
            "engine_kwargs",
        }
        if extra:
            return None
        if agg_kwargs.get("engine") not in (None, "cython"):
            return None

        frame = self._modin_frame
        # resolve key columns: labels of this frame's own columns
        if not (isinstance(by, list) and drop and all(not hasattr(b, "to_pandas") for b in by)):
            return None
        key_positions: List[int] = []
        for label in by:
            pos = frame.column_position(label)
            if len(pos) != 1:
                return None
            key_positions.append(pos[0])
        key_labels = list(by)
        key_cols = [frame._columns[p] for p in key_positions]
        if not all(c.is_device and c.pandas_dtype.kind in "biuf" for c in key_cols):
            return None
        if len(frame) == 0:
            return None

        # resolve value columns
        if selection is not None:
            sel_list = [selection] if not isinstance(selection, list) else list(selection)
            value_positions = []
            for label in sel_list:
                pos = frame.column_position(label)
                if len(pos) != 1:
                    return None
                value_positions.append(pos[0])
        else:
            value_positions = [
                i for i in range(frame.num_cols) if i not in key_positions
            ]
        labels = list(frame.columns)
        value_cols = []
        value_labels = []
        for i in value_positions:
            col = frame._columns[i]
            if col.is_device and col.pandas_dtype.kind in "biuf":
                value_cols.append(col)
                value_labels.append(labels[i])
                continue
            if numeric_only:
                if _is_numeric_dtype(col.pandas_dtype):
                    return None  # numeric but not device-computable
                continue  # genuinely non-numeric: pandas drops it too
            if agg_func == "size":
                continue
            return None
        if agg_func != "size" and not value_cols:
            return None

        try:
            codes, n_groups, group_keys, sizes = gb_ops.factorize_keys(
                [c.data for c in key_cols], len(frame), dropna=dropna
            )
        except gb_ops._TooManyGroups:
            return None
        if n_groups == 0:
            return None

        # bool value columns aggregate as ints for sum/mean like pandas
        arrays = []
        for c in value_cols:
            a = c.data
            if a.dtype == torch.bool and agg_func in ("sum", "mean"):
                a = a.to(torch.int64)
            arrays.append(a)
        datas = gb_ops.groupby_reduce(
            agg_func, arrays, codes, n_groups, len(frame), sizes=sizes
        )
        if agg_func == "size":
            value_labels = [MODIN_UNNAMED_SERIES_LABEL]
        new_cols = [
            DeviceColumn(d, numpy_dtype(d.dtype), length=n_groups) for d in datas
        ]
        result_frame = TorchDataframe(
            new_cols,
            value_labels,
            LazyIndex.from_arrays(group_keys, key_labels),
            nrows=n_groups,
        )
        qc = type(self)(result_frame)
        if series_groupby or agg_func == "size":
            qc._shape_hint = "column"
        return qc

    # ---------------------------- row selection ----------------------- #

    def getitem_row_array(self, key: Any) -> "TorchQueryCompiler":
        return type(self)(
            self._modin_frame.take_rows_positional(np.asarray(list(key), dtype=np.int64)),
            self._shape_hint,
        )

    def row_slice(self, start: Optional[int], stop: Optional[int], step: Optional[int] = None) -> "TorchQueryCompiler":
        return type(self)(
            self._modin_frame.take_rows_positional(slice(start, stop, step)),
            self._shape_hint,
        )

    def take_2d_positional(self, index: Any = None, columns: Any = None) -> "TorchQueryCompiler":
        frame = self._modin_frame
        if columns is not None:
            if isinstance(columns, slice):
                positions = list(range(*columns.indices(frame.num_cols)))
            else:
                positions = [int(c) for c in columns]
            frame = frame.select_columns_by_position(positions)
        if index is not None:
            if not isinstance(index, slice):
                index = np.asarray(index if hasattr(index, "__len__") else list(index), dtype=np.int64)
            frame = frame.take_rows_positional(index)
        return type(self)(frame)

    def getitem_array(self, key: Any) -> "TorchQueryCompiler":
        """Rows where a boolean mask is True: a device mask (a compiler of
        one bool column) compacts on the device; a host mask gathers by its
        positions."""
        frame = self._modin_frame
        if isinstance(key, TorchQueryCompiler):
            mask_frame = key._modin_frame
            if (
                mask_frame.num_cols == 1
                and mask_frame.get_column(0).is_device
                and mask_frame.get_column(0).pandas_dtype == np.dtype(bool)
                and len(mask_frame) == len(frame)
                # pandas aligns a boolean-Series mask to the frame's index;
                # the positional path holds only when the indexes match
                and self._fast_index_match(key)
            ):
                return type(self)(
                    frame.filter_rows_mask_device(mask_frame.get_column(0).data),
                    self._shape_hint,
                )
        else:
            key_arr = np.asarray(key)
            if key_arr.dtype == bool:
                return type(self)(frame.filter_rows_mask(key_arr), self._shape_hint)
        return self._default_to_pandas(lambda obj, k: obj[k], key)

    # ------------------------------ setitem --------------------------- #

    def _column_from_value(self, value: Any) -> Optional[Any]:
        """A device column of this frame's length from a compatible value,
        or None (the caller then defaults to pandas)."""
        n = len(self._modin_frame)
        if isinstance(value, TorchQueryCompiler):
            vframe = value._modin_frame
            if vframe.num_cols == 1 and len(vframe) == n and self._fast_index_match(value):
                return vframe.get_column(0)
            return None
        if isinstance(value, (int, float, bool, np.integer, np.floating, np.bool_)):
            dtype = np.asarray(value).dtype
            if not _is_device_dtype(dtype):
                return None
            data = torch.full((n,), value, dtype=torch_dtype(dtype), device=self._device())
            return DeviceColumn(data, dtype, length=n)
        if isinstance(value, (np.ndarray, list, tuple, range)):
            arr = np.array(value)  # a copy: the caller may write to its array
            if arr.ndim == 1 and len(arr) == n and _is_device_dtype(arr.dtype):
                return DeviceColumn.from_numpy(arr, self._device())
        return None

    def setitem(self, axis: int, key: Any, value: Any) -> "TorchQueryCompiler":
        """Set the column ``key`` (``axis=0``; setting a row is a later
        slice of the port)."""
        if axis != 0:
            raise NotImplementedError("setitem sets columns (axis=0) only")
        frame = self._modin_frame
        col = self._column_from_value(value) if len(frame) > 0 else None
        positions = frame.column_position(key)
        if col is not None and len(positions) <= 1:
            new_cols = list(frame._columns)
            if positions:
                new_cols[positions[0]] = col
                return type(self)(frame.with_columns(new_cols))
            new_cols.append(col)
            labels = _insert_label(frame.columns, len(new_cols) - 1, key)
            return type(self)(frame.with_columns(new_cols, labels))

        def setter(df, v):
            df = df.copy()
            df[key] = v
            return df

        return self._default_to_pandas(setter, value)

    def insert(self, loc: int, column: Any, value: Any) -> "TorchQueryCompiler":
        frame = self._modin_frame
        col = self._column_from_value(value) if len(frame) > 0 else None
        if col is not None:
            new_cols = list(frame._columns)
            new_cols.insert(loc, col)
            labels = _insert_label(frame.columns, loc, column)
            return type(self)(frame.with_columns(new_cols, labels))

        def inserter(df, v):
            df = df.copy()
            df.insert(loc, column, v, allow_duplicates=True)
            return df

        return self._default_to_pandas(inserter, value)

    # ------------------------------- query ---------------------------- #

    def rowwise_query(self, expr: str, **kwargs: Any) -> "TorchQueryCompiler":
        """Row-wise ``df.query`` compiled onto the device operator surface;
        NotImplementedError sends the caller to pandas."""
        local_dict = kwargs.pop("local_dict", None)
        if kwargs:
            raise NotImplementedError(
                "only plain row-wise expressions take the native query path"
            )
        from modin_tpu_torch.core.computation.eval import try_query
        from modin_tpu_torch.pandas.dataframe import DataFrame

        result = try_query(DataFrame(query_compiler=self), expr, local_dict)
        if result is None:
            raise NotImplementedError(
                f"the expression {expr!r} is not a supported row-wise query"
            )
        return result._query_compiler

    # ------------------------------- concat --------------------------- #

    def concat(
        self, axis: int, other: Any, join: str = "outer", ignore_index: bool = False,
        sort: bool = False, **kwargs: Any,
    ) -> "TorchQueryCompiler":
        others = list(other) if isinstance(other, (list, tuple)) else [other]
        result = self._try_device_concat(axis, others, ignore_index, sort, kwargs)
        if result is not None:
            return result

        def pandas_concat(first, *rest):
            import pandas

            return pandas.concat(
                [first, *rest], axis=axis, join=join, ignore_index=ignore_index,
                sort=sort, **kwargs,
            )

        return self._default_to_pandas(pandas_concat, *others)

    def _try_device_concat(
        self, axis: int, others: List[Any], ignore_index: bool, sort: bool, kwargs: dict
    ) -> Optional["TorchQueryCompiler"]:
        if kwargs or sort or not all(isinstance(o, TorchQueryCompiler) for o in others):
            return None  # sort=True reorders even identical labels
        base = self._modin_frame
        frames = [o._modin_frame for o in others]
        if axis == 0:
            labels = list(base.columns)
            if base.num_cols == 0 or not all(
                list(f.columns) == labels
                and all(
                    c.is_device and d.is_device and c.pandas_dtype == d.pandas_dtype
                    for c, d in zip(base._columns, f._columns)
                )
                for f in frames
            ):
                return None
            result = base.concat_rows(frames)
            if ignore_index:
                result._index = LazyIndex(None, len(result))
            return type(self)(result, self._shape_hint)
        if ignore_index or not all(self._fast_index_match(o) for o in others):
            return None
        # column concat of index-aligned frames: the column lists append,
        # no data moves; duplicate labels are legal in pandas concat
        new_cols = list(base._columns)
        labels = list(base.columns)
        for f in frames:
            new_cols.extend(f._columns)
            labels.extend(f.columns)
        return type(self)(TorchDataframe(new_cols, labels, base._index, nrows=len(base)))

    # -------------------------------- isin ---------------------------- #

    def isin(self, values: Any, ignore_indices: bool = False, **kwargs: Any) -> "TorchQueryCompiler":
        result = self._try_device_isin(values, kwargs)
        if result is not None:
            return result
        return self._default_to_pandas(lambda obj, v: obj.isin(v), values)

    def _try_device_isin(self, values: Any, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        """Membership of numeric device columns in a literal value list."""
        if kwargs or not isinstance(values, (list, tuple, set, frozenset, np.ndarray)):
            return None
        vals = list(values)
        if not 0 < len(vals) <= 1024 or not all(
            isinstance(v, (int, float, bool, np.integer, np.floating, np.bool_)) for v in vals
        ):
            return None
        frame = self._modin_frame
        cols = self._device_raw()
        if len(frame) == 0 or cols is None or not all(
            c.pandas_dtype.kind in "biuf" for c in frame._columns
        ):
            return None
        is_nan = [isinstance(v, (float, np.floating)) and np.isnan(v) for v in vals]
        clean = np.asarray([v for v, nan in zip(vals, is_nan) if not nan])
        if clean.size == 0:
            clean = np.empty(0, np.float64)
        all_int_values = clean.dtype.kind in "biu"
        device = self._device()
        datas = []
        for col, data in zip(frame._columns, cols):
            dtype = col.pandas_dtype
            if dtype.kind in "iu" and all_int_values:
                # an all-integer value list compares with integer columns
                # EXACTLY (no float64 rounding past 2^53); values outside
                # the column's range cannot match
                info = np.iinfo(dtype)
                ints = [int(v) for v in clean if info.min <= int(v) <= info.max]
                test = torch.as_tensor(np.asarray(ints, dtype=dtype), device=device)
                x = data
            else:
                # any float in the list promotes the comparison to float64,
                # column included: lossy, as pandas is
                test = torch.as_tensor(clean.astype(np.float64), device=device)
                x = data.to(torch.float64)
            hit = torch.isin(x, test)
            if any(is_nan) and dtype.kind == "f":
                hit = hit | torch.isnan(data)
            datas.append(hit)
        return self._wrap_device_result(datas)

    # -------------------------------- sort ---------------------------- #

    def sort_rows_by_column_values(self, columns: Any, ascending: Any = True, **kwargs: Any) -> "TorchQueryCompiler":
        result = self._try_device_sort(columns, ascending, kwargs)
        if result is not None:
            return result
        return self._default_to_pandas(
            lambda obj: obj.sort_values(columns, ascending=ascending, **kwargs)
        )

    def _try_device_sort(self, columns: Any, ascending: Any, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        """Stable multi-key sort by numeric device key columns; host
        payload columns follow the permutation on the host.  ``kind`` is not
        read: the sort is always stable, which is a valid answer for every
        kind (pandas sorts several keys stably whatever the kind)."""
        if kwargs.get("key") is not None:
            return None
        na_position = kwargs.get("na_position", "last")
        if na_position not in ("first", "last"):
            return None
        col_list = list(columns) if isinstance(columns, (list, tuple)) else [columns]
        asc = list(ascending) if isinstance(ascending, (list, tuple)) else [ascending] * len(col_list)
        if not col_list or len(asc) != len(col_list):
            return None
        frame = self._modin_frame
        if len(frame) == 0:
            return None
        keys = []
        for label in col_list:
            pos = frame.column_position(label)
            if len(pos) != 1:
                return None
            col = frame._columns[pos[0]]
            # bool and datetime keys are declined: no sort of bool tensors,
            # and NaT (int64 min) would sort first whatever na_position says
            if not col.is_device or col.pandas_dtype.kind not in "iuf":
                return None
            keys.append(col.data)
        perm = sort_ops.lexsort_permutation(
            keys, len(frame), [bool(a) for a in asc], na_position
        )
        index = LazyIndex(None, len(frame)) if kwargs.get("ignore_index", False) else None
        return type(self)(frame.take_rows_device(perm, index), self._shape_hint)

    # ------------------------------- merge ---------------------------- #

    def merge(self, right: Any, **kwargs: Any) -> "TorchQueryCompiler":
        result = self._try_device_merge(right, kwargs)
        if result is not None:
            return result
        return self._default_to_pandas(lambda left, r: left.merge(r, **kwargs), right)

    def _try_device_merge(self, right: Any, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        """The device sort-merge join for numeric keys (one or several key
        columns, every ``how``), all columns of both frames on the device."""
        how = kwargs.get("how", "inner")
        if how not in ("inner", "left", "right", "outer"):
            return None
        if (
            kwargs.get("left_index")
            or kwargs.get("right_index")
            or kwargs.get("sort")
            or kwargs.get("indicator")
            or kwargs.get("validate") is not None
            or not isinstance(right, TorchQueryCompiler)
        ):
            return None

        # ---- resolve key label pairs (multi-key capable) ---------------- #
        on, left_on, right_on = kwargs.get("on"), kwargs.get("left_on"), kwargs.get("right_on")

        def as_list(x):
            return list(x) if isinstance(x, list) else [x]

        if on is not None:
            l_keys = r_keys = as_list(on)
        elif left_on is not None and right_on is not None:
            l_keys, r_keys = as_list(left_on), as_list(right_on)
            if len(l_keys) != len(r_keys):
                return None
        else:
            return None
        if not all(hashable(x) for x in l_keys + r_keys):
            return None  # array-like keys take the pandas path
        # pandas collapses a key pair with identical labels into one column
        coalesce = [ll == rl for ll, rl in zip(l_keys, r_keys)]

        lframe, rframe = self._modin_frame, right._modin_frame
        l_labels, r_labels = list(lframe.columns), list(rframe.columns)
        if len(set(l_labels)) != len(l_labels) or len(set(r_labels)) != len(r_labels):
            return None
        if len(lframe) == 0 or len(rframe) == 0:
            return None
        if not all(c.is_device for c in lframe._columns + rframe._columns):
            return None  # host payloads (strings) are a later slice
        lkey_positions, rkey_positions = [], []
        for ll, rl in zip(l_keys, r_keys):
            lp, rp = lframe.column_position(ll), rframe.column_position(rl)
            if len(lp) != 1 or len(rp) != 1:
                return None
            lc, rc = lframe.get_column(lp[0]), rframe.get_column(rp[0])
            # exact dtype match: pandas promotes int32 vs int64 keys; bool
            # keys are declined (no sort of bool tensors)
            if lc.pandas_dtype.kind not in "iuf" or lc.pandas_dtype != rc.pandas_dtype:
                return None
            lkey_positions.append(lp[0])
            rkey_positions.append(rp[0])
        suffixes = kwargs.get("suffixes") or ("_x", "_y")
        if (
            not isinstance(suffixes, (tuple, list))
            or len(suffixes) != 2
            or not all(isinstance(sfx, str) and sfx for sfx in suffixes)
        ):
            return None  # None/empty suffixes have pandas-specific semantics
        if how == "outer" and not all(coalesce):
            # pandas sorts an outer result by the key tuple; with distinct
            # left_on/right_on labels the key lives in two columns
            return None

        coalesced_lkeys = {lp for lp, co in zip(lkey_positions, coalesce) if co}
        coalesced_rkeys = {rp for rp, co in zip(rkey_positions, coalesce) if co}
        lkey_to_rkey = {
            lp: rp for lp, rp, co in zip(lkey_positions, rkey_positions, coalesce) if co
        }
        right_value_positions = [i for i in range(rframe.num_cols) if i not in coalesced_rkeys]
        # bool columns on a side with missing matches become object in pandas
        if how in ("left", "outer") and any(
            rframe.get_column(i).pandas_dtype.kind == "b" for i in right_value_positions
        ):
            return None
        if how in ("right", "outer") and any(
            lframe.get_column(i).pandas_dtype.kind == "b"
            for i in range(lframe.num_cols)
            if i not in coalesced_lkeys
        ):
            return None

        # ---- key codes and match positions ------------------------------ #
        lkey_datas = [lframe.get_column(p).data for p in lkey_positions]
        rkey_datas = [rframe.get_column(p).data for p in rkey_positions]
        if len(lkey_datas) == 1:
            lkey, rkey = lkey_datas[0], rkey_datas[0]
        else:
            lkey, rkey = join_ops.composite_key_codes(lkey_datas, rkey_datas)
        if how == "right":
            # probe from the right side: output rows follow right order and
            # the left side is the nullable one
            rprobe_left, rprobe_right, n_out, has_miss = join_ops.sort_merge_positions(
                rkey, lkey, len(rframe), len(lframe), how="left"
            )
            left_pos, right_pos = rprobe_right, rprobe_left
        else:
            left_pos, right_pos, n_out, has_miss = join_ops.sort_merge_positions(
                lkey, rkey, len(lframe), len(rframe),
                how="left" if how in ("left", "outer") else "inner",
            )
        # outer: right rows the left join missed get appended
        appendix_positions, n_appendix = None, 0
        if how == "outer":
            appendix_positions, n_appendix = join_ops.right_only_positions(
                right_pos, len(rframe)
            )
        left_has_nulls = (how == "right" and has_miss) or n_appendix > 0
        right_has_nulls = how in ("left", "outer") and has_miss
        n_total = n_out + n_appendix

        # ---- gather + assemble: (data, dtype, source position, side) ---- #
        l_datas = [c.data for c in lframe._columns]
        if how == "right":
            l_gathered = join_ops.gather_right_columns(l_datas, left_pos)
        else:
            l_gathered = gather_columns_device(l_datas, left_pos)
        suffix_l, suffix_r = suffixes
        right_value_labels = {r_labels[i] for i in right_value_positions}
        new_cols: list = []
        new_labels: list = []
        for i, col in enumerate(lframe._columns):
            label = l_labels[i]
            if label in right_value_labels and i not in coalesced_lkeys:
                label = f"{label}{suffix_l}"
            data, dtype = l_gathered[i], col.pandas_dtype
            if how == "right" and i in lkey_to_rkey:
                # coalesced key: every output row is a right row, so the key
                # value comes from the (always valid) right side
                data = gather_columns_device([rframe.get_column(lkey_to_rkey[i]).data], right_pos)[0]
            if left_has_nulls and i not in coalesced_lkeys and dtype.kind in "iu":
                # pandas promotes int columns with missing matches to float64
                data = data.to(torch.float64)
                if how == "right":
                    data = torch.where(left_pos < 0, float("nan"), data)
                dtype = np.dtype(np.float64)
            new_cols.append((data, dtype, i, "left"))
            new_labels.append(label)
        right_datas = join_ops.gather_right_columns(
            [rframe.get_column(i).data for i in right_value_positions], right_pos
        )
        coalesced_labels = {l_labels[lp] for lp in coalesced_lkeys}
        for i, data in zip(right_value_positions, right_datas):
            label = r_labels[i]
            if label in l_labels and label not in coalesced_labels:
                label = f"{label}{suffix_r}"
            dtype = rframe.get_column(i).pandas_dtype
            if right_has_nulls and dtype.kind in "iu":
                data = torch.where(right_pos < 0, float("nan"), data.to(torch.float64))
                dtype = np.dtype(np.float64)
            new_cols.append((data, dtype, i, "right"))
            new_labels.append(label)
        if len(set(new_labels)) != len(new_labels):
            return None  # colliding suffixed labels: pandas raises MergeError

        # ---- outer appendix: right-only rows ----------------------------- #
        if n_appendix > 0:
            key_appendix = {
                lp: rframe.get_column(rp).data
                for lp, rp, co in zip(lkey_positions, rkey_positions, coalesce) if co
            }
            merged = []
            for data, dtype, src, side in new_cols:
                if side == "right":
                    app = gather_columns_device([rframe.get_column(src).data], appendix_positions)[0]
                elif src in key_appendix:
                    app = gather_columns_device([key_appendix[src]], appendix_positions)[0]
                else:
                    null = float("nan") if dtype.kind == "f" else join_ops._null_sentinel(data.dtype)
                    app = torch.full((n_appendix,), null, dtype=data.dtype, device=data.device)
                merged.append((torch.cat([data, app.to(data.dtype)]), dtype, src, side))
            new_cols = merged
        final_cols = [DeviceColumn(d, dt, length=n_total) for d, dt, _, _ in new_cols]
        result = TorchDataframe(final_cols, new_labels, LazyIndex(None, n_total), nrows=n_total)
        if how == "outer" and n_total > 0:
            # pandas sorts an outer merge by the join keys (stable, so equal
            # keys keep the left-join expansion order)
            perm = sort_ops.lexsort_permutation(
                [final_cols[lp].data for lp in lkey_positions], n_total,
                [True] * len(lkey_positions),
            )
            result = result.take_rows_device(perm, LazyIndex(None, n_total))
        return type(self)(result)


# ---------------------------------------------------------------------- #
# Generated binary ops: try the device path, else default to pandas.
# ---------------------------------------------------------------------- #


def _make_binary_override(op: str):
    def method(self: TorchQueryCompiler, other: Any, **kwargs: Any):
        result = self._try_device_binary(op, other, kwargs)
        if result is not None:
            return result
        return self._default_to_pandas(
            lambda obj, oth: getattr(obj, op)(oth, **kwargs), other
        )

    method.__name__ = op
    return method


for _op in sorted(elementwise.BINARY_OPS):
    setattr(TorchQueryCompiler, _op, _make_binary_override(_op))
