"""``TorchQueryCompiler`` — the device query compiler of the torch port.

The port's counterpart of ``modin_tpu/core/storage_formats/tpu/
query_compiler.py``, cut to the main path: ``from_pandas``/``to_pandas``/
``from_numpy_columns``, elementwise binary ops (``_try_device_binary``),
``abs``/``negative``, column reductions (``_try_device_reduce``) and groupby
aggregations on key columns (``groupby_agg`` -> ``_try_device_groupby``).

Each device path gates on the dtypes and arguments it can honor exactly as
the JAX compiler's gates do, and declines by returning None.  A declined
operation defaults to pandas: the frame goes to pandas, pandas computes the
result, and the result comes back through ``from_pandas``.  That is modin's
correctness floor, not a device fallback; ``DEFAULTS_TO_PANDAS`` counts it.
Where the JAX compiler has a device path the port does not have yet (string
keys through dictionary codes, ``axis=1`` reductions, ``as_index=False``),
the port defaults to pandas.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from modin_tpu_torch.core.dataframe.torch.dataframe import (
    DeviceColumn,
    TorchDataframe,
)
from modin_tpu_torch.core.dataframe.torch.metadata import LazyIndex
from modin_tpu_torch.ops import elementwise, reductions
from modin_tpu_torch.ops import groupby as gb_ops
from modin_tpu_torch.utils import MODIN_UNNAMED_SERIES_LABEL, numpy_dtype

# operations that went to pandas because no device path took them
DEFAULTS_TO_PANDAS = 0


def _is_numeric_dtype(dtype: Any) -> bool:
    if isinstance(dtype, np.dtype):
        return dtype.kind in "biufc"
    return bool(getattr(dtype, "_is_numeric", False))


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
        if op in self._CMP_OPS:
            if not all(k in "biuf" for k in kinds):
                return None
        elif not all(k in self._ARITH_KINDS for k in kinds):
            return None

        # scalar other
        if isinstance(other, (int, float, np.integer, np.floating)) and not isinstance(other, bool):
            if all(k in "iub" for k in kinds) and isinstance(other, (int, np.integer)):
                # pandas 3 promotes int floordiv/mod to float64 (inf/nan)
                # when any divisor is zero — data-dependent result dtype
                if op in ("floordiv", "mod") and int(other) == 0:
                    return None
                if op in ("rfloordiv", "rmod"):
                    return None  # the divisor is the (data) column
            return self._wrap_device_result(elementwise.binary_op_columns(op, cols, other))
        if isinstance(other, (bool, np.bool_)) and op in self._CMP_OPS:
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
            if not all(k in "biuf" for k in okinds):
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

    def _try_device_unary(self, op: str) -> Optional["TorchQueryCompiler"]:
        frame = self._modin_frame
        if len(frame) == 0:
            return None
        cols = self._device_raw()
        if cols is None or not all(
            c.pandas_dtype.kind in "iuf" for c in frame._columns
        ):
            return None
        return self._wrap_device_result(elementwise.unary_op_columns(op, cols))

    def abs(self) -> "TorchQueryCompiler":
        result = self._try_device_unary("abs")
        return result if result is not None else self._default_to_pandas(lambda o: o.abs())

    def negative(self) -> "TorchQueryCompiler":
        result = self._try_device_unary("negative")
        return result if result is not None else self._default_to_pandas(lambda o: -o)

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
