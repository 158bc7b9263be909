"""``TorchQueryCompiler`` — the device query compiler of the torch port.

The port's counterpart of ``modin_tpu/core/storage_formats/tpu/
query_compiler.py``, cut to the slices ported so far:

- ``from_pandas``/``to_pandas``/``from_numpy_columns``;
- elementwise binary ops incl. the logical ``&``/``|``/``^`` and ``**``
  (``_try_device_binary``; a frame against a Series along its columns,
  ``df - df.mean()``, through ``_try_device_binary_along_columns``), the
  cumulative ops (``_cum_op``) and ``shift``/``diff`` (``_try_shift_like``).
  The elementwise ops and maps defer (``ops/lazy.py``): a result column
  holds an expression (``DeviceColumn.raw``) until a consumer needs values,
  and reductions, filters and ``to_pandas`` run a chain as one fused
  launch; a consumer of several columns' values takes them through
  ``_device_cols`` (one launch for the frame's deferred columns);
- the maps ``abs``/``negative``/``invert``, ``isna``/``notna``, ``round``,
  ``fillna`` (a scalar, a dict, ``fillna(df.mean())``) and ``clip`` over
  the device columns, with pandas' own function over the host (string)
  columns in their places (``_map_device_host``); ``astype`` to one
  numeric dtype; ``df.loc[mask, col] = scalar`` (``setitem_bool``) and
  ``dropna``;
- column reductions sum/mean/count/min/max/prod/var/std/sem/skew/kurt/
  any/all and median, along either axis (``_try_device_reduce``); the sort-shaped
  family over a shared sorted representation — ``nunique``, ``mode`` (both
  axes), ``quantile``, ``describe`` — with the bincount kernel as the
  histogram of bounded-range int columns; ``idxmin``/``idxmax``,
  ``nlargest``/``nsmallest`` (frame and Series), ``rank`` (its tie groups
  through the scan kernel) and ``duplicated``/``drop_duplicates`` (string
  keys by their dictionary codes);
- groupby aggregations on key columns or an external Series key
  (``groupby_agg`` -> ``_try_device_groupby``: the segment and order
  aggregations), ``as_index=False`` through ``reset_index``; ``agg`` with
  a list or a dict of names (``_try_device_groupby_multi``), ``describe``,
  the grouped cumulatives, ``cumcount``/``ngroup`` and ``transform`` of a
  reduction (the row-shaped ops gate through
  ``_resolve_rowwise_groupby``);
- rolling and expanding sum/mean/count/min/max/var/std/sem and ewm
  mean/sum/var/std/cov/corr (``_try_device_rolling``,
  ``_try_device_expanding``, ``_try_device_ewm``, ``_try_device_ewm_pair``);
- the relational paths: boolean-mask and positional row selection
  (``getitem_array``, ``getitem_row_array``, ``row_slice``,
  ``take_2d_positional``), ``setitem``/``insert``, column ``drop``,
  ``rowwise_query`` (``df.query``), ``concat``, ``isin``, ``merge`` (the
  device sort-merge join) and ``sort_rows_by_column_values``;
- string and object columns through their dictionary encoding
  (``ops/dictionary.py``): groupby, sort and merge keys, comparisons with a
  string, ``isin``, ``nunique``/``mode``, ``min``/``max``/``count``,
  ``unique``, ``series_value_counts`` and the ``.str`` predicates and
  measures (``_try_str_lut``); their payloads travel on the host;
- the ``.dt`` fields of naive datetime and timedelta columns
  (``_try_dt_component``, ``ops/datetime_parts.py``), ``resample`` of a
  sorted ``DatetimeIndex`` (``_try_device_resample``,
  ``RESAMPLE_DEVICE_OPS``), bool sort and merge keys, ``corr``/``cov``
  (``_try_device_corr_cov``, ``ops/stats.py``), ``series_get_dummies``,
  dict ``series_map`` and numpy's math ufuncs (``unary_math``).

It is a :class:`BaseQueryCompiler`: every other pandas method exists there
and defaults to pandas.  Each device path gates on the dtypes and arguments
it can honor exactly as the JAX compiler's gates do, and declines by
returning None; a declined operation defaults to pandas too.  Every
``_try_*`` method carries ``@device_path(family)``
(``core/execution/resilience.py``): its family's circuit breaker, the
evict-then-retry leg for an OOM, and a counted fallback to pandas for a
classified device failure; a port-only method takes the family of its
nearest JAX counterpart (``concat`` the relational ``merge``, ``isin`` and
``clip`` the elementwise ``binary``, ``sort`` the ``sort_shuffle`` family).  The frame
goes to pandas, pandas computes the result, and the result comes back
through ``from_pandas``.  That is modin's correctness floor, not a device
fallback; ``DEFAULTS_TO_PANDAS`` counts every such call, wherever it is
made (``ErrorMessage.default_to_pandas``).  Where the JAX compiler has a
device path the port does not have yet (out-of-core and range-partition
variants of sort and merge, the ``views/`` result caches), the port
defaults to pandas; so does a sort-shaped reduction the kernel router
(``ops/router.py``) predicts faster in pandas.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from modin_tpu_torch.core.dataframe.torch.dataframe import (
    DeviceColumn,
    HostColumn,
    TorchDataframe,
    _is_device_dtype,
    column_of_series,
)
from modin_tpu_torch.core.dataframe.torch.metadata import LazyIndex
from modin_tpu_torch.core.storage_formats.base.query_compiler import (
    BaseQueryCompiler,
)
from modin_tpu_torch.config import PlanMode
from modin_tpu_torch.core.execution.resilience import device_path
from modin_tpu_torch.error_message import ErrorMessage
from modin_tpu_torch.ops import datetime_parts, dictionary, elementwise, reductions, sorted_cache, stats
from modin_tpu_torch.ops import groupby as gb_ops
from modin_tpu_torch import views
from modin_tpu_torch.ops import join as join_ops
from modin_tpu_torch.ops import sort as sort_ops
from modin_tpu_torch.ops import window as window_ops
from modin_tpu_torch.ops.lazy import materialize_exprs
from modin_tpu_torch.ops.structural import gather_columns_device
from modin_tpu_torch.parallel.engine import TorchWrapper
from modin_tpu_torch.utils import (
    MODIN_UNNAMED_SERIES_LABEL,
    has_torch_dtype,
    hashable,
    numpy_dtype,
    torch_dtype,
    try_cast_to_pandas,
)

# operations that went to pandas because no device path took them
# (incremented only by ErrorMessage.default_to_pandas)
DEFAULTS_TO_PANDAS = 0


def _is_categorical(col: Any) -> bool:
    """Whether ``col`` is a host column of a pandas categorical dtype."""
    return not col.is_device and getattr(col.pandas_dtype, "name", None) == "category"


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


def _same_dtype(a: Any, b: Any) -> bool:
    try:
        return bool(a == b)
    except (TypeError, ValueError):
        return False


def _is_number(v: Any) -> bool:
    """A numeric scalar that is not a bool."""
    return isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, (bool, np.bool_))


def _fractional(v: Any) -> bool:
    """Whether an int column cannot hold the numeric scalar ``v``: pandas'
    ``can_hold_element`` for values within the column's range."""
    return v is not None and not float(v).is_integer()


class TorchQueryCompiler(BaseQueryCompiler):
    """Query compiler over a :class:`TorchDataframe`.

    ``_shape_hint == "column"`` marks a compiler that stands for a Series.

    Deferred mode (``plan/``): a compiler built by :meth:`from_plan` holds a
    pending logical plan (``_plan``) instead of a frame.  Plan-capable
    methods carry a one-line guard that extends the plan; every other
    method reaches ``_modin_frame``, whose getter materializes the plan
    (optimize + lower through the eager seams) on first touch, so an op
    with no plan node is a materialization point by construction, and
    ``MODIN_TPU_TORCH_PLAN=Off`` (no plan is ever built) is the eager port.
    """

    _plan = None

    def __init__(self, frame: TorchDataframe, shape_hint: Optional[str] = None):
        self._modin_frame = frame
        self._shape_hint = shape_hint

    @classmethod
    def from_plan(cls, plan: Any, shape_hint: Optional[str] = None) -> "TorchQueryCompiler":
        """A deferred compiler over a pending plan node."""
        self = cls.__new__(cls)
        self._frame = None
        self._plan = plan
        self._shape_hint = shape_hint
        return self

    def _planning(self) -> bool:
        """Whether a plan-capable call should try to defer: a plan is
        pending, or ``MODIN_TPU_TORCH_PLAN=Force``."""
        return self._plan is not None or PlanMode.get() == "Force"

    @property
    def _modin_frame(self) -> TorchDataframe:
        frame = self._frame
        if frame is None:
            frame = _plan_runtime().force(self)
        return frame

    @_modin_frame.setter
    def _modin_frame(self, frame: TorchDataframe) -> None:
        self._frame = frame
        self._plan = None

    def eager_snapshot(self) -> "TorchQueryCompiler":
        """An eager compiler over this one's (materialized) frame."""
        return TorchQueryCompiler(self._modin_frame, self._shape_hint)

    def explain(self, analyze: bool = False) -> str:
        """EXPLAIN: the logical plan before and after the rewrite, with the
        rules that fired; ``analyze`` executes it (a pending plan
        materializes into this compiler) and annotates every node with its
        wall time, rows, bytes and kernel launches."""
        from modin_tpu_torch.plan.explain import explain_qc

        return explain_qc(self, analyze=analyze)

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

    def to_numpy(self, **kwargs: Any) -> np.ndarray:
        """``DataFrame.to_numpy``: a frame of numeric device columns asked
        with no ``dtype``, ``copy`` or ``na_value`` is stacked on the device
        in pandas' common dtype and comes over in one device-to-host copy;
        every other form goes through pandas."""
        from pandas.api.extensions import no_default

        if (
            kwargs.get("dtype") is None
            and kwargs.get("copy", False) is False
            and kwargs.get("na_value", no_default) is no_default
            and set(kwargs) <= {"dtype", "copy", "na_value"}
        ):
            stacked = self._modin_frame.to_numpy_stacked()
            if stacked is not None:
                return stacked
        return self.to_pandas().to_numpy(**kwargs)

    def to_interchange_dataframe(self, nan_as_null: bool = False, allow_copy: bool = True):
        """The port's protocol producer over this frame's columns: no
        pandas frame of the whole, zero copy over host caches, one fetch a
        requested computed column."""
        from modin_tpu_torch.core.dataframe.torch.interchange.dataframe import (
            TorchDataFrameXchg,
        )

        return TorchDataFrameXchg(self._modin_frame, nan_as_null=nan_as_null, allow_copy=allow_copy)

    def execute(self) -> None:
        self._modin_frame.finalize()

    def finalize(self) -> None:
        self._modin_frame.finalize()

    def copy(self) -> "TorchQueryCompiler":
        if self._plan is not None:
            # plans are immutable: a copy shares the pending plan
            return type(self).from_plan(self._plan, self._shape_hint)
        # frames are never written in place (every op builds a new one), so
        # a copy shares the columns
        return type(self)(self._modin_frame, self._shape_hint)

    # ------------------------------------------------------------------ #
    # Metadata
    # ------------------------------------------------------------------ #

    def get_columns(self) -> Any:
        from modin_tpu_torch.core.dataframe.torch.metadata import ensure_index

        if self._plan is not None:
            return _plan_runtime().plan_columns(self)
        return ensure_index(self._modin_frame.columns)

    def get_index(self) -> Any:
        return self._modin_frame.index

    def _set_columns(self, labels: Any) -> None:
        from modin_tpu_torch.core.dataframe.torch.metadata import ensure_index

        labels = ensure_index(labels)
        frame = self._modin_frame
        if len(labels) != frame.num_cols:
            raise ValueError(
                f"Length mismatch: Expected axis has {frame.num_cols} elements, "
                f"new values have {len(labels)} elements"
            )
        self._modin_frame = frame.with_columns(list(frame._columns), labels)

    def _set_index(self, labels: Any) -> None:
        from modin_tpu_torch.core.dataframe.torch.metadata import ensure_index

        labels = ensure_index(labels)
        frame = self._modin_frame
        if len(labels) != len(frame):
            raise ValueError(
                f"Length mismatch: Expected axis has {len(frame)} elements, "
                f"new values have {len(labels)} elements"
            )
        self._modin_frame = frame.with_columns(
            list(frame._columns), index=LazyIndex(labels, len(frame))
        )

    index = property(get_index, _set_index)
    columns = property(get_columns, _set_columns)

    @property
    def dtypes(self) -> Any:
        import pandas

        if self._plan is not None:
            known = _plan_runtime().plan_dtypes(self)
            if known is not None:
                return known
        frame = self._modin_frame
        return pandas.Series(
            [c.pandas_dtype for c in frame._columns], index=self.get_columns(), dtype=object
        )

    def get_axis_len(self, axis: int) -> int:
        if axis and self._plan is not None:
            return len(_plan_runtime().plan_columns(self))
        return len(self._modin_frame) if axis == 0 else self._modin_frame.num_cols

    def __len__(self) -> int:
        return len(self._modin_frame)

    def has_multiindex(self, axis: int = 0) -> bool:
        if axis == 0:
            return self._modin_frame._index.is_multi()
        return super().has_multiindex(axis)

    def columnarize(self) -> "TorchQueryCompiler":
        """Series normal form without building the row labels of a
        one-column frame (the base class asks for them).  A pending plan of
        one column only takes the Series tag."""
        if self._plan is not None and len(self.get_columns()) == 1:
            result = self.copy()
            result._shape_hint = "column"
            return result
        frame = self._modin_frame
        if frame.num_cols == 1 and len(frame) != 1:
            return type(self)(frame, "column")
        return super().columnarize()

    def getitem_column_array(
        self, key: Any, numeric: bool = False, ignore_order: bool = False
    ) -> "TorchQueryCompiler":
        if self._planning():
            planned = _plan_runtime().defer_project(self, key, numeric)
            if planned is not None:
                return planned
        frame = self._modin_frame
        if numeric:
            positions = [int(i) for i in key]
        else:
            positions = []
            for label in key:
                pos = frame.column_position(label)
                if not pos:
                    raise KeyError(label)
                positions.extend(pos)
        return type(self)(frame.select_columns_by_position(positions))

    def _device(self) -> torch.device:
        for col in self._modin_frame._columns:
            if col.is_device:
                return col.device
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
        """Run ``fn(pandas_obj, *args, **kwargs)`` in pandas, counted;
        compilers among the arguments go to pandas too (a column-shaped one
        as a Series)."""
        ErrorMessage.default_to_pandas(f"`{getattr(fn, '__name__', 'operation')}`")
        args = try_cast_to_pandas(args)
        return self._from_pandas_result(fn(self.to_pandas_object(), *args, **kwargs))

    # ================================================================== #
    # Device hot paths
    # ================================================================== #

    _ARITH_KINDS = frozenset("iuf")
    _CMP_OPS = frozenset(["eq", "ne", "lt", "le", "gt", "ge"])
    _LOGICAL_OPS = elementwise.LOGICAL_OPS

    def _device_cols(self) -> Optional[List[torch.Tensor]]:
        """All columns as concrete device tensors (the deferred ones
        materialized in one fused run), or None if any column is host-only:
        what a multi-column consumer of the values takes."""
        cols = self._modin_frame._columns
        if all(c.is_device for c in cols):
            return self._modin_frame.device_datas()
        return None

    def _device_raw(self) -> Optional[List[Any]]:
        """All columns as device tensors or deferred expressions, or None if
        any column is host-only: the elementwise and reduction paths extend
        a chain instead of forcing it."""
        cols = self._modin_frame._columns
        if all(c.is_device for c in cols):
            return [c.raw for c in cols]
        return None

    @staticmethod
    def _encoded(col: Any) -> Optional[Any]:
        """A host string/object column's dictionary encoding (categorical
        and device columns have none here)."""
        if col.is_device or _is_categorical(col):
            return None
        return dictionary.encode_host_column(col)

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

    @device_path("binary")
    def _try_dict_compare(self, op: str, other: str) -> Optional["TorchQueryCompiler"]:
        """A comparison of string columns with a string scalar: sorted
        categories turn it into a code threshold (one searchsorted of the
        categories on the host, one device compare).  Missing rows are
        False, and True for ``ne``, as in pandas."""
        import pandas

        datas = []
        for c in self._modin_frame._columns:
            if isinstance(c.pandas_dtype, pandas.StringDtype) and c.pandas_dtype.na_value is pandas.NA:
                # the NA-backed 'string' dtype compares to a boolean
                # extension array with NA: pandas keeps it
                return None
            enc = self._encoded(c)
            if enc is None:
                return None
            try:
                pos = int(np.searchsorted(enc.categories, other))
            except TypeError:
                return None
            exact = bool(pos < len(enc.categories) and enc.categories[pos] == other)
            codes = enc.codes.data
            if op in ("eq", "ne"):
                eq = codes == float(pos) if exact else torch.zeros_like(codes, dtype=torch.bool)
                # NaN codes compare unequal: ne is True there, as in pandas
                datas.append(eq if op == "eq" else ~eq)
            elif op in ("lt", "ge"):
                below = codes < float(pos)
                datas.append(below if op == "lt" else codes >= float(pos))
            else:  # le, gt
                bound = float(pos + (1 if exact else 0))
                datas.append(codes < bound if op == "le" else codes >= bound)
        return self._wrap_device_result(datas)

    @device_path("binary")
    def _try_device_binary(self, op: str, other: Any, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        if op not in elementwise.BINARY_OPS:
            return None
        if kwargs.get("level") is not None or kwargs.get("fill_value") is not None:
            return None
        frame = self._modin_frame
        if frame.num_cols == 0 or len(frame) == 0:
            return None
        if op in self._CMP_OPS and isinstance(other, str):
            return self._try_dict_compare(op, other)
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
            if (
                op in ("pow", "rpow")
                and all(k in "iu" for k in kinds)
                and isinstance(other, (int, np.integer))
            ):
                # int ** negative int raises in pandas, and rpow's exponent
                # sign is the data's: the int/int pow family goes to pandas
                return None
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
            if (
                self._shape_hint != "column"
                and other._shape_hint == "column"
                and kwargs.get("axis", None) in (1, "columns")
            ):
                return self._try_device_binary_along_columns(op, other, kinds, logical)
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
                op in ("pow", "rpow")
                and all(k in "iu" for k in kinds)
                and all(k in "iu" for k in okinds)
            ):
                return None  # the exponent's sign is the data's; pandas may raise
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

    def _int_series_operands(self, other: Any) -> bool:
        """Both sides one-column Series compilers whose numpy result dtype
        is an int one: where pandas' ``//``/``%`` operators depend on
        whether a divisor is zero."""
        if not (
            isinstance(other, TorchQueryCompiler)
            and self._shape_hint == "column"
            and other._shape_hint == "column"
        ):
            return False
        dtypes = [c.pandas_dtype for c in self._modin_frame._columns + other._modin_frame._columns]
        return (
            len(dtypes) == 2
            and all(isinstance(d, np.dtype) and d.kind in "iub" for d in dtypes)
            and np.result_type(*dtypes).kind in "iu"
        )

    @device_path("binary")
    def _try_int_division_operator(self, op: str, other: "TorchQueryCompiler") -> Optional["TorchQueryCompiler"]:
        """pandas' operator ``a // b`` or ``a % b`` (``op`` is the flex
        name, ``r`` for the reflected side) of two int Series: the int
        result where no divisor is zero, else float64 with +/-inf (``//``,
        by the dividend's sign; NaN for 0 // 0) or NaN (``%``) at each zero
        divisor, as pandas' ``mask_zero_div_zero``/``_fill_zeros`` do.  The
        flex methods keep numpy's 0 there and take the ordinary path.  One
        host sync reads whether a divisor is zero: the dtype depends on it."""
        a, b = self._modin_frame.get_column(0), other._modin_frame.get_column(0)
        if not (a.is_device and b.is_device) or not self._fast_index_match(other):
            return None
        x, y = a.data, b.data
        num, den = (y, x) if op.startswith("r") else (x, y)
        zero = den == 0
        result = elementwise.get_op(op)(x, y)
        if bool(zero.any()):
            result = result.to(torch.float64)
            if op.endswith("floordiv"):
                fill = torch.where(num > 0, float("inf"), torch.where(num < 0, float("-inf"), float("nan")))
            else:
                fill = torch.full_like(result, float("nan"))
            result = torch.where(zero, fill.to(torch.float64), result)
        la, lb = self._modin_frame.columns[0], other._modin_frame.columns[0]
        return self._wrap_device_result([result], col_labels=[la if la == lb else MODIN_UNNAMED_SERIES_LABEL])

    @device_path("binary")
    def _try_device_binary_along_columns(
        self, op: str, other: "TorchQueryCompiler", kinds: List[str], logical: bool
    ) -> Optional["TorchQueryCompiler"]:
        """``df <op> series`` whose labels are the frame's columns
        (``df - df.mean()``): pandas broadcasts the Series' values across
        the rows, so column j meets value j as a numpy scalar (strong in
        numpy's promotion, as pandas' broadcast array is).  The values come
        to the host once (a reduction's result already is there); each
        column's op defers with its value as a runtime scalar.  The JAX
        package sends this to pandas."""
        import pandas

        frame, oframe = self._modin_frame, other._modin_frame
        if oframe.num_cols != 1 or len(oframe) != frame.num_cols or logical:
            return None
        col = oframe.get_column(0)
        if not col.is_device or col.pandas_dtype.kind not in "biuf":
            return None
        if not oframe.index.equals(pandas.Index(list(frame.columns))):
            return None  # pandas aligns (reorders, widens) the labels first
        if op in ("floordiv", "rfloordiv", "mod", "rmod") and col.pandas_dtype.kind in "iub" and all(
            k in "iub" for k in kinds
        ):
            return None  # a zero divisor makes pandas' int result float64
        if op in ("pow", "rpow") and col.pandas_dtype.kind in "iu" and all(k in "iu" for k in kinds):
            return None
        values = col.to_numpy()
        return self._wrap_device_result(
            elementwise.binary_op_columns(op, self._device_raw(), [values[j] for j in range(len(values))])
        )

    # ------------------------------- maps ----------------------------- #

    def _map_device_host(
        self,
        device_fn: Callable[[List[torch.Tensor]], List[torch.Tensor]],
        host_fn: Callable[[Any], Any],
        require_kinds: Optional[str] = None,
    ) -> Optional["TorchQueryCompiler"]:
        """``device_fn`` over the device columns and pandas' own ``host_fn``
        over each host column (a pandas Series), in their positions; None
        (decline) for an empty frame or a device column whose kind is not
        in ``require_kinds``.  A host result of a device dtype (``isna`` of
        a string column) goes to the device."""
        import pandas

        frame = self._modin_frame
        if len(frame) == 0:
            return None
        device_positions = [i for i, c in enumerate(frame._columns) if c.is_device]
        if require_kinds is not None and any(
            frame._columns[i].pandas_dtype.kind not in require_kinds for i in device_positions
        ):
            return None
        new_device = device_fn([frame._columns[i].raw for i in device_positions]) if device_positions else []
        new_columns: list = list(frame._columns)
        for pos, data in zip(device_positions, new_device):
            old = frame._columns[pos]
            dtype = old.pandas_dtype if data.dtype == old.dtype else numpy_dtype(data.dtype)
            new_columns[pos] = DeviceColumn(data, dtype, length=len(frame))
        for i, col in enumerate(frame._columns):
            if not col.is_device:
                series = pandas.Series(col.data, dtype=col.pandas_dtype, copy=False)
                new_columns[i] = column_of_series(host_fn(series), self._device())
        return type(self)(frame.with_columns(new_columns), self._shape_hint)

    def _defer_unary(self, method: str, args: tuple = (), kwargs: Optional[dict] = None,
                     bool_out: bool = False) -> Optional["TorchQueryCompiler"]:
        if self._planning():
            return _plan_runtime().defer_unary(self, method, args, kwargs, bool_out=bool_out)
        return None

    def abs(self) -> "TorchQueryCompiler":
        planned = self._defer_unary("abs")
        if planned is not None:
            return planned
        result = self._map_device_host(
            lambda cols: elementwise.unary_op_columns("abs", cols), lambda s: s.abs(), "iuf"
        )
        return result if result is not None else self._default_to_pandas(lambda o: o.abs())

    def negative(self) -> "TorchQueryCompiler":
        planned = self._defer_unary("negative")
        if planned is not None:
            return planned
        result = self._map_device_host(
            lambda cols: elementwise.unary_op_columns("negative", cols), lambda s: -s, "iuf"
        )
        return result if result is not None else self._default_to_pandas(lambda o: -o)

    def invert(self) -> "TorchQueryCompiler":
        """``~``: logical not of bool columns, bitwise not of int ones."""
        planned = self._defer_unary("invert")
        if planned is not None:
            return planned
        result = self._map_device_host(
            lambda cols: elementwise.unary_op_columns("invert", cols), lambda s: ~s, "biu"
        )
        return result if result is not None else self._default_to_pandas(lambda o: ~o)

    MATH_UNARY = elementwise.MATH_UNARY

    def unary_math(self, op_name: str) -> "TorchQueryCompiler":
        """numpy's math ufunc ``op_name`` (``np.sqrt(df)``): its torch
        counterpart over the numeric device columns, numpy's own over the
        host columns; otherwise pandas applies the ufunc."""
        planned = self._defer_unary("unary_math", (op_name,))
        if planned is not None:
            return planned
        ufunc = getattr(np, op_name)
        if op_name in self.MATH_UNARY:
            result = self._map_device_host(
                lambda cols: elementwise.math_unary_columns(op_name, cols), ufunc, "iuf"
            )
            if result is not None:
                return result
        return self._default_to_pandas(ufunc)

    # ---------------------- missing data and dtypes --------------------- #

    def _mM_flags(self) -> List[bool]:
        """Per device column: whether it holds datetimes/timedeltas (int64
        ticks with the NaT sentinel)."""
        return [c.pandas_dtype.kind in "mM" for c in self._modin_frame._columns if c.is_device]

    def _isna_like(self, negate: bool) -> Optional["TorchQueryCompiler"]:
        flags = self._mM_flags()
        return self._map_device_host(
            lambda cols: elementwise.isna_columns(cols, flags, negate),
            (lambda s: s.notna()) if negate else (lambda s: s.isna()),
        )

    def isna(self) -> "TorchQueryCompiler":
        planned = self._defer_unary("isna", bool_out=True)
        if planned is not None:
            return planned
        result = self._isna_like(negate=False)
        return result if result is not None else super().isna()

    def notna(self) -> "TorchQueryCompiler":
        planned = self._defer_unary("notna", bool_out=True)
        if planned is not None:
            return planned
        result = self._isna_like(negate=True)
        return result if result is not None else super().notna()

    def round(self, decimals: Any = 0, **kwargs: Any) -> "TorchQueryCompiler":
        if isinstance(decimals, int) and not isinstance(decimals, bool):
            planned = self._defer_unary("round", (), dict(decimals=decimals, **kwargs))
            if planned is not None:
                return planned
        result = None
        if isinstance(decimals, (int, np.integer)) and not isinstance(decimals, bool) and not kwargs:
            d = int(decimals)
            # past -18 the unit 10**-d leaves int64 (pandas' float path
            # overflows there): pandas answers for int columns
            if d >= -18 or not any(
                c.is_device and c.pandas_dtype.kind in "iu" for c in self._modin_frame._columns
            ):
                flags = self._mM_flags()
                result = self._map_device_host(
                    lambda cols: elementwise.round_columns(cols, d, flags),
                    lambda s: s.round(d) if s.dtype.kind in "iuf" else s,
                )
        return result if result is not None else super().round(decimals=decimals, **kwargs)

    def fillna(self, **kwargs: Any) -> "TorchQueryCompiler":
        """A numeric scalar into every float column, or a dict (or a
        Series, ``fillna(df.mean())``) of numeric scalars into the columns
        it names; int and bool columns hold no NaN and pass through.
        Datetime columns decline: pandas turns them to object there."""
        value = kwargs.get("value")
        plain = kwargs.get("limit") is None and kwargs.get("axis") in (0, None)
        if plain and _is_number(value):
            result = self._map_device_host(
                lambda cols: elementwise.fillna_columns(cols, value),
                lambda s: s.fillna(value),
                require_kinds="biuf",
            )
            if result is not None:
                return result
        mapping = None
        if isinstance(value, dict):
            mapping = value
        elif isinstance(value, TorchQueryCompiler) and kwargs.get("squeeze_value"):
            ser = value.to_pandas()
            if ser.shape[1] == 1 and ser.index.is_unique:
                mapping = ser.iloc[:, 0].to_dict()
        frame = self._modin_frame
        if (
            mapping is not None
            and plain
            and not kwargs.get("squeeze_self")
            and len(frame) > 0
            and all(_is_number(v) for v in mapping.values())
        ):
            targets = [
                (i, mapping[label]) for i, label in enumerate(frame.columns)
                if hashable(label) and label in mapping
            ]
            if all(
                frame._columns[i].is_device and frame._columns[i].pandas_dtype.kind in "biuf"
                for i, _ in targets
            ):
                new_cols = list(frame._columns)
                for i, v in targets:
                    c = frame._columns[i]
                    new_cols[i] = DeviceColumn(
                        elementwise.fillna_columns([c.raw], v)[0], c.pandas_dtype, length=len(frame)
                    )
                return type(self)(frame.with_columns(new_cols), self._shape_hint)
        return super().fillna(**kwargs)

    def clip(self, lower: Any, upper: Any, **kwargs: Any) -> "TorchQueryCompiler":
        result = None
        if kwargs.get("axis") in (None, 0) and not kwargs.get("inplace") and not (
            set(kwargs) - {"axis", "inplace"}
        ):
            result = self._try_device_clip(lower, upper)
        return result if result is not None else super().clip(lower, upper, **kwargs)

    @device_path("binary")
    def _try_device_clip(self, lower: Any, upper: Any) -> Optional["TorchQueryCompiler"]:
        """pandas' scalar clip: a NaN bound is no bound, crossed bounds
        swap, NaN stays.  Result dtypes follow pandas' ``where``: a float
        column keeps its dtype; an int column keeps it unless a bound it
        cannot hold (a fractional float) replaces a value, which makes it
        float64 (one fetch of those flags for every column)."""
        def as_bound(v):
            if v is None or (_is_number(v) and np.isnan(v)):
                return None
            return v if _is_number(v) else False

        lower, upper = as_bound(lower), as_bound(upper)
        if lower is False or upper is False:
            return None
        if lower is not None and upper is not None and lower > upper:
            lower, upper = upper, lower
        # per device column: a 0-d device flag of "a fractional bound
        # replaces a value" (int columns with such a bound), else None
        hit_flags = []
        for c in (c for c in self._modin_frame._columns if c.is_device):
            kind = c.pandas_dtype.kind
            if kind not in "iuf":
                return None
            hits = []
            if kind != "f":
                info = np.iinfo(c.pandas_dtype)
                for b in (lower, upper):
                    if b is not None and not _fractional(b) and not info.min <= b <= info.max:
                        return None  # pandas widens to another int dtype there
                if _fractional(lower):
                    hits.append((c.data < lower).any())
                if _fractional(upper):
                    hits.append((c.data > upper).any())
            hit_flags.append(torch.stack(hits).any() if hits else None)
        fetched = [f for f in hit_flags if f is not None]
        host = iter(TorchWrapper.materialize(torch.stack(fetched)).tolist() if fetched else ())
        to_float = [f is not None and bool(next(host)) for f in hit_flags]

        def device_fn(datas):
            out = []
            for d, widen in zip(datas, to_float):
                if widen:
                    d = elementwise.astype_column(d, np.dtype(np.float64))
                if d.dtype.is_floating_point:
                    out.append(elementwise.clip_columns([d], lower, upper)[0])
                else:
                    # the int column keeps its dtype: a fractional bound
                    # replaced nothing, an integral one is cast
                    lo, hi = (None if b is None or _fractional(b) else int(b) for b in (lower, upper))
                    out.append(elementwise.clip_columns([d], lo, hi)[0])
            return out

        return self._map_device_host(device_fn, lambda s: s.clip(lower, upper), require_kinds="iuf")

    def astype(self, col_dtypes: Any, errors: str = "raise") -> "TorchQueryCompiler":
        """One numeric target for a frame of numeric device columns; a float
        column into an int target declines (pandas raises on NaN)."""
        frame = self._modin_frame
        if not isinstance(col_dtypes, dict) and len(frame) > 0:
            try:
                target = np.dtype(col_dtypes)
            except TypeError:
                target = None
            if (
                target is not None
                and target.kind in "iuf"
                and has_torch_dtype(target)
                and all(c.is_device and c.pandas_dtype.kind in "biuf" for c in frame._columns)
                and not (
                    target.kind in "iu"
                    and any(c.pandas_dtype.kind == "f" for c in frame._columns)
                )
            ):
                new_cols = [
                    DeviceColumn(elementwise.astype_column(c.raw, target), target, length=len(frame))
                    for c in frame._columns
                ]
                return type(self)(frame.with_columns(new_cols), self._shape_hint)
        return super().astype(col_dtypes, errors=errors)

    # ----------------------------- reductions ------------------------- #

    @device_path("reduce")
    def _try_device_reduce(
        self, op: str, axis: Any, skipna: bool, numeric_only: bool, kwargs: dict, keep: Any = None,
        donate_cols: Optional[list] = None,
    ) -> Optional["TorchQueryCompiler"]:
        """``keep`` is the whole-plan fused leg (``plan/fuse.py``): a
        deferred bool mask over the uncompacted rows, folded into the
        reduction's launch instead of a compaction, and ``donate_cols`` the
        scan's columns that launch may consume.  It declines (None) where
        the masked form is not the staged one exactly: axis 1, median,
        dictionary-encoded host columns, and a filter that keeps no row
        (pandas' empty-frame answers live with the staged path; a donated
        column restores for it).  A median asks the kernel router, which
        may decline to pandas."""
        if op not in reductions.REDUCTIONS and op != "median":
            return None
        if keep is not None and (op == "median" or axis not in (0, None)):
            return None
        if kwargs.get("min_count", 0) not in (0, -1):
            return None
        if kwargs.get("bool_only"):
            return None
        if set(kwargs) - {"min_count", "bool_only", "ddof"}:
            return None
        ddof = int(kwargs.get("ddof", 1))
        frame = self._modin_frame
        if len(frame) == 0 or frame.num_cols == 0:
            return None
        if axis not in (0, 1, None):
            return None
        # string columns join min/max/count through their dictionary codes
        # (sorted categories: the code min/max IS the lexicographic one)
        dict_ok = op in ("min", "max", "count") and axis in (0, None) and not numeric_only
        positions = []
        decoders: dict = {}
        for i, col in enumerate(frame._columns):
            ok = col.is_device and col.pandas_dtype.kind in "biuf"
            if ok:
                positions.append(i)
                continue
            enc = self._encoded(col) if dict_ok else None
            # no categories = an all-missing column: pandas' None-vs-NaN
            # answers there stay with pandas
            if enc is not None and len(enc.categories):
                decoders[i] = enc
                positions.append(i)
            elif not numeric_only or _is_numeric_dtype(col.pandas_dtype):
                # a numeric column we can't run on device, or (without
                # numeric_only) any host column
                return None
        if not positions or (keep is not None and decoders):
            return None
        labels = frame.columns
        try:
            labels = labels[positions]  # pandas Index
        except TypeError:
            labels = [list(labels)[i] for i in positions]
        # a string column reduces through its dictionary codes
        sel_cols = [decoders[i].codes if i in decoders else frame._columns[i] for i in positions]
        # deferred columns fold into the reductions (one fused run)
        arrays = [c.data if i in decoders else c.raw for i, c in zip(positions, sel_cols)]
        # bool columns: pandas computes these over ints
        cast_bool = op in ("sum", "prod", "mean", "median", "var", "std", "sem", "skew", "kurt")
        if axis == 1:
            kinds = {frame._columns[i].pandas_dtype.kind for i in positions}
            if op not in reductions.AXIS1_REDUCTIONS or ("b" in kinds and len(kinds) > 1):
                # pandas interleaves bool with numbers as object rows
                return None
            data = reductions.reduce_axis1(
                op, arrays, skipna=skipna, ddof=ddof, cast_bool=cast_bool
            )
            # pandas: the columns' common dtype, then the op's rule for it
            target = reductions.pandas_result_dtype(
                op, np.result_type(*[frame._columns[i].pandas_dtype for i in positions])
            )
            if target.kind == "u" and target.itemsize == 8:
                result = HostColumn(np.asarray(TorchWrapper.materialize(data)).astype(target))
            else:
                data = data.to(torch_dtype(target))
                result = DeviceColumn(data, target, length=len(frame))
            return type(self)(
                TorchDataframe([result], [MODIN_UNNAMED_SERIES_LABEL], frame._index),
                "column",
            )
        if keep is not None:
            values, kept = reductions.reduce_columns_masked(
                op, arrays, keep, len(frame), skipna=skipna, ddof=ddof, cast_bool=cast_bool,
                donate_cols=donate_cols,
            )
            if kept == 0:
                return None
        elif op == "median":
            values = self._routed_median(sel_cols, skipna)
            if values is None:
                return None
        else:
            values = None
            if views.VIEWS_ON:
                # whole results reused and appended columns folded
                # (``views/reduce_cache.py``); None where a column is
                # deferred or spilled
                from modin_tpu_torch.views.reduce_cache import cached_reduce

                values = cached_reduce(op, sel_cols, len(frame), skipna, ddof, cast_bool)
            if values is None:
                values = reductions.reduce_columns(
                    op, arrays, len(frame), skipna=skipna, ddof=ddof, cast_bool=cast_bool
                )
        if decoders and op in ("min", "max"):
            import pandas

            out_values = [v.item() for v in values]
            for j, i in enumerate(positions):
                if i in decoders:
                    out_values[j] = dictionary.decode_codes(
                        np.asarray([out_values[j]], np.float64), decoders[i].categories
                    )[0]
            # pandas: a frame of string columns of one dtype keeps it (even
            # when every result is NaN); any mix is object
            dtypes = {str(frame._columns[i].pandas_dtype) for i in positions}
            dtype = (
                frame._columns[positions[0]].pandas_dtype
                if len(decoders) == len(positions) and len(dtypes) == 1
                else object
            )
            result = pandas.Series(out_values, index=labels, dtype=dtype)
            return self._from_pandas_result(result.rename(MODIN_UNNAMED_SERIES_LABEL))
        result = reductions.pandas_result_array(
            op, values, [frame._columns[i].pandas_dtype for i in positions]
        )
        qc = type(self).from_numpy_columns(
            {MODIN_UNNAMED_SERIES_LABEL: result}, index=labels, device=self._device()
        )
        qc._shape_hint = "column"
        return qc

    def _routed_median(self, cols: List[Any], skipna: bool) -> Optional[list]:
        """The medians of ``cols`` over their sorted representations, the
        kernel router's verdict first (None: pandas).  A cached whole result
        answers a column with no device work and plans as "view"."""
        from modin_tpu_torch.ops import router
        from modin_tpu_torch.views import reduce_cache as view_reduce

        n = len(self._modin_frame)
        if router.forced_host("median", n):
            return None
        params = (bool(skipna),)
        cached = view_reduce.sort_reduce_lookup("median", params, cols) if views.VIEWS_ON else {}
        strategies = [
            "view" if i in cached else ("cached" if sorted_cache.peek(c) else "sort")
            for i, c in enumerate(cols)
        ]
        if router.decide("median", n, strategies) == "host":
            return None
        view_reduce.sort_reduce_consume("median", params, cols, cached)
        values: list = [cached.get(i) for i in range(len(cols))]
        miss_is = [i for i in range(len(cols)) if i not in cached]
        if miss_is:
            got = reductions.median_columns([cols[i] for i in miss_is], n, skipna=skipna)
            for i, v in zip(miss_is, got):
                values[i] = v
                if views.VIEWS_ON:
                    view_reduce.sort_reduce_store("median", params, cols[i], v)
        return values

    # ---------------- sort-shaped reductions (axis 0 and 1) ------------- #

    def _all_numeric_device(self) -> bool:
        """Whether every column is a numeric device column (string columns
        join the sort-shaped family through dictionary codes in the JAX
        package, a later slice of the port)."""
        frame = self._modin_frame
        return bool(frame.num_cols) and all(
            c.is_device and c.pandas_dtype.kind in "biuf" for c in frame._columns
        )

    def _sort_reduce_specs(self, numeric_only: bool = False) -> Optional[tuple]:
        """(specs for ``plan_sort_reduce``, {position: DictEncoding}), or None
        when a column joins neither as a numeric device column nor through
        its dictionary encoding."""
        specs: list = []
        decoders: dict = {}
        for i, c in enumerate(self._modin_frame._columns):
            if c.is_device and c.pandas_dtype.kind in "biuf":
                specs.append({"col": c})
                continue
            enc = None if numeric_only else self._encoded(c)
            if enc is None:
                return None
            decoders[i] = enc
            specs.append(
                {"col": enc.codes, "n_categories": len(enc.categories), "has_nan": enc.has_nan}
            )
        return specs, decoders

    def _row_result(self, data: torch.Tensor) -> "TorchQueryCompiler":
        """A Series-shaped compiler of one device column per row."""
        frame = self._modin_frame
        col = DeviceColumn(data, numpy_dtype(data.dtype), length=len(frame))
        return type(self)(
            TorchDataframe([col], [MODIN_UNNAMED_SERIES_LABEL], frame._index), "column"
        )

    @device_path("sort_reduce")
    def _try_sort_reduce_nunique(self, dropna: bool) -> Optional["TorchQueryCompiler"]:
        """Distinct count per column: string columns from their categories,
        bounded-range ints through one O(n) histogram (the bincount
        kernel), the rest through the shared sorted representation."""
        from modin_tpu_torch.ops import router
        from modin_tpu_torch.views import reduce_cache as view_reduce

        frame = self._modin_frame
        n = len(frame)
        if router.forced_host("nunique", n):
            return None  # before any device work (materialization, the range probe)
        got = self._sort_reduce_specs()
        if got is None:
            return None
        specs, _ = got
        # cached whole results answer their columns with no device work (no
        # range probe, no sort) and plan as "view"
        keyed = [None if "n_categories" in spec else spec["col"] for spec in specs]
        params = (bool(dropna),)
        cached = view_reduce.sort_reduce_lookup("nunique", params, keyed) if views.VIEWS_ON else {}
        miss_is = [i for i in range(len(specs)) if i not in cached]
        plans = reductions.plan_sort_reduce("nunique", [specs[i] for i in miss_is], n)
        if router.decide("nunique", n, ["view"] * len(cached) + [p.strategy for p in plans]) == "host":
            return None
        view_reduce.sort_reduce_consume("nunique", params, keyed, cached)
        counts = [cached.get(i) for i in range(len(specs))]
        if plans:
            for i, v, p in zip(miss_is, reductions.nunique_planned(plans, n, bool(dropna)), plans):
                counts[i] = v
                if views.VIEWS_ON and keyed[i] is not None and p.strategy != "dict":
                    view_reduce.sort_reduce_store("nunique", params, keyed[i], v)
        qc = type(self).from_numpy_columns(
            {MODIN_UNNAMED_SERIES_LABEL: np.asarray(counts, dtype=np.int64)},
            index=self.get_columns(), device=self._device(),
        )
        qc._shape_hint = "column"
        return qc

    def nunique(self, axis: int = 0, dropna: bool = True, **kwargs: Any):
        frame = self._modin_frame
        if not kwargs and len(frame) and frame.num_cols:
            if axis == 0:
                result = self._try_sort_reduce_nunique(bool(dropna))
                if result is not None:
                    return result
            elif axis == 1 and self._all_numeric_device():
                data = reductions.nunique_axis1(
                    frame.device_datas(), len(frame), bool(dropna)
                )
                return self._row_result(data)
        return super().nunique(axis=axis, dropna=dropna, **kwargs)

    @device_path("sort_reduce")
    def _try_sort_reduce_mode(self, numeric_only: bool, dropna: bool) -> Optional["TorchQueryCompiler"]:
        """Modal values per column: bounded-range ints and dictionary codes
        through O(n) histograms (no cap on the mode set: every modal value
        falls out of the bin mask), the rest through the sorted
        representation's run-length pass.  ``dropna=False`` (NaN competes
        for the max count) only where every column plans "hist"."""
        import pandas

        from modin_tpu_torch.ops import router
        from modin_tpu_torch.views import reduce_cache as view_reduce

        frame = self._modin_frame
        n = len(frame)
        if router.forced_host("mode", n):
            return None  # before any device work (materialization, the range probe)
        got = self._sort_reduce_specs(numeric_only)
        if got is None:
            return None
        specs, decoders = got
        # cached (modal values, nan_modal) answers skip the device work and
        # plan as "view"
        keyed = [None if "n_categories" in spec else spec["col"] for spec in specs]
        params = (bool(dropna),)
        cached = view_reduce.sort_reduce_lookup("mode", params, keyed) if views.VIEWS_ON else {}
        miss_is = [i for i in range(len(specs)) if i not in cached]
        plans = reductions.plan_sort_reduce("mode", [specs[i] for i in miss_is], n)
        if not dropna and any(p.strategy != "hist" for p in plans):
            return None
        if router.decide("mode", n, ["view"] * len(cached) + [p.strategy for p in plans]) == "host":
            return None
        view_reduce.sort_reduce_consume("mode", params, keyed, cached)
        per_col = [cached.get(i) for i in range(len(specs))]
        if plans:
            for i, v, p in zip(miss_is, reductions.mode_planned(plans, n, bool(dropna)), plans):
                per_col[i] = v
                if views.VIEWS_ON and v is not None and keyed[i] is not None and p.strategy != "dict":
                    view_reduce.sort_reduce_store("mode", params, keyed[i], v)
        if any(v is None for v in per_col):
            return None
        pieces = []
        for i, ((values, nan_modal), col) in enumerate(zip(per_col, frame._columns)):
            if i not in decoders:
                pieces.append(
                    pandas.Series(np.asarray(values).astype(col.pandas_dtype, copy=False), name=i)
                )
                continue
            decoded = list(decoders[i].categories[np.asarray(values).astype(np.int64)])
            if nan_modal:
                # pandas keeps the column's own first missing object (None
                # stays None, NaN stays NaN), sorted last
                host = np.asarray(col.data, dtype=object)
                na_pos = np.flatnonzero(pandas.isna(host))
                decoded.append(host[na_pos[0]] if len(na_pos) else np.nan)
            pieces.append(pandas.Series(decoded, dtype=col.pandas_dtype, name=i))
        # positional names first: duplicate labels must survive the concat
        result = pandas.concat(pieces, axis=1)
        result.columns = self.get_columns()
        return type(self).from_pandas(result, self._device())

    def mode(self, axis: int = 0, numeric_only: bool = False, dropna: bool = True, **kwargs: Any):
        frame = self._modin_frame
        if axis == 0 and not kwargs and len(frame) and frame.num_cols:
            result = self._try_sort_reduce_mode(bool(numeric_only), bool(dropna))
            if result is not None:
                return result
        if axis == 1 and dropna and not kwargs and len(frame) and self._all_numeric_device():
            cols, m_max, uniform = reductions.mode_axis1(
                frame.device_datas(), len(frame)
            )
            if m_max > 0:
                integral = all(c.pandas_dtype.kind in "biu" for c in frame._columns)
                out_dtype = np.dtype(np.int64) if (uniform and integral) else np.dtype(np.float64)
                new_cols = [
                    DeviceColumn(
                        d.to(torch_dtype(out_dtype)) if d.dtype != torch_dtype(out_dtype) else d,
                        out_dtype, length=len(frame),
                    )
                    for d in cols
                ]
                import pandas

                return type(self)(
                    TorchDataframe(new_cols, pandas.RangeIndex(m_max), frame._index)
                )
        return super().mode(axis=axis, numeric_only=numeric_only, dropna=dropna, **kwargs)

    def quantile(
        self,
        q: Any = 0.5,
        axis: int = 0,
        numeric_only: bool = False,
        interpolation: str = "linear",
        method: str = "single",
        **kwargs: Any,
    ):
        from pandas.api.types import is_list_like

        frame = self._modin_frame
        qs = list(q) if is_list_like(q) else [q]
        device_ok = (
            axis in (0, "index")
            and method == "single"
            and not kwargs
            and len(frame)
            and interpolation in ("linear", "lower", "higher", "midpoint", "nearest")
            and len(qs) > 0
            and all(isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool) for v in qs)
            and all(0 <= float(v) <= 1 for v in qs)
        )
        if device_ok:
            result = self._try_sort_reduce_quantile(
                q, [float(v) for v in qs], str(interpolation), bool(numeric_only),
                bool(is_list_like(q)),
            )
            if result is not None:
                return result
        return super().quantile(
            q=q, axis=axis, numeric_only=numeric_only, interpolation=interpolation,
            method=method, **kwargs,
        )

    @device_path("sort_reduce")
    def _try_sort_reduce_quantile(
        self, q: Any, qs: list, interpolation: str, numeric_only: bool, list_like: bool
    ) -> Optional["TorchQueryCompiler"]:
        """Quantiles over the shared sorted representation (one sort per
        column for the whole sort-shaped family); router-gated."""
        import pandas

        from modin_tpu_torch.ops import router, sorted_cache

        frame = self._modin_frame
        if router.forced_host("quantile", len(frame)):
            return None  # before any device work
        positions = []
        for i, col in enumerate(frame._columns):
            # bool columns: pandas' quantile raises on them
            if col.is_device and col.pandas_dtype.kind in "iuf":
                positions.append(i)
            elif numeric_only and col.pandas_dtype.kind not in "biufc":
                continue  # pandas drops it
            else:
                return None
        if not positions:
            return None
        cols = [frame._columns[i] for i in positions]
        strategies = ["cached" if sorted_cache.peek(c) else "sort" for c in cols]
        if router.decide("quantile", len(frame), strategies) == "host":
            return None
        vals = reductions.quantile_columns(cols, len(frame), qs, interpolation)
        labels = self.get_columns()[positions]
        kept = _quantile_kept_dtypes(frame, positions)
        if kept is not None:
            vals = [v.astype(kept) for v in vals]
        if list_like:
            # positional dict first: duplicate labels must survive
            result = pandas.DataFrame(dict(enumerate(vals)), index=pandas.Index(qs))
            result.columns = labels
            return type(self).from_pandas(result, self._device())
        result = pandas.Series([arr[0] for arr in vals], index=labels, name=q,
                               dtype=None if kept is None else kept)
        qc = type(self).from_pandas(result.to_frame(), self._device())
        qc._shape_hint = "column"
        return qc

    def _describe_routed_device(self) -> bool:
        """The kernel router's verdict on describe's quantiles (the
        sort-shaped piece; count/mean/std/min/max are cheap either way)."""
        from modin_tpu_torch.ops import router, sorted_cache

        frame = self._modin_frame
        if router.forced_host("quantile", len(frame)):
            return False
        strategies = ["cached" if sorted_cache.peek(c) else "sort" for c in frame._columns]
        return router.decide("quantile", len(frame), strategies) == "device"

    def describe(self, percentiles: Any = None, include: Any = None, exclude: Any = None):
        """Numeric describe = count/mean/std + quantiles + min/max, every
        piece a device reduction, laid out in pandas' rows on the host.
        Non-numeric columns and include/exclude keep the pandas default."""
        import pandas

        frame = self._modin_frame
        if percentiles is None:
            qs = [0.25, 0.5, 0.75]
        else:
            try:
                # pandas uses the given percentiles as they are (no implicit
                # median), sorted
                qs = sorted(float(p) for p in percentiles)
            except (TypeError, ValueError):
                qs = None
            if qs is not None and len(set(qs)) != len(qs):
                qs = None  # pandas raises on duplicate percentiles
        if (
            qs is not None
            and include is None
            and exclude is None
            and len(frame)
            and frame.num_cols
            and all(c.is_device and c.pandas_dtype.kind in "iuf" for c in frame._columns)
            and all(0.0 <= q <= 1.0 for q in qs)
            and self._describe_routed_device()
        ):
            arrays = frame.device_datas()
            n = len(frame)
            stats = {}
            for op in ("count", "mean", "std", "min", "max"):
                vals = reductions.reduce_columns(op, arrays, n, skipna=True, ddof=1)
                stats[op] = [float(np.asarray(v)) for v in vals]
            # columns, not tensors: the quantiles consume (and seed) the
            # shared sorted representation
            qvals = reductions.quantile_columns(list(frame._columns), n, qs, "linear")
            rows = ["count", "mean", "std", "min"]
            data_rows = [stats["count"], stats["mean"], stats["std"], stats["min"]]
            for j, q in enumerate(qs):
                rows.append(f"{q * 100:g}%")
                data_rows.append([float(v[j]) for v in qvals])
            rows.append("max")
            data_rows.append(stats["max"])
            result = pandas.DataFrame(
                np.asarray(data_rows, dtype=np.float64),
                index=pandas.Index(rows),
                columns=self.get_columns(),
            )
            return type(self).from_pandas(result, self._device())
        return super().describe(percentiles=percentiles, include=include, exclude=exclude)

    # Beyond this many rows a transpose leaves the columnar device store:
    # the result would have as many columns, and one device tensor per
    # column at 1e5 and more costs minutes and gigabytes of Python objects.
    # The wide result rides a host (native) compiler instead.
    _TRANSPOSE_WIDE_COLS = 4096

    def transpose(self, *args: Any, **kwargs: Any):
        if len(self._modin_frame) > self._TRANSPOSE_WIDE_COLS:
            from modin_tpu_torch.core.storage_formats.native.query_compiler import (
                NativeQueryCompiler,
            )

            ErrorMessage.default_to_pandas("`DataFrame.transpose`")
            return NativeQueryCompiler(self.to_pandas().T)
        return super().transpose(*args, **kwargs)

    # --------------------------- cumulative ops ------------------------ #

    def _cum_op(self, name: str, axis: Any, skipna: bool) -> Optional["TorchQueryCompiler"]:
        """cumsum/cumprod/cummax/cummin down the columns on the device:
        floats skip NaN (``skipna=True`` only), ints are exact."""
        cols = self._numeric_device_columns()
        if axis not in (0, "index", None) or cols is None:
            return None
        kinds = {c.pandas_dtype.kind for c in self._modin_frame._columns}
        if "u" in kinds:
            return None  # the scan runs in int64; pandas sums unsigned ints in uint64
        if not skipna and "f" in kinds:
            return None  # the NaN-propagating form is not on the device
        return self._wrap_device_result(elementwise.unary_op_columns(name, cols))

    # ----------------------------- shift/diff -------------------------- #

    @device_path("shift")
    def _try_shift_like(self, kernel: Callable, kwargs: dict, as_diff: bool) -> Optional["TorchQueryCompiler"]:
        periods = kwargs.get("periods", 1)
        if (
            kwargs.get("axis", 0) not in (0, "index", None)
            or kwargs.get("freq") is not None
            or kwargs.get("suffix") is not None
            or "fill_value" in kwargs
            or isinstance(periods, bool)
            or not isinstance(periods, (int, np.integer))
        ):
            return None
        cols = self._numeric_device_columns()
        if cols is None:
            return None
        frame = self._modin_frame
        if as_diff and any(
            c.pandas_dtype.kind in "iu" and c.pandas_dtype.itemsize < 4 for c in frame._columns
        ):
            return None  # pandas diffs int8/int16 into float32
        return self._wrap_device_result(kernel(cols, len(frame), int(periods)))

    def shift(self, **kwargs: Any) -> "TorchQueryCompiler":
        result = self._try_shift_like(elementwise.shift_columns, kwargs, False)
        return result if result is not None else super().shift(**kwargs)

    def diff(self, **kwargs: Any) -> "TorchQueryCompiler":
        result = self._try_shift_like(elementwise.diff_columns, kwargs, True)
        return result if result is not None else super().diff(**kwargs)

    # ------------------------------- windows --------------------------- #

    def _numeric_device_columns(self) -> Optional[List[torch.Tensor]]:
        """The columns of a non-empty frame whose every column is a numeric
        (int, uint, float) device column, or None."""
        frame = self._modin_frame
        if len(frame) == 0 or not frame.num_cols:
            return None
        if not all(c.pandas_dtype.kind in "iuf" for c in frame._columns):
            return None
        return self._device_cols()

    @staticmethod
    def _window_ddof(kwargs: dict, takes_ddof: bool) -> Optional[int]:
        """The ddof of a window aggregation (1 where it takes none), or None
        for a kwarg only pandas can honor (or reject properly)."""
        extra = dict(kwargs)
        ddof = extra.pop("ddof", 1) if takes_ddof else 1
        if extra.pop("numeric_only", False):
            return None  # changes the column selection
        for k in ("engine", "engine_kwargs"):
            if k in extra and extra[k] is None:
                extra.pop(k)
        if extra or isinstance(ddof, bool) or not isinstance(ddof, (int, np.integer)):
            return None
        return int(ddof)

    @device_path("rolling")
    def _try_device_rolling(self, op: str, rolling_kwargs: dict, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        window = rolling_kwargs.get("window")
        if isinstance(window, bool) or not isinstance(window, (int, np.integer)) or window <= 0:
            return None
        for key in ("center", "win_type", "on", "closed", "step"):
            if rolling_kwargs.get(key) not in (None, False):
                return None
        if rolling_kwargs.get("method", "single") != "single":
            return None
        ddof = self._window_ddof(kwargs, op in ("var", "std", "sem"))
        if ddof is None:
            return None
        min_periods = rolling_kwargs.get("min_periods")
        if min_periods is None:
            min_periods = int(window)
        elif isinstance(min_periods, bool) or not isinstance(min_periods, (int, np.integer)) or not (
            0 <= min_periods <= window
        ):
            return None  # pandas raises its ValueError on the default
        cols = self._numeric_device_columns()
        if cols is None:
            return None
        return self._wrap_device_result(
            window_ops.rolling_reduce(op, cols, len(self._modin_frame), int(window), int(min_periods), ddof)
        )

    @device_path("expanding")
    def _try_device_expanding(self, op: str, expanding_args: list, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        min_periods = expanding_args[0] if expanding_args else 1
        method = expanding_args[1] if len(expanding_args) > 1 else "single"
        if method != "single":
            return None
        if isinstance(min_periods, bool) or not isinstance(min_periods, (int, np.integer)) or min_periods < 0:
            return None
        ddof = self._window_ddof(kwargs, op in ("var", "std", "sem"))
        if ddof is None:
            return None
        cols = self._numeric_device_columns()
        if cols is None:
            return None
        return self._wrap_device_result(
            window_ops.expanding_reduce(op, cols, len(self._modin_frame), int(min_periods), ddof)
        )

    @staticmethod
    def _parse_ewm_kwargs(ewm_kwargs: dict) -> Optional[tuple]:
        """ewm's construction kwargs as (alpha, adjust, ignore_na,
        min_periods), or None where only pandas can honor (or properly
        reject) them: ``times``, ``method="table"``, no or several decay
        parameters, a timedelta halflife, out-of-range values."""
        ek = dict(ewm_kwargs)
        if ek.pop("times", None) is not None:
            return None
        if ek.pop("method", "single") != "single":
            return None
        com = ek.pop("com", None)
        span = ek.pop("span", None)
        halflife = ek.pop("halflife", None)
        alpha = ek.pop("alpha", None)
        adjust = ek.pop("adjust", True)
        ignore_na = ek.pop("ignore_na", False)
        min_periods = ek.pop("min_periods", 0)
        if ek:
            return None
        if min_periods is None:
            min_periods = 0
        if isinstance(min_periods, bool) or not isinstance(min_periods, (int, np.integer)) or min_periods < 0:
            return None
        if not isinstance(adjust, (bool, np.bool_)) or not isinstance(ignore_na, (bool, np.bool_)):
            return None
        decay = [v for v in (com, span, halflife, alpha) if v is not None]
        if len(decay) != 1 or isinstance(decay[0], bool) or not isinstance(
            decay[0], (int, float, np.integer, np.floating)
        ):
            return None
        if com is not None:
            if com < 0:
                return None
            a = 1.0 / (1.0 + float(com))
        elif span is not None:
            if span < 1:
                return None
            a = 2.0 / (float(span) + 1.0)
        elif halflife is not None:
            if halflife <= 0:
                return None
            a = 1.0 - float(np.exp(-np.log(2.0) / float(halflife)))
        else:
            if not 0 < alpha <= 1:
                return None
            a = float(alpha)
        return a, bool(adjust), bool(ignore_na), int(min_periods)

    @device_path("ewm")
    def _try_device_ewm(self, op: str, ewm_kwargs: dict, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        parsed = self._parse_ewm_kwargs(ewm_kwargs)
        if parsed is None:
            return None
        a, adjust, ignore_na, min_periods = parsed
        extra = dict(kwargs)
        bias = extra.pop("bias", False) if op in ("var", "std") else False
        if not isinstance(bias, (bool, np.bool_)):
            return None
        if self._window_ddof(extra, False) is None:
            return None  # numeric_only or an unknown kwarg
        if op == "sum" and not adjust:
            return None  # pandas raises NotImplementedError on the default
        cols = self._numeric_device_columns()
        if cols is None:
            return None
        return self._wrap_device_result(
            window_ops.ewm_reduce(op, cols, len(self._modin_frame), a, adjust, ignore_na, min_periods, bool(bias))
        )

    @device_path("ewm")
    def _try_device_ewm_pair(self, op: str, ewm_kwargs: dict, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        """ewm cov/corr of a Series with itself or with a label-matched
        Series, or of two frames with the same columns, under joint
        validity.  ``pairwise=True`` and a frame against itself (pandas'
        pairwise MultiIndex blocks) stay with pandas."""
        parsed = self._parse_ewm_kwargs(ewm_kwargs)
        if parsed is None:
            return None
        a, adjust, ignore_na, min_periods = parsed
        extra = dict(kwargs)
        other = extra.pop("other", None)
        if extra.pop("pairwise", None) not in (None, False):
            return None
        bias = extra.pop("bias", False) if op == "cov" else False
        if not isinstance(bias, (bool, np.bool_)):
            return None
        if extra.pop("numeric_only", False) or extra:
            return None
        cols = self._numeric_device_columns()
        if cols is None:
            return None
        frame = self._modin_frame
        both_series = self._shape_hint == "column" and (
            other is None or getattr(other, "_shape_hint", None) == "column"
        )
        if other is None:
            if self._shape_hint != "column":
                return None
            ocols, oframe = cols, frame
        else:
            if not isinstance(other, TorchQueryCompiler):
                return None
            oframe = other._modin_frame
            ocols = other._numeric_device_columns()
            if ocols is None or len(oframe) != len(frame) or frame.num_cols != oframe.num_cols:
                return None
            if not both_series and list(frame.columns) != list(oframe.columns):
                return None
            if not self._fast_index_match(other):
                return None  # pandas aligns on labels first
        datas = window_ops.ewm_pair_reduce(
            op, cols, ocols, len(frame), a, adjust, ignore_na, min_periods, bool(bias)
        )
        col_labels = None
        if other is not None and both_series and list(frame.columns)[0] != list(oframe.columns)[0]:
            # the binary-op naming rule: differing names give an unnamed result
            col_labels = [MODIN_UNNAMED_SERIES_LABEL]
        return self._wrap_device_result(datas, col_labels=col_labels)

    def ewm_cov(self, ewm_kwargs: dict, *args: Any, **kwargs: Any):
        result = None if args else self._try_device_ewm_pair("cov", ewm_kwargs, dict(kwargs))
        if result is not None:
            return result
        return super().ewm_cov(ewm_kwargs, *args, **kwargs)

    def ewm_corr(self, ewm_kwargs: dict, *args: Any, **kwargs: Any):
        result = None if args else self._try_device_ewm_pair("corr", ewm_kwargs, dict(kwargs))
        if result is not None:
            return result
        return super().ewm_corr(ewm_kwargs, *args, **kwargs)

    # ------------------------------ resample -------------------------- #

    @device_path("resample")
    def _try_device_resample(self, op: str, resample_kwargs: dict, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        """A resample of a sorted ``DatetimeIndex`` as time-bucket codes and
        the groupby segment aggregations.  pandas' own binner
        (``Grouper._get_time_bins``) gives each bucket's row count, for every
        rule family and closed/label/origin/offset; the codes repeat each
        bucket number that many times, and the counts go to
        ``groupby_reduce`` as ``sizes`` (no histogram kernel).  Empty
        buckets come out as pandas has them: sum 0, count 0, mean/min/max
        NaN.  An unsorted or NaT-bearing index declines."""
        import pandas

        defaults = {"convention": "start", "on": None, "level": None, "group_keys": False, "axis": 0}
        if any(resample_kwargs.get(k, v) != v for k, v in defaults.items()):
            return None
        extra = dict(kwargs)
        ddof = extra.pop("ddof", 1) if op in ("var", "std") else 1
        if extra.pop("numeric_only", False) or extra or not isinstance(ddof, (int, np.integer)):
            return None
        frame = self._modin_frame
        n = len(frame)
        if n == 0:
            return None
        index = frame.index
        if not isinstance(index, pandas.DatetimeIndex) or index.hasnans or not index.is_monotonic_increasing:
            return None  # pandas drops NaT rows before binning; the buckets need sorted rows
        try:
            grouper = pandas.Grouper(
                freq=resample_kwargs.get("rule"),
                closed=resample_kwargs.get("closed"),
                label=resample_kwargs.get("label"),
                origin=resample_kwargs.get("origin", "start_day"),
                offset=resample_kwargs.get("offset"),
            )
            _binner, bins, bin_labels = grouper._get_time_bins(index)
        except (TypeError, ValueError):
            return None  # a rule or arguments pandas' binner refuses
        n_groups = len(bin_labels)
        if n_groups == 0 or n_groups > (1 << 24):
            return None  # a rule far finer than the span: a huge empty range
        sizes = np.diff(np.r_[0, np.asarray(bins, dtype=np.int64)])
        if int(sizes.sum()) != n:
            return None
        value_positions = [
            i for i, c in enumerate(frame._columns) if c.is_device and c.pandas_dtype.kind in "biuf"
        ]
        if op != "size" and (not value_positions or len(value_positions) != frame.num_cols):
            return None
        device = self._device()
        codes = torch.repeat_interleave(
            torch.arange(n_groups, device=device), torch.as_tensor(sizes, device=device), output_size=n
        )
        if op == "size":
            datas = gb_ops.groupby_reduce("size", [], codes, n_groups, n, sizes=sizes)
            # a Series keeps its name on the size result
            labels = self.get_columns()[:1] if self._shape_hint == "column" else [MODIN_UNNAMED_SERIES_LABEL]
        else:
            has_empty = bool((sizes == 0).any())
            arrays = []
            for i in value_positions:
                a = frame._columns[i].data
                if a.dtype == torch.bool:
                    if op in ("min", "max") and has_empty:
                        return None  # pandas gives object here
                    if op in ("sum", "mean", "var", "std"):
                        a = a.to(torch.int64)
                if op in ("min", "max") and has_empty and not a.dtype.is_floating_point:
                    # empty buckets put NaN in the result: pandas promotes
                    # int min/max to float64 exactly then
                    a = a.to(torch.float64)
                arrays.append(a)
            datas = gb_ops.groupby_reduce(op, arrays, codes, n_groups, n, sizes=sizes, ddof=int(ddof))
            if op in ("sum", "prod"):
                datas = gb_ops.widen_blocks(
                    datas, [a.dtype for a in arrays], _block_groups(frame, value_positions, runs=False)
                )
            labels = self.get_columns()[value_positions]
        cols = [_agg_column(d, n_groups) for d in datas]
        qc = type(self)(TorchDataframe(cols, labels, bin_labels, nrows=n_groups))
        if op == "size":
            qc._shape_hint = "column"
        return qc

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
        if self._planning():
            planned = _plan_runtime().run_groupby_agg(
                self, by, agg_func,
                dict(axis=axis, groupby_kwargs=groupby_kwargs, agg_args=agg_args, agg_kwargs=agg_kwargs,
                     how=how, drop=drop, series_groupby=series_groupby, selection=selection),
            )
            if planned is not None:
                return planned
        groupby_kwargs = dict(groupby_kwargs or {})
        agg_kwargs = dict(agg_kwargs or {})
        views_args = None
        if views.VIEWS_ON and axis == 0 and not agg_args and isinstance(agg_func, str):
            # the same aggregation over these tensors answers from the
            # artifact registry, and an appended frame folds only its tail
            # rows through the device groupby (``views/groupby_cache.py``)
            from modin_tpu_torch.views import groupby_cache

            views_args = (by, agg_func, groupby_kwargs, agg_kwargs, drop, series_groupby, selection)
            try:
                cached = groupby_cache.groupby_consult(self, *views_args)
            except Exception:  # a failed consult is a miss: the device path runs
                cached = None
            if cached is not None:
                return cached
        result = self._try_device_groupby(
            by, agg_func, axis, groupby_kwargs, agg_args, agg_kwargs, drop,
            series_groupby, selection,
        )
        if result is not None and views_args is not None:
            try:
                groupby_cache.groupby_record(self, result, *views_args)
            except Exception:  # recording is best-effort: the result stands
                pass
        if result is None:
            result = self._try_device_groupby_multi(
                by, agg_func, axis, groupby_kwargs, agg_args, agg_kwargs, drop,
                series_groupby, selection,
            )
        if result is None and axis == 0 and not agg_args and isinstance(agg_func, str):
            if agg_func in gb_ops.CUM_AGGS and not {
                k: v for k, v in agg_kwargs.items() if not (k == "numeric_only" and v is False)
            }:
                result = self._try_device_groupby_cum(
                    agg_func, by, groupby_kwargs, drop, series_groupby, selection
                )
            elif agg_func in ("cumcount", "ngroup") and set(agg_kwargs) <= {"ascending"}:
                result = self._try_device_groupby_number(
                    agg_func, by, groupby_kwargs, drop, bool(agg_kwargs.get("ascending", True))
                )
            elif agg_func == "describe" and not series_groupby:
                result = self._try_device_groupby_describe(
                    by, groupby_kwargs, agg_kwargs, drop, selection
                )
        if result is not None:
            return result

        def pandas_groupby(obj, by_obj):
            gb = obj.groupby(by_obj, **groupby_kwargs)
            if selection is not None:
                gb = gb[selection]
            if isinstance(agg_func, str):
                return getattr(gb, agg_func)(*agg_args, **agg_kwargs)
            if callable(agg_func):
                return agg_func(gb, *agg_args, **agg_kwargs)
            return gb.agg(agg_func, *agg_args, **agg_kwargs)

        return self._default_to_pandas(pandas_groupby, by)

    @device_path("groupby")
    def _try_device_groupby(
        self, by, agg_func, axis, groupby_kwargs, agg_args, agg_kwargs, drop,
        series_groupby, selection,
    ) -> Optional["TorchQueryCompiler"]:
        if axis != 0 or agg_args:
            return None
        if not isinstance(agg_func, str) or agg_func not in (gb_ops.SEGMENT_AGGS | gb_ops.ORDER_AGGS):
            return None
        if groupby_kwargs.get("level") is not None:
            return None
        if not groupby_kwargs.get("sort", True):
            return None
        as_index = groupby_kwargs.get("as_index", True)
        if not as_index and agg_func == "size":
            return None
        dropna = groupby_kwargs.get("dropna", True)
        numeric_only = bool(agg_kwargs.get("numeric_only", False))
        if agg_kwargs.get("min_count", 0) not in (0, -1):
            return None
        if agg_kwargs.get("skipna", True) is not True:
            return None
        extra = set(agg_kwargs) - {
            "numeric_only", "min_count", "ddof", "skipna", "engine",
            "engine_kwargs", "q", "interpolation", "dropna",
        }
        if extra:
            return None
        if agg_kwargs.get("engine") not in (None, "cython"):
            return None
        ddof = agg_kwargs.get("ddof", 1)
        if isinstance(ddof, bool) or not isinstance(ddof, (int, np.integer)):
            return None
        if agg_func == "quantile":
            qval = agg_kwargs.get("q", 0.5)
            if isinstance(qval, bool) or not isinstance(qval, (int, float, np.integer, np.floating)):
                return None  # a list of q makes a MultiIndex result
            if not 0 <= float(qval) <= 1:
                return None  # pandas raises its ValueError
            interp = agg_kwargs.get("interpolation", "linear")
            if interp not in ("linear", "lower", "higher", "midpoint", "nearest"):
                return None
        elif "q" in agg_kwargs or "interpolation" in agg_kwargs:
            return None
        else:
            qval, interp = 0.5, "linear"
        if agg_func == "nunique":
            values_dropna = bool(agg_kwargs.get("dropna", True))
        elif "dropna" in agg_kwargs:
            return None
        else:
            values_dropna = True

        frame = self._modin_frame
        if len(frame) == 0:
            return None
        # resolve the key columns: labels of this frame's own columns, or
        # external Series-shaped compilers aligned with this frame
        key_positions: List[int] = []
        if isinstance(by, list) and drop and all(not hasattr(b, "to_pandas") for b in by):
            for label in by:
                pos = frame.column_position(label)
                if len(pos) != 1:
                    return None
                key_positions.append(pos[0])
            key_labels = list(by)
            key_cols = [frame._columns[p] for p in key_positions]
        else:
            key_labels, key_cols = [], []
            for ext in by if isinstance(by, list) else [by]:
                if not isinstance(ext, TorchQueryCompiler) or not as_index:
                    return None
                eframe = ext._modin_frame
                if eframe.num_cols != 1 or len(eframe) != len(frame) or not self._fast_index_match(ext):
                    return None
                label = list(eframe.columns)[0]
                key_labels.append(None if label == MODIN_UNNAMED_SERIES_LABEL else label)
                key_cols.append(eframe.get_column(0))
            if not key_cols:
                return None
        # numeric device keys as they are; host string/object keys through
        # their dictionary codes, categorical keys through pandas' own codes
        key_datas = []
        key_decoders: List[Any] = []  # None, categories, or the categorical dtype
        for c in key_cols:
            if c.is_device and c.pandas_dtype.kind in "biuf":
                key_datas.append(c.data)
                key_decoders.append(None)
            elif _is_categorical(c):
                enc = dictionary.encode_categorical_column(c)
                if enc is None or (not groupby_kwargs.get("observed", True) and len(key_cols) > 1):
                    return None
                key_datas.append(enc.codes.data)
                key_decoders.append(c.pandas_dtype)
            else:
                enc = self._encoded(c)
                if enc is None:
                    return None
                key_datas.append(enc.codes.data)
                key_decoders.append(enc.categories)
        categorical = [d is not None and not isinstance(d, np.ndarray) for d in key_decoders]

        # resolve the value columns
        if selection is not None:
            sel_list = [selection] if not isinstance(selection, list) else list(selection)
            value_positions = []
            for label in sel_list:
                pos = frame.column_position(label)
                if len(pos) != 1:
                    return None
                value_positions.append(pos[0])
        else:
            value_positions = [i for i in range(frame.num_cols) if i not in key_positions]
        labels = list(frame.columns)
        value_datas = []
        value_labels = []
        value_src: List[int] = []  # the frame position of each value column
        value_decoders: List[Any] = []  # (categories, source dtype) of string values
        for i in value_positions:
            col = frame._columns[i]
            if col.is_device and col.pandas_dtype.kind in "biuf":
                data = col.data
                if data.dtype == torch.bool:
                    if agg_func == "quantile":
                        return None  # pandas: "Cannot use quantile with bool dtype"
                    if agg_func in ("sum", "prod", "mean", "var", "std", "sem", "median"):
                        data = data.to(torch.int64)  # bools count as ints, as in pandas
                elif data.dtype == torch.float16 and agg_func in _FLOAT16_GROUPBY:
                    # pandas aggregates float16 as float32 (median as float64)
                    data = data.to(_FLOAT16_GROUPBY[agg_func])
                value_datas.append(data)
                value_src.append(i)
                value_labels.append(labels[i])
                value_decoders.append(None)
                continue
            if numeric_only:
                if _is_numeric_dtype(col.pandas_dtype):
                    return None  # numeric but not device-computable
                continue  # genuinely non-numeric: pandas drops it too
            if agg_func == "size":
                continue
            # string values join min/max/count/first/last/nunique through
            # their codes (sorted categories: the code min/max is the
            # lexicographic one; the rest do not look at the values)
            enc = (
                self._encoded(col)
                if agg_func in ("min", "max", "count", "first", "last", "nunique")
                else None
            )
            # no categories = an all-missing column: pandas' answers stay
            if enc is None or not len(enc.categories):
                return None
            value_datas.append(enc.codes.data)
            value_src.append(i)
            value_labels.append(labels[i])
            value_decoders.append((enc.categories, col.pandas_dtype))
        if agg_func != "size" and not value_datas:
            return None

        try:
            codes, n_groups, group_keys, sizes = gb_ops.factorize_keys_cached(
                key_datas, len(frame), dropna=dropna
            )
        except gb_ops._TooManyGroups:
            return None
        if n_groups == 0:
            return None
        if not groupby_kwargs.get("observed", True) and categorical[0]:
            # observed=False keeps the unobserved categories, which the codes
            # never see: the device answers only when there are none
            nan_group = 1 if (not dropna and np.isnan(group_keys[0]).any()) else 0
            if n_groups - nan_group < len(key_decoders[0].categories):
                return None

        n = len(frame)
        if agg_func in ("median", "quantile"):
            datas = gb_ops.groupby_quantile(
                value_datas, codes, n_groups, n, q=float(qval), interpolation=interp,
                preserve_float_dtype=agg_func == "median",
            )
        elif agg_func == "nunique":
            datas = gb_ops.groupby_nunique(value_datas, codes, n_groups, n, dropna=values_dropna)
        elif agg_func in ("first", "last"):
            datas = gb_ops.groupby_first_last(agg_func, value_datas, codes, n_groups, n)
        else:
            datas = gb_ops.groupby_reduce(
                agg_func, value_datas, codes, n_groups, n, sizes=sizes, ddof=int(ddof)
            )
            if agg_func in ("sum", "prod"):
                datas = gb_ops.widen_blocks(
                    datas, [d.dtype for d in value_datas],
                    _block_groups(frame, value_src, runs=bool(key_positions) or selection is not None),
                )
        if agg_func == "size":
            value_labels = [MODIN_UNNAMED_SERIES_LABEL]
            value_decoders = [None]
        new_cols: list = []
        for d, dec in zip(datas, value_decoders):
            if dec is not None and agg_func in ("min", "max", "first", "last"):
                # a string value column: the per-group result is a code
                import pandas

                cats, src_dtype = dec
                decoded = dictionary.decode_codes(TorchWrapper.materialize(d), cats)
                if isinstance(src_dtype, pandas.StringDtype):
                    decoded = pandas.array(decoded, dtype=src_dtype)
                new_cols.append(HostColumn(decoded))
            else:
                new_cols.append(_agg_column(d, n_groups))
        # the group keys, string levels decoded and categorical levels in
        # their dtype (pandas gives a CategoricalIndex)
        keys = []
        for vals, dec, is_cat in zip(group_keys, key_decoders, categorical):
            if dec is None:
                keys.append(vals)
            elif is_cat:
                import pandas

                vals = np.asarray(vals, dtype=np.float64)
                keys.append(pandas.Categorical.from_codes(
                    np.where(np.isnan(vals), -1, vals).astype(np.int64), dtype=dec
                ))
            else:
                keys.append(dictionary.decode_codes(vals, dec))
        qc = type(self)(TorchDataframe(
            new_cols, value_labels, LazyIndex.from_arrays(keys, key_labels), nrows=n_groups,
        ))
        if not as_index:
            # the keys become columns before the values, under a RangeIndex
            qc = qc.reset_index(drop=False)
        if series_groupby or agg_func == "size":
            qc._shape_hint = "column"
        return qc

    @device_path("groupby")
    def _try_device_groupby_multi(
        self, by, agg_func, axis, groupby_kwargs, agg_args, agg_kwargs, drop,
        series_groupby, selection,
    ) -> Optional["TorchQueryCompiler"]:
        """``agg([...])`` and ``agg({col: name})`` of strings: one device
        aggregation each over the kept factorization, put together as
        pandas does (a ``(column, aggregation)`` MultiIndex for a list, flat
        aggregation names for a Series groupby, flat columns for a dict)."""
        if not groupby_kwargs.get("as_index", True):
            return None  # the key columns go back in per layout

        def run_one(func, sel):
            return self._try_device_groupby(
                by, func, axis, groupby_kwargs, agg_args, agg_kwargs, drop,
                series_groupby, sel,
            )

        import pandas

        if isinstance(agg_func, list) and agg_func and all(isinstance(f, str) for f in agg_func):
            if not series_groupby and len(set(agg_func)) != len(agg_func):
                return None  # pandas raises SpecificationError on duplicates
            parts = []
            for f in agg_func:
                part = run_one(f, selection)
                if part is None:
                    return None
                parts.append(part)
            frames = [p._modin_frame for p in parts]
            base_labels = list(frames[0].columns)
            if any(isinstance(lab, tuple) for lab in base_labels):
                return None  # pandas nests a deeper MultiIndex
            if not all(list(f.columns) == base_labels for f in frames[1:]):
                return None
            new_cols, labels = [], []
            if series_groupby:
                for f, fname in zip(frames, agg_func):
                    new_cols.append(f._columns[0])
                    labels.append(fname)
                new_labels = pandas.Index(labels)
            else:
                for pos, label in enumerate(base_labels):
                    for f, fname in zip(frames, agg_func):
                        new_cols.append(f._columns[pos])
                        labels.append((label, fname))
                new_labels = pandas.MultiIndex.from_tuples(labels)
            return type(self)(TorchDataframe(new_cols, new_labels, frames[0]._index, nrows=len(frames[0])))

        if (
            isinstance(agg_func, dict)
            and agg_func
            and not series_groupby
            and selection is None
            and all(isinstance(f, str) for f in agg_func.values())
        ):
            parts = []
            for col, f in agg_func.items():
                part = run_one(f, [col])
                if part is None:
                    return None
                parts.append(part)
            frames = [p._modin_frame for p in parts]
            if not all(f.num_cols == 1 for f in frames):
                return None
            return type(self)(TorchDataframe(
                [f._columns[0] for f in frames], pandas.Index(list(agg_func)),
                frames[0]._index, nrows=len(frames[0]),
            ))
        return None

    @device_path("groupby")
    def _try_device_groupby_describe(
        self, by, groupby_kwargs, agg_kwargs, drop, selection=None
    ) -> Optional["TorchQueryCompiler"]:
        """``groupby.describe()`` as eight device aggregations (count, mean,
        std, min, the three quartiles, max) over the one kept
        factorization, in pandas' float64 ``(column, statistic)`` layout."""
        if any(agg_kwargs.get(k) is not None for k in ("include", "exclude", "percentiles")):
            return None
        if not groupby_kwargs.get("as_index", True):
            return None
        plan = [
            ("count", {}), ("mean", {}), ("std", {}), ("min", {}),
            ("quantile", {"q": 0.25}), ("quantile", {"q": 0.5}),
            ("quantile", {"q": 0.75}), ("max", {}),
        ]
        parts = []
        for func, kw in plan:
            r = self._try_device_groupby(
                by, func, 0, groupby_kwargs, (), {"numeric_only": True, **kw}, drop, False, selection,
            )
            if r is None:
                return None
            parts.append(r._modin_frame)
        vcols = list(parts[0].columns)
        if not vcols or any(list(f.columns) != vcols for f in parts):
            return None
        import pandas

        stats = ["count", "mean", "std", "min", "25%", "50%", "75%", "max"]
        f64 = np.dtype(np.float64)
        new_cols, tuples = [], []
        for vi, vc in enumerate(vcols):
            for f, st in zip(parts, stats):
                col = f.get_column(vi)
                if not col.is_device:
                    return None
                if col.pandas_dtype != f64:
                    # pandas' describe is float64 throughout
                    col = DeviceColumn(col.data.to(torch.float64), f64, length=col.length)
                new_cols.append(col)
                tuples.append((vc, st))
        return type(self)(TorchDataframe(
            new_cols, pandas.MultiIndex.from_tuples(tuples), parts[0]._index, nrows=len(parts[0]),
        ))

    def groupby_transform(
        self,
        by: Any,
        agg_func: Any,
        groupby_kwargs: Optional[dict] = None,
        drop: bool = False,
        series_groupby: bool = False,
        selection: Any = None,
    ) -> "TorchQueryCompiler":
        result = self._try_device_groupby_transform(
            by, agg_func, dict(groupby_kwargs or {}), drop, series_groupby, selection
        )
        if result is not None:
            return result
        return super().groupby_transform(
            by, agg_func, groupby_kwargs=groupby_kwargs, drop=drop,
            series_groupby=series_groupby, selection=selection,
        )

    def _rowwise_result(self, datas: List[Any], labels: Sequence[Any], series: bool) -> "TorchQueryCompiler":
        """A row-shaped groupby result: this frame's index, new columns (a
        uint64 result, a host numpy array, as a host column)."""
        frame = self._modin_frame
        cols = [_agg_column(d, len(frame)) for d in datas]
        qc = type(self)(TorchDataframe(cols, labels, frame._index, nrows=len(frame)))
        if series:
            qc._shape_hint = "column"
        return qc

    @device_path("groupby")
    def _try_device_groupby_transform(
        self, by, agg_func, groupby_kwargs, drop, series_groupby, selection
    ) -> Optional["TorchQueryCompiler"]:
        """``transform("sum"/"mean"/...)``: a segment aggregation over the
        kept factorization, gathered back to the rows (the frame's shape and
        index)."""
        if not isinstance(agg_func, str) or agg_func not in (gb_ops.SEGMENT_AGGS - {"size"}):
            return None
        resolved = self._resolve_rowwise_groupby(by, groupby_kwargs, drop, selection, "biuf")
        if resolved is None:
            return None
        value_positions, codes, n_groups, sizes = resolved
        frame = self._modin_frame
        arrays = []
        for i in value_positions:
            a = frame._columns[i].data
            if a.dtype == torch.bool and agg_func in ("sum", "prod", "mean", "var", "std", "sem"):
                a = a.to(torch.int64)
            arrays.append(a)
        aggs = gb_ops.groupby_reduce(agg_func, arrays, codes, n_groups, len(frame), sizes=sizes)
        if any(isinstance(a, np.ndarray) for a in aggs):
            return None  # a uint64 result: the port keeps no uint64 device column
        labels = [list(frame.columns)[i] for i in value_positions]
        return self._rowwise_result(gb_ops.groupby_broadcast(aggs, codes), labels, series_groupby)

    def _resolve_rowwise_groupby(
        self, by, groupby_kwargs, drop, selection, value_kinds: str, need_values: bool = True
    ):
        """The shared gate of the row-shaped groupby ops (transform,
        cumulatives, cumcount/ngroup): (value positions, codes, group count,
        sizes) or None.  Keys are int/bool device columns of this frame:
        NaN keys would make the result's dtype and NaN rows data-dependent."""
        if groupby_kwargs.get("level") is not None or groupby_kwargs.get("dropna", True) is not True:
            return None
        frame = self._modin_frame
        if len(frame) == 0:
            return None
        if not (isinstance(by, list) and drop and all(not hasattr(b, "to_pandas") for b in by)):
            return None
        key_positions = []
        for label in by:
            pos = frame.column_position(label)
            if len(pos) != 1:
                return None
            key_positions.append(pos[0])
        key_cols = [frame._columns[p] for p in key_positions]
        if not all(c.is_device and c.pandas_dtype.kind in "biu" for c in key_cols):
            return None
        if selection is not None:
            value_positions = []
            for label in [selection] if not isinstance(selection, list) else list(selection):
                pos = frame.column_position(label)
                if len(pos) != 1:
                    return None
                value_positions.append(pos[0])
        else:
            value_positions = [i for i in range(frame.num_cols) if i not in key_positions]
        value_cols = [frame._columns[i] for i in value_positions]
        if need_values and not value_cols:
            return None
        if not all(c.is_device and c.pandas_dtype.kind in value_kinds for c in value_cols):
            return None
        try:
            codes, n_groups, _keys, sizes = gb_ops.factorize_keys_cached(
                [c.data for c in key_cols], len(frame)
            )
        except gb_ops._TooManyGroups:
            return None
        if n_groups == 0:
            return None
        return value_positions, codes, n_groups, sizes

    @device_path("groupby")
    def _try_device_groupby_cum(
        self, op, by, groupby_kwargs, drop, series_groupby, selection
    ) -> Optional["TorchQueryCompiler"]:
        """Grouped cumulatives: one segmented scan over the rows sorted by
        code, scattered back to row order (the scan kernel)."""
        # bools change dtype per op in pandas, and uint64 does not fit the
        # kernel's int64: both stay with pandas
        resolved = self._resolve_rowwise_groupby(by, groupby_kwargs, drop, selection, "iuf")
        if resolved is None:
            return None
        value_positions, codes, _n_groups, _sizes = resolved
        frame = self._modin_frame
        if any(frame._columns[i].data.dtype == torch.uint64 for i in value_positions):
            return None
        arrays = [
            a.to(torch.float32) if a.dtype == torch.float16 and op in ("cumsum", "cumprod") else a
            for a in frame.device_datas(value_positions)
        ]
        labels = [list(frame.columns)[i] for i in value_positions]
        datas = gb_ops.groupby_cumulative(op, arrays, codes)
        if op in ("cumsum", "cumprod"):
            datas = gb_ops.widen_blocks(
                datas, [a.dtype for a in arrays], _block_groups(frame, value_positions, runs=True)
            )
        return self._rowwise_result(datas, labels, series_groupby)

    @device_path("groupby")
    def _try_device_groupby_number(
        self, op, by, groupby_kwargs, drop, ascending: bool
    ) -> Optional["TorchQueryCompiler"]:
        """``cumcount`` (each row's place in its group) and ``ngroup`` (its
        group's number, in sorted key order): int64 Series over the frame's
        rows."""
        resolved = self._resolve_rowwise_groupby(
            by, groupby_kwargs, drop, None, "biuf", need_values=False
        )
        if resolved is None or (op == "ngroup" and not groupby_kwargs.get("sort", True)):
            return None  # unsorted groups number by first appearance
        _positions, codes, n_groups, sizes = resolved
        if op == "cumcount":
            data = gb_ops.groupby_cumcount(codes, n_groups, sizes, ascending)
        else:
            data = codes if ascending else (n_groups - 1) - codes
        return self._rowwise_result([data], [MODIN_UNNAMED_SERIES_LABEL], True)

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
        if self._planning() and isinstance(key, TorchQueryCompiler):
            planned = _plan_runtime().defer_filter(self, key)
            if planned is not None:
                return planned
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
                # a deferred mask and the frame's deferred columns run in
                # one fused launch before the compaction
                return type(self)(
                    frame.filter_rows_mask_device(mask_frame.get_column(0).raw),
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
        """Set the column ``key`` on the device (``axis=0``); a row
        (``axis=1``) defaults to pandas."""
        if axis != 0:
            return super().setitem(axis, key, value)
        frame = self._modin_frame
        col = self._column_from_value(value) if len(frame) > 0 else None
        positions = frame.column_position(key)
        if col is not None and len(positions) <= 1:
            new_cols = list(frame._columns)
            if positions:
                # the replaced column's derived caches (its sorted
                # representation, its artifacts) go with it
                old = new_cols[positions[0]]
                if old.is_device and old is not col:
                    old._invalidate_derived()
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

    def setitem_bool(self, row_loc: Any, col_loc: Any, item: Any) -> "TorchQueryCompiler":
        """``df.loc[mask, col] = scalar`` as one ``torch.where``.  pandas 3
        never upcasts in a loc assignment (an incompatible scalar raises),
        so the device takes the dtype-keeping scalars only: a bool into a
        bool column, an int within range into an int column, an int or
        float into a float column (cast to its dtype, as pandas casts it);
        the rest defaults to pandas, which gives its result or its error."""
        frame = self._modin_frame
        pos = []
        if (
            isinstance(row_loc, TorchQueryCompiler)
            and row_loc._modin_frame.num_cols == 1
            and len(row_loc._modin_frame) == len(frame)
            and len(frame) > 0
            and self._fast_index_match(row_loc)
            and hashable(col_loc)
        ):
            mcol = row_loc._modin_frame.get_column(0)
            if mcol.is_device and mcol.pandas_dtype == np.dtype(bool):
                pos = frame.column_position(col_loc)
        col = frame._columns[pos[0]] if len(pos) == 1 else None
        kind = col.pandas_dtype.kind if col is not None and col.is_device else ""
        is_bool = isinstance(item, (bool, np.bool_))
        if kind == "b":
            ok = is_bool
        elif kind and kind in "iu":
            info = np.iinfo(col.pandas_dtype)
            # out of range would wrap on the device; pandas 3 raises
            ok = isinstance(item, (int, np.integer)) and not is_bool and info.min <= int(item) <= info.max
        else:
            ok = kind == "f" and _is_number(item)
        if not ok:
            return super().setitem_bool(row_loc, col_loc, item)
        value = torch.tensor(
            elementwise.cast_scalar(item, col.data.dtype), dtype=col.data.dtype, device=col.data.device
        )
        new_cols = list(frame._columns)
        new_cols[pos[0]] = DeviceColumn(
            torch.where(mcol.data, value, col.data), col.pandas_dtype, length=len(frame)
        )
        return type(self)(frame.with_columns(new_cols), self._shape_hint)

    def drop(self, index: Any = None, columns: Any = None, errors: str = "raise") -> "TorchQueryCompiler":
        """Dropping a list of present column labels keeps the other columns
        as they are (no data moves); any other drop defaults to pandas."""
        frame = self._modin_frame
        if index is None and isinstance(columns, list):
            dropped: set = set()
            for label in columns:
                pos = frame.column_position(label)
                if not pos:
                    break  # a missing label: pandas raises or ignores it
                dropped.update(pos)
            else:
                keep = [i for i in range(frame.num_cols) if i not in dropped]
                return type(self)(frame.select_columns_by_position(keep), self._shape_hint)
        return super().drop(index=index, columns=columns, errors=errors)

    # --------------------------- reset_index --------------------------- #

    def reset_index(self, **kwargs: Any) -> "TorchQueryCompiler":
        """``drop=True`` swaps in a RangeIndex (no device work);
        ``drop=False`` puts the index levels before the columns: numeric
        levels on the device, the others (strings, categoricals) on the
        host.  Other arguments, and labels that collide, default to pandas."""
        import pandas

        drop = kwargs.get("drop", False)
        unsupported = any(
            (k == "level" and v is not None)
            or (k == "names" and v is not None)
            or (k == "col_level" and v != 0)
            or (k == "col_fill" and v != "")
            or (k == "allow_duplicates" and v is not False and v is not pandas.api.extensions.no_default)
            for k, v in kwargs.items()
        )
        frame = self._modin_frame
        n = len(frame)
        if unsupported or isinstance(frame.columns, pandas.MultiIndex):
            return super().reset_index(**kwargs)
        if drop:
            return type(self)(frame.with_columns(list(frame._columns), index=LazyIndex(None, n)))
        idx = frame.index
        if isinstance(idx, pandas.MultiIndex):
            levels = [idx.get_level_values(i) for i in range(idx.nlevels)]
            names = [nm if nm is not None else f"level_{i}" for i, nm in enumerate(idx.names)]
        else:
            levels = [idx]
            taken = set(frame.columns)
            names = [idx.name if idx.name is not None else ("index" if "index" not in taken else "level_0")]
        if any(nm in set(frame.columns) for nm in names):
            return super().reset_index(**kwargs)  # pandas raises or renames
        # by the LEVEL's dtype: a categorical of ints is no device column
        new_cols = [column_of_series(lv, self._device()) for lv in levels]
        labels = pandas.Index(names + list(frame.columns))
        return type(self)(
            TorchDataframe(new_cols + list(frame._columns), labels, LazyIndex(None, n), nrows=n)
        )

    # ------------------------ unique, value_counts --------------------- #

    def unique(self, **kwargs: Any) -> "TorchQueryCompiler":
        """The distinct values of a string Series in order of appearance:
        the dictionary codes factorize on the device, and each group's first
        row position orders them."""
        import pandas

        frame = self._modin_frame
        col = frame.get_column(0) if frame.num_cols == 1 else None
        enc = self._encoded(col) if col is not None and len(frame) and not kwargs else None
        if enc is None:
            return super().unique(**kwargs)
        codes, n_groups, group_keys, _ = gb_ops.factorize_keys(
            [enc.codes.data], len(frame), dropna=False
        )
        first = TorchWrapper.materialize(gb_ops.groupby_first_position(codes, n_groups))
        order = np.argsort(first, kind="stable")
        values = dictionary.decode_codes(np.asarray(group_keys[0])[order], enc.categories)
        if isinstance(col.pandas_dtype, pandas.StringDtype):
            result = pandas.Series(pandas.array(values, dtype=col.pandas_dtype))
        else:
            result = pandas.Series(values, dtype=object)
        return type(self).from_pandas(result.to_frame(MODIN_UNNAMED_SERIES_LABEL), self._device())

    def series_value_counts(self, **kwargs: Any) -> "TorchQueryCompiler":
        """Counts of a numeric or string Series: the values (a string
        column's codes) factorize on the device and the group sizes count
        through the bincount kernel; ties keep pandas' order of first
        appearance."""
        import pandas

        frame = self._modin_frame
        col = frame.get_column(0) if frame.num_cols == 1 else None
        data = decoder = None
        if col is not None and len(frame) and kwargs.get("bins") is None:
            if col.is_device and col.pandas_dtype.kind in "biuf":
                data = col.data
            else:
                enc = self._encoded(col)
                if enc is not None:
                    data, decoder = enc.codes.data, enc.categories
        if data is None or set(kwargs) - {"normalize", "sort", "ascending", "bins", "dropna"}:
            return super().series_value_counts(**kwargs)
        try:
            codes, n_groups, group_keys, sizes = gb_ops.factorize_keys(
                [data], len(frame), dropna=kwargs.get("dropna", True)
            )
        except gb_ops._TooManyGroups:
            return super().series_value_counts(**kwargs)
        if n_groups == 0:
            return super().series_value_counts(**kwargs)
        counts_dev = gb_ops.groupby_reduce("size", [], codes, n_groups, len(frame), sizes=sizes)[0]
        first_dev = gb_ops.groupby_first_position(codes, n_groups)
        counts, first_pos = TorchWrapper.materialize([counts_dev, first_dev])
        keys = group_keys[0] if decoder is None else dictionary.decode_codes(group_keys[0], decoder)
        if getattr(keys, "dtype", None) == np.float16:
            keys = keys.astype(np.float32)  # pandas has no float16 index: its counts' is float32
        normalize = kwargs.get("normalize", False)
        name = list(frame.columns)[0]
        result = pandas.Series(
            counts / counts.sum() if normalize else counts,
            index=pandas.Index(keys, name=None if name == MODIN_UNNAMED_SERIES_LABEL else name),
        )
        if kwargs.get("sort", True):
            # by count, ties in order of first appearance
            order = np.lexsort((first_pos, counts if kwargs.get("ascending", False) else -counts))
        else:
            order = np.argsort(first_pos, kind="stable")
        result = result.iloc[order]
        result.name = "proportion" if normalize else "count"
        return self._from_pandas_result(result)

    # ------------------------------- .str ------------------------------ #

    @device_path("str_lut")
    def _try_str_lut(self, name: str, args: tuple, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        """A string predicate or measure through the dictionary encoding:
        the pandas method runs once per category on the host, and its
        results gather by code on the device.  Missing rows take what
        pandas gives for a missing value of the column's dtype."""
        import re

        import pandas

        frame = self._modin_frame
        col = frame.get_column(0) if frame.num_cols == 1 else None
        if col is None or col.is_device or not len(frame):
            return None
        if isinstance(col.pandas_dtype, pandas.StringDtype) and col.pandas_dtype.na_value is pandas.NA:
            # the NA-backed 'string' dtype answers in Int64/boolean
            # extension arrays: pandas keeps it
            return None
        enc = self._encoded(col)
        if enc is None:
            return None
        try:
            lut_ser = getattr(pandas.Series(enc.categories, dtype=col.pandas_dtype).str, name)(*args, **kwargs)
            na_probe = None
            if enc.has_nan:
                na_probe = getattr(
                    pandas.Series([np.nan], dtype=col.pandas_dtype).str, name
                )(*args, **kwargs).iloc[0]
        except (TypeError, ValueError, AttributeError, NotImplementedError, KeyError, re.error):
            return None  # pandas refuses this method or these arguments
        if not isinstance(lut_ser, pandas.Series) or len(lut_ser) != len(enc.categories):
            return None
        kind = getattr(lut_ser.dtype, "kind", "")
        if kind == "b":
            if enc.has_nan and not isinstance(na_probe, (bool, np.bool_)):
                return None  # NaN-mixed object output
            lut = np.append(lut_ser.to_numpy().astype(bool), bool(na_probe) if enc.has_nan else False)
            out_dtype = np.dtype(bool)
        elif kind in "iuf":
            fill = np.nan if enc.has_nan else 0.0  # no NaN code: never gathered
            if enc.has_nan and not (
                na_probe is None or (isinstance(na_probe, (float, np.floating)) and np.isnan(na_probe))
            ):
                if not isinstance(na_probe, (int, float, np.integer, np.floating)):
                    return None
                fill = float(na_probe)
            lut = np.append(lut_ser.to_numpy().astype(np.float64), fill)
            if kind in "iu" and not np.isnan(lut).any():
                lut = lut.astype(np.int64)
            out_dtype = lut.dtype
        else:
            return None  # string and object results stay with pandas
        data = dictionary.gather_lut(enc.codes.data, lut)
        result_col = DeviceColumn(data, out_dtype, length=len(frame))
        return type(self)(TorchDataframe([result_col], frame._col_labels, frame._index), "column")

    # ------------------------------- .dt ------------------------------- #

    @device_path("dt_component")
    def _try_dt_component(self, name: str, args: tuple, kwargs: dict, timedelta: bool) -> Optional["TorchQueryCompiler"]:
        """A calendar field of a naive datetime64 Series (or a field of a
        timedelta64 one) over its int64 ticks (``ops/datetime_parts.py``).
        tz-aware columns are host columns and stay with pandas."""
        frame = self._modin_frame
        col = frame.get_column(0) if frame.num_cols == 1 else None
        if (
            args
            or kwargs
            or col is None
            or not col.is_device
            or col.pandas_dtype.kind != ("m" if timedelta else "M")
            or not len(frame)
        ):
            return None
        names = datetime_parts.TIMEDELTA_COMPONENT_NAMES if timedelta else datetime_parts.COMPONENT_NAMES
        unit = np.datetime_data(col.pandas_dtype)[0]
        if name not in names or unit not in datetime_parts.UNITS:
            return None
        fn = datetime_parts.td_component if timedelta else datetime_parts.dt_component
        data, dtype = fn(name, col.data, unit)
        return type(self)(frame.with_columns([DeviceColumn(data, dtype, length=len(frame))]), "column")

    # --------------------------- encodings ----------------------------- #

    def series_get_dummies(
        self,
        prefix: Any = None,
        prefix_sep: str = "_",
        dummy_na: bool = False,
        drop_first: bool = False,
        dtype: Any = None,
    ) -> Optional["TorchQueryCompiler"]:
        """One-hot columns of a string or categorical Series, one ``codes ==
        k`` compare per category (at most 256), in pandas' order: the sorted
        values of a string column, the category order of a categorical
        (unobserved categories included).  None where it does not apply:
        the caller goes to pandas."""
        import pandas

        frame = self._modin_frame
        col = frame.get_column(0) if frame.num_cols == 1 else None
        if col is None or col.is_device or not len(frame):
            return None
        categorical = _is_categorical(col)
        enc = dictionary.encode_categorical_column(col) if categorical else self._encoded(col)
        if enc is None or not 0 < len(enc.categories) <= 256:
            return None
        try:
            out_dtype = np.dtype(bool if dtype is None else dtype)
        except TypeError:
            return None
        if out_dtype.kind not in "biuf" or not has_torch_dtype(out_dtype):
            return None
        codes = enc.codes.data
        masks = [codes == float(k) for k in range(1 if drop_first else 0, len(enc.categories))]
        labels = [f"{prefix}{prefix_sep}{cat}" if prefix is not None else cat
                  for cat in enc.categories[1 if drop_first else 0:]]
        if dummy_na:
            masks.append(torch.isnan(codes))
            labels.append(f"{prefix}{prefix_sep}nan" if prefix is not None else np.nan)
        if not masks:
            return None
        cols = [DeviceColumn(m.to(torch_dtype(out_dtype)), out_dtype, length=len(frame)) for m in masks]
        if categorical and prefix is None:
            # pandas labels a categorical's dummies with a CategoricalIndex
            # (the dummy_na column's NaN label is its -1 code)
            label_index = pandas.CategoricalIndex(labels, dtype=col.pandas_dtype)
        else:
            label_index = pandas.Index(labels)
        return type(self)(TorchDataframe(cols, label_index, frame._index, nrows=len(frame)))

    def series_map(self, arg: Any, na_action: Any = None) -> "TorchQueryCompiler":
        """``Series.map`` with a dict of numeric values on the device.  A
        string or object column maps its categories on the host and gathers
        the table by code; a numeric column looks its values up in the
        sorted keys (one ``searchsorted``).  Object results (bools with
        misses), NaN keys and other arguments go to pandas."""
        import pandas

        frame = self._modin_frame
        col = frame.get_column(0) if frame.num_cols == 1 else None
        if isinstance(arg, pandas.Series) and arg.index.is_unique:
            arg = arg.to_dict()
        data = None
        numeric = (int, float, bool, np.integer, np.floating, np.bool_)
        if (
            col is not None
            and type(arg) is dict  # a subclass may define __missing__
            and len(frame)
            and not any(isinstance(k, (float, np.floating)) and np.isnan(k) for k in arg)
            and all(v is None or isinstance(v, numeric) for v in arg.values())
            and any(v is not None for v in arg.values())  # only None values: pandas gives object
        ):
            values = [v for v in arg.values() if v is not None]
            all_bool = all(isinstance(v, (bool, np.bool_)) for v in values)
            all_int = all(isinstance(v, (int, np.integer, np.bool_)) for v in values)
            if not col.is_device:
                enc = self._encoded(col)
                if enc is not None:
                    lut = np.full(len(enc.categories) + 1, np.nan)
                    matched = np.zeros(len(enc.categories), bool)
                    for i, c in enumerate(enc.categories):
                        v = arg.get(c)
                        if v is not None:
                            lut[i], matched[i] = float(v), True
                    data = dictionary.gather_lut(enc.codes.data, lut)
                    fully = bool(matched.all()) and not enc.has_nan
            elif col.pandas_dtype.kind in "biuf":
                try:
                    keys = np.asarray(sorted(arg))
                except TypeError:
                    keys = None  # unorderable keys
                if keys is not None and len(keys) and keys.dtype.kind in "biuf":
                    device = col.data.device
                    ks = torch.as_tensor(keys.astype(np.float64), device=device)
                    vs = torch.as_tensor(
                        [np.nan if arg[k] is None else float(arg[k]) for k in keys.tolist()],
                        dtype=torch.float64, device=device,
                    )
                    x = col.data.to(torch.float64)
                    pos = torch.searchsorted(ks, x).clamp_(max=len(keys) - 1)
                    hit = ks[pos] == x
                    data = torch.where(hit, vs[pos], float("nan"))
                    fully = all_int and bool(hit.all())
        if data is None:
            return super().series_map(arg, na_action=na_action)
        if all_bool and not fully:
            return super().series_map(arg, na_action=na_action)  # pandas gives object
        if all_bool or (all_int and fully):
            data = data.to(torch.bool if all_bool else torch.int64)
        result_col = DeviceColumn(data, numpy_dtype(data.dtype), length=len(frame))
        return type(self)(frame.with_columns([result_col]), "column")

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

    @device_path("merge")
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
                and all(_same_dtype(c.pandas_dtype, d.pandas_dtype) for c, d in zip(base._columns, f._columns))
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

    @device_path("binary")
    def _try_device_isin(self, values: Any, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        """Membership in a literal value list: numeric device columns
        compare values, string columns compare the dictionary codes of the
        values present in their categories."""
        if kwargs or not isinstance(values, (list, tuple, set, frozenset, np.ndarray)):
            return None
        vals = list(values)
        if not 0 < len(vals) <= 1024 or not all(
            isinstance(v, (int, float, bool, str, np.integer, np.floating, np.bool_)) for v in vals
        ):
            return None
        frame = self._modin_frame
        if len(frame) == 0 or frame.num_cols == 0:
            return None
        is_nan = [isinstance(v, (float, np.floating)) and np.isnan(v) for v in vals]
        # plans: (device values, categories or None)
        plans = []
        for c in frame._columns:
            if c.is_device and c.pandas_dtype.kind in "biuf":
                plans.append((c.data, None))
                continue
            enc = self._encoded(c)
            if enc is None:
                return None
            if any(is_nan) and enc.has_nan and c.pandas_dtype == np.dtype(object):
                # object dtype keeps None and NaN apart in isin, and both
                # encode to a NaN code; the str dtype unifies them
                return None
            plans.append((enc.codes.data, enc.categories))
        numeric = [
            v for v, nan in zip(vals, is_nan)
            if not nan and not isinstance(v, str)
        ]
        clean = np.asarray(numeric) if numeric else np.empty(0, np.float64)
        all_int_values = clean.dtype.kind in "biu"
        device = self._device()
        datas = []
        for col, (data, cats) in zip(frame._columns, plans):
            dtype = col.pandas_dtype
            if cats is not None:
                codes = dictionary.lookup_values(vals, cats)
                test = torch.as_tensor(codes[~np.isnan(codes)], device=device)
                hit = torch.isin(data, test)
                if any(is_nan):
                    hit = hit | torch.isnan(data)
            elif dtype.kind in "iu" and all_int_values:
                # an all-integer value list compares with integer columns
                # EXACTLY (no float64 rounding past 2^53); values outside
                # the column's range cannot match
                info = np.iinfo(dtype)
                ints = [int(v) for v in clean if info.min <= int(v) <= info.max]
                hit = torch.isin(data, torch.as_tensor(np.asarray(ints, dtype=dtype), device=device))
            else:
                # any float in the list promotes the comparison to float64,
                # column included: lossy, as pandas is
                test = torch.as_tensor(clean.astype(np.float64), device=device)
                hit = torch.isin(data.to(torch.float64), test)
                if any(is_nan) and dtype.kind == "f":
                    hit = hit | torch.isnan(data)
            datas.append(hit)
        return self._wrap_device_result(datas)

    # ------------------------------ dropna ---------------------------- #

    def dropna(self, **kwargs: Any) -> "TorchQueryCompiler":
        """Rows without a missing value (``how="any"``) or not all missing
        (``"all"``) over ``subset``, when every column is on the device."""
        from pandas.api.types import is_list_like

        frame = self._modin_frame
        subset = kwargs.get("subset")
        if (
            kwargs.get("axis", 0) == 0
            and kwargs.get("how", "any") in ("any", "all")
            and kwargs.get("thresh") is None
            and not kwargs.get("ignore_index", False)
            and len(frame) > 0
            and all(c.is_device for c in frame._columns)
        ):
            positions = list(range(frame.num_cols))
            if subset is not None:
                positions = []
                for label in list(subset) if is_list_like(subset) else [subset]:
                    pos = frame.column_position(label)
                    if len(pos) != 1:
                        return super().dropna(**kwargs)
                    positions.append(pos[0])
            cols = [frame._columns[i] for i in positions]
            if not cols:
                return super().dropna(**kwargs)
            nas = torch.stack(materialize_exprs(elementwise.isna_columns(
                [c.raw for c in cols], [c.pandas_dtype.kind in "mM" for c in cols], negate=False
            )))
            keep = ~(nas.any(0) if kwargs.get("how", "any") == "any" else nas.all(0))
            return type(self)(frame.filter_rows_mask_device(keep), self._shape_hint)
        return super().dropna(**kwargs)

    # ------------------- idxmin/idxmax, nlargest/nsmallest -------------- #

    # ---------------------------- corr / cov -------------------------- #

    @device_path("corr_cov")
    def _try_device_corr_cov(
        self, method: str, min_periods: int, ddof: int, numeric_only: bool
    ) -> Optional["TorchQueryCompiler"]:
        """Pairwise ``corr``/``cov`` of the numeric device columns as one
        Gram product (``ops/stats.py``); a column of another kind declines,
        or is left out under ``numeric_only`` where pandas leaves it out."""
        frame = self._modin_frame
        if len(frame) == 0 or frame.num_cols == 0:
            return None
        if method == "cov" and any(getattr(c.pandas_dtype, "kind", "O") in "mM" for c in frame._columns):
            return None  # pandas refuses datetimes in cov, numeric_only or not
        positions = []
        for i, col in enumerate(frame._columns):
            kind = getattr(col.pandas_dtype, "kind", "O")
            if col.is_device and kind in "biuf":
                positions.append(i)
            elif not (numeric_only and kind not in "biufc"):
                return None
        if not positions:
            return None
        mat, _ = stats.corr_cov_matrix(
            frame.device_datas(positions), method, ddof=ddof, min_periods=min_periods
        )
        labels = self.get_columns()[positions]
        import pandas

        return type(self).from_pandas(pandas.DataFrame(mat, index=labels, columns=labels), self._device())

    def corr(self, method: Any = "pearson", min_periods: Any = 1, numeric_only: bool = False, **kwargs: Any):
        if method == "pearson" and not kwargs:
            result = self._try_device_corr_cov(
                "corr", int(min_periods) if min_periods is not None else 1, 1, bool(numeric_only)
            )
            if result is not None:
                return result
        return super().corr(method=method, min_periods=min_periods, numeric_only=numeric_only, **kwargs)

    def cov(self, min_periods: Any = None, ddof: Any = 1, numeric_only: bool = False, **kwargs: Any):
        if not kwargs and isinstance(ddof, (int, np.integer)):
            result = self._try_device_corr_cov(
                "cov", int(min_periods) if min_periods is not None else 1, int(ddof), bool(numeric_only)
            )
            if result is not None:
                return result
        return super().cov(min_periods=min_periods, ddof=ddof, numeric_only=numeric_only, **kwargs)

    def _device_idx_minmax(self, op: str, axis: Any, skipna: bool, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        import pandas

        frame = self._modin_frame
        if not (
            axis in (0, "index")
            and skipna
            and not kwargs
            and len(frame) > 0
            and frame.num_cols > 0
            and all(c.is_device and c.pandas_dtype.kind in "iuf" for c in frame._columns)
        ):
            return None
        positions, valid_counts = reductions.idx_minmax(
            op, frame.device_datas(), len(frame)
        )
        if not all(valid_counts):
            return None  # an all-NaN column: pandas raises
        result = pandas.Series(frame.index.take(positions), index=self.get_columns())
        return self._from_pandas_result(result.rename(MODIN_UNNAMED_SERIES_LABEL))

    def idxmin(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False, **kwargs: Any):
        result = self._device_idx_minmax("idxmin", axis, skipna, kwargs)
        if result is not None:
            return result
        return super().idxmin(axis=axis, skipna=skipna, numeric_only=numeric_only, **kwargs)

    def idxmax(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False, **kwargs: Any):
        result = self._device_idx_minmax("idxmax", axis, skipna, kwargs)
        if result is not None:
            return result
        return super().idxmax(axis=axis, skipna=skipna, numeric_only=numeric_only, **kwargs)

    @device_path("top_k")
    def _try_device_top_k(self, n: int, column_pos: int, largest: bool, keep: str) -> Optional["TorchQueryCompiler"]:
        frame = self._modin_frame
        if keep != "first" or len(frame) == 0:
            return None
        col = frame._columns[column_pos]
        if not col.is_device or col.pandas_dtype.kind not in "biuf":
            return None
        positions = sort_ops.top_k_positions(col.data, len(frame), int(n), bool(largest))
        return type(self)(frame.take_rows_device(positions), self._shape_hint)

    def _top_k_dispatch(self, n: Any, columns: Any, keep: Any, kwargs: dict, largest: bool) -> Optional["TorchQueryCompiler"]:
        if kwargs or not isinstance(n, (int, np.integer)) or isinstance(n, bool) or n < 0:
            return None
        frame = self._modin_frame
        if columns is None:
            # the Series form: its one column orders itself
            if frame.num_cols != 1:
                return None
            pos = 0
        else:
            col_list = columns if isinstance(columns, list) else [columns]
            if len(col_list) != 1:
                return None  # a tie-break chain of columns stays with pandas
            matches = frame.column_position(col_list[0])
            if len(matches) != 1:
                return None
            pos = matches[0]
        return self._try_device_top_k(int(n), pos, largest, keep)

    def nlargest(self, n: int = 5, columns: Any = None, keep: str = "first", **kwargs: Any):
        result = self._top_k_dispatch(n, columns, keep, kwargs, largest=True)
        if result is not None:
            return result
        return super().nlargest(n=n, columns=columns, keep=keep, **kwargs)

    def nsmallest(self, n: int = 5, columns: Any = None, keep: str = "first", **kwargs: Any):
        result = self._top_k_dispatch(n, columns, keep, kwargs, largest=False)
        if result is not None:
            return result
        return super().nsmallest(n=n, columns=columns, keep=keep, **kwargs)

    def series_nlargest(self, n: int = 5, keep: str = "first", **kwargs: Any):
        result = self._top_k_dispatch(n, None, keep, kwargs, largest=True)
        if result is not None:
            result._shape_hint = "column"
            return result
        return super().series_nlargest(n=n, keep=keep, **kwargs)

    def series_nsmallest(self, n: int = 5, keep: str = "first", **kwargs: Any):
        result = self._top_k_dispatch(n, None, keep, kwargs, largest=False)
        if result is not None:
            result._shape_hint = "column"
            return result
        return super().series_nsmallest(n=n, keep=keep, **kwargs)

    # both take pandas' own arguments, so the API's fallback of
    # ``Series.nlargest``/``nsmallest`` may route into them
    # (``BasePandasDataset._try_qc_dispatch`` checks this marker)
    series_nlargest._pandas_signature_default = True
    series_nsmallest._pandas_signature_default = True

    # -------------------------------- rank ---------------------------- #

    def rank(
        self,
        axis: Any = 0,
        method: str = "average",
        numeric_only: bool = False,
        na_option: str = "keep",
        ascending: bool = True,
        pct: bool = False,
        **kwargs: Any,
    ):
        """Column ranks on the device (``ops/sort.rank_columns``, through
        the scan kernel) for numeric device columns; with ``numeric_only``
        the other columns drop out, as in pandas."""
        frame = self._modin_frame
        positions: Optional[List[int]] = None
        if (
            axis in (0, "index", None)
            and not kwargs
            and method in sort_ops.RANK_METHODS
            and na_option in sort_ops.NA_OPTIONS
            and isinstance(ascending, (bool, np.bool_))
            and isinstance(pct, (bool, np.bool_))
            and len(frame) > 0
        ):
            positions = []
            for i, col in enumerate(frame._columns):
                if col.is_device and col.pandas_dtype.kind in "biuf":
                    positions.append(i)
                elif not (numeric_only and not _is_numeric_dtype(col.pandas_dtype)):
                    positions = None
                    break
        if positions:
            datas = sort_ops.rank_columns(
                frame.device_datas(positions), len(frame),
                method, bool(ascending), na_option, bool(pct),
            )
            labels = self.get_columns()[positions]
            return self._wrap_device_result(datas, col_labels=labels)
        return super().rank(
            axis=axis, method=method, numeric_only=numeric_only,
            na_option=na_option, ascending=ascending, pct=pct, **kwargs,
        )

    # ---------------------- duplicated, drop_duplicates ------------------ #

    def _duplicated_device_mask(self, subset: Any, keep: Any) -> Optional[torch.Tensor]:
        """The duplicate-row mask over the subset columns on the device, or
        None: a key that is neither a numeric device column nor a string
        column (its dictionary codes), a missing or repeated label, or a
        ``keep`` pandas rejects."""
        import pandas

        frame = self._modin_frame
        if keep not in ("first", "last", False) or len(frame) == 0:
            return None
        if subset is None:
            positions = list(range(frame.num_cols))
        else:
            # any list-like subset; a tuple stays one label
            if isinstance(subset, (list, np.ndarray, pandas.Index, pandas.Series)):
                labels = list(subset)
            else:
                labels = [subset]
            positions = []
            for label in labels:
                matches = frame.column_position(label)
                if len(matches) != 1:
                    return None  # pandas raises on a missing label
                positions.append(matches[0])
        if not positions:
            return None
        keys = []
        for i in positions:
            c = frame._columns[i]
            if c.is_device and c.pandas_dtype.kind in "biuf":
                keys.append(c.data)
                continue
            # string and object keys compare by dictionary code: NaN codes
            # are equal, as pandas' missing values are in duplicated
            enc = self._encoded(c)
            if enc is None:
                return None
            keys.append(enc.codes.data)
        return join_ops.duplicated_mask(keys, len(frame), keep)

    def duplicated(self, subset: Any = None, keep: Any = "first", **kwargs: Any):
        mask = self._duplicated_device_mask(subset, keep) if not kwargs else None
        if mask is not None:
            return self._wrap_device_result([mask], col_labels=[MODIN_UNNAMED_SERIES_LABEL])
        return super().duplicated(subset=subset, keep=keep, **kwargs)

    def drop_duplicates(self, subset: Any = None, keep: Any = "first", ignore_index: bool = False, **kwargs: Any):
        mask = self._duplicated_device_mask(subset, keep) if not kwargs else None
        if mask is not None:
            new_frame = self._modin_frame.filter_rows_mask_device(~mask)
            if ignore_index:
                new_frame = new_frame.with_columns(
                    list(new_frame._columns), index=LazyIndex(None, len(new_frame))
                )
            return type(self)(new_frame, self._shape_hint)
        return super().drop_duplicates(
            subset=subset, keep=keep, ignore_index=ignore_index, **kwargs
        )

    # -------------------------------- sort ---------------------------- #

    def sort_rows_by_column_values(self, columns: Any, ascending: Any = True, **kwargs: Any) -> "TorchQueryCompiler":
        if self._planning():
            planned = _plan_runtime().defer_sort(self, columns, ascending, kwargs)
            if planned is not None:
                return planned
        result = self._try_device_sort(columns, ascending, kwargs)
        if result is not None:
            return result
        return self._default_to_pandas(
            lambda obj: obj.sort_values(columns, ascending=ascending, **kwargs)
        )

    @device_path("sort_shuffle")
    def _try_device_sort(self, columns: Any, ascending: Any, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        """Stable multi-key sort by numeric device key columns and string
        columns' dictionary codes (sorted categories make the codes
        order-isomorphic to the strings, and NaN codes take na_position);
        host payload columns follow the permutation on the host.  ``kind``
        is not read: the sort is always stable, which is a valid answer for
        every kind (pandas sorts several keys stably whatever the kind)."""
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
            if not col.is_device:
                enc = self._encoded(col)
                if enc is None:
                    return None
                keys.append(enc.codes.data)
                continue
            # datetime keys are declined, as in the JAX package: NaT (int64
            # min) would sort first whatever na_position says
            if col.pandas_dtype.kind not in "biuf":
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

    @device_path("merge")
    def _try_device_merge(self, right: Any, kwargs: dict) -> Optional["TorchQueryCompiler"]:
        """The device sort-merge join (one or several key columns, every
        ``how``): numeric key pairs as they are, string key pairs through
        their dictionary codes remapped to the union dictionary.  String and
        object payload columns gather on the host by the join positions,
        fetched once."""
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
        for c in lframe._columns + rframe._columns:
            # host payloads: object and string columns (other extension
            # dtypes have join rules of their own in pandas)
            if not c.is_device:
                import pandas

                if not (
                    pandas.api.types.is_object_dtype(c.pandas_dtype)
                    or isinstance(c.pandas_dtype, pandas.StringDtype)
                ):
                    return None
        lkey_positions, rkey_positions = [], []
        dict_pairs: dict = {}  # key index -> (left encoding, right encoding)
        for ki, (ll, rl) in enumerate(zip(l_keys, r_keys)):
            lp, rp = lframe.column_position(ll), rframe.column_position(rl)
            if len(lp) != 1 or len(rp) != 1:
                return None
            lc, rc = lframe.get_column(lp[0]), rframe.get_column(rp[0])
            if lc.is_device and rc.is_device:
                # exact dtype match: pandas promotes int32 vs int64 keys;
                # datetime keys are declined, as in the JAX package
                if lc.pandas_dtype.kind not in "biuf" or lc.pandas_dtype != rc.pandas_dtype:
                    return None
            elif lc.is_device or rc.is_device:
                return None
            else:
                l_enc, r_enc = self._encoded(lc), self._encoded(rc)
                if l_enc is None or r_enc is None:
                    return None
                dict_pairs[ki] = (l_enc, r_enc)
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
        lkey_datas, rkey_datas = [], []
        for ki, (lp, rp) in enumerate(zip(lkey_positions, rkey_positions)):
            if ki in dict_pairs:
                l_enc, r_enc = dict_pairs[ki]
                _, l_map, r_map = dictionary.union_categories(l_enc.categories, r_enc.categories)
                lkey_datas.append(dictionary.remap_codes_device(l_enc.codes.data, l_map))
                rkey_datas.append(dictionary.remap_codes_device(r_enc.codes.data, r_map))
            else:
                lkey_datas.append(lframe.get_column(lp).data)
                rkey_datas.append(rframe.get_column(rp).data)
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

        # host positions, each fetched once when a host column needs it
        fetched: dict = {}

        def host_pos(name: str) -> np.ndarray:
            if name not in fetched:
                t = {"left": left_pos, "right": right_pos, "appendix": appendix_positions}[name]
                fetched[name] = TorchWrapper.materialize(t)
            return fetched[name]

        # ---- gather + assemble: (data, dtype, source position, side) ---- #
        # device data is a tensor; host data a callable giving the values
        # at a positions array (-1 -> missing)
        l_dev = [i for i, c in enumerate(lframe._columns) if c.is_device]
        l_datas = [lframe._columns[i].data for i in l_dev]
        if how == "right":
            l_gathered = dict(zip(l_dev, join_ops.gather_right_columns(l_datas, left_pos)))
        else:
            l_gathered = dict(zip(l_dev, gather_columns_device(l_datas, left_pos)))
        suffix_l, suffix_r = suffixes
        right_value_labels = {r_labels[i] for i in right_value_positions}
        new_cols: list = []
        new_labels: list = []
        for i, col in enumerate(lframe._columns):
            label = l_labels[i]
            if label in right_value_labels and i not in coalesced_lkeys:
                label = f"{label}{suffix_l}"
            new_labels.append(label)
            dtype = col.pandas_dtype
            if not col.is_device:
                if how == "right" and i in lkey_to_rkey:
                    # coalesced key: every output row is a right row
                    data = _host_take(rframe.get_column(lkey_to_rkey[i]).data, host_pos("right"))
                else:
                    data = _host_take(col.data, host_pos("left"))
                new_cols.append((data, dtype, i, "left"))
                continue
            data = l_gathered[i]
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
        r_dev = [i for i in right_value_positions if rframe.get_column(i).is_device]
        r_gathered = dict(zip(r_dev, join_ops.gather_right_columns(
            [rframe.get_column(i).data for i in r_dev], right_pos
        )))
        coalesced_labels = {l_labels[lp] for lp in coalesced_lkeys}
        for i in right_value_positions:
            col = rframe.get_column(i)
            label = r_labels[i]
            if label in l_labels and label not in coalesced_labels:
                label = f"{label}{suffix_r}"
            new_labels.append(label)
            dtype = col.pandas_dtype
            if not col.is_device:
                new_cols.append((_host_take(col.data, host_pos("right")), dtype, i, "right"))
                continue
            data = r_gathered[i]
            if right_has_nulls and dtype.kind in "iu":
                data = torch.where(right_pos < 0, float("nan"), data.to(torch.float64))
                dtype = np.dtype(np.float64)
            new_cols.append((data, dtype, i, "right"))
        if len(set(new_labels)) != len(new_labels):
            return None  # colliding suffixed labels: pandas raises MergeError

        # ---- outer appendix: right-only rows ----------------------------- #
        if n_appendix > 0:
            key_appendix = {
                lp: rframe.get_column(rp)
                for lp, rp, co in zip(lkey_positions, rkey_positions, coalesce) if co
            }
            merged = []
            for data, dtype, src, side in new_cols:
                source = rframe.get_column(src) if side == "right" else key_appendix.get(src)
                if isinstance(data, torch.Tensor):
                    if source is not None:
                        app = gather_columns_device([source.data], appendix_positions)[0]
                    else:
                        null = float("nan") if dtype.kind == "f" else join_ops._null_sentinel(data.dtype)
                        app = torch.full((n_appendix,), null, dtype=data.dtype, device=data.device)
                    data = torch.cat([data, app.to(data.dtype)])
                else:
                    app_pos = host_pos("appendix")
                    if source is None:
                        source, app_pos = data, np.full(n_appendix, -1, dtype=np.int64)
                    else:
                        source = source.data
                    data = _host_concat([data, _host_take(source, app_pos)])
                merged.append((data, dtype, src, side))
            new_cols = merged
        final_cols = [
            DeviceColumn(d, dt, length=n_total) if isinstance(d, torch.Tensor) else HostColumn(d)
            for d, dt, _, _ in new_cols
        ]
        result = TorchDataframe(final_cols, new_labels, LazyIndex(None, n_total), nrows=n_total)
        if how == "outer" and n_total > 0:
            # pandas sorts an outer merge by the join keys (stable, so equal
            # keys keep the left-join expansion order); string keys sort by
            # their union codes, gathered as the columns were
            key_arrays = []
            for ki, lp in enumerate(lkey_positions):
                if ki in dict_pairs:
                    main = gather_columns_device([lkey_datas[ki]], left_pos)[0]
                    if n_appendix > 0:
                        app = gather_columns_device([rkey_datas[ki]], appendix_positions)[0]
                        main = torch.cat([main, app])
                    key_arrays.append(main)
                else:
                    key_arrays.append(final_cols[lp].data)
            perm = sort_ops.lexsort_permutation(key_arrays, n_total, [True] * len(key_arrays))
            result = result.take_rows_device(perm, LazyIndex(None, n_total))
        return type(self)(result)


def _plan_runtime():
    """``plan/runtime.py``, imported at the first deferral (the planner
    needs pandas; the eager compiler runs without it)."""
    from modin_tpu_torch.plan import runtime

    return runtime


#: the dtype pandas aggregates a float16 column in, by groupby aggregation
_FLOAT16_GROUPBY = {
    "sum": torch.float32, "mean": torch.float32, "prod": torch.float32, "var": torch.float32,
    "median": torch.float64,
}


def _quantile_kept_dtypes(frame: Any, positions: Sequence[int]) -> Optional[np.dtype]:
    """The dtype pandas gives quantiles of the float32/float16 columns at
    ``positions``, or None for float64.  pandas keeps a narrow float dtype
    for the columns of a block that holds a NaN (a Series: the column has
    one) and answers float64 otherwise; the result is their common dtype."""
    blocks = frame._blocks
    kept = []
    with_nan = set()
    for pos in positions:
        col = frame._columns[pos]
        if col.pandas_dtype in (np.float32, np.float16) and bool(
            TorchWrapper.materialize(torch.isnan(col.data).any())
        ):
            with_nan.add(pos if blocks is None else blocks[pos])
    for pos in positions:
        col = frame._columns[pos]
        key = pos if blocks is None else blocks[pos]
        kept.append(col.pandas_dtype if key in with_nan else np.dtype(np.float64))
    if not kept or all(d == np.float64 for d in kept):
        return None
    return np.result_type(*kept)


def _block_groups(frame: Any, positions: Sequence[int], runs: bool) -> List[List[int]]:
    """Indices into ``positions`` whose narrow-int device columns shared a
    pandas block (``TorchDataframe._blocks``), for ``groupby.widen_blocks``.
    A groupby that drops its key columns (or selects columns) takes its
    value columns out of their blocks, and pandas then keeps together only
    the columns of one block that stand next to each other (``runs``); a
    resample keeps whole blocks."""
    blocks = frame._blocks
    if blocks is None:
        return []

    def narrow(pos: int) -> bool:
        col = frame._columns[pos]
        return col.is_device and col.pandas_dtype.kind in "iu" and col.pandas_dtype.itemsize < 8

    groups: List[List[int]] = []
    if runs:
        run: List[int] = []
        for j, pos in enumerate(positions):
            if run and narrow(pos) and blocks[pos] == blocks[positions[run[-1]]]:
                run.append(j)
                continue
            if len(run) > 1:
                groups.append(run)
            run = [j] if narrow(pos) else []
        if len(run) > 1:
            groups.append(run)
        return groups
    by_block: dict = {}
    for j, pos in enumerate(positions):
        if narrow(pos):
            by_block.setdefault(blocks[pos], []).append(j)
    return [g for g in by_block.values() if len(g) > 1]


def _agg_column(d: Any, n_groups: int) -> Any:
    """A grouped aggregation's column: a device tensor, or the host numpy
    array of a uint64 result (``groupby.int_sum_result``)."""
    if isinstance(d, np.ndarray):
        return HostColumn(d)
    return DeviceColumn(d, numpy_dtype(d.dtype), length=n_groups)


def _host_take(values: Any, positions: np.ndarray) -> Any:
    """``values`` (numpy or extension array) at ``positions``; -1 gives the
    dtype's missing value, as pandas' merge fills it."""
    from pandas.api.extensions import take

    return take(values, positions, allow_fill=True)


def _host_concat(parts: List[Any]) -> Any:
    """Host arrays one after another, in their common dtype (object when
    they differ)."""
    if all(isinstance(p, np.ndarray) for p in parts):
        return np.concatenate(parts)
    if len({str(p.dtype) for p in parts}) == 1:
        return type(parts[0])._concat_same_type(parts)
    return np.concatenate([np.asarray(p, dtype=object) for p in parts])


# ---------------------------------------------------------------------- #
# Generated binary ops: try the device path, else default to pandas.
# ---------------------------------------------------------------------- #


def _make_binary_override(op: str):
    def method(self: TorchQueryCompiler, other: Any, **kwargs: Any):
        kwargs.pop("squeeze_other", None)  # a column-shaped compiler squeezes itself
        if self._planning():
            planned = _plan_runtime().defer_binary(self, op, other, kwargs)
            if planned is not None:
                return planned
        result = self._try_device_binary(op, other, kwargs)
        if result is not None:
            return result
        if op.startswith("__"):
            # dunder ops take only `other` (a Series aligns by index)
            kwargs = {k: v for k, v in kwargs.items() if k not in ("axis", "level", "fill_value")}
        return self._default_to_pandas(
            lambda obj, oth: getattr(obj, op)(oth, **kwargs), other
        )

    method.__name__ = op
    return method


for _op in sorted(elementwise.BINARY_OPS):
    setattr(TorchQueryCompiler, _op, _make_binary_override(_op))


def _make_division_operator(dunder: str):
    """``__floordiv__`` & co.: a Series' ``//``/``%`` against a Series.  Int
    operands take pandas' operator result (device, else pandas' operator);
    any other pair is the flex op's, as in pandas."""
    flex = dunder.strip("_")

    def method(self: TorchQueryCompiler, other: Any, **kwargs: Any):
        if not self._int_series_operands(other):
            return getattr(self, flex)(other, **kwargs)
        result = self._try_int_division_operator(flex, other)
        if result is not None:
            return result
        return self._default_to_pandas(lambda obj, oth: getattr(obj, dunder)(oth), other)

    method.__name__ = dunder
    return method


for _op in ("__floordiv__", "__rfloordiv__", "__mod__", "__rmod__"):
    setattr(TorchQueryCompiler, _op, _make_division_operator(_op))


def _make_reduce_override(op: str):
    def method(
        self: TorchQueryCompiler,
        axis: Any = 0,
        skipna: bool = True,
        numeric_only: bool = False,
        **kwargs: Any,
    ):
        if self._planning():
            planned = _plan_runtime().run_reduce(
                self, op, dict(axis=axis, skipna=skipna, numeric_only=numeric_only, **kwargs)
            )
            if planned is not None:
                return planned
        result = self._try_device_reduce(op, axis, skipna, numeric_only, kwargs)
        if result is not None:
            return result
        # the pandas default (looked up per call: without pandas the base
        # compiler registers no defaults)
        base_method = getattr(BaseQueryCompiler, op)
        return base_method(self, axis=axis, skipna=skipna, numeric_only=numeric_only, **kwargs)

    method.__name__ = op
    return method


for _op in ["sum", "prod", "mean", "median", "min", "max", "var", "std", "sem", "skew", "kurt"]:
    setattr(TorchQueryCompiler, _op, _make_reduce_override(_op))


def _make_nonskipna_reduce_override(op: str):
    def method(self: TorchQueryCompiler, axis: Any = 0, **kwargs: Any):
        skipna = kwargs.pop("skipna", True)
        numeric_only = kwargs.pop("numeric_only", False)
        if self._planning():
            planned = _plan_runtime().run_reduce(
                self, op, dict(axis=axis, skipna=skipna, numeric_only=numeric_only, **kwargs)
            )
            if planned is not None:
                return planned
        result = self._try_device_reduce(op, axis, skipna, numeric_only, kwargs)
        if result is not None:
            return result
        base_method = getattr(BaseQueryCompiler, op)
        if op == "count":
            return base_method(self, axis=axis, numeric_only=numeric_only, **kwargs)
        return base_method(self, axis=axis, skipna=skipna, **kwargs)

    method.__name__ = op
    return method


for _op in ["count", "any", "all"]:
    setattr(TorchQueryCompiler, _op, _make_nonskipna_reduce_override(_op))


# string predicates and measures whose per-category results gather by code
# on the device (_try_str_lut); string-valued methods (lower, strip,
# replace, ...) stay with pandas
_STR_LUT_METHODS = [
    "len", "count", "contains", "startswith", "endswith", "match",
    "fullmatch", "find", "rfind", "isalnum", "isalpha", "isdigit",
    "isspace", "islower", "isupper", "istitle", "isnumeric", "isdecimal",
]


def _make_str_lut_override(name: str):
    def method(self: TorchQueryCompiler, *args: Any, **kwargs: Any):
        result = self._try_str_lut(name, args, kwargs)
        if result is not None:
            return result
        return getattr(BaseQueryCompiler, f"str_{name}")(self, *args, **kwargs)

    method.__name__ = f"str_{name}"
    return method


for _op in _STR_LUT_METHODS:
    setattr(TorchQueryCompiler, f"str_{_op}", _make_str_lut_override(_op))


def _make_cum_override(op: str):
    def method(self: TorchQueryCompiler, axis: Any = 0, skipna: bool = True, **kwargs: Any):
        result = self._cum_op(op, axis, skipna)
        if result is not None:
            return result
        return getattr(BaseQueryCompiler, op)(self, axis=axis, skipna=skipna, **kwargs)

    method.__name__ = op
    return method


for _op in sorted(elementwise.CUM_OPS):
    setattr(TorchQueryCompiler, _op, _make_cum_override(_op))


def _make_window_override(kind: str, op: str):
    """``rolling_<op>``/``expanding_<op>``/``ewm_<op>``: the device path,
    else the pandas default of the base compiler."""
    def method(self: TorchQueryCompiler, window_args: Any, *args: Any, **kwargs: Any):
        result = None
        if not args:
            if kind == "rolling":
                result = self._try_device_rolling(op, window_args, dict(kwargs))
            elif kind == "expanding":
                result = self._try_device_expanding(op, list(window_args), dict(kwargs))
            else:
                result = self._try_device_ewm(op, window_args, dict(kwargs))
        if result is not None:
            return result
        return getattr(BaseQueryCompiler, f"{kind}_{op}")(self, window_args, *args, **kwargs)

    method.__name__ = f"{kind}_{op}"
    return method


for _op in window_ops.ROLLING_DEVICE_OPS:
    setattr(TorchQueryCompiler, f"rolling_{_op}", _make_window_override("rolling", _op))
for _op in window_ops.EXPANDING_DEVICE_OPS:
    setattr(TorchQueryCompiler, f"expanding_{_op}", _make_window_override("expanding", _op))
for _op in window_ops.EWM_DEVICE_OPS:
    setattr(TorchQueryCompiler, f"ewm_{_op}", _make_window_override("ewm", _op))


def _make_dt_override(name: str, timedelta: bool):
    """``dt_<name>``: the device field, else the pandas default."""
    def method(self: TorchQueryCompiler, *args: Any, **kwargs: Any):
        result = self._try_dt_component(name, args, kwargs, timedelta)
        if result is not None:
            return result
        return getattr(BaseQueryCompiler, f"dt_{name}")(self, *args, **kwargs)

    method.__name__ = f"dt_{name}"
    return method


for _op in datetime_parts.COMPONENT_NAMES:
    setattr(TorchQueryCompiler, f"dt_{_op}", _make_dt_override(_op, False))
for _op in datetime_parts.TIMEDELTA_COMPONENT_NAMES:
    setattr(TorchQueryCompiler, f"dt_{_op}", _make_dt_override(_op, True))

RESAMPLE_DEVICE_OPS = ("sum", "mean", "count", "min", "max", "var", "std", "size")


def _make_resample_override(op: str):
    """``resample_<op>``: the device path, else the pandas default."""
    def method(self: TorchQueryCompiler, resample_kwargs: dict, *args: Any, **kwargs: Any):
        result = None if args else self._try_device_resample(op, resample_kwargs, dict(kwargs))
        if result is not None:
            return result
        return getattr(BaseQueryCompiler, f"resample_{op}")(self, resample_kwargs, *args, **kwargs)

    method.__name__ = f"resample_{op}"
    return method


for _op in RESAMPLE_DEVICE_OPS:
    setattr(TorchQueryCompiler, f"resample_{_op}", _make_resample_override(_op))
