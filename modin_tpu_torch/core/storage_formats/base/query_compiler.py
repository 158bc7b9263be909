"""``BaseQueryCompiler`` — the query compiler every storage format of the port implements.

The port's counterpart of ``modin_tpu/core/storage_formats/base/
query_compiler.py``: every pandas method exists here, implemented by
materializing to pandas (``default2pandas``), and ``TorchQueryCompiler``
overrides the subset that runs on the device.  Each default is counted in
``query_compiler.DEFAULTS_TO_PANDAS`` (``ErrorMessage.default_to_pandas``).
Left out, as later slices of the port: the backend-switching caster and its
cost model, extensions and the logging layer.

A query compiler always represents a **2-D frame**; a Series is a one-column
frame whose ``_shape_hint`` is ``"column"`` (the API layer squeezes).

The device layers of the port run without pandas; without it this module
still imports, and defines no defaults.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Hashable, List, Optional

import numpy as np

from modin_tpu_torch.logging import ClassLogger
from modin_tpu_torch.error_message import ErrorMessage
from modin_tpu_torch.utils import MODIN_UNNAMED_SERIES_LABEL, try_cast_to_pandas

try:
    import pandas
except ImportError:  # the device layers run without pandas; defaults need it
    pandas = None
else:
    from pandas.api.types import is_scalar

    from modin_tpu_torch.core.dataframe.algebra.default2pandas import (
        BinaryDefault,
        DataFrameDefault,
        DateTimeDefault,
        EwmDefault,
        ExpandingDefault,
        GroupByDefault,
        ListDefault,
        ResampleDefault,
        RollingDefault,
        SeriesDefault,
        StrDefault,
        StructDefault,
    )


# ---------------------------------------------------------------------- #
# API-layer routing tables: public pandas method name -> named QC method.
# The API layer's fallback path (pandas/base.py:_default_to_pandas) consults
# these so the long tail dispatches through a *named* BaseQueryCompiler
# method, overridable by the torch compiler, instead of short-circuiting to
# host pandas at the API layer.  Only registrations whose QC signature is
# exactly the pandas signature are routed (they are generated from the
# pandas callable itself).
# ---------------------------------------------------------------------- #
DATAFRAME_QC_ROUTES: dict = {}
SERIES_QC_ROUTES: dict = {}


def _set_axis(axis: int):
    def axis_setter(self: "BaseQueryCompiler", labels: pandas.Index) -> None:
        new_qc = DataFrameDefault.register(pandas.DataFrame.set_axis)(
            self, axis=axis, labels=labels
        )
        self.__dict__.update(new_qc.__dict__)

    return axis_setter


class BaseQueryCompiler(ClassLogger, abc.ABC, modin_layer="QUERY-COMPILER"):
    """Interface between the API layer and a storage format."""

    _modin_frame: Any = None
    _shape_hint: Optional[str] = None

    @property
    def __constructor__(self) -> type:
        return type(self)

    # ------------------------------------------------------------------ #
    # Abstract data-exchange primitives
    # ------------------------------------------------------------------ #

    @classmethod
    @abc.abstractmethod
    def from_pandas(cls, df: pandas.DataFrame) -> "BaseQueryCompiler":
        """Build a QC from a pandas DataFrame."""

    @abc.abstractmethod
    def to_pandas(self) -> pandas.DataFrame:
        """Materialize to a pandas DataFrame."""

    @classmethod
    def from_arrow(cls, at: Any) -> "BaseQueryCompiler":
        return cls.from_pandas(at.to_pandas())

    def to_numpy(self, **kwargs: Any) -> np.ndarray:
        return self.to_pandas().to_numpy(**kwargs)

    def to_interchange_dataframe(self, nan_as_null: bool = False, allow_copy: bool = True):
        return self.to_pandas().__dataframe__(
            nan_as_null=nan_as_null, allow_copy=allow_copy
        )

    @classmethod
    def from_interchange_dataframe(cls, df: Any) -> "BaseQueryCompiler":
        from pandas.api.interchange import from_dataframe

        return cls.from_pandas(from_dataframe(df))

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #

    def copy(self) -> "BaseQueryCompiler":
        return DataFrameDefault.register(pandas.DataFrame.copy)(self)

    def free(self) -> None:
        """Release the underlying resources."""

    def finalize(self) -> None:
        """Finalize constructing the dataframe (flush deferred work)."""

    def execute(self) -> None:
        """Block until all submitted device/engine work for this frame completes."""

    def dispatch(self) -> None:
        """Enqueue any deferred work without blocking (no-op off-device)."""

    def support_materialization_in_worker_process(self) -> bool:
        return True

    # ------------------------------------------------------------------ #
    # Metadata
    # ------------------------------------------------------------------ #

    def get_index(self) -> pandas.Index:
        return self.to_pandas().index

    def get_columns(self) -> pandas.Index:
        return self.to_pandas().columns

    index = property(lambda self: self.get_index(), _set_axis(0))
    columns = property(lambda self: self.get_columns(), _set_axis(1))

    @property
    def dtypes(self) -> pandas.Series:
        return self.to_pandas().dtypes

    def get_dtypes_set(self) -> set:
        return set(self.dtypes.values)

    def get_axis_len(self, axis: int) -> int:
        return len(self.index if axis == 0 else self.columns)

    def is_series_like(self) -> bool:
        return len(self.columns) == 1 or len(self.index) == 1

    def set_index_name(self, name: Hashable, axis: int = 0) -> None:
        getattr(self, "index" if axis == 0 else "columns").name = name

    def get_index_name(self, axis: int = 0) -> Hashable:
        return getattr(self, "index" if axis == 0 else "columns").name

    def set_index_names(self, names: Any = None, axis: int = 0) -> None:
        getattr(self, "index" if axis == 0 else "columns").names = names

    def get_index_names(self, axis: int = 0) -> List[Hashable]:
        return getattr(self, "index" if axis == 0 else "columns").names

    def get_pandas_backend(self) -> Optional[str]:
        return None

    def repartition(self, axis: Optional[int] = None) -> "BaseQueryCompiler":
        return self

    # ------------------------------------------------------------------ #
    # Generic defaulting
    # ------------------------------------------------------------------ #

    def default_to_pandas(self, pandas_op: Callable, *args: Any, **kwargs: Any) -> Any:
        """Materialize, apply ``pandas_op(df, *args, **kwargs)``, re-wrap."""
        op_name = getattr(pandas_op, "__name__", str(pandas_op))
        ErrorMessage.default_to_pandas(f"`{op_name}`")
        args = try_cast_to_pandas(args)
        kwargs = try_cast_to_pandas(kwargs)
        result = pandas_op(self.to_pandas(), *args, **kwargs)
        if isinstance(result, pandas.Series):
            if result.name is None:
                result = result.rename(MODIN_UNNAMED_SERIES_LABEL)
            result = result.to_frame()
        if isinstance(result, pandas.DataFrame):
            return self.from_pandas(result)
        return result

    # ------------------------------------------------------------------ #
    # Structural operations (explicit defaults; hot ones overridden by
    # concrete compilers)
    # ------------------------------------------------------------------ #

    def transpose(self, *args: Any, **kwargs: Any) -> "BaseQueryCompiler":
        return DataFrameDefault.register(pandas.DataFrame.transpose)(self)

    def columnarize(self) -> "BaseQueryCompiler":
        """Shape the frame into a single column (Series normal form)."""
        if len(self.columns) != 1 or (
            len(self.index) == 1 and self.index[0] == MODIN_UNNAMED_SERIES_LABEL
        ):
            result = self.transpose()
        else:
            # copy: the caller will tag/rename this as a Series; it must not
            # alias the parent frame's compiler
            result = self.copy()
        result._shape_hint = "column"
        return result

    def getitem_column_array(
        self, key: Any, numeric: bool = False, ignore_order: bool = False
    ) -> "BaseQueryCompiler":
        if numeric:
            return DataFrameDefault.register(
                lambda df, key: df.iloc[:, list(key)], fn_name="getitem_column_array"
            )(self, key=key)
        return DataFrameDefault.register(
            lambda df, key: df.loc[:, list(key)], fn_name="getitem_column_array"
        )(self, key=key)

    def getitem_row_array(self, key: Any) -> "BaseQueryCompiler":
        return DataFrameDefault.register(
            lambda df, key: df.iloc[list(key)], fn_name="getitem_row_array"
        )(self, key=key)

    def getitem_array(self, key: Any) -> "BaseQueryCompiler":
        if isinstance(key, type(self)):
            key = key.to_pandas().squeeze(axis=1)
        return DataFrameDefault.register(
            lambda df, key: df[key], fn_name="getitem_array"
        )(self, key=key)

    def take_2d_positional(
        self, index: Optional[Any] = None, columns: Optional[Any] = None
    ) -> "BaseQueryCompiler":
        index = slice(None) if index is None else index
        columns = slice(None) if columns is None else columns
        return DataFrameDefault.register(
            lambda df: df.iloc[index, columns], fn_name="take_2d_positional"
        )(self)

    def row_slice(self, start: Optional[int], stop: Optional[int], step: Optional[int] = None) -> "BaseQueryCompiler":
        """Positional row window — the repr/head/tail fast path."""
        return self.take_2d_positional(index=slice(start, stop, step))

    def insert(self, loc: int, column: Hashable, value: Any) -> "BaseQueryCompiler":
        value = try_cast_to_pandas(value, squeeze=True)

        def inserter(df: pandas.DataFrame) -> pandas.DataFrame:
            df = df.copy()
            df.insert(loc, column, value)
            return df

        return DataFrameDefault.register(inserter, fn_name="insert")(self)

    def insert_item(
        self, axis: int, loc: int, value: "BaseQueryCompiler", how: str = "inner", replace: bool = False
    ) -> "BaseQueryCompiler":
        assert isinstance(value, type(self)), "Cannot insert non-query-compiler values"
        delta = int(replace)
        if axis == 0:
            first = self.getitem_row_array(range(loc))
            second = self.getitem_row_array(range(loc + delta, self.get_axis_len(0)))
        else:
            first = self.getitem_column_array(range(loc), numeric=True)
            second = self.getitem_column_array(
                range(loc + delta, self.get_axis_len(1)), numeric=True
            )
        return first.concat(axis, [value, second], join=how, sort=False, ignore_index=False)

    def setitem(self, axis: int, key: Hashable, value: Any) -> "BaseQueryCompiler":
        value = try_cast_to_pandas(value, squeeze=True)

        def setitem(df: pandas.DataFrame, axis: int, key: Hashable, value: Any) -> pandas.DataFrame:
            df = df.copy()
            if is_scalar(key) and isinstance(value, pandas.DataFrame):
                value = value.squeeze(axis=1)
            if axis == 0:
                df[key] = value
            else:
                df.loc[key] = value
            return df

        return DataFrameDefault.register(setitem, fn_name="setitem")(
            self, axis=axis, key=key, value=value
        )

    def write_items(
        self, row_numeric_index: Any, col_numeric_index: Any, item: Any, need_columns_reindex: bool = True
    ) -> "BaseQueryCompiler":
        item = try_cast_to_pandas(item)

        def write_items_fn(df: pandas.DataFrame) -> pandas.DataFrame:
            df = df.copy()
            to_write = item
            if isinstance(to_write, (pandas.DataFrame, pandas.Series)):
                to_write = to_write.to_numpy() if not need_columns_reindex else to_write
            if isinstance(to_write, (pandas.DataFrame, pandas.Series)):
                to_write = np.asarray(to_write)
            if not is_scalar(to_write) and not isinstance(
                to_write, (pandas.DataFrame, pandas.Series)
            ):
                arr = np.asarray(to_write)
                if arr.ndim == 1:
                    n_rows_sel = (
                        len(range(*row_numeric_index.indices(len(df))))
                        if isinstance(row_numeric_index, slice)
                        else len(list(row_numeric_index))
                    )
                    n_cols_sel = (
                        len(range(*col_numeric_index.indices(df.shape[1])))
                        if isinstance(col_numeric_index, slice)
                        else len(list(col_numeric_index))
                    )
                    if n_cols_sel == 1 and len(arr) == n_rows_sel:
                        # a 1-D value into an (n, 1) selection is a column
                        # write, not a row broadcast
                        to_write = arr.reshape(-1, 1)
            df.iloc[
                list(row_numeric_index)
                if not isinstance(row_numeric_index, slice)
                else row_numeric_index,
                list(col_numeric_index)
                if not isinstance(col_numeric_index, slice)
                else col_numeric_index,
            ] = to_write
            return df

        return DataFrameDefault.register(write_items_fn, fn_name="write_items")(self)

    def drop(
        self,
        index: Optional[Any] = None,
        columns: Optional[Any] = None,
        errors: str = "raise",
    ) -> "BaseQueryCompiler":
        if index is None and columns is None:
            return self
        return DataFrameDefault.register(pandas.DataFrame.drop)(
            self, index=index, columns=columns, errors=errors
        )

    def concat(
        self,
        axis: int,
        other: Any,
        join: str = "outer",
        ignore_index: bool = False,
        sort: bool = False,
        **kwargs: Any,
    ) -> "BaseQueryCompiler":
        concat_join = "outer" if join != "inner" else "inner"

        def concat_fn(df: pandas.DataFrame, axis: int, other: Any, **kw: Any) -> pandas.DataFrame:
            ignore_index_kw = kw.pop("ignore_index", False)
            if isinstance(other, pandas.DataFrame):
                other = [other]
            return pandas.concat(
                [df] + other, axis=axis, join=concat_join, sort=sort,
                ignore_index=ignore_index_kw,
            )

        if not isinstance(other, (list, tuple)):
            other = [other]
        other = [o.to_pandas() if isinstance(o, BaseQueryCompiler) else o for o in other]
        result = DataFrameDefault.register(concat_fn, fn_name="concat")(
            self, axis=axis, other=other, ignore_index=ignore_index
        )
        if ignore_index:
            if axis == 0:
                return result.reset_index(drop=True)
            result.columns = pandas.RangeIndex(len(result.columns))
        return result

    def reindex(self, axis: int, labels: Any, **kwargs: Any) -> "BaseQueryCompiler":
        return DataFrameDefault.register(pandas.DataFrame.reindex)(
            self, axis=axis, labels=labels, **kwargs
        )

    def reset_index(self, **kwargs: Any) -> "BaseQueryCompiler":
        return DataFrameDefault.register(pandas.DataFrame.reset_index)(self, **kwargs)

    def set_index_from_columns(
        self, keys: List[Hashable], drop: bool = True, append: bool = False
    ) -> "BaseQueryCompiler":
        return DataFrameDefault.register(pandas.DataFrame.set_index)(
            self, keys=keys, drop=drop, append=append
        )

    def sort_rows_by_column_values(
        self, columns: Any, ascending: Any = True, **kwargs: Any
    ) -> "BaseQueryCompiler":
        return DataFrameDefault.register(pandas.DataFrame.sort_values)(
            self, by=columns, axis=0, ascending=ascending, **kwargs
        )

    def sort_columns_by_row_values(
        self, rows: Any, ascending: Any = True, **kwargs: Any
    ) -> "BaseQueryCompiler":
        return DataFrameDefault.register(pandas.DataFrame.sort_values)(
            self, by=rows, axis=1, ascending=ascending, **kwargs
        )

    def sort_index(self, **kwargs: Any) -> "BaseQueryCompiler":
        return DataFrameDefault.register(pandas.DataFrame.sort_index)(self, **kwargs)

    # ------------------------------------------------------------------ #
    # Reductions that need special squeezing/naming
    # ------------------------------------------------------------------ #

    # ------------------------------------------------------------------ #
    # Label -> position resolution (the loc/iloc seam; reference:
    # base/query_compiler.py:4844 get_positions_from_labels / :4809
    # take_2d_labels).  Implemented on axis metadata only — no data
    # materialization — so device frames stay on device through .loc.
    # ------------------------------------------------------------------ #

    def get_axis(self, axis: int) -> pandas.Index:
        return self.index if axis == 0 else self.columns

    def get_positions_from_labels(self, row_loc: Any, col_loc: Any) -> list:
        """Resolve loc-style row/column locators to iloc-style positions.

        Returns per axis: ``slice(None)`` for a full-axis grab (kept symbolic
        to avoid forcing lazy axis lengths), else a numpy position array or
        range-like.  Semantics follow pandas ``.loc`` exactly (reference
        base/query_compiler.py:4844): label slices are closed intervals;
        scalars resolve through ``Index.get_loc`` (partial-string datetime
        keys included); ``range``/``RangeIndex`` locators are *label lists*
        (missing labels raise ``KeyError``), not positions; MultiIndex axes
        resolve tuples through ``Index.get_locs`` (partial keys included) and
        label lists through level-0 selection.
        """
        from pandas.api.types import is_list_like

        out = []
        for axis, loc in ((0, row_loc), (1, col_loc)):
            if isinstance(loc, slice) and loc == slice(None):
                out.append(loc)
                continue
            if isinstance(loc, slice):
                lab = self.get_axis(axis)
                # label slices are closed intervals in .loc; slice_indexer
                # expects label bounds directly
                positions = lab.slice_indexer(loc.start, loc.stop, loc.step)
                n = len(lab)
                out.append(
                    pandas.RangeIndex(
                        positions.start + (n if positions.start < 0 else 0),
                        positions.stop + (n if positions.stop < 0 else 0),
                        positions.step,
                    )
                )
                continue
            if is_scalar(loc):
                out.append(self._scalar_label_positions(axis, loc))
                continue
            if isinstance(loc, tuple):
                if self.has_multiindex(axis):
                    # per-level selectors (partial or full key); get_locs
                    # raises KeyError for missing labels itself
                    lab = self.get_axis(axis)
                    out.append(np.asarray(lab.get_locs(list(loc))))
                else:
                    # on a flat index a tuple is itself a label
                    out.append(self._scalar_label_positions(axis, loc))
                continue
            if isinstance(loc, pandas.MultiIndex):
                lab = self.get_axis(axis)
                positions = lab.get_indexer_for(loc)
                if (positions == -1).any():
                    raise KeyError(list(loc[positions == -1]))
                out.append(np.asarray(positions))
                continue
            values = np.asarray(loc)
            if values.dtype == bool:
                lab = self.get_axis(axis)
                if len(values) != len(lab):
                    raise IndexError(
                        f"Boolean index has wrong length: "
                        f"{len(values)} instead of {len(lab)}"
                    )
                out.append(np.flatnonzero(values))
                continue
            lab = self.get_axis(axis)
            if self.has_multiindex(axis):
                keys = list(loc)
                if any(isinstance(k, tuple) for k in keys):
                    # list of (full) key tuples: exact-key selection
                    positions = lab.get_indexer_for(keys)
                    if (positions == -1).any():
                        raise KeyError(
                            [k for k, p in zip(keys, positions) if p == -1]
                        )
                    out.append(np.asarray(positions))
                else:
                    # list of scalars selects on the first level, keeping all
                    # levels (pandas .loc[list] on a MultiIndex)
                    out.append(np.asarray(lab.get_locs([keys])))
                continue
            if is_list_like(loc) and not isinstance(loc, (np.ndarray, pandas.Index)):
                try:
                    loc = np.asarray(list(loc), dtype=lab.dtype)
                except (TypeError, ValueError):
                    loc = np.asarray(list(loc), dtype=object)
            positions = lab.get_indexer_for(loc)
            missing = positions == -1
            if missing.any():
                raise KeyError(
                    f"{list(np.asarray(loc)[missing])} not in index"
                )
            out.append(positions)
        return out

    def _scalar_label_positions(self, axis: int, loc: Any) -> Any:
        """Positions of one scalar label via ``Index.get_loc`` (handles
        duplicate labels and partial-string datetime keys)."""
        lab = self.get_axis(axis)
        try:
            pos = lab.get_loc(loc)
        except TypeError:
            raise KeyError(loc)
        if isinstance(pos, slice):
            n = len(lab)
            return pandas.RangeIndex(
                (pos.start or 0) + (n if (pos.start or 0) < 0 else 0),
                pos.stop + (n if pos.stop < 0 else 0),
                pos.step or 1,
            )
        if isinstance(pos, np.ndarray):
            return np.flatnonzero(pos) if pos.dtype == bool else np.asarray(pos)
        return np.array([pos], dtype=np.int64)

    def take_2d_labels(self, index: Any, columns: Any) -> "BaseQueryCompiler":
        row_lookup, col_lookup = self.get_positions_from_labels(index, columns)
        return self.take_2d_positional(
            None if isinstance(row_lookup, slice) else row_lookup,
            None if isinstance(col_lookup, slice) else col_lookup,
        )

    def lookup(self, row_labels: Any, col_labels: Any) -> np.ndarray:
        """Label-pair fancy indexing (the removed ``DataFrame.lookup``)."""
        ErrorMessage.default_to_pandas("`lookup`")
        df = self.to_pandas()
        rows = df.index.get_indexer_for(row_labels)
        cols = df.columns.get_indexer_for(col_labels)
        return df.to_numpy()[rows, cols]

    def setitem_bool(self, row_loc: Any, col_loc: Any, item: Any) -> "BaseQueryCompiler":
        """Set a scalar where a boolean row mask holds for one column."""

        def setter(df: pandas.DataFrame, row_loc: Any, col_loc: Any, item: Any) -> pandas.DataFrame:
            df = df.copy()
            mask = (
                row_loc.squeeze(axis=1)
                if isinstance(row_loc, pandas.DataFrame)
                else row_loc
            )
            df.loc[mask, col_loc] = item
            return df

        return DataFrameDefault.register(setter, fn_name="setitem_bool")(
            self, row_loc=try_cast_to_pandas(row_loc), col_loc=col_loc, item=item
        )

    def rowwise_query(self, expr: str, **kwargs: Any) -> "BaseQueryCompiler":
        """Row-wise ``df.query``; concrete compilers implement the fast path."""
        raise NotImplementedError(
            "Row-wise query execution is not implemented for this backend"
        )

    def apply_on_series(self, func: Any, *args: Any, **kwargs: Any) -> "BaseQueryCompiler":
        assert self.is_series_like()
        return SeriesDefault.register(pandas.Series.apply)(
            self, func=func, *args, **kwargs
        )

    def series_view(self, dtype: Any = None, **kwargs: Any) -> "BaseQueryCompiler":
        """Reinterpret the underlying buffer with a new dtype (the removed
        ``Series.view``; kept for reference name parity)."""

        def view_fn(s: pandas.Series, dtype: Any) -> pandas.Series:
            return pandas.Series(
                s.to_numpy().view(dtype), index=s.index, name=s.name
            )

        return SeriesDefault.register(view_fn, fn_name="series_view")(
            self, dtype=dtype
        )

    def groupby_dtypes(
        self,
        by: Any,
        axis: int = 0,
        groupby_kwargs: Optional[dict] = None,
        agg_args: tuple = (),
        agg_kwargs: Optional[dict] = None,
        drop: bool = False,
    ) -> "BaseQueryCompiler":
        return self.groupby_agg(
            by,
            lambda grp: grp.dtypes,
            axis=axis,
            groupby_kwargs=groupby_kwargs,
            agg_args=agg_args,
            agg_kwargs=agg_kwargs,
            drop=drop,
        )

    def first(self, offset: Any) -> "BaseQueryCompiler":
        """Initial ``offset`` window of a time-indexed frame (the removed
        ``DataFrame.first``; kept for reference name parity)."""

        def first_fn(df: pandas.DataFrame, offset: Any) -> pandas.DataFrame:
            if df.empty:
                return df
            off = pandas.tseries.frequencies.to_offset(offset)
            end = df.index[0] + off
            # Day counted as fixed-width here, matching the legacy behavior
            # (it was a Tick when DataFrame.first existed)
            is_tick = isinstance(off, pandas.tseries.offsets.Tick) or isinstance(
                off, pandas.tseries.offsets.Day
            )
            if is_tick and end in df.index:
                return df.iloc[: df.index.searchsorted(end, side="left")]
            return df.loc[:end]

        return DataFrameDefault.register(first_fn, fn_name="first")(self, offset)

    def last(self, offset: Any) -> "BaseQueryCompiler":
        """Final ``offset`` window of a time-indexed frame (the removed
        ``DataFrame.last``; kept for reference name parity)."""

        def last_fn(df: pandas.DataFrame, offset: Any) -> pandas.DataFrame:
            if df.empty:
                return df
            off = pandas.tseries.frequencies.to_offset(offset)
            start = df.index[-1] - off
            is_tick = isinstance(off, pandas.tseries.offsets.Tick) or isinstance(
                off, pandas.tseries.offsets.Day
            )
            if is_tick and start in df.index:
                return df.iloc[df.index.searchsorted(start, side="right"):]
            return df.loc[start:]

        return DataFrameDefault.register(last_fn, fn_name="last")(self, offset)

    # --- frame metadata-cache introspection (reference: query_compiler.py
    # frame_has_*_cache family; lazy executions report pending metadata) ---

    def frame_has_index_cache(self) -> bool:
        return True

    def frame_has_columns_cache(self) -> bool:
        return True

    def frame_has_dtypes_cache(self) -> bool:
        return True

    def frame_has_materialized_index(self) -> bool:
        return True

    def frame_has_materialized_columns(self) -> bool:
        return True

    def frame_has_materialized_dtypes(self) -> bool:
        return True

    def set_frame_index_cache(self, index: Any) -> None:
        self.index = index

    def set_frame_columns_cache(self, columns: Any) -> None:
        self.columns = columns

    def set_frame_dtypes_cache(self, dtypes: Any) -> None:
        """Lazy-dtype executions adopt an externally-known dtype cache."""

    # --- numpy protocol hooks  ---

    def do_array_ufunc_implementation(
        self, frame: Any, ufunc: Any, method: str, *inputs: Any, **kwargs: Any
    ) -> Any:
        """Backend hook for ``__array_ufunc__`` on API objects: apply the
        ufunc against materialized pandas inputs and re-wrap."""
        cast_inputs = try_cast_to_pandas(inputs, squeeze=True)
        result = getattr(ufunc, method)(*cast_inputs, **kwargs)
        if isinstance(result, (pandas.DataFrame, pandas.Series)):
            if isinstance(result, pandas.Series):
                name = result.name if result.name is not None else MODIN_UNNAMED_SERIES_LABEL
                qc = self.from_pandas(result.to_frame(name))
                qc._shape_hint = "column"
            else:
                qc = self.from_pandas(result)
            return qc
        return result

    def do_array_function_implementation(
        self, frame: Any, func: Any, types: tuple, args: tuple, kwargs: dict
    ) -> Any:
        """Backend hook for ``__array_function__`` (NEP-18) on API objects."""
        cast_args = try_cast_to_pandas(args, squeeze=True)
        cast_kwargs = try_cast_to_pandas(kwargs, squeeze=True)
        result = func(*cast_args, **cast_kwargs)
        if isinstance(result, pandas.Series):
            name = result.name if result.name is not None else MODIN_UNNAMED_SERIES_LABEL
            qc = self.from_pandas(result.to_frame(name))
            qc._shape_hint = "column"
            return qc
        if isinstance(result, pandas.DataFrame):
            return self.from_pandas(result)
        return result

    def is_monotonic_increasing(self) -> bool:
        return SeriesDefault.register(pandas.Series.is_monotonic_increasing)(self)

    def is_monotonic_decreasing(self) -> bool:
        return SeriesDefault.register(pandas.Series.is_monotonic_decreasing)(self)

    def first_valid_index(self) -> Any:
        return DataFrameDefault.register(pandas.DataFrame.first_valid_index)(self)

    def last_valid_index(self) -> Any:
        return DataFrameDefault.register(pandas.DataFrame.last_valid_index)(self)

    def has_multiindex(self, axis: int = 0) -> bool:
        return isinstance(self.index if axis == 0 else self.columns, pandas.MultiIndex)

    # ------------------------------------------------------------------ #
    # Groupby (single generic entry point; string-kernel fast paths live in
    # concrete compilers)
    # ------------------------------------------------------------------ #

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
    ) -> "BaseQueryCompiler":
        df = self.to_pandas()
        if series_groupby and selection is None:
            df = df.squeeze(axis=1)
        pandas_by = try_cast_to_pandas(by, squeeze=True)
        groupby_kwargs = dict(groupby_kwargs or {})
        agg_kwargs = dict(agg_kwargs or {})
        ErrorMessage.default_to_pandas("`groupby_agg`")
        grp = df.groupby(by=pandas_by, **groupby_kwargs)
        if selection is not None:
            grp = grp[selection]
        if callable(agg_func):
            result = agg_func(grp, *agg_args, **agg_kwargs)
        elif isinstance(agg_func, str):
            result = getattr(grp, agg_func)(*agg_args, **agg_kwargs)
        else:
            result = grp.agg(agg_func, *agg_args, **agg_kwargs)
        was_series = isinstance(result, pandas.Series)
        if was_series:
            name = result.name if result.name is not None else MODIN_UNNAMED_SERIES_LABEL
            result = result.to_frame(name)
        qc = self.from_pandas(result)
        if was_series:
            qc._shape_hint = "column"
        return qc

    def groupby_transform(
        self,
        by: Any,
        agg_func: Any,
        groupby_kwargs: Optional[dict] = None,
        drop: bool = False,
        series_groupby: bool = False,
        selection: Any = None,
    ) -> "BaseQueryCompiler":
        """Row-shaped groupby transform (``grp.transform(func)``)."""
        transformer = lambda grp: grp.transform(agg_func)  # noqa: E731
        transformer._row_shaped_groupby = True
        return self.groupby_agg(
            by,
            transformer,
            groupby_kwargs=groupby_kwargs,
            drop=drop,
            series_groupby=series_groupby,
            selection=selection,
        )

    # ------------------------------------------------------------------ #
    # Merge / join
    # ------------------------------------------------------------------ #

    def merge(self, right: "BaseQueryCompiler", **kwargs: Any) -> "BaseQueryCompiler":
        return BinaryDefault.register(pandas.DataFrame.merge)(self, right, **kwargs)

    def merge_asof(self, right: "BaseQueryCompiler", **kwargs: Any) -> "BaseQueryCompiler":
        return BinaryDefault.register(pandas.merge_asof, fn_name="merge_asof")(
            self, right, **kwargs
        )

    def join(self, right: Any, **kwargs: Any) -> "BaseQueryCompiler":
        if isinstance(right, BaseQueryCompiler):
            right = right.to_pandas()
        elif isinstance(right, (list, tuple)):
            right = [
                r.to_pandas() if isinstance(r, BaseQueryCompiler) else r for r in right
            ]
        return DataFrameDefault.register(pandas.DataFrame.join)(self, right, **kwargs)

    # ------------------------------------------------------------------ #
    # Misc ops with non-trivial arg handling
    # ------------------------------------------------------------------ #

    def fillna(self, **kwargs: Any) -> "BaseQueryCompiler":
        squeeze_self = kwargs.pop("squeeze_self", False)
        squeeze_value = kwargs.pop("squeeze_value", False)

        def fillna_fn(df: pandas.DataFrame, **kw: Any) -> Any:
            if squeeze_self:
                df = df.squeeze(axis=1)
            value = kw.get("value")
            if squeeze_value and isinstance(value, pandas.DataFrame):
                kw["value"] = value.squeeze(axis=1)
            return df.fillna(**kw)

        kwargs["value"] = try_cast_to_pandas(kwargs.get("value"))
        return DataFrameDefault.register(fillna_fn, fn_name="fillna")(self, **kwargs)

    def apply(
        self,
        func: Any,
        axis: int = 0,
        raw: bool = False,
        result_type: Any = None,
        args: tuple = (),
        **kwargs: Any,
    ) -> "BaseQueryCompiler":
        return DataFrameDefault.register(pandas.DataFrame.apply)(
            self, func=func, axis=axis, raw=raw, result_type=result_type,
            args=args, **kwargs,
        )

    def explode(self, column: Any, ignore_index: bool = False) -> "BaseQueryCompiler":
        return DataFrameDefault.register(pandas.DataFrame.explode)(
            self, column, ignore_index=ignore_index
        )

    def series_update(self, other: Any, **kwargs: Any) -> "BaseQueryCompiler":
        def update_fn(s: pandas.Series, other: Any) -> pandas.Series:
            s = s.copy()
            s.update(other.squeeze(axis=1) if isinstance(other, pandas.DataFrame) else other)
            return s

        return BinaryDefault.register(update_fn, squeeze_self=True, fn_name="series_update")(
            self, other
        )

    def df_update(self, other: Any, **kwargs: Any) -> "BaseQueryCompiler":
        def update_fn(df: pandas.DataFrame, other: Any, **kw: Any) -> pandas.DataFrame:
            df = df.copy()
            df.update(other, **kw)
            return df

        return BinaryDefault.register(update_fn, fn_name="df_update")(self, other, **kwargs)

    def clip(self, lower: Any, upper: Any, **kwargs: Any) -> "BaseQueryCompiler":
        lower = try_cast_to_pandas(lower, squeeze=True)
        upper = try_cast_to_pandas(upper, squeeze=True)
        return DataFrameDefault.register(pandas.DataFrame.clip)(
            self, lower, upper, **kwargs
        )

    def where(self, cond: Any, other: Any, **kwargs: Any) -> "BaseQueryCompiler":
        cond = try_cast_to_pandas(cond)
        other = try_cast_to_pandas(other)
        return DataFrameDefault.register(pandas.DataFrame.where)(
            self, cond, other, **kwargs
        )

    def get_dummies(self, columns: Any, **kwargs: Any) -> "BaseQueryCompiler":
        def get_dummies_fn(df: pandas.DataFrame, columns: Any, **kw: Any) -> pandas.DataFrame:
            return pandas.get_dummies(df, columns=columns, **kw)

        return DataFrameDefault.register(get_dummies_fn, fn_name="get_dummies")(
            self, columns, **kwargs
        )

    def searchsorted(self, **kwargs: Any) -> "BaseQueryCompiler":
        def searchsorted_fn(s: pandas.Series, **kw: Any) -> pandas.Series:
            return pandas.Series(s.searchsorted(**kw))

        return SeriesDefault.register(searchsorted_fn, fn_name="searchsorted")(self, **kwargs)

    def unique(self, **kwargs: Any) -> "BaseQueryCompiler":
        def unique_fn(s: pandas.Series, **kw: Any) -> pandas.Series:
            return pandas.Series(s.unique(**kw))

        return SeriesDefault.register(unique_fn, fn_name="unique")(self, **kwargs)

    def repeat(self, repeats: Any) -> "BaseQueryCompiler":
        return SeriesDefault.register(pandas.Series.repeat)(self, repeats=repeats)

    def isin(self, values: Any, ignore_indices: bool = False, **kwargs: Any) -> "BaseQueryCompiler":
        if isinstance(values, type(self)) and ignore_indices:
            values = values.to_pandas().squeeze(axis=1).tolist()
        else:
            values = try_cast_to_pandas(values, squeeze=True)
        return DataFrameDefault.register(pandas.DataFrame.isin)(self, values=values)

    def case_when(self, caselist: list) -> "BaseQueryCompiler":
        caselist = [
            tuple(
                data.to_pandas().squeeze(axis=1) if isinstance(data, type(self)) else data
                for data in case_tuple
            )
            for case_tuple in caselist
        ]
        return SeriesDefault.register(pandas.Series.case_when)(self, caselist=caselist)

    def compare(self, other: Any, **kwargs: Any) -> "BaseQueryCompiler":
        return BinaryDefault.register(pandas.DataFrame.compare)(self, other=other, **kwargs)

    def expanding_aggregate(self, axis, expanding_args, func, *args, **kwargs):
        return ExpandingDefault.register(
            pandas.core.window.expanding.Expanding.aggregate
        )(self, expanding_args, func, *args, **kwargs)

    # window generic
    def rolling_aggregate(self, fold_axis, rolling_kwargs, func, *args, **kwargs):
        return RollingDefault.register(
            pandas.core.window.rolling.Rolling.aggregate
        )(self, rolling_kwargs, func, *args, **kwargs)

    def groupby_window(
        self, by, kind, window_kwargs, agg_func, groupby_kwargs, agg_args,
        agg_kwargs, drop=False, selection=None, series_groupby=False,
    ):
        """Windowed aggregation over groups: ``grp.<kind>(**kw).<agg>()``
        for kind in rolling/expanding/ewm (reference modin/pandas/window.py
        RollingGroupby; one generic seam here since all three window
        families share the groupby shape)."""
        df = self.to_pandas()
        if series_groupby and selection is None:
            df = df.squeeze(axis=1)
        pandas_by = try_cast_to_pandas(by, squeeze=True)
        ErrorMessage.default_to_pandas(f"`GroupBy.{kind}.{agg_func}`")
        grp = df.groupby(by=pandas_by, **dict(groupby_kwargs or {}))
        if selection is not None:
            grp = grp[selection]
        win = getattr(grp, kind)(**window_kwargs)
        if isinstance(agg_func, str):
            result = getattr(win, agg_func)(*agg_args, **dict(agg_kwargs or {}))
        else:
            result = agg_func(win, *agg_args, **dict(agg_kwargs or {}))
        was_series = isinstance(result, pandas.Series)
        if was_series:
            name = result.name if result.name is not None else MODIN_UNNAMED_SERIES_LABEL
            result = result.to_frame(name)
        qc = self.from_pandas(result)
        if was_series:
            qc._shape_hint = "column"
        return qc

    def groupby_rolling(self, by, agg_func, axis, groupby_kwargs, rolling_kwargs, agg_args, agg_kwargs, drop=False, selection=None, series_groupby=False):
        return self.groupby_window(
            by, "rolling", rolling_kwargs, agg_func, groupby_kwargs,
            agg_args, agg_kwargs, drop=drop, selection=selection,
            series_groupby=series_groupby,
        )

    # ------------------------------------------------------------------ #
    # String free-function conversions (series-level)
    # ------------------------------------------------------------------ #

    def to_datetime(self, *args: Any, **kwargs: Any) -> "BaseQueryCompiler":
        return SeriesDefault.register(pandas.to_datetime, fn_name="to_datetime")(
            self, *args, **kwargs
        )

    def to_numeric(self, *args: Any, **kwargs: Any) -> "BaseQueryCompiler":
        return SeriesDefault.register(pandas.to_numeric, fn_name="to_numeric")(
            self, *args, **kwargs
        )

    def to_timedelta(self, *args: Any, **kwargs: Any) -> "BaseQueryCompiler":
        return SeriesDefault.register(pandas.to_timedelta, fn_name="to_timedelta")(
            self, *args, **kwargs
        )

    # dt extraction needing the index rather than values
    def dt_nanoseconds(self) -> "BaseQueryCompiler":
        return DateTimeDefault.register(property(lambda dt: dt.nanoseconds), fn_name="nanoseconds")(self)

    def unary_math(self, op_name: str) -> "BaseQueryCompiler":
        """Elementwise numpy-style math (sqrt/exp/log/...) over the frame."""
        ufunc = getattr(np, op_name)
        return DataFrameDefault.register(
            lambda df: pandas.DataFrame(
                ufunc(df.to_numpy()), index=df.index, columns=df.columns
            ),
            fn_name=op_name,
        )(self)

    def describe(self, percentiles: Any = None, include: Any = None, exclude: Any = None) -> "BaseQueryCompiler":
        return DataFrameDefault.register(pandas.DataFrame.describe)(
            self, percentiles=percentiles, include=include, exclude=exclude
        )

    def write_csv(self, **kwargs: Any) -> Any:
        """``to_csv`` through the CSV dispatcher's chunked writer."""
        from modin_tpu_torch.core.execution.dispatching.factories.dispatcher import (
            FactoryDispatcher,
        )

        return FactoryDispatcher.to_csv(self, **kwargs)

    # free any deferred results; used by tests
    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} shape_hint={self._shape_hint}>"


# ---------------------------------------------------------------------- #
# Programmatic defaults: the long tail of the ~460-method surface.
# Each entry becomes `BaseQueryCompiler.<name> = <Default>.register(<kernel>)`.
# Concrete compilers override the hot subset (see TorchQueryCompiler).
# ---------------------------------------------------------------------- #

def _register_defaults() -> None:
    binary_methods = [
        "add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv",
        "floordiv", "rfloordiv", "mod", "rmod", "pow", "rpow",
        "eq", "ne", "lt", "le", "gt", "ge",
        "__and__", "__or__", "__xor__", "__rand__", "__ror__", "__rxor__",
        # a Series' ``//`` and ``%`` against a Series (pandas' operators
        # fill a zero int divisor; its flex methods do not)
        "__floordiv__", "__rfloordiv__", "__mod__", "__rmod__",
    ]
    for qc_name in binary_methods:
        fn = getattr(pandas.DataFrame, qc_name, None)
        if fn is not None:
            setattr(BaseQueryCompiler, qc_name, BinaryDefault.register(fn))

    df_methods = {
        # reductions
        "sum": "sum", "prod": "prod", "count": "count", "mean": "mean",
        "median": "median", "std": "std", "var": "var", "sem": "sem",
        "skew": "skew", "kurt": "kurt", "min": "min", "max": "max",
        "any": "any", "all": "all", "idxmin": "idxmin", "idxmax": "idxmax",
        "nunique": "nunique", "memory_usage": "memory_usage",
        # maps
        "abs": "abs", "round": "round", "replace": "replace",
        "negative": "__neg__", "invert": "__invert__",
        "ffill": "ffill", "bfill": "bfill",
        "isna": "isna", "notna": "notna", "convert_dtypes": "convert_dtypes",
        "infer_objects": "infer_objects", "map": "map",
        # cumulative
        "cumsum": "cumsum", "cummax": "cummax", "cummin": "cummin",
        "cumprod": "cumprod",
        # reshaping / misc
        "astype": "astype", "diff": "diff", "shift": "shift", "rank": "rank",
        "quantile": "quantile", "nlargest": "nlargest", "nsmallest": "nsmallest",
        "duplicated": "duplicated", "drop_duplicates": "drop_duplicates",
        "stack": "stack", "unstack": "unstack", "melt": "melt",
        "pivot": "pivot", "corr": "corr", "cov": "cov",
        "mode": "mode", "dropna": "dropna", "eval": "eval",
        "query": "query", "sample": "sample", "asfreq": "asfreq",
        "interpolate": "interpolate", "kurtosis": "kurt",
        "truncate": "truncate", "droplevel": "droplevel",
        "swaplevel": "swaplevel", "reorder_levels": "reorder_levels",
        "to_period": "to_period", "to_timestamp": "to_timestamp",
        "tz_convert": "tz_convert", "tz_localize": "tz_localize",
        "pct_change": "pct_change", "at_time": "at_time",
        "between_time": "between_time",
        "add_prefix": "add_prefix", "add_suffix": "add_suffix",
    }
    for qc_name, pandas_name in df_methods.items():
        existing = getattr(BaseQueryCompiler, qc_name, None)
        if existing is None:
            fn = getattr(pandas.DataFrame, pandas_name, None)
            if fn is None:
                continue
            existing = DataFrameDefault.register(fn)
            setattr(BaseQueryCompiler, qc_name, existing)
        if (
            qc_name == pandas_name
            and not pandas_name.startswith("_")
            and getattr(existing, "_pandas_signature_default", False)
        ):
            # generated from the pandas callable itself -> signature-safe to
            # route the API fallback through the named QC method (dispatch
            # re-verifies the marker on the *resolved* method, so a backend
            # override with a normalized signature is never mis-bound)
            DATAFRAME_QC_ROUTES.setdefault(pandas_name, qc_name)

    # ops that must run against the squeezed Series
    BaseQueryCompiler.series_value_counts = SeriesDefault.register(
        pandas.Series.value_counts
    )
    BaseQueryCompiler.series_argsort = SeriesDefault.register(pandas.Series.argsort)
    BaseQueryCompiler.series_between = SeriesDefault.register(pandas.Series.between)
    BaseQueryCompiler.series_autocorr = SeriesDefault.register(pandas.Series.autocorr)
    BaseQueryCompiler.series_corr = SeriesDefault.register(pandas.Series.corr)
    BaseQueryCompiler.series_cov = SeriesDefault.register(pandas.Series.cov)
    BaseQueryCompiler.dot = BinaryDefault.register(pandas.DataFrame.dot)
    BaseQueryCompiler.series_dot = BinaryDefault.register(
        pandas.Series.dot, squeeze_self=True, fn_name="series_dot"
    )
    BaseQueryCompiler.align = BinaryDefault.register(pandas.DataFrame.align)
    BaseQueryCompiler.combine = BinaryDefault.register(pandas.DataFrame.combine)
    BaseQueryCompiler.combine_first = BinaryDefault.register(
        pandas.DataFrame.combine_first
    )

    # str accessor surface
    str_methods = [
        "capitalize", "casefold", "cat", "center", "contains", "count",
        "decode", "encode", "endswith", "extract", "extractall", "find",
        "findall", "fullmatch", "get", "get_dummies", "index", "join", "len",
        "ljust", "lower", "lstrip", "match", "normalize", "pad", "partition",
        "removeprefix", "removesuffix", "repeat", "replace", "rfind", "rindex",
        "rjust", "rpartition", "rsplit", "rstrip", "slice", "slice_replace",
        "split", "startswith", "strip", "swapcase", "title", "translate",
        "upper", "wrap", "zfill", "isalnum", "isalpha", "isdecimal", "isdigit",
        "islower", "isnumeric", "isspace", "istitle", "isupper",
    ]
    str_cls = pandas.core.strings.accessor.StringMethods
    for name in str_methods:
        target = getattr(str_cls, name, None)
        if target is None:
            continue
        setattr(BaseQueryCompiler, f"str_{name}", StrDefault.register(target, fn_name=name))
    BaseQueryCompiler.str___getitem__ = StrDefault.register(
        str_cls.__getitem__, fn_name="__getitem__"
    )

    # dt accessor surface: properties + methods
    dt_cls = pandas.core.indexes.accessors.CombinedDatetimelikeProperties
    dt_props = [
        "date", "time", "timetz", "year", "month", "day", "hour", "minute",
        "second", "microsecond", "nanosecond", "dayofweek", "day_of_week",
        "weekday", "dayofyear", "day_of_year", "quarter", "is_month_start",
        "is_month_end", "is_quarter_start", "is_quarter_end", "is_year_start",
        "is_year_end", "is_leap_year", "daysinmonth", "days_in_month", "tz",
        "freq", "unit", "days", "seconds", "microseconds", "nanoseconds",
        "components", "qyear", "start_time", "end_time",
    ]
    for name in dt_props:
        setattr(
            BaseQueryCompiler,
            f"dt_{name}",
            SeriesDefault.register(
                (lambda nm: (lambda s: getattr(s.dt, nm)))(name), fn_name=name
            ),
        )
    dt_methods = [
        "to_period", "to_pydatetime", "tz_localize", "tz_convert", "normalize",
        "strftime", "round", "floor", "ceil", "month_name", "day_name",
        "total_seconds", "to_pytimedelta", "asfreq", "isocalendar", "to_timestamp",
    ]
    for name in dt_methods:
        setattr(
            BaseQueryCompiler,
            f"dt_{name}",
            SeriesDefault.register(
                (lambda nm: (lambda s, *a, **k: getattr(s.dt, nm)(*a, **k)))(name),
                fn_name=name,
            ),
        )

    # cat accessor
    BaseQueryCompiler.cat_codes = SeriesDefault.register(
        lambda s: s.cat.codes, fn_name="codes"
    )
    for name in [
        "add_categories", "remove_categories", "remove_unused_categories",
        "rename_categories", "reorder_categories", "set_categories",
        "as_ordered", "as_unordered",
    ]:
        setattr(
            BaseQueryCompiler,
            f"cat_{name}",
            SeriesDefault.register(
                (lambda nm: (lambda s, *a, **k: getattr(s.cat, nm)(*a, **k)))(name),
                fn_name=name,
            ),
        )

    # rolling/expanding/resample aggregations
    for name in [
        "count", "sum", "mean", "median", "var", "std", "min", "max", "skew",
        "kurt", "sem", "quantile", "apply", "rank", "corr", "cov",
    ]:
        setattr(BaseQueryCompiler, f"rolling_{name}", RollingDefault.register(name))
        setattr(BaseQueryCompiler, f"expanding_{name}", ExpandingDefault.register(name))
    for name in ["mean", "sum", "var", "std", "corr", "cov", "aggregate"]:
        setattr(BaseQueryCompiler, f"ewm_{name}", EwmDefault.register(name))
    for name in [
        "count", "sum", "mean", "median", "var", "std", "min", "max", "sem",
        "first", "last", "ohlc", "prod", "size", "nunique", "quantile",
        "agg", "aggregate", "apply", "transform", "ffill", "bfill", "nearest",
        "asfreq", "interpolate",
    ]:
        setattr(BaseQueryCompiler, f"resample_{name}", ResampleDefault.register(name))

    # named groupby aggregations (used when api wants direct dispatch)
    for name in [
        "sum", "count", "size", "mean", "min", "max", "prod", "any", "all",
        "median", "std", "var", "sem", "skew", "nunique", "first", "last",
        "head", "tail", "ngroup", "cumsum", "cumprod", "cummax", "cummin",
        "cumcount", "rank", "shift", "diff", "pct_change", "quantile",
        "fillna", "ffill", "bfill", "idxmin", "idxmax", "corr", "cov",
        "value_counts", "ohlc", "sample", "nth", "unique",
        "get_group", "nlargest", "nsmallest", "take", "hist", "boxplot",
    ]:
        setattr(BaseQueryCompiler, f"groupby_{name}", GroupByDefault.register(name))

    _register_long_tail()
    _register_full_api_surface()


# Names the sweep must not route through the QC: data-exchange/iteration/
# accessor factories the API layer owns, writers, and methods whose QC
# counterpart has a normalized (non-pandas) signature.
_SWEEP_EXCLUDE = frozenset(
    [
        # accessor / lazy-handle factories (API constructs the handle)
        "groupby", "rolling", "expanding", "ewm", "resample", "plot", "hist",
        "boxplot", "style", "str", "dt", "cat", "sparse", "list", "struct",
        # iteration / identity / conversion the API layer owns
        "items", "iterrows", "itertuples", "keys", "bool", "info", "copy",
        "pipe", "pop", "squeeze", "transpose", "swapaxes", "set_flags",
        "__iter__",
        # explicit QC methods with normalized signatures (API wires these)
        "drop", "fillna", "insert", "merge", "join", "apply", "where", "mask",
        "clip", "isin", "sort_index", "sort_values", "reindex", "reset_index",
        "set_index", "describe", "explode", "update", "compare", "align",
        "combine", "combine_first", "dot", "get", "filter", "take", "xs",
        "reindex_like", "rename", "rename_axis", "set_axis", "agg",
        "aggregate", "applymap", "assign", "equals", "head", "tail", "nth",
        "first", "last", "abs",
    ]
)


def _register_full_api_surface() -> None:
    """Sweep the public pandas.DataFrame/Series surfaces: every remaining
    callable gets a named, generated QC default (``<name>`` for frame ops,
    ``series_<name>`` for series ops) plus a routing-table entry so the API
    fallback path dispatches through the QC by name (ref: the ~460-method
    surface of base/query_compiler.py:162)."""
    import functools as _functools
    import inspect as _inspect

    for name in dir(pandas.DataFrame):
        if name.startswith("_") or name in _SWEEP_EXCLUDE or name.startswith("to_"):
            continue
        raw = _inspect.getattr_static(pandas.DataFrame, name)
        if isinstance(raw, (property, _functools.cached_property)):
            continue
        attr = getattr(pandas.DataFrame, name, None)
        if not callable(attr) or isinstance(raw, (classmethod, staticmethod)):
            continue
        if name in DATAFRAME_QC_ROUTES:
            continue
        if getattr(BaseQueryCompiler, name, None) is None:
            setattr(BaseQueryCompiler, name, DataFrameDefault.register(attr))
            DATAFRAME_QC_ROUTES[name] = name
        # an existing explicit def with a custom signature is NOT routed

    for name in dir(pandas.Series):
        if name.startswith("_") or name in _SWEEP_EXCLUDE or name.startswith("to_"):
            continue
        raw = _inspect.getattr_static(pandas.Series, name)
        if isinstance(raw, property):
            continue
        attr = getattr(pandas.Series, name, None)
        if not callable(attr) or isinstance(raw, (classmethod, staticmethod)):
            continue
        qc_name = f"series_{name}"
        existing = getattr(BaseQueryCompiler, qc_name, None)
        if existing is None:
            setattr(
                BaseQueryCompiler,
                qc_name,
                SeriesDefault.register(attr, fn_name=qc_name),
            )
        SERIES_QC_ROUTES.setdefault(name, qc_name)

    # series routes for names covered by pre-existing series_* registrations
    # generated from the matching pandas.Series callable
    for name in ("value_counts", "between", "autocorr", "corr", "cov"):
        SERIES_QC_ROUTES.setdefault(name, f"series_{name}")


def _register_long_tail() -> None:
    """The rest of the reference QC surface (ref base/query_compiler.py:162):
    binary comparisons in Series form, reshape free functions, Arrow list/
    struct accessors, win_type rolling, and resample shape variants.  All
    default-to-pandas; concrete compilers may override any of them."""
    # Series-form binary comparisons (ref: series_eq..series_ge) + divmod
    for name in ("eq", "ne", "lt", "le", "gt", "ge"):
        setattr(
            BaseQueryCompiler,
            f"series_{name}",
            BinaryDefault.register(
                getattr(pandas.Series, name), squeeze_self=True, fn_name=f"series_{name}"
            ),
        )
    BaseQueryCompiler.divmod = BinaryDefault.register(
        pandas.Series.divmod, squeeze_self=True, fn_name="divmod"
    )
    BaseQueryCompiler.rdivmod = BinaryDefault.register(
        pandas.Series.rdivmod, squeeze_self=True, fn_name="rdivmod"
    )
    BaseQueryCompiler.equals = BinaryDefault.register(pandas.DataFrame.equals)
    BaseQueryCompiler.corrwith = BinaryDefault.register(pandas.DataFrame.corrwith)
    BaseQueryCompiler.mask = BinaryDefault.register(pandas.DataFrame.mask)
    BaseQueryCompiler.series_mask = BinaryDefault.register(
        pandas.Series.mask, squeeze_self=True, fn_name="series_mask"
    )

    # reshape / free-function surface applied against self
    BaseQueryCompiler.pivot_table = DataFrameDefault.register(
        pandas.DataFrame.pivot_table
    )
    BaseQueryCompiler.cut = SeriesDefault.register(
        lambda s, **kwargs: pandas.cut(s, **kwargs), fn_name="cut"
    )
    BaseQueryCompiler.qcut = SeriesDefault.register(
        lambda s, **kwargs: pandas.qcut(s, **kwargs), fn_name="qcut"
    )
    BaseQueryCompiler.merge_ordered = BinaryDefault.register(
        lambda df, right, **kwargs: pandas.merge_ordered(df, right, **kwargs),
        fn_name="merge_ordered",
    )
    BaseQueryCompiler.wide_to_long = DataFrameDefault.register(
        lambda df, **kwargs: pandas.wide_to_long(df, **kwargs), fn_name="wide_to_long"
    )
    BaseQueryCompiler.lreshape = DataFrameDefault.register(
        lambda df, groups, **kwargs: pandas.lreshape(df, groups, **kwargs),
        fn_name="lreshape",
    )

    # conversions / misc parity names
    BaseQueryCompiler.dataframe_to_dict = DataFrameDefault.register(
        pandas.DataFrame.to_dict, fn_name="dataframe_to_dict"
    )
    BaseQueryCompiler.series_to_dict = SeriesDefault.register(
        pandas.Series.to_dict, fn_name="series_to_dict"
    )
    BaseQueryCompiler.to_list = SeriesDefault.register(
        pandas.Series.to_list, fn_name="to_list"
    )
    BaseQueryCompiler.argsort = SeriesDefault.register(pandas.Series.argsort)
    BaseQueryCompiler.conj = DataFrameDefault.register(
        lambda df: pandas.DataFrame(
            np.conj(df.to_numpy()), index=df.index, columns=df.columns
        ),
        fn_name="conj",
    )
    BaseQueryCompiler.delitem = DataFrameDefault.register(
        lambda df, key: df.drop(columns=[key]), fn_name="delitem"
    )
    BaseQueryCompiler.sizeof = DataFrameDefault.register(
        lambda df: df.memory_usage(index=True, deep=True).sum(), fn_name="sizeof"
    )
    BaseQueryCompiler.quantile_for_single_value = DataFrameDefault.register(
        pandas.DataFrame.quantile, fn_name="quantile_for_single_value"
    )
    BaseQueryCompiler.quantile_for_list_of_values = DataFrameDefault.register(
        pandas.DataFrame.quantile, fn_name="quantile_for_list_of_values"
    )

    # dt unit conversion (pandas 2+ non-nano support)
    BaseQueryCompiler.dt_as_unit = SeriesDefault.register(
        lambda s, *a, **k: s.dt.as_unit(*a, **k), fn_name="as_unit"
    )

    # Arrow-backed list/struct accessors (ref: list_*, struct_*)
    BaseQueryCompiler.list_flatten = ListDefault.register("flatten", fn_name="flatten")
    BaseQueryCompiler.list_len = ListDefault.register("len", fn_name="len")
    BaseQueryCompiler.list___getitem__ = ListDefault.register(
        "__getitem__", fn_name="__getitem__"
    )
    BaseQueryCompiler.struct_explode = StructDefault.register(
        "explode", fn_name="explode"
    )
    BaseQueryCompiler.struct_field = StructDefault.register("field", fn_name="field")
    BaseQueryCompiler.struct_dtypes = StructDefault.register(
        lambda acc: acc.dtypes, fn_name="dtypes"
    )

    # win_type rolling (pandas Window object; kwargs carry win_type)
    for name in ("mean", "sum", "var", "std"):
        setattr(BaseQueryCompiler, f"window_{name}", RollingDefault.register(name))

    # resample shape variants (ref: resample_agg_df/ser, app_df/ser, ohlc_*)
    BaseQueryCompiler.resample_agg_df = ResampleDefault.register(
        "aggregate", fn_name="agg_df"
    )
    BaseQueryCompiler.resample_agg_ser = ResampleDefault.register(
        "aggregate", squeeze_self=True, fn_name="agg_ser"
    )
    BaseQueryCompiler.resample_app_df = ResampleDefault.register(
        "apply", fn_name="app_df"
    )
    BaseQueryCompiler.resample_app_ser = ResampleDefault.register(
        "apply", squeeze_self=True, fn_name="app_ser"
    )
    BaseQueryCompiler.resample_ohlc_df = ResampleDefault.register(
        "ohlc", fn_name="ohlc_df"
    )
    BaseQueryCompiler.resample_ohlc_ser = ResampleDefault.register(
        "ohlc", squeeze_self=True, fn_name="ohlc_ser"
    )
    BaseQueryCompiler.resample_fillna = ResampleDefault.register(
        lambda r, method, limit=None: r.nearest(limit=limit)
        if method == "nearest"
        else getattr(r, method)(limit=limit),
        fn_name="fillna",
    )
    BaseQueryCompiler.resample_get_group = ResampleDefault.register(
        "get_group", fn_name="get_group"
    )
    BaseQueryCompiler.resample_pipe = ResampleDefault.register("pipe", fn_name="pipe")


if pandas is not None:
    _register_defaults()
