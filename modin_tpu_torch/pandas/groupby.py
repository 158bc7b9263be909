"""``DataFrameGroupBy``/``SeriesGroupBy`` of the torch port — lazy groupby
objects.

The port's counterpart of ``modin_tpu/pandas/groupby.py``, cut to
``count``/``size``/``sum``/``mean``/``min``/``max`` and column selection
(``gb["col"]``, ``gb[["a", "b"]]``).  The object holds (frame, by, groupby
kwargs, selection) and hands each aggregation to
``TorchQueryCompiler.groupby_agg``; the compiler runs what it can on the
device and defaults the rest to pandas, counted.  Any other method of
pandas' groupby objects goes the same way by name, so that its call counts
one default and its frame or Series comes back as the port's.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import pandas
from pandas.api.types import is_list_like

from modin_tpu_torch.pandas.base import BasePandasDataset
from modin_tpu_torch.utils import hashable


class DataFrameGroupBy:
    def __init__(
        self,
        df: Any,
        by: Any = None,
        level: Any = None,
        as_index: bool = True,
        sort: bool = True,
        group_keys: bool = True,
        observed: Any = True,
        dropna: bool = True,
        selection: Any = None,
    ) -> None:
        self._df = df
        self._by = by
        self._selection = selection
        self._kwargs = {
            "level": level,
            "as_index": as_index,
            "sort": sort,
            "group_keys": group_keys,
            "observed": observed,
            "dropna": dropna,
        }

    def _resolve_by(self):
        """(by for the compiler, drop): column labels stay labels (drop=True),
        a Series becomes its query compiler."""
        by = self._by
        if isinstance(by, BasePandasDataset):
            return by._query_compiler, False
        columns = self._df.columns if self._df.ndim == 2 else ()
        if hashable(by) and not isinstance(by, tuple):
            if by in columns:
                return [by], True
            return by, False
        if is_list_like(by) and not isinstance(by, np.ndarray):
            by_list = list(by)
            if all(
                hashable(o) and not isinstance(o, BasePandasDataset) and o in columns
                for o in by_list
            ):
                return by_list, True
            return [
                o._query_compiler if isinstance(o, BasePandasDataset) else o
                for o in by_list
            ], False
        return by, False

    _series_groupby = False

    def _groupby_agg(self, agg_func: str, agg_kwargs: Optional[dict] = None, agg_args: tuple = ()):
        by, drop = self._resolve_by()
        result_qc = self._df._query_compiler.groupby_agg(
            by=by,
            agg_func=agg_func,
            axis=0,
            groupby_kwargs=dict(self._kwargs),
            agg_args=agg_args,
            agg_kwargs=dict(agg_kwargs or {}),
            drop=drop,
            series_groupby=self._series_groupby,
            selection=self._selection,
        )
        from modin_tpu_torch.core.storage_formats.base.query_compiler import BaseQueryCompiler
        from modin_tpu_torch.pandas.dataframe import DataFrame
        from modin_tpu_torch.pandas.series import Series

        if not isinstance(result_qc, BaseQueryCompiler):
            return result_qc  # a scalar or dict of pandas' method
        if result_qc._shape_hint == "column":
            return Series(query_compiler=result_qc)
        return DataFrame(query_compiler=result_qc)

    def sum(self, numeric_only: bool = False, min_count: int = 0):
        return self._groupby_agg("sum", {"numeric_only": numeric_only, "min_count": min_count})

    def count(self):
        return self._groupby_agg("count")

    def mean(self, numeric_only: bool = False):
        return self._groupby_agg("mean", {"numeric_only": numeric_only})

    def min(self, numeric_only: bool = False, min_count: int = -1):
        return self._groupby_agg("min", {"numeric_only": numeric_only, "min_count": min_count})

    def max(self, numeric_only: bool = False, min_count: int = -1):
        return self._groupby_agg("max", {"numeric_only": numeric_only, "min_count": min_count})

    def size(self):
        result = self._groupby_agg("size")
        if self._kwargs["as_index"]:
            # size is a Series in pandas when as_index=True
            from modin_tpu_torch.pandas.series import Series

            qc = result._query_compiler
            qc._shape_hint = "column"
            return Series(query_compiler=qc)
        return result

    def __getitem__(self, key: Any):
        kwargs = {k: v for k, v in self._kwargs.items() if k != "level"}
        if is_list_like(key) and not isinstance(key, str):
            return DataFrameGroupBy(
                self._df, by=self._by, level=self._kwargs["level"], selection=list(key), **kwargs
            )
        return SeriesGroupBy(
            self._df, by=self._by, level=self._kwargs["level"], selection=key, **kwargs
        )

    def _to_pandas_groupby(self):
        from modin_tpu_torch.utils import try_cast_to_pandas

        grp = self._df._to_pandas().groupby(
            by=try_cast_to_pandas(self._by, squeeze=True), **self._kwargs
        )
        return grp if self._selection is None else grp[self._selection]

    def __getattr__(self, name: str):
        """A column (``gb.col``), or any other member of pandas' groupby
        object: a method runs through the compiler's ``groupby_agg`` when
        called (one counted default), a property on pandas' object."""
        if name.startswith("_"):
            raise AttributeError(name)
        if self._df.ndim == 2 and self._selection is None and name in self._df.columns:
            return self[name]
        pandas_cls = (
            pandas.core.groupby.SeriesGroupBy
            if self._series_groupby
            else pandas.core.groupby.DataFrameGroupBy
        )
        member = getattr(pandas_cls, name, None)
        if member is None:
            raise AttributeError(name)
        if callable(member):
            def method(*args: Any, **kwargs: Any):
                return self._groupby_agg(name, kwargs, args)

            method.__name__ = name
            return method
        from modin_tpu_torch.error_message import ErrorMessage

        ErrorMessage.default_to_pandas(f"`GroupBy.{name}`")
        return getattr(self._to_pandas_groupby(), name)


class SeriesGroupBy(DataFrameGroupBy):
    """A groupby whose values are one column: ``df.groupby(k)["col"]`` or
    ``series.groupby(key)``; its aggregations are Series."""

    _series_groupby = True
