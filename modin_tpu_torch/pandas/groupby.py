"""``DataFrameGroupBy``/``SeriesGroupBy`` of the torch port — lazy groupby
objects.

The port's counterpart of ``modin_tpu/pandas/groupby.py``: the
aggregations (``sum`` ... ``quantile``, ``agg`` with a list or a dict of
names, ``describe``), the row-shaped ops (``cumsum``/``cumprod``/
``cummax``/``cummin``, ``cumcount``, ``ngroup``, ``shift``, ``diff``,
``transform``), the windows of a groupby (``rolling``/``expanding``/
``ewm``, which default to pandas) and column selection (``gb["col"]``,
``gb[["a", "b"]]``).  The object holds (frame, by, groupby kwargs,
selection) and hands each call to ``TorchQueryCompiler.groupby_agg`` (or
``groupby_transform``); the compiler runs what it can on the device and
defaults the rest to pandas, counted.  Any other method of pandas' groupby
objects goes the same way by name, so that its call counts one default and
its frame or Series comes back as the port's.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import pandas
from pandas.api.types import is_list_like

from modin_tpu_torch.logging import ClassLogger
from modin_tpu_torch.pandas.base import BasePandasDataset
from modin_tpu_torch.utils import hashable


class DataFrameGroupBy(ClassLogger, modin_layer="PANDAS-API"):
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
        return self._wrap(result_qc)

    @staticmethod
    def _wrap(result_qc: Any):
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

    def prod(self, numeric_only: bool = False, min_count: int = 0):
        return self._groupby_agg("prod", {"numeric_only": numeric_only, "min_count": min_count})

    def median(self, numeric_only: bool = False):
        return self._groupby_agg("median", {"numeric_only": numeric_only})

    def std(self, ddof: int = 1, engine: Any = None, engine_kwargs: Any = None, numeric_only: bool = False):
        return self._groupby_agg("std", {"ddof": ddof, "numeric_only": numeric_only})

    def var(self, ddof: int = 1, engine: Any = None, engine_kwargs: Any = None, numeric_only: bool = False):
        return self._groupby_agg("var", {"ddof": ddof, "numeric_only": numeric_only})

    def sem(self, ddof: int = 1, numeric_only: bool = False):
        return self._groupby_agg("sem", {"ddof": ddof, "numeric_only": numeric_only})

    def skew(self, skipna: bool = True, numeric_only: bool = False):
        return self._groupby_agg("skew", {"skipna": skipna, "numeric_only": numeric_only})

    def first(self, numeric_only: bool = False, min_count: int = -1, skipna: bool = True):
        return self._groupby_agg(
            "first", {"numeric_only": numeric_only, "min_count": min_count, "skipna": skipna}
        )

    def last(self, numeric_only: bool = False, min_count: int = -1, skipna: bool = True):
        return self._groupby_agg(
            "last", {"numeric_only": numeric_only, "min_count": min_count, "skipna": skipna}
        )

    def any(self, skipna: bool = True):
        return self._groupby_agg("any", {"skipna": skipna})

    def all(self, skipna: bool = True):
        return self._groupby_agg("all", {"skipna": skipna})

    def nunique(self, dropna: bool = True):
        return self._groupby_agg("nunique", {"dropna": dropna})

    def quantile(self, q: Any = 0.5, interpolation: str = "linear", numeric_only: bool = False):
        return self._groupby_agg(
            "quantile", {"q": q, "interpolation": interpolation, "numeric_only": numeric_only}
        )

    def cumsum(self, numeric_only: bool = False, *args: Any, **kwargs: Any):
        return self._groupby_agg("cumsum", {"numeric_only": numeric_only, **kwargs}, args)

    def cumprod(self, numeric_only: bool = False, *args: Any, **kwargs: Any):
        return self._groupby_agg("cumprod", {"numeric_only": numeric_only, **kwargs}, args)

    def cummax(self, numeric_only: bool = False, **kwargs: Any):
        return self._groupby_agg("cummax", {"numeric_only": numeric_only, **kwargs})

    def cummin(self, numeric_only: bool = False, **kwargs: Any):
        return self._groupby_agg("cummin", {"numeric_only": numeric_only, **kwargs})

    def cumcount(self, ascending: bool = True):
        return self._groupby_agg("cumcount", {"ascending": ascending})

    def ngroup(self, ascending: bool = True):
        return self._groupby_agg("ngroup", {"ascending": ascending})

    def shift(self, periods: Any = 1, freq: Any = None, fill_value: Any = None, suffix: Any = None):
        kwargs = {"periods": periods, "freq": freq}
        if fill_value is not None:
            kwargs["fill_value"] = fill_value
        if suffix is not None:
            kwargs["suffix"] = suffix
        return self._groupby_agg("shift", kwargs)

    def diff(self, periods: int = 1):
        return self._groupby_agg("diff", {"periods": periods})

    def describe(self, percentiles: Any = None, include: Any = None, exclude: Any = None):
        return self._groupby_agg(
            "describe", {"percentiles": percentiles, "include": include, "exclude": exclude}
        )

    def agg(self, func: Any = None, *args: Any, engine: Any = None, engine_kwargs: Any = None, **kwargs: Any):
        """A name, a list of names or a dict of names go to the compiler as
        they are (its device paths read them); named aggregation and
        callables go to pandas."""
        if func is None and kwargs:
            return self._groupby_agg(lambda grp, **kw: grp.agg(**kw), kwargs)
        names = isinstance(func, str) or (
            isinstance(func, list) and all(isinstance(f, str) for f in func)
        ) or (isinstance(func, dict) and all(isinstance(f, str) for f in func.values()))
        if names and not args and not kwargs:
            return self._groupby_agg(func)
        from modin_tpu_torch.utils import try_cast_to_pandas

        pandas_func = try_cast_to_pandas(func)
        return self._groupby_agg(lambda grp, *a, **kw: grp.agg(pandas_func, *a, **kw), kwargs, args)

    aggregate = agg

    def transform(self, func: Any, *args: Any, engine: Any = None, engine_kwargs: Any = None, **kwargs: Any):
        """A reduction's name runs on the device (the aggregate gathered
        back to the rows); anything else goes to pandas."""
        if isinstance(func, str) and not args and not kwargs:
            by, drop = self._resolve_by()
            return self._wrap(self._df._query_compiler.groupby_transform(
                by=by,
                agg_func=func,
                groupby_kwargs=dict(self._kwargs),
                drop=drop,
                series_groupby=self._series_groupby,
                selection=self._selection,
            ))
        return self._groupby_agg(lambda grp, *a, **kw: grp.transform(func, *a, **kw), kwargs, args)

    def rolling(self, window: Any = None, min_periods: Any = None, center: bool = False, win_type: Any = None,
                on: Any = None, closed: Any = None, method: str = "single"):
        from modin_tpu_torch.pandas.window import GroupByRolling

        return GroupByRolling(
            self, window=window, min_periods=min_periods, center=center, win_type=win_type,
            on=on, closed=closed, method=method,
        )

    def expanding(self, min_periods: int = 1, method: str = "single"):
        from modin_tpu_torch.pandas.window import GroupByExpanding

        return GroupByExpanding(self, min_periods=min_periods, method=method)

    def ewm(self, com: Any = None, span: Any = None, halflife: Any = None, alpha: Any = None,
            min_periods: Any = 0, adjust: bool = True, ignore_na: bool = False, times: Any = None,
            method: str = "single"):
        from modin_tpu_torch.pandas.window import GroupByEwm
        from modin_tpu_torch.utils import try_cast_to_pandas

        return GroupByEwm(
            self, com=com, span=span, halflife=halflife, alpha=alpha, min_periods=min_periods,
            adjust=adjust, ignore_na=ignore_na, times=try_cast_to_pandas(times, squeeze=True),
            method=method,
        )

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

    def size(self):
        """Group sizes, named after the selected column (or the grouped
        Series) where the result is a Series, as pandas names them."""
        result = super().size()
        if self._kwargs["as_index"]:
            result.name = self._selection if self._selection is not None else self._df.name
        return result

    def unique(self):
        return self._groupby_agg("unique")

    def nlargest(self, n: int = 5, keep: str = "first"):
        return self._groupby_agg("nlargest", {"n": n, "keep": keep})

    def nsmallest(self, n: int = 5, keep: str = "first"):
        return self._groupby_agg("nsmallest", {"n": n, "keep": keep})
