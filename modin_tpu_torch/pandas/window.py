"""``Rolling``/``Expanding``/``Ewm`` window objects of the torch port, and the
windows of a groupby.

The port's counterpart of ``modin_tpu/pandas/window.py``: a lazy handle
(the frame or Series, the window's arguments) whose aggregations call the
compiler's ``rolling_<agg>``/``expanding_<agg>``/``ewm_<agg>``.  The
compiler runs sum/mean/count/min/max/var/std/sem of rolling and expanding
windows and ewm mean/sum/var/std/cov/corr on the device and defaults the
rest to pandas, counted.  The windows of a groupby (``_GroupByWindow``)
default to pandas as a whole, as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import pandas

_ROLLING_AGGS = [
    "count", "sum", "mean", "median", "var", "std", "min", "max", "skew",
    "kurt", "sem", "quantile", "rank",
]
_EXPANDING_AGGS = _ROLLING_AGGS + ["apply", "corr", "cov"]


def _other_arg(other: Any) -> Any:
    """``other`` of cov/corr as the compiler takes it: the port's frame or
    Series as its compiler (the device pair path reads it; the pandas
    default converts it back)."""
    from modin_tpu_torch.pandas.base import BasePandasDataset

    return other._query_compiler if isinstance(other, BasePandasDataset) else other


class _Window:
    """What the three window kinds share: the handle and the wrapping of a
    compiler result as the port's DataFrame or Series."""

    _kind = ""

    def __init__(self, dataframe: Any, window_args: Any) -> None:
        self._dataframe = dataframe
        self._window_args = window_args

    @property
    def _query_compiler(self):
        return self._dataframe._query_compiler

    def _wrap(self, qc: Any) -> Any:
        if not hasattr(qc, "to_pandas"):
            return qc
        if self._dataframe.ndim == 1:
            from modin_tpu_torch.pandas.series import Series

            qc._shape_hint = "column"
            return Series(query_compiler=qc)
        from modin_tpu_torch.pandas.dataframe import DataFrame

        return DataFrame(query_compiler=qc)

    def _agg(self, name: str, *args: Any, **kwargs: Any) -> Any:
        method = getattr(self._query_compiler, f"{self._kind}_{name}")
        return self._wrap(method(self._window_args, *args, **kwargs))


def _add_aggs(cls: type, names: list) -> None:
    for name in names:
        if name in cls.__dict__:
            continue

        def make(name: str):
            def method(self, *args: Any, **kwargs: Any):
                return self._agg(name, *args, **kwargs)

            method.__name__ = name
            return method

        setattr(cls, name, make(name))


class Rolling(_Window):
    _kind = "rolling"

    def __init__(self, dataframe: Any, **rolling_kwargs: Any) -> None:
        super().__init__(dataframe, rolling_kwargs)

    @property
    def rolling_kwargs(self) -> dict:
        return self._window_args

    def aggregate(self, func: Any, *args: Any, **kwargs: Any):
        return self._wrap(
            self._query_compiler.rolling_aggregate(0, self._window_args, func, *args, **kwargs)
        )

    agg = aggregate

    def apply(self, func: Any, raw: bool = False, engine: Any = None, engine_kwargs: Any = None,
              args: Any = None, kwargs: Any = None):
        return self._agg("apply", func=func, raw=raw, args=args or (), kwargs=kwargs or {})

    def corr(self, other: Any = None, pairwise: Any = None, ddof: int = 1, **kwargs: Any):
        from modin_tpu_torch.utils import try_cast_to_pandas

        return self._agg("corr", other=try_cast_to_pandas(other, squeeze=True), pairwise=pairwise,
                         ddof=ddof, **kwargs)

    def cov(self, other: Any = None, pairwise: Any = None, ddof: int = 1, **kwargs: Any):
        from modin_tpu_torch.utils import try_cast_to_pandas

        return self._agg("cov", other=try_cast_to_pandas(other, squeeze=True), pairwise=pairwise,
                         ddof=ddof, **kwargs)


_add_aggs(Rolling, _ROLLING_AGGS)


class Expanding(_Window):
    _kind = "expanding"

    def __init__(self, dataframe: Any, min_periods: int = 1, method: str = "single") -> None:
        super().__init__(dataframe, [min_periods, method])

    @property
    def expanding_args(self) -> list:
        return self._window_args

    def aggregate(self, func: Any, *args: Any, **kwargs: Any):
        return self._wrap(
            self._query_compiler.expanding_aggregate(0, self._window_args, func, *args, **kwargs)
        )

    agg = aggregate

    def corr(self, other: Any = None, pairwise: Any = None, ddof: int = 1, numeric_only: bool = False):
        from modin_tpu_torch.utils import try_cast_to_pandas

        return self._agg("corr", other=try_cast_to_pandas(other, squeeze=True), pairwise=pairwise,
                         ddof=ddof, numeric_only=numeric_only)

    def cov(self, other: Any = None, pairwise: Any = None, ddof: int = 1, numeric_only: bool = False):
        from modin_tpu_torch.utils import try_cast_to_pandas

        return self._agg("cov", other=try_cast_to_pandas(other, squeeze=True), pairwise=pairwise,
                         ddof=ddof, numeric_only=numeric_only)


_add_aggs(Expanding, _EXPANDING_AGGS)


class Ewm(_Window):
    """Exponentially weighted windows: ``ewm_<agg>`` of the compiler."""

    _kind = "ewm"

    def __init__(self, dataframe: Any, **ewm_kwargs: Any) -> None:
        super().__init__(dataframe, ewm_kwargs)

    @property
    def ewm_kwargs(self) -> dict:
        return self._window_args

    def mean(self, numeric_only: bool = False, engine: Any = None, engine_kwargs: Any = None):
        return self._agg("mean", numeric_only=numeric_only, engine=engine, engine_kwargs=engine_kwargs)

    def sum(self, numeric_only: bool = False, engine: Any = None, engine_kwargs: Any = None):
        return self._agg("sum", numeric_only=numeric_only, engine=engine, engine_kwargs=engine_kwargs)

    def var(self, bias: bool = False, numeric_only: bool = False):
        return self._agg("var", bias=bias, numeric_only=numeric_only)

    def std(self, bias: bool = False, numeric_only: bool = False):
        return self._agg("std", bias=bias, numeric_only=numeric_only)

    def corr(self, other: Any = None, pairwise: Any = None, numeric_only: bool = False):
        return self._agg("corr", other=_other_arg(other), pairwise=pairwise, numeric_only=numeric_only)

    def cov(self, other: Any = None, pairwise: Any = None, bias: bool = False, numeric_only: bool = False):
        return self._agg("cov", other=_other_arg(other), pairwise=pairwise, bias=bias,
                         numeric_only=numeric_only)

    def aggregate(self, func: Any, *args: Any, **kwargs: Any):
        return self._agg("aggregate", func, *args, **kwargs)

    agg = aggregate

    def __getattr__(self, name: str):
        """What pandas' ewm object has beyond the above (``online``, ...)
        defaults to pandas when called; other names raise as in pandas."""
        if name.startswith("_") or not hasattr(pandas.core.window.ewm.ExponentialMovingWindow, name):
            raise AttributeError(name)
        df, ewm_kwargs = self._dataframe, self._window_args

        def fallback(*args: Any, **kwargs: Any):
            return df._default_to_pandas(lambda obj: getattr(obj.ewm(**ewm_kwargs), name)(*args, **kwargs))

        fallback.__name__ = name
        return fallback


class _GroupByWindow:
    """``df.groupby(...).rolling/expanding/ewm(...)``: every aggregation goes
    to the compiler's ``groupby_window``, which defaults to pandas (counted)
    as the JAX package's does.  The names are pandas' groupby window
    class's; others raise as in pandas."""

    _kind = ""
    _pandas_cls: Any = None

    def __init__(self, groupby: Any, **window_kwargs: Any) -> None:
        self._groupby = groupby
        self._window_kwargs = window_kwargs

    def _agg(self, name: str, *args: Any, **kwargs: Any):
        gb = self._groupby
        by, drop = gb._resolve_by()
        qc = gb._df._query_compiler.groupby_window(
            by=by,
            kind=self._kind,
            window_kwargs=self._window_kwargs,
            agg_func=name,
            groupby_kwargs=gb._kwargs,
            agg_args=args,
            agg_kwargs=kwargs,
            drop=drop,
            selection=gb._selection,
            series_groupby=gb._series_groupby,
        )
        from modin_tpu_torch.pandas.dataframe import DataFrame
        from modin_tpu_torch.pandas.series import Series

        if getattr(qc, "_shape_hint", None) == "column":
            return Series(query_compiler=qc)
        return DataFrame(query_compiler=qc)

    def __getattr__(self, name: str):
        if name.startswith("_") or not callable(getattr(self._pandas_cls, name, None)):
            raise AttributeError(name)

        def method(*args: Any, **kwargs: Any):
            return self._agg(name, *args, **kwargs)

        method.__name__ = name
        return method


class GroupByRolling(_GroupByWindow):
    _kind = "rolling"
    _pandas_cls = pandas.core.window.rolling.RollingGroupby


class GroupByExpanding(_GroupByWindow):
    _kind = "expanding"
    _pandas_cls = pandas.core.window.expanding.ExpandingGroupby


class GroupByEwm(_GroupByWindow):
    _kind = "ewm"
    _pandas_cls = pandas.core.window.ewm.ExponentialMovingWindowGroupby
