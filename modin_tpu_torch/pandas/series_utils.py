"""``.str`` / ``.dt`` / ``.cat`` accessors for Series.

The port's counterpart of ``modin_tpu/pandas/series_utils.py``: each
accessor method dispatches to the matching ``str_*``/``dt_*``/``cat_*`` query
compiler method (pandas defaults in the port's base compiler); results that
are element-wise maps come back as Series.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import pandas

from modin_tpu_torch.logging import ClassLogger


class _AccessorBase(ClassLogger, modin_layer="PANDAS-API"):
    _prefix = ""

    def __init__(self, series: Any) -> None:
        self._series = series
        self._query_compiler = series._query_compiler

    def _dispatch(self, name: str, *args: Any, **kwargs: Any) -> Any:
        from modin_tpu_torch.pandas.series import Series

        qc_method = getattr(self._query_compiler, f"{self._prefix}{name}")
        result = qc_method(*args, **kwargs)
        if hasattr(result, "to_pandas"):
            result._shape_hint = "column"
            return Series(query_compiler=result)
        return result

    def _fallback(self, name: str, *args: Any, **kwargs: Any) -> Any:
        accessor = self._prefix.rstrip("_")
        return self._series._default_to_pandas(
            lambda s: getattr(getattr(s, accessor), name)(*args, **kwargs)
            if callable(getattr(getattr(s, accessor), name))
            else getattr(getattr(s, accessor), name)
        )


def _make_accessor_method(name: str):
    def method(self, *args: Any, **kwargs: Any):
        return self._dispatch(name, *args, **kwargs)

    method.__name__ = name
    return method


def _make_accessor_property(name: str):
    def getter(self):
        return self._dispatch(name)

    getter.__name__ = name
    return property(getter)


class StringMethods(_AccessorBase):
    _prefix = "str_"

    def __getitem__(self, key: Any):
        return self._dispatch("__getitem__", key)

    def cat(self, others: Any = None, sep: Any = None, na_rep: Any = None, join: str = "left"):
        from modin_tpu_torch.utils import try_cast_to_pandas

        others = try_cast_to_pandas(others, squeeze=True)
        return self._dispatch("cat", others=others, sep=sep, na_rep=na_rep, join=join)


for _name in [
    "capitalize", "casefold", "center", "contains", "count", "decode",
    "encode", "endswith", "extract", "extractall", "find", "findall",
    "fullmatch", "get", "get_dummies", "index", "join", "len", "ljust",
    "lower", "lstrip", "match", "normalize", "pad", "partition",
    "removeprefix", "removesuffix", "repeat", "replace", "rfind", "rindex",
    "rjust", "rpartition", "rsplit", "rstrip", "slice", "slice_replace",
    "split", "startswith", "strip", "swapcase", "title", "translate",
    "upper", "wrap", "zfill", "isalnum", "isalpha", "isdecimal", "isdigit",
    "islower", "isnumeric", "isspace", "istitle", "isupper",
]:
    setattr(StringMethods, _name, _make_accessor_method(_name))


class DatetimeProperties(_AccessorBase):
    _prefix = "dt_"


for _name in [
    "date", "time", "timetz", "year", "month", "day", "hour", "minute",
    "second", "microsecond", "nanosecond", "dayofweek", "day_of_week",
    "weekday", "dayofyear", "day_of_year", "quarter", "is_month_start",
    "is_month_end", "is_quarter_start", "is_quarter_end", "is_year_start",
    "is_year_end", "is_leap_year", "daysinmonth", "days_in_month",
    "days", "seconds", "microseconds", "nanoseconds", "components",
    "start_time", "end_time",
]:
    setattr(DatetimeProperties, _name, _make_accessor_property(_name))

for _name in [
    "to_period", "to_pydatetime", "tz_localize", "tz_convert", "normalize",
    "strftime", "round", "floor", "ceil", "month_name", "day_name",
    "total_seconds", "to_pytimedelta", "asfreq", "isocalendar", "to_timestamp",
]:
    setattr(DatetimeProperties, _name, _make_accessor_method(_name))


def _dt_tz_getter(self):
    return self._series._to_pandas().dt.tz


DatetimeProperties.tz = property(_dt_tz_getter)
DatetimeProperties.freq = property(lambda self: self._series._to_pandas().dt.freq)
DatetimeProperties.unit = property(lambda self: self._series._to_pandas().dt.unit)


class CategoryMethods(_AccessorBase):
    _prefix = "cat_"

    @property
    def categories(self):
        return self._series.dtype.categories

    @property
    def ordered(self) -> bool:
        return self._series.dtype.ordered

    @property
    def codes(self):
        return self._dispatch("codes")


for _name in [
    "add_categories", "remove_categories", "remove_unused_categories",
    "rename_categories", "reorder_categories", "set_categories",
    "as_ordered", "as_unordered",
]:
    setattr(CategoryMethods, _name, _make_accessor_method(_name))

DatetimeProperties.as_unit = _make_accessor_method("as_unit")


class ListAccessor(_AccessorBase):
    """``.list`` accessor for ArrowDtype list columns (ref series_utils.py ListAccessor)."""

    _prefix = "list_"

    def __getitem__(self, key: Any):
        return self._dispatch("__getitem__", key)

    def flatten(self):
        return self._dispatch("flatten")

    def len(self):
        return self._dispatch("len")


class StructAccessor(_AccessorBase):
    """``.struct`` accessor for ArrowDtype struct columns (ref series_utils.py StructAccessor)."""

    _prefix = "struct_"

    @property
    def dtypes(self):
        return self._dispatch("dtypes")

    def explode(self):
        result = self._dispatch("explode")
        from modin_tpu_torch.pandas.dataframe import DataFrame

        if hasattr(result, "_query_compiler"):
            qc = result._query_compiler
            qc._shape_hint = None
            return DataFrame(query_compiler=qc)
        return result

    def field(self, name_or_index: Any):
        return self._dispatch("field", name_or_index)
