"""``Resampler`` — the lazy resample handle of the torch port.

The port's counterpart of ``modin_tpu/pandas/resample.py``: the frame or
Series and the resample arguments; each aggregation calls the compiler's
``resample_<agg>``, which runs ``RESAMPLE_DEVICE_OPS`` on the device (time
buckets from pandas' own binner, the groupby segment aggregations) and
defaults the rest to pandas, counted.
"""

from __future__ import annotations

from typing import Any

from modin_tpu_torch.logging import ClassLogger
from modin_tpu_torch.utils import MODIN_UNNAMED_SERIES_LABEL


class Resampler(ClassLogger, modin_layer="PANDAS-API"):
    def __init__(self, dataframe: Any, rule: Any, **kwargs: Any) -> None:
        self._dataframe = dataframe
        self.resample_kwargs = {"rule": rule, **kwargs}

    @property
    def _query_compiler(self):
        return self._dataframe._query_compiler

    def _agg(self, name: str, *args: Any, **kwargs: Any):
        qc_method = getattr(self._query_compiler, f"resample_{name}")
        return self._wrap(qc_method(_clean_kwargs(self.resample_kwargs), *args, **kwargs))

    def _wrap(self, qc: Any):
        if not hasattr(qc, "to_pandas"):
            return qc
        # size() of a frame is a Series too (the compiler marks it); a
        # Series source can still give a frame (ohlc)
        if (self._dataframe.ndim == 1 or qc._shape_hint == "column") and qc.get_axis_len(1) <= 1:
            from modin_tpu_torch.pandas.series import Series

            qc._shape_hint = "column"
            return Series(query_compiler=qc)
        from modin_tpu_torch.pandas.dataframe import DataFrame

        return DataFrame(query_compiler=qc)

    def __getitem__(self, key: Any):
        return Resampler(self._dataframe[key], **self.resample_kwargs)

    def _pandas_resampler_call(self, fn: Any):
        kwargs = _clean_kwargs(self.resample_kwargs)
        return self._dataframe._default_to_pandas(lambda obj: fn(obj.resample(**kwargs)))

    @property
    def groups(self):
        return self._pandas_resampler_call(lambda r: r.groups)

    @property
    def indices(self):
        return self._pandas_resampler_call(lambda r: r.indices)

    def get_group(self, name: Any):
        return self._pandas_resampler_call(lambda r: r.get_group(name))

    def size(self, *args: Any, **kwargs: Any):
        """A Series whatever the source's shape or path."""
        from modin_tpu_torch.pandas.dataframe import DataFrame

        out = self._agg("size", *args, **kwargs)
        if isinstance(out, DataFrame) and len(out.columns) == 1:
            label = out.columns[0]
            series = out[label]
            return series.rename(None) if label == MODIN_UNNAMED_SERIES_LABEL else series
        return out


def _clean_kwargs(kwargs: dict) -> dict:
    return {k: v for k, v in kwargs.items() if v is not None or k == "rule"}


def _make_resample(name: str):
    def method(self, *args: Any, **kwargs: Any):
        return self._agg(name, *args, **kwargs)

    method.__name__ = name
    return method


for _name in [
    "count", "sum", "mean", "median", "var", "std", "min", "max", "sem",
    "first", "last", "ohlc", "prod", "nunique", "quantile",
    "agg", "aggregate", "apply", "transform", "ffill", "bfill", "nearest",
    "asfreq", "interpolate",
]:
    setattr(Resampler, _name, _make_resample(_name))
