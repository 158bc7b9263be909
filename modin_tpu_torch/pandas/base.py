"""Shared surface of the port's ``DataFrame`` and ``Series``.

The port's counterpart of ``modin_tpu/pandas/base.py``, cut to the main
path: arithmetic and comparison methods with their dunders, ``abs``,
negation, and the ``sum``/``mean``/``count``/``min``/``max`` reductions.
Every method hands its work to the query compiler.
"""

from __future__ import annotations

from typing import Any

import pandas

from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
    TorchQueryCompiler,
)

_ARITH_OPS = (
    "add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv",
    "floordiv", "rfloordiv", "mod", "rmod",
)
_CMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge")
_DUNDERS = {
    "__add__": "add", "__radd__": "radd", "__sub__": "sub", "__rsub__": "rsub",
    "__mul__": "mul", "__rmul__": "rmul", "__truediv__": "truediv",
    "__rtruediv__": "rtruediv", "__floordiv__": "floordiv",
    "__rfloordiv__": "rfloordiv", "__mod__": "mod", "__rmod__": "rmod",
    "__eq__": "eq", "__ne__": "ne", "__lt__": "lt", "__le__": "le",
    "__gt__": "gt", "__ge__": "ge",
}


class ModinAPI:
    """``obj.modin``: conversions specific to this package."""

    def __init__(self, data: Any) -> None:
        self._data = data

    def to_pandas(self) -> Any:
        """Materialize to a plain pandas object on the host."""
        return self._data._to_pandas()


class BasePandasDataset:
    """Holds a :class:`TorchQueryCompiler` and wraps its results."""

    _query_compiler: TorchQueryCompiler
    # axis the binary methods default to (pandas: "columns" for frames)
    _default_binary_axis: Any = "columns"

    @staticmethod
    def _wrap(result: Any) -> Any:
        if not isinstance(result, TorchQueryCompiler):
            return result
        if result._shape_hint == "column":
            from modin_tpu_torch.pandas.series import Series

            return Series(query_compiler=result)
        from modin_tpu_torch.pandas.dataframe import DataFrame

        return DataFrame(query_compiler=result)

    @staticmethod
    def _to_compiler(other: Any) -> Any:
        if isinstance(other, BasePandasDataset):
            return other._query_compiler
        if isinstance(other, pandas.DataFrame):
            return TorchQueryCompiler.from_pandas(other)
        if isinstance(other, pandas.Series):
            qc = TorchQueryCompiler.from_pandas(other.to_frame())
            qc._shape_hint = "column"
            return qc
        return other

    def _binary_op(self, op: str, other: Any, **kwargs: Any) -> Any:
        qc_method = getattr(self._query_compiler, op)
        return self._wrap(qc_method(self._to_compiler(other), **kwargs))

    @property
    def modin(self) -> ModinAPI:
        return ModinAPI(self)

    def _to_pandas(self) -> Any:
        return self._query_compiler.to_pandas_object()

    def __len__(self) -> int:
        return len(self._query_compiler)

    @property
    def index(self) -> pandas.Index:
        return self._query_compiler.get_index()

    def __repr__(self) -> str:
        return repr(self._to_pandas())

    def __abs__(self) -> Any:
        return self.abs()

    def abs(self) -> Any:
        return self._wrap(self._query_compiler.abs())

    def __neg__(self) -> Any:
        return self._wrap(self._query_compiler.negative())

    def _reduce(self, op: str, **kwargs: Any) -> Any:
        return self._wrap(getattr(self._query_compiler, op)(**kwargs))

    def sum(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False, min_count: int = 0) -> Any:
        return self._reduce(
            "sum", axis=axis, skipna=skipna, numeric_only=numeric_only, min_count=min_count
        )

    def mean(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False) -> Any:
        return self._reduce("mean", axis=axis, skipna=skipna, numeric_only=numeric_only)

    def min(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False) -> Any:
        return self._reduce("min", axis=axis, skipna=skipna, numeric_only=numeric_only)

    def max(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False) -> Any:
        return self._reduce("max", axis=axis, skipna=skipna, numeric_only=numeric_only)

    def count(self, axis: Any = 0, numeric_only: bool = False) -> Any:
        return self._reduce("count", axis=axis, numeric_only=numeric_only)


def _make_arith(op: str):
    def method(self, other: Any, axis: Any = None, level: Any = None, fill_value: Any = None):
        if axis is None:
            axis = self._default_binary_axis
        return self._binary_op(op, other, axis=axis, level=level, fill_value=fill_value)

    method.__name__ = op
    return method


def _make_cmp(op: str):
    def method(self, other: Any, axis: Any = None, level: Any = None):
        if axis is None:
            axis = self._default_binary_axis
        return self._binary_op(op, other, axis=axis, level=level)

    method.__name__ = op
    return method


def _make_dunder(name: str, op: str):
    def method(self, other: Any):
        return getattr(self, op)(other)

    method.__name__ = name
    return method


for _op in _ARITH_OPS:
    setattr(BasePandasDataset, _op, _make_arith(_op))
for _op in _CMP_OPS:
    setattr(BasePandasDataset, _op, _make_cmp(_op))
for _name, _op in _DUNDERS.items():
    setattr(BasePandasDataset, _name, _make_dunder(_name, _op))
