"""``NativeQueryCompiler`` — one in-process pandas frame, no device.

The port's counterpart of ``modin_tpu/core/storage_formats/native/
query_compiler.py``, without the backend-switching cost model (the caster is
a later slice of the port).  The torch compiler hands it results that the
columnar device store cannot hold well: a transpose of more than
``TorchQueryCompiler._TRANSPOSE_WIDE_COLS`` rows has as many columns, and one
device tensor per column is not an option at 1e5 and more.
"""

from __future__ import annotations

from typing import Any, Optional

import pandas

from modin_tpu_torch.core.storage_formats.base.query_compiler import (
    BaseQueryCompiler,
)
from modin_tpu_torch.utils import MODIN_UNNAMED_SERIES_LABEL


class NativeQueryCompiler(BaseQueryCompiler):
    """A query compiler holding one plain ``pandas.DataFrame`` in-process."""

    def __init__(self, pandas_frame: pandas.DataFrame, shape_hint: Optional[str] = None):
        if not isinstance(pandas_frame, pandas.DataFrame):
            raise TypeError(f"NativeQueryCompiler holds a pandas.DataFrame, got {type(pandas_frame)}")
        self._pandas_frame = pandas_frame
        self._shape_hint = shape_hint
        if shape_hint is None and len(pandas_frame.columns) == 1:
            if pandas_frame.columns[0] == MODIN_UNNAMED_SERIES_LABEL:
                self._shape_hint = "column"

    # -- data exchange ------------------------------------------------- #

    @classmethod
    def from_pandas(cls, df: pandas.DataFrame, data_cls: Any = None) -> "NativeQueryCompiler":
        return cls(df)

    def to_pandas(self) -> pandas.DataFrame:
        return self._pandas_frame.copy()

    def copy(self) -> "NativeQueryCompiler":
        return type(self)(self._pandas_frame, self._shape_hint)

    def free(self) -> None:
        self._pandas_frame = None

    # -- metadata ------------------------------------------------------ #

    def get_index(self) -> pandas.Index:
        return self._pandas_frame.index

    def get_columns(self) -> pandas.Index:
        return self._pandas_frame.columns

    def _set_index(self, idx: pandas.Index) -> None:
        self._pandas_frame = self._pandas_frame.set_axis(idx, axis=0)

    def _set_columns(self, cols: pandas.Index) -> None:
        self._pandas_frame = self._pandas_frame.set_axis(cols, axis=1)

    index = property(get_index, _set_index)
    columns = property(get_columns, _set_columns)

    @property
    def dtypes(self) -> pandas.Series:
        return self._pandas_frame.dtypes

    def get_axis_len(self, axis: int) -> int:
        return self._pandas_frame.shape[1 if axis else 0]
