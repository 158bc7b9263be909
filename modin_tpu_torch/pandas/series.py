"""``Series`` of the torch port: one column of a frame, or a result.

The port's counterpart of ``modin_tpu/pandas/series.py``, cut to the main
path.  A Series is a query compiler of one column with ``_shape_hint ==
"column"``; an unnamed Series carries the column label ``__reduced__``.
"""

from __future__ import annotations

from typing import Any, Optional

import pandas

from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
    TorchQueryCompiler,
)
from modin_tpu_torch.pandas.base import BasePandasDataset
from modin_tpu_torch.utils import MODIN_UNNAMED_SERIES_LABEL


class Series(BasePandasDataset):
    _default_binary_axis = 0

    def __init__(
        self,
        data: Any = None,
        index: Any = None,
        dtype: Any = None,
        name: Any = None,
        copy: Optional[bool] = None,
        query_compiler: Optional[TorchQueryCompiler] = None,
    ) -> None:
        if query_compiler is None:
            if isinstance(data, BasePandasDataset):
                data = data._to_pandas()
            s = pandas.Series(data, index=index, dtype=dtype, name=name, copy=copy)
            label = s.name if s.name is not None else MODIN_UNNAMED_SERIES_LABEL
            query_compiler = TorchQueryCompiler.from_pandas(s.to_frame(label))
        query_compiler._shape_hint = "column"
        self._query_compiler = query_compiler

    @property
    def name(self) -> Any:
        label = list(self._query_compiler.get_columns())[0]
        return None if label == MODIN_UNNAMED_SERIES_LABEL else label

    @property
    def dtype(self) -> Any:
        return self._query_compiler._modin_frame.get_column(0).pandas_dtype

    @property
    def shape(self) -> tuple:
        return (len(self),)

    def _reduce(self, op: str, **kwargs: Any) -> Any:
        result = getattr(self._query_compiler, op)(**kwargs)
        if isinstance(result, TorchQueryCompiler):
            # one value, labelled by the Series' name
            return result.to_pandas().iloc[0, 0]
        return result

    def to_numpy(self) -> Any:
        return self._to_pandas().to_numpy()
