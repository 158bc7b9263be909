"""``DataFrame`` of the torch port (the subset the main path drives).

The port's counterpart of ``modin_tpu/pandas/dataframe.py``: construction
from anything pandas takes, column selection, the arithmetic/comparison
surface and reductions of :class:`BasePandasDataset`, and ``groupby``.
Methods the JAX package has and the port does not yet have are absent.
"""

from __future__ import annotations

from typing import Any, Optional

import pandas

from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
    TorchQueryCompiler,
)
from modin_tpu_torch.pandas.base import BasePandasDataset


class DataFrame(BasePandasDataset):
    def __init__(
        self,
        data: Any = None,
        index: Any = None,
        columns: Any = None,
        dtype: Any = None,
        copy: Optional[bool] = None,
        query_compiler: Optional[TorchQueryCompiler] = None,
    ) -> None:
        if query_compiler is None:
            if isinstance(data, DataFrame) and index is None and columns is None and dtype is None:
                query_compiler = data._query_compiler
            else:
                if isinstance(data, BasePandasDataset):
                    data = data._to_pandas()
                df = pandas.DataFrame(data, index=index, columns=columns, dtype=dtype, copy=copy)
                query_compiler = TorchQueryCompiler.from_pandas(df)
        self._query_compiler = query_compiler

    @property
    def columns(self) -> pandas.Index:
        cols = self._query_compiler.get_columns()
        return cols if isinstance(cols, pandas.Index) else pandas.Index(list(cols))

    @property
    def shape(self) -> tuple:
        return len(self), len(self.columns)

    @property
    def dtypes(self) -> pandas.Series:
        frame = self._query_compiler._modin_frame
        return pandas.Series(
            [c.pandas_dtype for c in frame._columns], index=self.columns
        )

    def __getitem__(self, key: Any) -> Any:
        if isinstance(key, list):
            return DataFrame(query_compiler=self._query_compiler.getitem_column_array(key))
        qc = self._query_compiler.getitem_column_array([key])
        qc._shape_hint = "column"
        return self._wrap(qc)

    def groupby(
        self,
        by: Any = None,
        level: Any = None,
        as_index: bool = True,
        sort: bool = True,
        group_keys: bool = True,
        observed: Any = True,
        dropna: bool = True,
    ):
        from modin_tpu_torch.pandas.groupby import DataFrameGroupBy

        if by is None and level is None:
            raise TypeError("You have to supply one of 'by' and 'level'")
        return DataFrameGroupBy(
            self,
            by=by,
            level=level,
            as_index=as_index,
            sort=sort,
            group_keys=group_keys,
            observed=observed,
            dropna=dropna,
        )
