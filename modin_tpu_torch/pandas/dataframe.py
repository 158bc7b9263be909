"""``DataFrame`` of the torch port (the subset the ported slices drive).

The port's counterpart of ``modin_tpu/pandas/dataframe.py``: construction
from anything pandas takes, column and row selection (``__getitem__`` with
labels, boolean masks and slices; column attributes), ``__setitem__`` and
``insert``, the arithmetic/comparison/logical surface and reductions of
:class:`BasePandasDataset`, ``groupby``, ``sort_values``, ``merge`` and
``query``.  Methods the JAX package has and the port does not yet have are
absent.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import pandas
from pandas.api.types import is_bool_dtype, is_integer, is_list_like

from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
    TorchQueryCompiler,
)
from modin_tpu_torch.pandas.base import BasePandasDataset
from modin_tpu_torch.utils import hashable


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

    def _update_inplace(self, new_query_compiler: TorchQueryCompiler) -> None:
        self._query_compiler = new_query_compiler

    def _create_or_update_from_compiler(self, new_query_compiler: TorchQueryCompiler, inplace: bool) -> Any:
        if inplace:
            self._update_inplace(new_query_compiler)
            return None
        return self._wrap(new_query_compiler)

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

    # ------------------------------------------------------------------ #
    # Item access
    # ------------------------------------------------------------------ #

    def __getitem__(self, key: Any) -> Any:
        from modin_tpu_torch.pandas.series import Series

        qc = self._query_compiler
        if isinstance(key, (Series, pandas.Series, np.ndarray)) and is_bool_dtype(key.dtype):
            if isinstance(key, np.ndarray):
                return DataFrame(query_compiler=qc.getitem_array(key))
            return DataFrame(query_compiler=qc.getitem_array(self._to_compiler(key)))
        if isinstance(key, slice):
            if (is_integer(key.start) or key.start is None) and (
                is_integer(key.stop) or key.stop is None
            ) and (is_integer(key.step) or key.step is None):
                return DataFrame(query_compiler=qc.row_slice(key.start, key.stop, key.step))
            # label slices are a later slice of the port
            return self._wrap(qc._default_to_pandas(lambda df: df[key]))
        if hashable(key) and not isinstance(key, tuple):
            column = qc.getitem_column_array([key])
            column._shape_hint = "column"
            return self._wrap(column)
        if is_list_like(key) and not isinstance(key, (BasePandasDataset, pandas.DataFrame)):
            key_list = list(key)
            if key_list and np.asarray(key_list).dtype == bool:
                return DataFrame(query_compiler=qc.getitem_array(np.asarray(key_list)))
            return DataFrame(query_compiler=qc.getitem_column_array(key_list))
        return self._wrap(qc._default_to_pandas(lambda df, k: df[k], self._to_compiler(key)))

    def __getattr__(self, key: str) -> Any:
        # called only when normal lookup fails: a column label as attribute
        try:
            qc = object.__getattribute__(self, "_query_compiler")
        except AttributeError:
            raise AttributeError(key) from None
        if not key.startswith("_") and key in qc.get_columns():
            return self[key]
        raise AttributeError(f"'DataFrame' object has no attribute '{key}'")

    def __setitem__(self, key: Any, value: Any) -> None:
        value = self._to_compiler(value)
        if hashable(key) and not isinstance(key, tuple):
            self._update_inplace(self._query_compiler.setitem(0, key, value))
            return

        # boolean-mask rows, several columns: pandas
        def setter(df: pandas.DataFrame, v: Any) -> pandas.DataFrame:
            df = df.copy()
            df[key] = v
            return df

        self._update_inplace(self._query_compiler._default_to_pandas(setter, value))

    def insert(self, loc: int, column: Any, value: Any, allow_duplicates: bool = False) -> None:
        if not allow_duplicates and column in self.columns:
            raise ValueError(f"cannot insert {column}, already exists")
        ncols = len(self.columns)
        if not isinstance(loc, (int, np.integer)) or not 0 <= loc <= ncols:
            raise IndexError(f"index {loc} is out of bounds for axis 0 with size {ncols}")
        self._update_inplace(
            self._query_compiler.insert(int(loc), column, self._to_compiler(value))
        )

    # ------------------------------------------------------------------ #
    # Relational operations
    # ------------------------------------------------------------------ #

    def sort_values(
        self,
        by: Any,
        *,
        axis: Any = 0,
        ascending: Any = True,
        inplace: bool = False,
        kind: str = "quicksort",
        na_position: str = "last",
        ignore_index: bool = False,
        key: Any = None,
    ) -> Any:
        by = list(by) if is_list_like(by) else [by]
        if isinstance(ascending, (list, tuple)):
            ascending = list(ascending)
        kwargs = dict(kind=kind, na_position=na_position, ignore_index=ignore_index, key=key)
        qc = self._query_compiler
        if axis in (0, "index"):
            # labels that name no column (index levels, typos) go to pandas,
            # which sorts by them or raises its KeyError
            new_qc = qc.sort_rows_by_column_values(by, ascending=ascending, **kwargs)
        else:
            new_qc = qc._default_to_pandas(
                lambda df: df.sort_values(by, axis=axis, ascending=ascending, **kwargs)
            )
        return self._create_or_update_from_compiler(new_qc, inplace)

    def merge(
        self,
        right: Any,
        how: str = "inner",
        on: Any = None,
        left_on: Any = None,
        right_on: Any = None,
        left_index: bool = False,
        right_index: bool = False,
        sort: bool = False,
        suffixes: Any = ("_x", "_y"),
        copy: Any = None,
        indicator: bool = False,
        validate: Any = None,
    ) -> "DataFrame":
        from modin_tpu_torch.pandas.series import Series

        if isinstance(right, (Series, pandas.Series)):
            if right.name is None:
                raise ValueError("Cannot merge a Series without a name")
            right_qc = self._to_compiler(right)
            right = DataFrame(query_compiler=TorchQueryCompiler(right_qc._modin_frame))
        elif isinstance(right, pandas.DataFrame):
            right = DataFrame(right)
        if not isinstance(right, DataFrame):
            raise TypeError(
                f"Can only merge Series or DataFrame objects, a {type(right)} was passed"
            )
        return DataFrame(
            query_compiler=self._query_compiler.merge(
                right._query_compiler,
                how=how,
                on=on,
                left_on=left_on,
                right_on=right_on,
                left_index=left_index,
                right_index=right_index,
                sort=sort,
                suffixes=suffixes,
                indicator=indicator,
                validate=validate,
            )
        )

    def query(self, expr: str, *, inplace: bool = False, **kwargs: Any) -> Any:
        from modin_tpu_torch.core.computation.eval import caller_namespace

        ns = (
            caller_namespace(int(kwargs.get("level", 0) or 0))
            if "@" in expr and "local_dict" not in kwargs
            else None
        )
        new_qc = None
        if not kwargs:
            # the compiler runs simple row-wise expressions on the device and
            # raises NotImplementedError for everything else
            try:
                new_qc = self._query_compiler.rowwise_query(expr, local_dict=ns)
            except NotImplementedError:
                new_qc = None
        if new_qc is None:
            if ns is not None:
                # pandas runs deep inside this package, out of reach of its
                # frame walk: hand it the caller's namespace
                kwargs["local_dict"] = ns
                kwargs.pop("level", None)
            new_qc = self._query_compiler._default_to_pandas(
                lambda df: df.query(expr, **kwargs)
            )
        return self._create_or_update_from_compiler(new_qc, inplace)

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
