"""``DataFrame`` of the torch port: the pandas.DataFrame-compatible frame.

The port's counterpart of ``modin_tpu/pandas/dataframe.py``.  Holds no data,
only a ``_query_compiler`` handle.  Every pandas method exists: the ones
below route to the compiler (which runs what it can on the device and
defaults the rest to pandas, counted), and ``_install_fallbacks`` generates
counted pandas defaults for the rest.  ``transpose``, ``apply`` and
``aggregate`` with a callable default to pandas, as in the JAX package; a
transpose of more than ``TorchQueryCompiler._TRANSPOSE_WIDE_COLS`` rows
comes back on the host-only compiler.
"""

from __future__ import annotations

import functools
import itertools
import re
from typing import Any, Hashable, Iterator, Optional, Sequence, Union

import numpy as np
import pandas
from pandas._libs.lib import no_default
from pandas.api.types import is_list_like
from pandas.core.dtypes.common import is_bool_dtype, is_integer

from modin_tpu_torch.error_message import ErrorMessage
from modin_tpu_torch.pandas.base import BasePandasDataset, _install_fallbacks
from modin_tpu_torch.utils import (
    MODIN_UNNAMED_SERIES_LABEL,
    hashable,
    try_cast_to_pandas,
)


class DataFrame(BasePandasDataset):
    _pandas_class = pandas.DataFrame
    ndim = 2

    def __init__(
        self,
        data: Any = None,
        index: Any = None,
        columns: Any = None,
        dtype: Any = None,
        copy: Any = None,
        query_compiler: Any = None,
    ) -> None:
        from modin_tpu_torch.pandas.series import Series

        if query_compiler is not None:
            assert (
                data is None and index is None and columns is None
            ), "Cannot pass both query_compiler and data/index/columns"
            self._set_query_compiler(query_compiler)
            return
        if isinstance(data, DataFrame):
            if index is None and columns is None and dtype is None:
                self._set_query_compiler(data._query_compiler.copy())
                return
            pandas_df = data._to_pandas()
            new_pandas = pandas.DataFrame(
                pandas_df, index=index, columns=columns, dtype=dtype, copy=copy
            )
            self._set_query_compiler(self._from_pandas_qc(new_pandas))
            return
        if isinstance(data, Series):
            data = data._to_pandas()
        if isinstance(data, pandas.DataFrame):
            if index is None and columns is None and dtype is None:
                self._set_query_compiler(self._from_pandas_qc(data.copy()))
                return
            data = pandas.DataFrame(
                data, index=index, columns=columns, dtype=dtype, copy=copy
            )
            self._set_query_compiler(self._from_pandas_qc(data))
            return
        elif isinstance(data, dict):
            data = {
                k: try_cast_to_pandas(v) if isinstance(v, BasePandasDataset) else v
                for k, v in data.items()
            }
        elif is_list_like(data) and not isinstance(data, np.ndarray):
            data = [
                try_cast_to_pandas(v) if isinstance(v, BasePandasDataset) else v
                for v in data
            ]
        pandas_df = pandas.DataFrame(
            data=data, index=index, columns=columns, dtype=dtype, copy=copy
        )
        self._set_query_compiler(self._from_pandas_qc(pandas_df))

    @staticmethod
    def _from_pandas_qc(pandas_df: pandas.DataFrame):
        from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
            TorchQueryCompiler,
        )

        return TorchQueryCompiler.from_pandas(pandas_df)

    # ------------------------------------------------------------------ #
    # Metadata
    # ------------------------------------------------------------------ #

    def _get_columns(self) -> pandas.Index:
        return self._query_compiler.columns

    def _set_columns(self, new_columns: Any) -> None:
        self._query_compiler.columns = (
            new_columns
            if isinstance(new_columns, pandas.Index)
            else pandas.Index(new_columns)
        )

    columns = property(_get_columns, _set_columns)

    @property
    def shape(self) -> tuple:
        return len(self), len(self.columns)

    @property
    def T(self) -> "DataFrame":
        return self.transpose()

    def transpose(self, copy: bool = False, *args: Any) -> "DataFrame":
        return DataFrame(query_compiler=self._query_compiler.transpose(*args))

    # ------------------------------------------------------------------ #
    # Display
    # ------------------------------------------------------------------ #

    def __repr__(self) -> str:
        num_rows = pandas.get_option("display.max_rows") or len(self)
        num_cols = pandas.get_option("display.max_columns") or len(self.columns)
        result = repr(self._build_repr_df(num_rows, num_cols))
        nrows, ncols = self.shape
        if nrows > num_rows or ncols > num_cols:
            return re.sub(
                r"\[\d+ rows x \d+ columns\]",
                f"[{nrows} rows x {ncols} columns]",
                result,
            )
        return result

    def _repr_html_(self) -> str:
        num_rows = pandas.get_option("display.max_rows") or 60
        num_cols = pandas.get_option("display.max_columns") or 20
        result = self._build_repr_df(num_rows, num_cols)._repr_html_()
        nrows, ncols = self.shape
        if nrows > num_rows or ncols > num_cols:
            return re.sub(
                r"<p>\d+ rows [x×] \d+ columns</p>",
                f"<p>{nrows} rows x {ncols} columns</p>",
                result,
            )
        return result

    # ------------------------------------------------------------------ #
    # Materialization
    # ------------------------------------------------------------------ #

    def _to_pandas(self) -> pandas.DataFrame:
        return self._query_compiler.to_pandas()

    def __dataframe__(self, nan_as_null: bool = False, allow_copy: bool = True):
        return self._query_compiler.to_interchange_dataframe(
            nan_as_null=nan_as_null, allow_copy=allow_copy
        )

    # ------------------------------------------------------------------ #
    # Item access
    # ------------------------------------------------------------------ #

    def __getitem__(self, key: Any) -> Any:
        from modin_tpu_torch.pandas.series import Series

        if isinstance(key, (Series, np.ndarray, pandas.Series)) and (
            getattr(key, "dtype", None) is not None and is_bool_dtype(key.dtype)
        ):
            if isinstance(key, Series):
                return DataFrame(
                    query_compiler=self._query_compiler.getitem_array(
                        key._query_compiler
                    )
                )
            return DataFrame(query_compiler=self._query_compiler.getitem_array(np.asarray(key)))
        if isinstance(key, DataFrame):
            return self.where(key)
        if isinstance(key, slice):
            if (is_integer(key.start) or key.start is None) and (
                is_integer(key.stop) or key.stop is None
            ):
                return self.iloc[key]
            return self.loc[key]
        if isinstance(key, tuple) and isinstance(self.columns, pandas.MultiIndex):
            return self._default_to_pandas(lambda df: df[key])
        if hashable(key):
            if key not in self.columns:
                raise KeyError(key)
            return self._getitem_column(key)
        if is_list_like(key):
            key_list = list(key)
            if len(key_list) and np.asarray(key_list).dtype == bool:
                return DataFrame(
                    query_compiler=self._query_compiler.getitem_array(
                        np.asarray(key_list)
                    )
                )
            missing = [k for k in key_list if k not in self.columns]
            if missing:
                raise KeyError(f"{missing} not in index")
            return DataFrame(
                query_compiler=self._query_compiler.getitem_column_array(key_list)
            )
        return self._default_to_pandas(lambda df: df[key])

    def _getitem_column(self, key: Hashable):
        from modin_tpu_torch.pandas.series import Series

        positions = self.columns.get_indexer_for([key])
        if len(positions) > 1:
            return DataFrame(
                query_compiler=self._query_compiler.getitem_column_array(
                    list(positions), numeric=True
                )
            )
        qc = self._query_compiler.getitem_column_array([key])
        qc._shape_hint = "column"
        return Series(query_compiler=qc)

    def __setitem__(self, key: Any, value: Any) -> None:
        from modin_tpu_torch.pandas.series import Series

        if isinstance(value, BasePandasDataset):
            value = value._query_compiler
        if hashable(key) and not isinstance(key, tuple):
            self._update_inplace(self._query_compiler.setitem(0, key, value))
            return
        # fancy cases: boolean mask rows, multiple columns, tuples
        def setter(df: pandas.DataFrame) -> pandas.DataFrame:
            df = df.copy()
            df[key] = try_cast_to_pandas(value)
            return df

        self._update_inplace(self._query_compiler.default_to_pandas(setter))

    def __delitem__(self, key: Any) -> None:
        if key not in self.columns:
            raise KeyError(key)
        self._update_inplace(self._query_compiler.drop(columns=[key]))

    def __getattr__(self, key: str) -> Any:
        try:
            return object.__getattribute__(self, key)
        except AttributeError as err:
            if key not in _ATTRS_NO_LOOKUP:
                qc = object.__getattribute__(self, "_query_compiler")
                if qc is not None and key in qc.columns:
                    return self[key]
            raise err

    def __setattr__(self, key: str, value: Any) -> None:
        if key in ("_query_compiler", "_siblings", "_attrs"):
            object.__setattr__(self, key, value)
            return
        if key in type(self).__dict__ or key in BasePandasDataset.__dict__:
            object.__setattr__(self, key, value)
            return
        qc = getattr(self, "_query_compiler", None)
        if qc is not None and key in qc.columns:
            self[key] = value
            return
        if qc is not None and isinstance(value, (pandas.Series,)):
            import warnings

            from modin_tpu_torch.pandas.utils import SET_DATAFRAME_ATTRIBUTE_WARNING

            warnings.warn(SET_DATAFRAME_ATTRIBUTE_WARNING, UserWarning)
        object.__setattr__(self, key, value)

    def __iter__(self) -> Iterator[Hashable]:
        return iter(self.columns)

    def __contains__(self, key: Hashable) -> bool:
        return self.columns.__contains__(key)

    def keys(self) -> pandas.Index:
        return self.columns

    # ------------------------------------------------------------------ #
    # Column/row manipulation
    # ------------------------------------------------------------------ #

    def insert(self, loc: int, column: Hashable, value: Any, allow_duplicates: Any = no_default) -> None:
        if (
            allow_duplicates is not True and column in self.columns
        ):
            raise ValueError(f"cannot insert {column}, already exists")
        if not -len(self.columns) <= loc <= len(self.columns):
            raise IndexError(
                f"index {loc} is out of bounds for axis 0 with size {len(self.columns)}"
            )
        if isinstance(value, BasePandasDataset):
            value = value._query_compiler
        self._update_inplace(self._query_compiler.insert(loc, column, value))

    def pop(self, item: Hashable):
        result = self[item]
        self._update_inplace(self._query_compiler.drop(columns=[item]))
        return result

    def rename(
        self,
        mapper: Any = None,
        *,
        index: Any = None,
        columns: Any = None,
        axis: Any = None,
        copy: Any = None,
        inplace: bool = False,
        level: Any = None,
        errors: str = "ignore",
    ):
        if mapper is None and index is None and columns is None:
            raise TypeError("must pass an index to rename")
        if mapper is not None:
            axis_num = self._get_axis_number(axis) if axis is not None else 0
            if axis_num == 0:
                index = mapper
            else:
                columns = mapper
        new_qc = self._query_compiler
        if columns is not None and level is None and not callable(columns) and not isinstance(self.columns, pandas.MultiIndex):
            if errors == "raise":
                missing = [c for c in columns if c not in self.columns]
                if missing:
                    raise KeyError(f"{missing} not found in axis")
            new_columns = [
                columns.get(c, c) if isinstance(columns, dict) else c
                for c in self.columns
            ]
            new_qc = new_qc.copy()
            new_qc.columns = pandas.Index(new_columns, name=self.columns.name)
            columns = None
        if index is not None or columns is not None or level is not None:
            result = new_qc.default_to_pandas(
                pandas.DataFrame.rename,
                index=index,
                columns=columns,
                level=level,
                errors=errors,
            )
            new_qc = result
        return self._create_or_update_from_compiler(new_qc, inplace)

    def set_index(self, keys: Any, *, drop: bool = True, append: bool = False, inplace: bool = False, verify_integrity: bool = False):
        if not isinstance(keys, list):
            keys = [keys]
        from modin_tpu_torch.pandas.series import Series

        keys = [
            k._to_pandas() if isinstance(k, Series) else k for k in keys
        ]
        plain_labels = all(hashable(k) and not isinstance(k, (pandas.Series, pandas.Index, np.ndarray)) for k in keys)
        if plain_labels:
            for k in keys:
                if k not in self.columns:
                    raise KeyError(f"None of {[k]} are in the columns")
            new_qc = self._query_compiler.set_index_from_columns(
                keys, drop=drop, append=append
            )
        else:
            new_qc = self._query_compiler.default_to_pandas(
                pandas.DataFrame.set_index,
                keys,
                drop=drop,
                append=append,
                verify_integrity=verify_integrity,
            )
        return self._create_or_update_from_compiler(new_qc, inplace)

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
    ):
        axis = self._get_axis_number(axis)
        ascending = self._validate_ascending(ascending)
        if not is_list_like(by):
            by = [by]
        if axis == 0:
            missing = [b for b in by if b not in self.columns and b not in (self.index.names or [])]
            if missing:
                raise KeyError(missing[0])
            new_qc = self._query_compiler.sort_rows_by_column_values(
                by,
                ascending=ascending,
                kind=kind,
                na_position=na_position,
                ignore_index=ignore_index,
                key=key,
            )
        else:
            new_qc = self._query_compiler.sort_columns_by_row_values(
                by,
                ascending=ascending,
                kind=kind,
                na_position=na_position,
                key=key,
            )
        return self._create_or_update_from_compiler(new_qc, inplace)

    @staticmethod
    def _validate_ascending(ascending: Any) -> Any:
        if isinstance(ascending, (list, tuple)):
            return list(ascending)
        return bool(ascending)

    def nlargest(self, n: int, columns: Any, keep: str = "first") -> "DataFrame":
        return DataFrame(
            query_compiler=self._query_compiler.nlargest(n=n, columns=columns, keep=keep)
        )

    def nsmallest(self, n: int, columns: Any, keep: str = "first") -> "DataFrame":
        return DataFrame(
            query_compiler=self._query_compiler.nsmallest(n=n, columns=columns, keep=keep)
        )

    def duplicated(self, subset: Any = None, keep: Any = "first"):
        from modin_tpu_torch.pandas.series import Series

        qc = self._query_compiler.duplicated(subset=subset, keep=keep)
        qc._shape_hint = "column"
        return Series(query_compiler=qc)

    def drop_duplicates(self, subset: Any = None, *, keep: Any = "first", inplace: bool = False, ignore_index: bool = False):
        new_qc = self._query_compiler.drop_duplicates(
            subset=subset, keep=keep, ignore_index=ignore_index
        )
        return self._create_or_update_from_compiler(new_qc, inplace)

    # ------------------------------------------------------------------ #
    # Combination
    # ------------------------------------------------------------------ #

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

        if isinstance(right, Series):
            if right.name is None:
                raise ValueError("Cannot merge a Series without a name")
            right = right.to_frame()
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

    def join(
        self,
        other: Any,
        on: Any = None,
        how: str = "left",
        lsuffix: str = "",
        rsuffix: str = "",
        sort: bool = False,
        validate: Any = None,
    ) -> "DataFrame":
        from modin_tpu_torch.pandas.series import Series

        if isinstance(other, Series):
            if other.name is None:
                raise ValueError("Other Series must have a name")
            other = other.to_frame()
        if isinstance(other, DataFrame):
            other = other._query_compiler
        elif is_list_like(other):
            other = [
                o._query_compiler if isinstance(o, (DataFrame, Series)) else o
                for o in other
            ]
        return DataFrame(
            query_compiler=self._query_compiler.join(
                other,
                on=on,
                how=how,
                lsuffix=lsuffix,
                rsuffix=rsuffix,
                sort=sort,
                validate=validate,
            )
        )

    def update(self, other: Any, join: str = "left", overwrite: bool = True, filter_func: Any = None, errors: str = "ignore") -> None:
        if not isinstance(other, DataFrame):
            other = DataFrame(other)
        qc = self._query_compiler.df_update(
            other._query_compiler,
            join=join,
            overwrite=overwrite,
            filter_func=filter_func,
            errors=errors,
        )
        self._update_inplace(qc)

    def assign(self, **kwargs: Any) -> "DataFrame":
        df = self.copy()
        for k, v in kwargs.items():
            if callable(v):
                df[k] = v(df)
            else:
                df[k] = v
        return df

    def compare(self, other: Any, align_axis: Any = 1, keep_shape: bool = False, keep_equal: bool = False, result_names: Any = ("self", "other")) -> "DataFrame":
        if not isinstance(other, DataFrame):
            raise TypeError(f"can only compare with DataFrame, not {type(other)}")
        return DataFrame(
            query_compiler=self._query_compiler.compare(
                other._query_compiler,
                align_axis=align_axis,
                keep_shape=keep_shape,
                keep_equal=keep_equal,
                result_names=result_names,
            )
        )

    # ------------------------------------------------------------------ #
    # Groupby
    # ------------------------------------------------------------------ #

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

    # ------------------------------------------------------------------ #
    # Function application
    # ------------------------------------------------------------------ #

    def apply(
        self,
        func: Any,
        axis: Any = 0,
        raw: bool = False,
        result_type: Any = None,
        args: tuple = (),
        by_row: Any = "compat",
        engine: Any = "python",
        engine_kwargs: Any = None,
        **kwargs: Any,
    ):
        axis = self._get_axis_number(axis)
        result_qc = self._query_compiler.apply(
            func,
            axis=axis,
            raw=raw,
            result_type=result_type,
            args=args,
            **kwargs,
        )
        if not hasattr(result_qc, "to_pandas"):
            return result_qc
        result = DataFrame(query_compiler=result_qc)
        # pandas may reduce to a Series
        if (
            len(result.columns) == 1
            and result.columns[0] == MODIN_UNNAMED_SERIES_LABEL
        ):
            from modin_tpu_torch.pandas.series import Series

            result_qc._shape_hint = "column"
            return Series(query_compiler=result_qc)
        return result

    def map(self, func: Any, na_action: Any = None, **kwargs: Any) -> "DataFrame":
        return DataFrame(
            query_compiler=self._query_compiler.map(func, na_action=na_action, **kwargs)
        )

    def applymap(self, func: Any, na_action: Any = None, **kwargs: Any) -> "DataFrame":
        # removed in pandas 3; kept for compatibility with older user code
        return self.map(func, na_action=na_action, **kwargs)

    _AGG_REDUCTIONS = frozenset(
        ["sum", "mean", "min", "max", "prod", "product", "count", "median",
         "std", "var", "sem", "skew", "kurt", "any", "all"]
    )

    def aggregate(self, func: Any = None, axis: Any = 0, *args: Any, **kwargs: Any):
        # a bare named reduction IS that reduction (pandas applies the same
        # Series method per column): route it through the reduction surface
        # so the device kernels — and a pending graftplan — serve it instead
        # of a host materialization
        if (
            isinstance(func, str)
            and func in self._AGG_REDUCTIONS
            and not args
            and not kwargs
            and self._get_axis_number(axis) == 0
        ):
            return getattr(self, func)()
        return self._default_to_pandas("agg", func, axis, *args, **kwargs)

    agg = aggregate

    def corr(self, method: Any = "pearson", min_periods: int = 1, numeric_only: bool = False) -> "DataFrame":
        return DataFrame(
            query_compiler=self._query_compiler.corr(
                method=method, min_periods=min_periods, numeric_only=numeric_only
            )
        )

    def cov(self, min_periods: Any = None, ddof: int = 1, numeric_only: bool = False) -> "DataFrame":
        return DataFrame(
            query_compiler=self._query_compiler.cov(
                min_periods=min_periods, ddof=ddof, numeric_only=numeric_only
            )
        )

    def corrwith(self, other: Any, axis: Any = 0, drop: bool = False, method: Any = "pearson", numeric_only: bool = False):
        return self._reduce_dimension(
            self._query_compiler.corrwith(
                other._query_compiler if isinstance(other, BasePandasDataset) else other,
                axis=axis, drop=drop, method=method, numeric_only=numeric_only,
            )
        )

    def equals(self, other: Any) -> bool:
        return self._query_compiler.equals(
            other._query_compiler if isinstance(other, BasePandasDataset) else other
        )

    def select_dtypes(self, include: Any = None, exclude: Any = None) -> "DataFrame":
        # metadata-only: pandas resolves the include/exclude rules against an
        # EMPTY shell with our dtypes, then we slice columns positionally —
        # no device data moves
        shell = pandas.DataFrame(
            {i: pandas.Series(dtype=dt) for i, dt in enumerate(self.dtypes)}
        )
        keep = list(shell.select_dtypes(include=include, exclude=exclude).columns)
        return DataFrame(
            query_compiler=self._query_compiler.take_2d_positional(columns=keep)
        )

    def dot(self, other: Any):
        return self._binary_op("dot", other)

    def idxmin(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False):
        axis = self._get_axis_number(axis)
        return self._reduce_dimension(
            self._query_compiler.idxmin(axis=axis, skipna=skipna, numeric_only=numeric_only)
        )

    def idxmax(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False):
        axis = self._get_axis_number(axis)
        return self._reduce_dimension(
            self._query_compiler.idxmax(axis=axis, skipna=skipna, numeric_only=numeric_only)
        )

    def quantile(
        self,
        q: Any = 0.5,
        axis: Any = 0,
        numeric_only: bool = False,
        interpolation: str = "linear",
        method: str = "single",
    ):
        axis = self._get_axis_number(axis)
        result_qc = self._query_compiler.quantile(
            q=q, axis=axis, numeric_only=numeric_only,
            interpolation=interpolation, method=method,
        )
        if is_list_like(q):
            return DataFrame(query_compiler=result_qc)
        return self._reduce_dimension(result_qc)

    def mode(self, axis: Any = 0, numeric_only: bool = False, dropna: bool = True) -> "DataFrame":
        axis = self._get_axis_number(axis)
        return DataFrame(
            query_compiler=self._query_compiler.mode(
                axis=axis, numeric_only=numeric_only, dropna=dropna
            )
        )

    def describe(self, percentiles: Any = None, include: Any = None, exclude: Any = None) -> "DataFrame":
        return DataFrame(
            query_compiler=self._query_compiler.describe(
                percentiles=percentiles, include=include, exclude=exclude
            )
        )

    def round(self, decimals: Any = 0, *args: Any, **kwargs: Any) -> "DataFrame":
        if isinstance(decimals, BasePandasDataset):
            decimals = try_cast_to_pandas(decimals, squeeze=True)
        return DataFrame(query_compiler=self._query_compiler.round(decimals=decimals))

    # ------------------------------------------------------------------ #
    # Reshaping
    # ------------------------------------------------------------------ #

    def pivot(self, *, columns: Any, index: Any = no_default, values: Any = no_default) -> "DataFrame":
        kwargs = {"columns": columns}
        if index is not no_default:
            kwargs["index"] = index
        if values is not no_default:
            kwargs["values"] = values
        return DataFrame(query_compiler=self._query_compiler.pivot(**kwargs))

    def pivot_table(
        self,
        values: Any = None,
        index: Any = None,
        columns: Any = None,
        aggfunc: Any = "mean",
        fill_value: Any = None,
        margins: bool = False,
        dropna: bool = True,
        margins_name: str = "All",
        observed: Any = True,
        sort: bool = True,
    ) -> "DataFrame":
        return DataFrame(
            query_compiler=self._query_compiler.pivot_table(
                values=try_cast_to_pandas(values, squeeze=True),
                index=try_cast_to_pandas(index, squeeze=True),
                columns=try_cast_to_pandas(columns, squeeze=True),
                aggfunc=try_cast_to_pandas(aggfunc),
                fill_value=fill_value, margins=margins, dropna=dropna,
                margins_name=margins_name, observed=observed, sort=sort,
            )
        )

    def melt(
        self,
        id_vars: Any = None,
        value_vars: Any = None,
        var_name: Any = None,
        value_name: Any = "value",
        col_level: Any = None,
        ignore_index: bool = True,
    ) -> "DataFrame":
        return DataFrame(
            query_compiler=self._query_compiler.melt(
                id_vars=id_vars, value_vars=value_vars, var_name=var_name,
                value_name=value_name, col_level=col_level, ignore_index=ignore_index,
            )
        )

    def stack(self, level: Any = -1, dropna: Any = no_default, sort: Any = no_default, future_stack: bool = True):
        kwargs = {"level": level}
        if dropna is not no_default:
            kwargs["dropna"] = dropna
        if sort is not no_default:
            kwargs["sort"] = sort
        result = self._query_compiler.stack(**kwargs)
        return self._wrap_from_qc_auto(result)

    def unstack(self, level: Any = -1, fill_value: Any = None, sort: bool = True):
        result = self._query_compiler.unstack(level=level, fill_value=fill_value)
        return self._wrap_from_qc_auto(result)

    def _wrap_from_qc_auto(self, qc: Any):
        """Wrap a QC as Series if single unnamed column, else DataFrame."""
        from modin_tpu_torch.pandas.series import Series

        if not hasattr(qc, "to_pandas"):
            return qc
        cols = qc.columns
        if len(cols) == 1 and cols[0] == MODIN_UNNAMED_SERIES_LABEL:
            qc._shape_hint = "column"
            return Series(query_compiler=qc)
        return DataFrame(query_compiler=qc)

    def explode(self, column: Any, ignore_index: bool = False) -> "DataFrame":
        return DataFrame(
            query_compiler=self._query_compiler.explode(column, ignore_index=ignore_index)
        )

    def squeeze(self, axis: Any = None):
        return super().squeeze(axis)

    def value_counts(self, subset: Any = None, normalize: bool = False, sort: bool = True, ascending: bool = False, dropna: bool = True):
        from modin_tpu_torch.pandas.series import Series

        return self._default_to_pandas(
            "value_counts", subset=subset, normalize=normalize, sort=sort,
            ascending=ascending, dropna=dropna,
        )

    # ------------------------------------------------------------------ #
    # Iteration
    # ------------------------------------------------------------------ #

    def items(self) -> Iterator:
        for col in self.columns:
            yield col, self[col]

    def iterrows(self) -> Iterator:
        return self._default_to_pandas(lambda df: df.iterrows())

    def itertuples(self, index: bool = True, name: Any = "Pandas") -> Iterator:
        return self._default_to_pandas(lambda df: df.itertuples(index=index, name=name))

    # ------------------------------------------------------------------ #
    # Info / output
    # ------------------------------------------------------------------ #

    def info(self, verbose: Any = None, buf: Any = None, max_cols: Any = None, memory_usage: Any = None, show_counts: Any = None) -> None:
        self._default_to_pandas(
            "info", verbose=verbose, buf=buf, max_cols=max_cols,
            memory_usage=memory_usage, show_counts=show_counts,
        )

    def to_records(self, *args: Any, **kwargs: Any):
        return self._default_to_pandas("to_records", *args, **kwargs)

    def to_html(self, *args: Any, **kwargs: Any):
        return self._default_to_pandas("to_html", *args, **kwargs)

    # ------------------------------------------------------------------ #
    # Plotting & accessors
    # ------------------------------------------------------------------ #

    @property
    def plot(self):
        return self._default_to_pandas(lambda df: df.plot)

    def hist(self, *args: Any, **kwargs: Any):
        return self._default_to_pandas("hist", *args, **kwargs)

    def boxplot(self, *args: Any, **kwargs: Any):
        return self._default_to_pandas("boxplot", *args, **kwargs)

    @property
    def style(self):
        return self._default_to_pandas(lambda df: df.style)

    @property
    def sparse(self):
        return self._default_to_pandas(lambda df: df.sparse)

    def __divmod__(self, other: Any):
        return self._default_to_pandas("__divmod__", other)

    def __rdivmod__(self, other: Any):
        return self._default_to_pandas("__rdivmod__", other)

    def __matmul__(self, other: Any):
        return self.dot(other)

    def __rmatmul__(self, other: Any):
        return self._default_to_pandas("__rmatmul__", try_cast_to_pandas(other))

    def isetitem(self, loc: Any, value: Any) -> None:
        self._update_inplace(
            self._query_compiler.default_to_pandas(
                lambda df: df.copy().pipe(_isetitem_helper, loc, try_cast_to_pandas(value))
            )
        )

    def eval(self, expr: str, inplace: bool = False, **kwargs: Any):
        # the device expression engine of DataFrame.eval (try_eval) is a
        # later slice of the port: eval defaults to pandas
        from modin_tpu_torch.core.computation.eval import caller_namespace

        ns = (
            caller_namespace(int(kwargs.get("level", 0) or 0))
            if "@" in expr and "local_dict" not in kwargs
            else None
        )
        if ns is not None:
            # the pandas fallback runs deep inside the QC layers where the
            # user's locals are out of frame-walking reach; level is already
            # folded into the captured namespace
            kwargs["local_dict"] = ns
            kwargs.pop("level", None)
        result = self._default_to_pandas("eval", expr, **kwargs)
        if inplace:
            if isinstance(result, DataFrame):
                self._update_inplace(result._query_compiler)
                return None
            raise ValueError("Cannot operate inplace if there is no assignment")
        return result

    def query(self, expr: str, *, inplace: bool = False, **kwargs: Any):
        from modin_tpu_torch.core.computation.eval import caller_namespace

        ns = (
            caller_namespace(int(kwargs.get("level", 0) or 0))
            if "@" in expr and "local_dict" not in kwargs
            else None
        )
        if not kwargs:
            # named QC seam first (reference dataframe.py:1788): the storage
            # format compiles simple row-wise expressions natively and raises
            # NotImplementedError to route everything else to the fallback
            try:
                new_qc = self._query_compiler.rowwise_query(expr, local_dict=ns)
            except NotImplementedError:
                new_qc = None
            if new_qc is not None:
                if inplace:
                    self._update_inplace(new_qc)
                    return None
                return DataFrame(query_compiler=new_qc)
        if ns is not None:
            # the pandas fallback runs deep inside the QC layers where the
            # user's locals are out of frame-walking reach; level is already
            # folded into the captured namespace
            kwargs["local_dict"] = ns
            kwargs.pop("level", None)
        result = self._default_to_pandas("query", expr, **kwargs)
        if inplace:
            self._update_inplace(result._query_compiler)
            return None
        return result


def _isetitem_helper(df: pandas.DataFrame, loc: Any, value: Any) -> pandas.DataFrame:
    df.isetitem(loc, value)
    return df


_ATTRS_NO_LOOKUP = {
    "_query_compiler", "_siblings", "_attrs", "__class__", "__dict__",
    "_pandas_class", "_ipython_canary_method_should_not_exist_",
    "_ipython_display_", "_repr_mimebundle_", "__array_struct__",
    "__array_interface__", "_typ", "__deepcopy__", "__copy__",
}

_install_fallbacks(DataFrame, pandas.DataFrame)
