"""``loc``/``iloc``/``at``/``iat`` indexers of the torch port.

The port's counterpart of ``modin_tpu/pandas/indexing.py``: the API layer
parses locators and computes the result's dimensionality, while label
resolution lives in the query compiler (``qc.take_2d_labels`` /
``qc.get_positions_from_labels``), so that positional and boolean reads
reach the compiler's device paths (``take_2d_positional``,
``getitem_array`` with a mask) and device frames stay on the device.
MultiIndex axes resolve through ``Index.get_locs`` in the compiler; level
dropping after a partial lookup is an API-layer fixup.  The row labels of a
frame are built only where a label lookup needs them.  Writes route
existing-label assignments through ``qc.write_items`` and the boolean-mask
case through ``qc.setitem_bool``; both, enlargement and aligned frame-valued
assignment default to pandas.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import pandas
from pandas.api.types import is_bool_dtype, is_list_like, is_scalar
from pandas.core.dtypes.common import is_bool, is_integer

from modin_tpu_torch.logging import ClassLogger


def is_boolean_array(x: Any) -> bool:
    if isinstance(x, (np.ndarray, pandas.Series, pandas.Index)):
        return is_bool_dtype(x.dtype)
    from modin_tpu_torch.pandas.series import Series

    if isinstance(x, Series):
        return is_bool_dtype(x.dtype)
    return isinstance(x, (list, tuple)) and len(x) > 0 and all(is_bool(v) for v in x)


def is_integer_array(x: Any) -> bool:
    if isinstance(x, (np.ndarray, pandas.Series, pandas.Index)):
        return x.dtype.kind in "iu"
    return isinstance(x, (list, tuple)) and len(x) > 0 and all(is_integer(v) for v in x)


class _FallbackToPandas(Exception):
    pass


class _LocationIndexerBase(ClassLogger, modin_layer="PANDAS-API"):
    def __init__(self, modin_df: Any):
        self.df = modin_df
        self.qc = modin_df._query_compiler

    def _fallback_get(self, key: Any, attr: str) -> Any:
        from modin_tpu_torch.utils import try_cast_to_pandas

        # pandas must never see modin objects inside the key (it would
        # treat e.g. a boolean-Series mask as a label list)
        key = try_cast_to_pandas(key)
        return self.df._default_to_pandas(lambda obj: getattr(obj, attr)[key])

    def _fallback_set(self, key: Any, value: Any, attr: str) -> None:
        from modin_tpu_torch.utils import try_cast_to_pandas

        # the key can carry modin objects too (e.g. a boolean-Series mask in
        # a (rows, col) tuple) — pandas must never see them
        key = try_cast_to_pandas(key)
        value = try_cast_to_pandas(value)

        def setter(obj):
            obj = obj.copy()
            getattr(obj, attr)[key] = value
            return obj

        result = self.df._default_to_pandas(setter)
        self.df._update_inplace(result._query_compiler)

    def _wrap_row_series(self, row_qc: Any, label: Any) -> Any:
        """One selected row -> Series indexed by columns."""
        pandas_df = row_qc.to_pandas()
        row_series = pandas_df.iloc[0]
        row_series.name = label
        return self.df._wrap_pandas(row_series)

    def _write_positional(self, row_lookup: Any, col_lookup: Any, value: Any) -> bool:
        """Positional assignment via ``qc.write_items``; False if the value
        needs label alignment (frame-valued) and must take the fallback."""
        from modin_tpu_torch.pandas.base import BasePandasDataset

        if isinstance(value, (BasePandasDataset, pandas.Series, pandas.DataFrame)):
            # .loc/.iloc setitem with a pandas-like value aligns on labels;
            # keep those semantics on the oracle path
            return False
        new_qc = self.qc.write_items(row_lookup, col_lookup, value)
        self.df._update_inplace(new_qc)
        self.qc = self.df._query_compiler
        return True


class _iLocIndexer(_LocationIndexerBase):
    def __getitem__(self, key: Any) -> Any:
        from modin_tpu_torch.pandas.dataframe import DataFrame
        from modin_tpu_torch.pandas.series import Series

        if callable(key):
            return self.__getitem__(key(self.df))
        ndim = self.df.ndim
        if isinstance(key, tuple) and ndim == 2:
            if len(key) > 2:
                raise pandas.errors.IndexingError("Too many indexers")
            row_key = key[0]
            col_key = key[1] if len(key) > 1 else slice(None)
        else:
            row_key, col_key = key, slice(None)
            if isinstance(row_key, tuple) and ndim == 1:
                if len(row_key) > 1:
                    raise pandas.errors.IndexingError("Too many indexers")
                row_key = row_key[0] if row_key else slice(None)

        nrows = len(self.df)
        row_scalar = is_integer(row_key)
        col_scalar = is_integer(col_key)

        row_pos = self._positions(row_key, nrows, "row")
        if ndim == 1:
            if row_scalar:
                # one row to the host, not the whole Series
                return self.qc.take_2d_positional(index=row_pos).to_pandas().iloc[0, 0]
            new_qc = self.qc.take_2d_positional(index=row_pos)
            new_qc._shape_hint = "column"
            return Series(query_compiler=new_qc)

        ncols = len(self.df.columns)
        col_pos = self._positions(col_key, ncols, "column")
        if row_scalar and col_scalar:
            sub = self.qc.take_2d_positional(index=row_pos, columns=col_pos)
            return sub.to_pandas().iloc[0, 0]
        new_qc = self.qc.take_2d_positional(index=row_pos, columns=col_pos)
        if row_scalar:
            return self._wrap_row_series(new_qc, self.df.index[row_key])
        if col_scalar:
            new_qc._shape_hint = "column"
            return Series(query_compiler=new_qc)
        return DataFrame(query_compiler=new_qc)

    def _positions(self, axis_key: Any, length: int, axis_name: str) -> Any:
        if isinstance(axis_key, slice):
            return axis_key
        if is_integer(axis_key):
            if axis_key < -length or axis_key >= length:
                raise IndexError(
                    f"single positional indexer is out-of-bounds"
                )
            pos = axis_key if axis_key >= 0 else length + axis_key
            return [pos]
        if is_boolean_array(axis_key):
            mask = np.asarray(axis_key)
            if len(mask) != length:
                raise IndexError(
                    f"Boolean index has wrong length: {len(mask)} instead of {length}"
                )
            return list(np.nonzero(mask)[0])
        if is_list_like(axis_key):
            arr = np.asarray(axis_key, dtype=np.int64).ravel()
            if len(arr) and (arr.max(initial=-1) >= length or arr.min(initial=0) < -length):
                raise IndexError("positional indexers are out-of-bounds")
            return [int(i) if i >= 0 else length + int(i) for i in arr]
        raise TypeError(f"Cannot index by location index with a key of type {type(axis_key)}")

    def __setitem__(self, key: Any, value: Any) -> None:
        if callable(key):
            key = key(self.df)
        ndim = self.df.ndim
        if isinstance(key, tuple) and ndim == 2:
            if len(key) > 2:
                raise pandas.errors.IndexingError("Too many indexers")
            row_key = key[0]
            col_key = key[1] if len(key) > 1 else slice(None)
        else:
            row_key, col_key = key, slice(None)
        try:
            row_pos = self._positions(row_key, len(self.df), "row")
            col_pos = (
                self._positions(col_key, len(self.df.columns), "column")
                if ndim == 2
                else slice(None)
            )
        except (TypeError, IndexError):
            return self._fallback_set(key, value, "iloc")
        if not self._write_positional(row_pos, col_pos, value):
            self._fallback_set(key, value, "iloc")


class _LocIndexer(_LocationIndexerBase):
    def __getitem__(self, key: Any) -> Any:
        if callable(key):
            return self.__getitem__(key(self.df))
        if self.df.empty:
            return self._fallback_get(key, "loc")
        ndim_self = self.df.ndim
        rows_mi = self.qc.has_multiindex(0)
        if ndim_self == 2 and isinstance(key, tuple):
            if (
                rows_mi
                and 2 <= len(key) <= self.qc.get_axis(0).nlevels
                and all(is_scalar(k) for k in key)
            ):
                # loc[('a', 'b')] is ambiguous: a (partial) row key or a
                # (row, column) pair.  pandas prefers the row interpretation
                # when it resolves (reference indexing.py:731-747).
                try:
                    return self._getitem_via_qc(key, key, slice(None))
                except KeyError:
                    # a >2-long all-scalar tuple can only be a row key (a
                    # (row, col) pair has 2 parts): pandas surfaces the
                    # KeyError, not "Too many indexers"
                    if len(key) > 2:
                        raise
            if len(key) > 2:
                raise pandas.errors.IndexingError("Too many indexers")
            row_key = key[0]
            col_key = key[1] if len(key) > 1 else slice(None)
        else:
            row_key, col_key = key, slice(None)
            if (
                ndim_self == 1
                and isinstance(key, tuple)
                and not rows_mi
            ):
                if len(key) > 1:
                    raise pandas.errors.IndexingError("Too many indexers")
                row_key = key[0] if key else slice(None)
        try:
            return self._getitem_via_qc(key, row_key, col_key)
        except _FallbackToPandas:
            return self._fallback_get(key, "loc")

    def _getitem_via_qc(self, key: Any, row_key: Any, col_key: Any) -> Any:
        from modin_tpu_torch.pandas.dataframe import DataFrame
        from modin_tpu_torch.pandas.series import Series

        row_scalar = is_scalar(row_key)
        col_scalar = is_scalar(col_key)
        row_mi_full = self._multiindex_full_key(0, row_key)
        col_mi_full = (
            self._multiindex_full_key(1, col_key) if self.df.ndim == 2 else False
        )

        # Boolean-mask rows on a device frame: reuse the __getitem__ filter
        # fast path (mask fuses into the kernel) instead of materializing
        # positions on the host (reference _handle_boolean_masking :631).
        if (
            self.df.ndim == 2
            and isinstance(row_key, Series)
            and is_boolean_array(row_key)
        ):
            masked = self.df[row_key]
            if isinstance(col_key, slice) and col_key == slice(None):
                return masked
            return masked.loc[:, col_key]

        row_key = self._normalize_key(row_key, 0)
        if self.df.ndim == 2:
            col_key = self._normalize_key(col_key, 1)

        qc_view = self.qc.take_2d_labels(
            row_key, col_key if self.df.ndim == 2 else slice(None)
        )

        # An axis squeezes only when its key pins exactly one label: a scalar
        # (or tuple label) on a flat axis, or a full-depth tuple on a
        # MultiIndex axis.  A PARTIAL MultiIndex key keeps the axis and drops
        # the looked-up levels instead (pandas xs semantics).
        has_mi_rows = self.qc.has_multiindex(0)
        has_mi_cols = self.df.ndim == 2 and self.qc.has_multiindex(1)
        row_squeeze = row_mi_full or (
            (row_scalar or isinstance(row_key, tuple)) and not has_mi_rows
        )
        col_squeeze = col_mi_full or (
            (col_scalar or isinstance(col_key, tuple)) and not has_mi_cols
        )
        if self.df.ndim == 1:
            qc_view._shape_hint = "column"
            result = Series(query_compiler=qc_view)
            if row_squeeze:
                result = result.squeeze(axis=0)
        else:
            result = DataFrame(query_compiler=qc_view)
            if row_squeeze or col_squeeze:
                axis = (
                    None if row_squeeze and col_squeeze else 1 if col_squeeze else 0
                )
                result = result.squeeze(axis=axis)

        result = self._drop_levels(
            result, row_key, col_key, row_scalar, col_scalar,
            levels_already_dropped=row_mi_full or col_mi_full,
            row_squeezed=row_squeeze, col_squeezed=col_squeeze,
        )
        # Keep index state (e.g. DatetimeIndex freq) when selecting all
        # columns by an Index-valued row key (reference indexing.py:843-851)
        if (
            isinstance(key, pandas.Index)
            and not isinstance(key, pandas.MultiIndex)
            and isinstance(col_key, slice)
            and col_key == slice(None)
            and hasattr(result, "index")
            and len(result.index) == len(key)
        ):
            result.index = key
        return result

    def _drop_levels(
        self,
        result: Any,
        row_key: Any,
        col_key: Any,
        row_scalar: bool,
        col_scalar: bool,
        levels_already_dropped: bool,
        row_squeezed: bool = False,
        col_squeezed: bool = False,
    ) -> Any:
        """Partial-key MultiIndex lookups drop the looked-up levels
        (reference indexing.py:812-841)."""
        from modin_tpu_torch.pandas.base import BasePandasDataset
        from modin_tpu_torch.pandas.dataframe import DataFrame
        from modin_tpu_torch.pandas.series import Series

        if not isinstance(result, BasePandasDataset) or levels_already_dropped:
            return result
        col_list = [col_key] if col_scalar else col_key
        row_list = [row_key] if row_scalar else row_key
        if result._query_compiler.has_multiindex(0):
            # a Series whose index came from the COLUMNS (row axis squeezed
            # away, columns kept) drops col-key levels; every other result's
            # index is the row axis and drops row-key levels
            index_is_columns = (
                isinstance(result, Series) and row_squeezed and not col_squeezed
            )
            if index_is_columns:
                # same guard as the row branch below: only a scalar or tuple
                # col key looks up INTO the levels; a LIST key selects whole
                # level-0 entries and pandas keeps all levels
                if (
                    (col_scalar or isinstance(col_key, tuple))
                    and isinstance(col_list, (list, tuple))
                    and 0 < len(col_list) < result.index.nlevels
                    and all(
                        not isinstance(col_list[i], slice)
                        and is_scalar(col_list[i])
                        and col_list[i] in result.index.levels[i]
                        for i in range(len(col_list))
                    )
                ):
                    result.index = result.index.droplevel(list(range(len(col_list))))
            elif (
                (row_scalar or isinstance(row_key, tuple))
                and isinstance(row_list, (list, tuple))
                and 0 < len(row_list) < result.index.nlevels
                and all(
                    not isinstance(row_list[i], slice)
                    and is_scalar(row_list[i])
                    and row_list[i] in result.index.levels[i]
                    for i in range(len(row_list))
                )
            ):
                result.index = result.index.droplevel(list(range(len(row_list))))
        if (
            isinstance(result, DataFrame)
            and isinstance(result.columns, pandas.MultiIndex)
            and (col_scalar or isinstance(col_key, tuple))
            and isinstance(col_list, (list, tuple))
            and 0 < len(col_list) < result.columns.nlevels
            and all(
                not isinstance(col_list[i], slice)
                and is_scalar(col_list[i])
                and col_list[i] in result.columns.levels[i]
                for i in range(len(col_list))
            )
        ):
            result.columns = result.columns.droplevel(list(range(len(col_list))))
        return result

    def _multiindex_full_key(self, axis: int, key: Any) -> bool:
        """Tuple key whose length spans every level of a MultiIndex axis
        (reference _multiindex_possibly_contains_key, indexing.py:664)."""
        if not isinstance(key, tuple) or not self.qc.has_multiindex(axis):
            return False
        if not all(is_scalar(k) for k in key):
            return False
        return len(key) == self.qc.get_axis(axis).nlevels

    def _normalize_key(self, loc: Any, axis: int) -> Any:
        """Materialize modin-object keys; align boolean Series masks by label
        (pandas ``check_bool_indexer`` semantics)."""
        from modin_tpu_torch.pandas.base import BasePandasDataset
        from modin_tpu_torch.pandas.dataframe import DataFrame
        from modin_tpu_torch.pandas.series import Series

        if isinstance(loc, (DataFrame, pandas.DataFrame)):
            raise _FallbackToPandas()
        if isinstance(loc, Series):
            loc = loc._to_pandas()
        if isinstance(loc, BasePandasDataset):
            raise _FallbackToPandas()
        if isinstance(loc, pandas.Series):
            if is_bool_dtype(loc.dtype):
                labels = self.qc.get_axis(axis)
                if not loc.index.equals(labels):
                    loc = loc.reindex(labels)
                    if loc.isna().any():
                        raise pandas.errors.IndexingError(
                            "Unalignable boolean Series provided as indexer "
                            "(index of the boolean Series and of the indexed "
                            "object do not match)."
                        )
                return loc.to_numpy(dtype=bool)
            return loc.to_numpy()
        return loc

    def __setitem__(self, key: Any, value: Any) -> None:
        from modin_tpu_torch.pandas.series import Series

        if callable(key):
            key = key(self.df)
        ndim_self = self.df.ndim
        if self.qc.has_multiindex(0) or (
            ndim_self == 2 and isinstance(self.df.columns, pandas.MultiIndex)
        ):
            return self._fallback_set(key, value, "loc")
        if isinstance(key, tuple) and ndim_self == 2:
            if len(key) > 2:
                raise pandas.errors.IndexingError("Too many indexers")
            row_key = key[0]
            col_key = key[1] if len(key) > 1 else slice(None)
        else:
            row_key, col_key = key, slice(None)

        # The reference's boolean hot path (indexing.py:954): mask rows,
        # scalar value -> one named QC op
        if (
            ndim_self == 2
            and isinstance(row_key, Series)
            and is_boolean_array(row_key)
            and is_scalar(value)
            and not isinstance(col_key, slice)
        ):
            new_qc = self.qc.setitem_bool(row_key._query_compiler, col_key, value)
            self.df._update_inplace(new_qc)
            self.qc = self.df._query_compiler
            return

        try:
            row_norm = self._normalize_key(row_key, 0)
            col_norm = (
                self._normalize_key(col_key, 1) if ndim_self == 2 else slice(None)
            )
            row_lookup, col_lookup = self.qc.get_positions_from_labels(
                row_norm, col_norm
            )
        except KeyError:
            # missing labels: .loc setitem enlarges; keep pandas as the oracle
            return self._fallback_set(key, value, "loc")
        except (_FallbackToPandas, pandas.errors.IndexingError, TypeError):
            return self._fallback_set(key, value, "loc")
        if not self._write_positional(row_lookup, col_lookup, value):
            self._fallback_set(key, value, "loc")


class _AtIndexer(_LocationIndexerBase):
    def __getitem__(self, key: Any) -> Any:
        return self.df.loc[key]

    def __setitem__(self, key: Any, value: Any) -> None:
        self.df.loc[key] = value


class _iAtIndexer(_LocationIndexerBase):
    def __getitem__(self, key: Any) -> Any:
        return self.df.iloc[key]

    def __setitem__(self, key: Any, value: Any) -> None:
        self.df.iloc[key] = value
