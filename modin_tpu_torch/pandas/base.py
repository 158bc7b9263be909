"""``BasePandasDataset`` — everything the port's DataFrame and Series share.

The port's counterpart of ``modin_tpu/pandas/base.py``: explicit
implementations routed through the query compiler for the hot and structural
operations, and generated default-to-pandas fallbacks
(``_install_fallbacks``) for the long tail, so that every pandas method
exists.  What the device does not run goes to pandas through the compiler's
one counted default (``query_compiler.DEFAULTS_TO_PANDAS``).  ``rolling``,
``expanding`` and ``ewm`` return the port's window objects
(``pandas/window.py``), and ``resample`` its ``Resampler``
(``pandas/resample.py``).  The numpy math ufuncs of one argument
(``np.sqrt(df)`` and the others of the compiler's ``unary_math``) go through
the compiler; other ufuncs apply to the pandas object.  Left out, as a
later slice of the port: the backend switching between compilers.  ``to_csv``,
``to_json``, ``to_sql``, ``to_hdf`` and ``to_excel`` (and the DataFrame's
``to_parquet``/``to_feather``) go through the IO dispatchers
(``FactoryDispatcher``); the other writers default to pandas.
"""

from __future__ import annotations

import functools
import inspect
import pickle as pkl
import re
from typing import Any, Hashable, Optional, Sequence, Union

import numpy as np
import pandas
from pandas._libs.lib import no_default
from pandas.api.types import is_bool_dtype, is_list_like, is_numeric_dtype
from pandas.core.dtypes.common import is_integer

from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
    TorchQueryCompiler,
)
from modin_tpu_torch.error_message import ErrorMessage
from modin_tpu_torch.utils import MODIN_UNNAMED_SERIES_LABEL, try_cast_to_pandas

_DEFAULT_BEHAVIOUR = {
    "__class__", "__init__", "__init_subclass__", "__new__", "__dict__",
    "__module__", "__qualname__", "__doc__", "__reduce__", "__reduce_ex__",
    "__getstate__", "__setstate__", "__subclasshook__", "__dir__", "__weakref__",
    "__sizeof__", "__delattr__", "__setattr__", "__getattr__", "__getattribute__",
    "__annotations__", "__abstractmethods__", "__slots__",
    "_constructor", "_constructor_sliced", "_constructor_expanddim",
    "_accessors", "_internal_names", "_internal_names_set", "_metadata",
    "_mgr", "_values", "_typ", "_AXIS_ORDERS", "_AXIS_TO_AXIS_NUMBER",
    "_HANDLED_TYPES", "_hidden_attrs", "_info_axis_name", "_info_axis_number",
}


class ModinAPI:
    """``obj.modin``: conversions specific to this package."""

    def __init__(self, data: Any) -> None:
        self._data = data

    def to_pandas(self) -> Any:
        """Materialize to a plain pandas object on the host."""
        return self._data._to_pandas()


class BasePandasDataset:
    """Implementation of the operations common to DataFrame and Series."""

    _pandas_class = pandas.DataFrame
    _query_compiler = None
    _siblings: list

    # ------------------------------------------------------------------ #
    # Internal plumbing
    # ------------------------------------------------------------------ #

    def _set_query_compiler(self, qc) -> None:
        object.__setattr__(self, "_query_compiler", qc)
        object.__setattr__(self, "_siblings", [])

    @property
    def __constructor__(self):
        return type(self)

    @classmethod
    def _get_axis_number(cls, axis: Any) -> int:
        if axis is no_default or axis is None:
            return 0
        if axis in (0, "index", "rows"):
            return 0
        if axis in (1, "columns"):
            return 1
        raise ValueError(f"No axis named {axis} for object type {cls.__name__}")

    def _create_or_update_from_compiler(self, new_query_compiler, inplace: bool = False):
        """Return a new object from the compiler, or update self in place."""
        assert new_query_compiler is not None
        if not inplace:
            return self.__constructor__(query_compiler=new_query_compiler)
        self._update_inplace(new_query_compiler)
        return None

    def _update_inplace(self, new_query_compiler) -> None:
        # NOTE: the old compiler is NOT freed here — lazy handles (GroupBy,
        # Rolling, Resampler) may still reference it; GC reclaims it.
        object.__setattr__(self, "_query_compiler", new_query_compiler)
        for sib in getattr(self, "_siblings", []):
            object.__setattr__(sib, "_query_compiler", new_query_compiler)

    def _add_sibling(self, sibling) -> None:
        sibling._siblings = self._siblings + [self]
        for sib in self._siblings:
            sib._siblings += [sibling]
        self._siblings += [sibling]

    def _wrap_pandas(self, result: Any) -> Any:
        """Wrap a raw pandas result into the matching modin_tpu object."""
        from modin_tpu_torch.pandas.dataframe import DataFrame
        from modin_tpu_torch.pandas.series import Series

        qc_cls = type(self._query_compiler)
        if isinstance(result, pandas.DataFrame):
            return DataFrame(query_compiler=qc_cls.from_pandas(result))
        if isinstance(result, pandas.Series):
            name = result.name
            frame = result.to_frame(
                name if name is not None else MODIN_UNNAMED_SERIES_LABEL
            )
            qc = qc_cls.from_pandas(frame)
            qc._shape_hint = "column"
            return Series(query_compiler=qc)
        return result

    def _default_to_pandas(self, op: Any, *args: Any, **kwargs: Any) -> Any:
        """Materialize, apply a pandas operation, wrap the result back.

        String ops with a named BaseQueryCompiler counterpart dispatch
        through the QC (``series_<op>`` for Series), so that a compiler can
        override any of them; only the residue (callables, ops without a QC
        name) materializes here at the API layer.  Both routes count one
        default to pandas.
        """
        if isinstance(op, str):
            routed = self._try_qc_dispatch(op, args, kwargs)
            if routed is not NotImplemented:
                return routed
        op_name = op if isinstance(op, str) else getattr(op, "__name__", str(op))
        ErrorMessage.default_to_pandas(f"`{type(self).__name__}.{op_name}`")
        args = try_cast_to_pandas(args)
        kwargs = try_cast_to_pandas(kwargs)
        pandas_obj = self._to_pandas()
        if callable(op):
            result = op(pandas_obj, *args, **kwargs)
        else:
            attr = getattr(pandas_obj, op)
            result = attr(*args, **kwargs) if callable(attr) else attr
        if result is None and kwargs.get("inplace", False):
            # the pandas op mutated pandas_obj in place
            return self._update_inplace_from_pandas(pandas_obj)
        return self._wrap_pandas(result)

    def _try_qc_dispatch(self, op: str, args: tuple, kwargs: dict) -> Any:
        """Dispatch a pandas-signature fallback through a named QC method.

        Returns ``NotImplemented`` when no route exists (caller materializes
        at the API layer instead).
        """
        from modin_tpu_torch.core.storage_formats.base.query_compiler import (
            BaseQueryCompiler,
            DATAFRAME_QC_ROUTES,
            SERIES_QC_ROUTES,
        )

        routes = SERIES_QC_ROUTES if self.ndim == 1 else DATAFRAME_QC_ROUTES
        qc_name = routes.get(op)
        qc = self._query_compiler
        qc_method = getattr(type(qc), qc_name, None) if qc_name else None
        if qc_method is None:
            return NotImplemented
        if not getattr(qc_method, "_pandas_signature_default", False):
            # a backend override with a normalized (non-pandas) signature
            # shadows the generated default — routing pandas-signature args
            # into it would mis-bind, so take the API-layer fallback instead
            return NotImplemented
        args = try_cast_to_pandas(args)
        kwargs = try_cast_to_pandas(kwargs)
        # the QC level is out-of-place (reference invariant): compute a new
        # compiler, then adopt it in place here when the user asked for it
        inplace = bool(kwargs.get("inplace", False))
        if inplace:
            kwargs = {**kwargs, "inplace": False}
        result = qc_method(qc, *args, **kwargs)
        if isinstance(result, BaseQueryCompiler):
            if inplace:
                return self._create_or_update_from_compiler(result, inplace=True)
            return self._wrap_from_qc(result)
        return result

    def _wrap_from_qc(self, result_qc: Any) -> Any:
        """Wrap a result QC as Series/DataFrame based on its shape hint."""
        from modin_tpu_torch.pandas.dataframe import DataFrame
        from modin_tpu_torch.pandas.series import Series

        if result_qc._shape_hint == "column":
            return Series(query_compiler=result_qc)
        return DataFrame(query_compiler=result_qc)

    def _update_inplace_from_pandas(self, pandas_obj: Any) -> None:
        """Replace this object's contents with a mutated pandas object."""
        new_qc = type(self._query_compiler).from_pandas(
            pandas_obj
            if isinstance(pandas_obj, pandas.DataFrame)
            else pandas_obj.to_frame(
                pandas_obj.name
                if pandas_obj.name is not None
                else MODIN_UNNAMED_SERIES_LABEL
            )
        )
        # from_pandas always builds a frame-shaped QC; a Series must keep its
        # column hint or downstream squeezes (binary ops, casts) break
        new_qc._shape_hint = self._query_compiler._shape_hint
        return self._create_or_update_from_compiler(new_qc, inplace=True)

    def _reduce_dimension(self, query_compiler) -> Any:
        """Turn a reduction-result QC into a Series (DataFrame) or scalar (Series)."""
        from modin_tpu_torch.pandas.series import Series

        if not hasattr(query_compiler, "to_pandas"):
            return query_compiler  # already a scalar
        query_compiler._shape_hint = "column"
        return Series(query_compiler=query_compiler)

    def _stat_operation(
        self,
        op_name: str,
        axis: Any = 0,
        skipna: bool = True,
        numeric_only: bool = False,
        **kwargs: Any,
    ) -> Any:
        axis = self._get_axis_number(axis) if axis is not None else None
        result_qc = getattr(self._query_compiler, op_name)(
            axis=axis, skipna=skipna, numeric_only=numeric_only, **kwargs
        )
        return self._reduce_dimension(result_qc)

    def _binary_op(self, op: str, other: Any, **kwargs: Any) -> Any:
        from modin_tpu_torch.pandas.dataframe import DataFrame
        from modin_tpu_torch.pandas.series import Series

        squeeze_other = kwargs.pop("squeeze_other", isinstance(other, Series))
        if isinstance(other, BasePandasDataset):
            other_arg = other._query_compiler
        elif isinstance(other, (pandas.DataFrame, pandas.Series)):
            other_arg = self._to_compiler(other)
        else:
            other_arg = other
        if squeeze_other and not isinstance(self, Series):
            kwargs["squeeze_other"] = True
        new_qc = getattr(self._query_compiler, op)(other_arg, **kwargs)
        if not hasattr(new_qc, "to_pandas"):
            return new_qc
        if isinstance(self, DataFrame) or isinstance(other, DataFrame):
            result_cls = DataFrame
        else:
            result_cls = Series
            new_qc = new_qc.columnarize()
        return result_cls(query_compiler=new_qc)

    # ------------------------------------------------------------------ #
    # Materialization & repr
    # ------------------------------------------------------------------ #

    @staticmethod
    def _to_compiler(other: Any) -> Any:
        """A port object's compiler; a pandas object goes to the device
        (a Series as a column-shaped compiler); anything else as it is."""
        if isinstance(other, BasePandasDataset):
            return other._query_compiler
        if isinstance(other, pandas.DataFrame):
            return TorchQueryCompiler.from_pandas(other)
        if isinstance(other, pandas.Series):
            qc = TorchQueryCompiler.from_pandas(
                other.to_frame(other.name if other.name is not None else MODIN_UNNAMED_SERIES_LABEL)
            )
            qc._shape_hint = "column"
            return qc
        return other

    @property
    def modin(self) -> ModinAPI:
        return ModinAPI(self)

    def _to_pandas(self) -> Any:
        raise NotImplementedError

    def _build_repr_df(self, num_rows: int, num_cols: Optional[int] = None):
        """Gather only the head+tail window needed for display."""
        qc = self._query_compiler
        nrows = len(self)
        if nrows > num_rows:
            front = num_rows // 2 + 1
            back = num_rows - front + 2
            head = qc.row_slice(None, front)
            tail = qc.row_slice(nrows - back, None)
            qc = head.concat(0, [tail], ignore_index=False)
        if num_cols is not None:
            ncols = qc.get_axis_len(1)
            if ncols > num_cols:
                front = num_cols // 2 + 1
                back = num_cols - front + 2
                left = qc.getitem_column_array(range(front), numeric=True)
                right = qc.getitem_column_array(
                    range(ncols - back, ncols), numeric=True
                )
                qc = left.concat(1, [right])
        return qc.to_pandas()

    # ------------------------------------------------------------------ #
    # Metadata properties
    # ------------------------------------------------------------------ #

    def _get_index(self) -> pandas.Index:
        return self._query_compiler.index

    def _set_index(self, new_index: Any) -> None:
        if not isinstance(new_index, pandas.Index):
            new_index = pandas.Index(new_index)
        self._query_compiler.index = new_index

    index = property(_get_index, _set_index)

    @property
    def dtypes(self) -> Any:
        return self._query_compiler.dtypes

    @property
    def size(self) -> int:
        return np.prod(self.shape, dtype=np.int64)

    @property
    def empty(self) -> bool:
        return 0 in self.shape

    @property
    def values(self) -> np.ndarray:
        return self.to_numpy()

    @property
    def axes(self) -> list:
        if self.ndim == 1:
            return [self.index]
        return [self.index, self.columns]

    def __len__(self) -> int:
        return self._query_compiler.get_axis_len(0)

    # ------------------------------------------------------------------ #
    # Conversion
    # ------------------------------------------------------------------ #

    def to_numpy(self, dtype: Any = None, copy: bool = False, na_value: Any = no_default) -> np.ndarray:
        return self._query_compiler.to_numpy(dtype=dtype, copy=copy, na_value=na_value)

    def __array__(self, dtype: Any = None, copy: Optional[bool] = None) -> np.ndarray:
        arr = self.to_numpy(dtype)
        return arr

    def __array_ufunc__(self, ufunc: np.ufunc, method: str, *inputs: Any, **kwargs: Any) -> Any:
        """Numpy universal-function protocol: a math ufunc of this object
        alone through the compiler's ``unary_math``; any other call
        materializes, applies and wraps back."""
        if (
            method == "__call__"
            and not kwargs
            and len(inputs) == 1
            and inputs[0] is self
            and ufunc.__name__ in getattr(self._query_compiler, "MATH_UNARY", ())
        ):
            return self._create_or_update_from_compiler(self._query_compiler.unary_math(ufunc.__name__))
        pandas_inputs = [
            obj._to_pandas() if isinstance(obj, BasePandasDataset) else obj
            for obj in inputs
        ]
        result = getattr(ufunc, method)(*pandas_inputs, **kwargs)
        return self._wrap_pandas(result)

    def __array_wrap__(self, result: np.ndarray, context: Any = None, return_scalar: bool = False) -> Any:
        return result

    # ------------------------------------------------------------------ #
    # Copies & pickling
    # ------------------------------------------------------------------ #

    def copy(self, deep: bool = True):
        if deep:
            return self._create_or_update_from_compiler(self._query_compiler.copy())
        new_obj = self._create_or_update_from_compiler(self._query_compiler)
        self._add_sibling(new_obj)
        return new_obj

    def __copy__(self, deep: bool = True):
        return self.copy(deep=deep)

    def __deepcopy__(self, memo: Any = None):
        return self.copy(deep=True)

    def __sizeof__(self) -> int:
        return self._default_to_pandas("__sizeof__")

    # ------------------------------------------------------------------ #
    # Arithmetic / comparison operators
    # ------------------------------------------------------------------ #

    def _arith_method_factory(name):  # noqa: N805 — class-body helper
        def op(self, other, axis: Any = "columns", level: Any = None, fill_value: Any = None):
            if self.ndim == 1:
                axis = 0 if axis in (None, no_default, "columns") else self._get_axis_number(axis)
                return self._binary_op(name, other, axis=axis, level=level, fill_value=fill_value)
            return self._binary_op(name, other, axis=axis, level=level, fill_value=fill_value)

        op.__name__ = name
        return op

    add = _arith_method_factory("add")
    radd = _arith_method_factory("radd")
    sub = _arith_method_factory("sub")
    subtract = sub
    rsub = _arith_method_factory("rsub")
    mul = _arith_method_factory("mul")
    multiply = mul
    rmul = _arith_method_factory("rmul")
    truediv = _arith_method_factory("truediv")
    div = truediv
    divide = truediv
    rtruediv = _arith_method_factory("rtruediv")
    rdiv = rtruediv
    floordiv = _arith_method_factory("floordiv")
    rfloordiv = _arith_method_factory("rfloordiv")
    mod = _arith_method_factory("mod")
    rmod = _arith_method_factory("rmod")
    pow = _arith_method_factory("pow")
    rpow = _arith_method_factory("rpow")

    del _arith_method_factory

    def _comparison_method_factory(name):  # noqa: N805
        def op(self, other, axis: Any = "columns", level: Any = None):
            if self.ndim == 1:
                return self._binary_op(name, other, axis=0, level=level)
            return self._binary_op(name, other, axis=axis, level=level)

        op.__name__ = name
        return op

    eq = _comparison_method_factory("eq")
    ne = _comparison_method_factory("ne")
    lt = _comparison_method_factory("lt")
    le = _comparison_method_factory("le")
    gt = _comparison_method_factory("gt")
    ge = _comparison_method_factory("ge")

    del _comparison_method_factory

    def __add__(self, other):
        return self.add(other)

    def __radd__(self, other):
        return self.radd(other)

    def __sub__(self, other):
        return self.sub(other)

    def __rsub__(self, other):
        return self.rsub(other)

    def __mul__(self, other):
        return self.mul(other)

    def __rmul__(self, other):
        return self.rmul(other)

    def __truediv__(self, other):
        return self.truediv(other)

    def __rtruediv__(self, other):
        return self.rtruediv(other)

    def __floordiv__(self, other):
        return self.floordiv(other)

    def __rfloordiv__(self, other):
        return self.rfloordiv(other)

    def __mod__(self, other):
        return self.mod(other)

    def __rmod__(self, other):
        return self.rmod(other)

    def __pow__(self, other):
        return self.pow(other)

    def __rpow__(self, other):
        return self.rpow(other)

    def __eq__(self, other):
        return self.eq(other)

    def __ne__(self, other):
        return self.ne(other)

    def __lt__(self, other):
        return self.lt(other)

    def __le__(self, other):
        return self.le(other)

    def __gt__(self, other):
        return self.gt(other)

    def __ge__(self, other):
        return self.ge(other)

    def __and__(self, other):
        return self._binary_op("__and__", other, axis=0)

    def __rand__(self, other):
        return self._binary_op("__rand__", other, axis=0)

    def __or__(self, other):
        return self._binary_op("__or__", other, axis=0)

    def __ror__(self, other):
        return self._binary_op("__ror__", other, axis=0)

    def __xor__(self, other):
        return self._binary_op("__xor__", other, axis=0)

    def __rxor__(self, other):
        return self._binary_op("__rxor__", other, axis=0)

    def __neg__(self):
        return self._create_or_update_from_compiler(self._query_compiler.negative())

    def __invert__(self):
        return self._create_or_update_from_compiler(self._query_compiler.invert())

    def __abs__(self):
        return self.abs()

    def __round__(self, decimals: int = 0):
        return self.round(decimals)

    def __bool__(self) -> bool:
        raise ValueError(
            f"The truth value of a {type(self).__name__} is ambiguous. Use a.empty, "
            "a.bool(), a.item(), a.any() or a.all()."
        )

    def __hash__(self):
        raise TypeError(f"unhashable type: '{type(self).__name__}'")

    # ------------------------------------------------------------------ #
    # Elementwise maps
    # ------------------------------------------------------------------ #

    def abs(self):
        return self._create_or_update_from_compiler(self._query_compiler.abs())

    def round(self, decimals: int = 0, *args: Any, **kwargs: Any):
        return self._create_or_update_from_compiler(
            self._query_compiler.round(decimals=decimals)
        )

    def isna(self):
        return self._create_or_update_from_compiler(self._query_compiler.isna())

    isnull = isna

    def notna(self):
        return self._create_or_update_from_compiler(self._query_compiler.notna())

    notnull = notna

    def convert_dtypes(self, *args: Any, **kwargs: Any):
        return self._create_or_update_from_compiler(
            self._query_compiler.convert_dtypes(*args, **kwargs)
        )

    def infer_objects(self, copy: Any = None):
        return self._create_or_update_from_compiler(self._query_compiler.infer_objects())

    def astype(self, dtype: Any, copy: Any = None, errors: str = "raise"):
        if isinstance(dtype, dict) and self.ndim == 1:
            raise KeyError("Only the Series name can be used for the key in Series dtype mappings.")
        return self._create_or_update_from_compiler(
            self._query_compiler.astype(dtype, errors=errors)
        )

    def clip(self, lower: Any = None, upper: Any = None, *, axis: Any = None, inplace: bool = False, **kwargs: Any):
        axis = self._get_axis_number(axis) if axis is not None else None
        return self._create_or_update_from_compiler(
            self._query_compiler.clip(lower, upper, axis=axis, **kwargs), inplace
        )

    def fillna(
        self,
        value: Any = None,
        *,
        axis: Any = None,
        inplace: bool = False,
        limit: Optional[int] = None,
        downcast: Any = no_default,
    ):
        axis = self._get_axis_number(axis) if axis is not None else 0
        if isinstance(value, BasePandasDataset):
            value = value._query_compiler
        squeeze_value = (
            getattr(value, "_shape_hint", None) == "column"
            if value is not None and hasattr(value, "to_pandas")
            else False
        )
        new_qc = self._query_compiler.fillna(
            squeeze_self=self.ndim == 1,
            squeeze_value=squeeze_value,
            value=value,
            axis=axis,
            limit=limit,
        )
        return self._create_or_update_from_compiler(new_qc, inplace)

    def ffill(self, *, axis: Any = None, inplace: bool = False, limit: Optional[int] = None, limit_area: Any = None):
        return self._create_or_update_from_compiler(
            self._query_compiler.ffill(axis=axis, limit=limit), inplace
        )

    def bfill(self, *, axis: Any = None, inplace: bool = False, limit: Optional[int] = None, limit_area: Any = None):
        return self._create_or_update_from_compiler(
            self._query_compiler.bfill(axis=axis, limit=limit), inplace
        )

    def dropna(self, *, axis: Any = 0, how: Any = no_default, thresh: Any = no_default, subset: Any = None, inplace: bool = False, ignore_index: bool = False):
        axis = self._get_axis_number(axis)
        kwargs = {"axis": axis, "subset": subset, "ignore_index": ignore_index}
        if how is not no_default:
            kwargs["how"] = how
        if thresh is not no_default:
            kwargs["thresh"] = thresh
        if self.ndim == 1:
            kwargs.pop("subset")
            kwargs.pop("ignore_index") if "ignore_index" not in pandas.Series.dropna.__code__.co_varnames else None
        return self._create_or_update_from_compiler(
            self._query_compiler.dropna(**kwargs), inplace
        )

    def replace(self, to_replace: Any = None, value: Any = no_default, *, inplace: bool = False, regex: bool = False):
        kwargs = {"to_replace": to_replace, "regex": regex}
        if value is not no_default:
            kwargs["value"] = value
        return self._create_or_update_from_compiler(
            self._query_compiler.replace(**kwargs), inplace
        )

    # ------------------------------------------------------------------ #
    # Reductions
    # ------------------------------------------------------------------ #

    def _agg_reduce(self, op_name: str, axis: Any, skipna: bool = True, numeric_only: bool = False, **kwargs: Any):
        return self._stat_operation(op_name, axis, skipna, numeric_only, **kwargs)

    def sum(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False, min_count: int = 0, **kwargs: Any):
        return self._stat_operation("sum", axis, skipna, numeric_only, min_count=min_count, **kwargs)

    def prod(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False, min_count: int = 0, **kwargs: Any):
        return self._stat_operation("prod", axis, skipna, numeric_only, min_count=min_count, **kwargs)

    product = prod

    def mean(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False, **kwargs: Any):
        return self._stat_operation("mean", axis, skipna, numeric_only, **kwargs)

    def median(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False, **kwargs: Any):
        return self._stat_operation("median", axis, skipna, numeric_only, **kwargs)

    def std(self, axis: Any = 0, skipna: bool = True, ddof: int = 1, numeric_only: bool = False, **kwargs: Any):
        return self._stat_operation("std", axis, skipna, numeric_only, ddof=ddof, **kwargs)

    def var(self, axis: Any = 0, skipna: bool = True, ddof: int = 1, numeric_only: bool = False, **kwargs: Any):
        return self._stat_operation("var", axis, skipna, numeric_only, ddof=ddof, **kwargs)

    def sem(self, axis: Any = 0, skipna: bool = True, ddof: int = 1, numeric_only: bool = False, **kwargs: Any):
        return self._stat_operation("sem", axis, skipna, numeric_only, ddof=ddof, **kwargs)

    def skew(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False, **kwargs: Any):
        return self._stat_operation("skew", axis, skipna, numeric_only, **kwargs)

    def kurt(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False, **kwargs: Any):
        return self._stat_operation("kurt", axis, skipna, numeric_only, **kwargs)

    kurtosis = kurt

    def min(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False, **kwargs: Any):
        return self._stat_operation("min", axis, skipna, numeric_only, **kwargs)

    def max(self, axis: Any = 0, skipna: bool = True, numeric_only: bool = False, **kwargs: Any):
        return self._stat_operation("max", axis, skipna, numeric_only, **kwargs)

    def count(self, axis: Any = 0, numeric_only: bool = False):
        axis = self._get_axis_number(axis)
        return self._reduce_dimension(
            self._query_compiler.count(axis=axis, numeric_only=numeric_only)
        )

    def any(self, *, axis: Any = 0, bool_only: bool = False, skipna: bool = True, **kwargs: Any):
        axis = self._get_axis_number(axis) if axis is not None else None
        return self._reduce_dimension(
            self._query_compiler.any(axis=axis, bool_only=bool_only, skipna=skipna)
        )

    def all(self, axis: Any = 0, bool_only: bool = False, skipna: bool = True, **kwargs: Any):
        axis = self._get_axis_number(axis) if axis is not None else None
        return self._reduce_dimension(
            self._query_compiler.all(axis=axis, bool_only=bool_only, skipna=skipna)
        )

    def nunique(self, axis: Any = 0, dropna: bool = True):
        axis = self._get_axis_number(axis)
        result = self._query_compiler.nunique(axis=axis, dropna=dropna)
        if self.ndim == 1:
            return result.to_pandas().squeeze() if hasattr(result, "to_pandas") else result
        return self._reduce_dimension(result)

    def memory_usage(self, index: bool = True, deep: bool = False):
        return self._default_to_pandas("memory_usage", index=index, deep=deep)

    # ------------------------------------------------------------------ #
    # Cumulative ops
    # ------------------------------------------------------------------ #

    def _cum_operation(self, op_name: str, axis: Any, skipna: bool, *args: Any, **kwargs: Any):
        axis = self._get_axis_number(axis)
        return self._create_or_update_from_compiler(
            getattr(self._query_compiler, op_name)(axis=axis, skipna=skipna)
        )

    def cumsum(self, axis: Any = 0, skipna: bool = True, *args: Any, **kwargs: Any):
        return self._cum_operation("cumsum", axis, skipna, *args, **kwargs)

    def cumprod(self, axis: Any = 0, skipna: bool = True, *args: Any, **kwargs: Any):
        return self._cum_operation("cumprod", axis, skipna, *args, **kwargs)

    def cummax(self, axis: Any = 0, skipna: bool = True, *args: Any, **kwargs: Any):
        return self._cum_operation("cummax", axis, skipna, *args, **kwargs)

    def cummin(self, axis: Any = 0, skipna: bool = True, *args: Any, **kwargs: Any):
        return self._cum_operation("cummin", axis, skipna, *args, **kwargs)

    # ------------------------------------------------------------------ #
    # Ordering & window
    # ------------------------------------------------------------------ #

    def sort_index(
        self,
        *,
        axis: Any = 0,
        level: Any = None,
        ascending: bool = True,
        inplace: bool = False,
        kind: str = "quicksort",
        na_position: str = "last",
        sort_remaining: bool = True,
        ignore_index: bool = False,
        key: Any = None,
    ):
        axis = self._get_axis_number(axis)
        new_qc = self._query_compiler.sort_index(
            axis=axis,
            level=level,
            ascending=ascending,
            kind=kind,
            na_position=na_position,
            sort_remaining=sort_remaining,
            ignore_index=ignore_index,
            key=key,
        )
        return self._create_or_update_from_compiler(new_qc, inplace)

    def diff(self, periods: int = 1, axis: Any = 0):
        axis = self._get_axis_number(axis)
        kwargs = {"periods": periods}
        if self.ndim == 2:
            kwargs["axis"] = axis
        return self._create_or_update_from_compiler(
            self._query_compiler.diff(**kwargs)
        )

    def shift(self, periods: int = 1, freq: Any = None, axis: Any = 0, fill_value: Any = no_default, suffix: Any = None):
        kwargs = {"periods": periods, "freq": freq}
        if fill_value is not no_default:
            kwargs["fill_value"] = fill_value
        if self.ndim == 2:
            kwargs["axis"] = self._get_axis_number(axis)
        return self._create_or_update_from_compiler(self._query_compiler.shift(**kwargs))

    def rolling(self, window: Any, min_periods: Any = None, center: bool = False, win_type: Any = None,
                on: Any = None, closed: Any = None, step: Any = None, method: str = "single"):
        from modin_tpu_torch.pandas.window import Rolling

        return Rolling(
            self, window=window, min_periods=min_periods, center=center, win_type=win_type,
            on=on, closed=closed, step=step, method=method,
        )

    def expanding(self, min_periods: int = 1, method: str = "single"):
        from modin_tpu_torch.pandas.window import Expanding

        return Expanding(self, min_periods=min_periods, method=method)

    def ewm(self, com: Any = None, span: Any = None, halflife: Any = None, alpha: Any = None,
            min_periods: Any = 0, adjust: bool = True, ignore_na: bool = False, times: Any = None,
            method: str = "single"):
        from modin_tpu_torch.pandas.window import Ewm

        return Ewm(
            self, com=com, span=span, halflife=halflife, alpha=alpha, min_periods=min_periods,
            adjust=adjust, ignore_na=ignore_na, times=try_cast_to_pandas(times, squeeze=True),
            method=method,
        )

    def resample(self, rule: Any, axis: Any = no_default, closed: Any = None, label: Any = None,
                 convention: Any = no_default, on: Any = None, level: Any = None,
                 origin: Any = "start_day", offset: Any = None, group_keys: bool = False):
        from modin_tpu_torch.pandas.resample import Resampler

        return Resampler(
            self, rule=rule, closed=closed, label=label, on=on, level=level,
            origin=origin, offset=offset, group_keys=group_keys,
        )

    def rank(
        self,
        axis: Any = 0,
        method: str = "average",
        numeric_only: bool = False,
        na_option: str = "keep",
        ascending: bool = True,
        pct: bool = False,
    ):
        kwargs = dict(
            method=method,
            numeric_only=numeric_only,
            na_option=na_option,
            ascending=ascending,
            pct=pct,
        )
        if self.ndim == 2:
            kwargs["axis"] = self._get_axis_number(axis)
        return self._create_or_update_from_compiler(self._query_compiler.rank(**kwargs))

    def pct_change(self, periods: int = 1, fill_method: Any = no_default, limit: Any = no_default, freq: Any = None, **kwargs: Any):
        return self._default_to_pandas("pct_change", periods=periods, freq=freq, **kwargs)

    # ------------------------------------------------------------------ #
    # Selection
    # ------------------------------------------------------------------ #

    def head(self, n: int = 5):
        if n == 0:
            return self.iloc[:0]
        return self.iloc[:n]

    def tail(self, n: int = 5):
        if n == 0:
            return self.iloc[len(self) :]
        return self.iloc[-n:]

    def first(self, offset: Any):
        return self._default_to_pandas("first", offset)

    def last(self, offset: Any):
        return self._default_to_pandas("last", offset)

    def take(self, indices: Any, axis: Any = 0, **kwargs: Any):
        axis = self._get_axis_number(axis)
        if axis == 0:
            if isinstance(indices, slice):
                indices = range(*indices.indices(len(self)))
            else:
                n = len(self)
                indices = [i if i >= 0 else n + i for i in np.asarray(indices)]
            return self._create_or_update_from_compiler(
                self._query_compiler.getitem_row_array(indices)
            )
        n = self._query_compiler.get_axis_len(1)
        indices = [i if i >= 0 else n + i for i in np.asarray(indices)]
        return self._create_or_update_from_compiler(
            self._query_compiler.getitem_column_array(indices, numeric=True)
        )

    def sample(
        self,
        n: Optional[int] = None,
        frac: Optional[float] = None,
        replace: bool = False,
        weights: Any = None,
        random_state: Any = None,
        axis: Any = None,
        ignore_index: bool = False,
    ):
        axis = self._get_axis_number(axis) if axis is not None else 0
        if weights is not None or axis == 1:
            return self._default_to_pandas(
                "sample", n=n, frac=frac, replace=replace, weights=weights,
                random_state=random_state, axis=axis, ignore_index=ignore_index,
            )
        if n is None and frac is None:
            n = 1
        length = len(self)
        if n is None:
            n = int(length * frac)
        # pandas resolves seeds through np.random.RandomState (com.random_state),
        # so an int random_state must reproduce pandas' exact draw
        if isinstance(
            random_state, (np.random.RandomState, np.random.Generator)
        ):
            rng = random_state
        elif random_state is None:
            rng = np.random.default_rng()
        else:
            rng = np.random.RandomState(random_state)
        positions = rng.choice(length, n, replace=replace)
        result = self._create_or_update_from_compiler(
            self._query_compiler.getitem_row_array(list(positions))
        )
        if ignore_index:
            result.index = pandas.RangeIndex(len(result.index))
        return result

    def reindex(self, index: Any = None, columns: Any = None, copy: Any = None, **kwargs: Any):
        new_qc = None
        if index is not None:
            if not isinstance(index, pandas.Index):
                index = pandas.Index(index)
            if not index.equals(self.index):
                new_qc = self._query_compiler.reindex(axis=0, labels=index, **kwargs)
        if new_qc is None:
            new_qc = self._query_compiler
        final_qc = new_qc
        if columns is not None and self.ndim == 2:
            if not isinstance(columns, pandas.Index):
                columns = pandas.Index(columns)
            if not columns.equals(new_qc.columns):
                final_qc = new_qc.reindex(axis=1, labels=columns, **kwargs)
        return self._create_or_update_from_compiler(final_qc)

    def reindex_like(
        self,
        other: Any,
        method: Any = None,
        copy: Any = no_default,
        limit: Any = None,
        tolerance: Any = None,
    ):
        kwargs: dict = {}
        if method is not None:
            kwargs["method"] = method
        if limit is not None:
            kwargs["limit"] = limit
        if tolerance is not None:
            kwargs["tolerance"] = tolerance
        return self.reindex(
            index=other.index,
            columns=other.columns if self.ndim == 2 else None,
            **kwargs,
        )

    def rename_axis(
        self,
        mapper: Any = no_default,
        *,
        index: Any = no_default,
        columns: Any = no_default,
        axis: Any = 0,
        copy: Any = None,
        inplace: bool = False,
    ):
        # metadata-only: pandas resolves the mapper semantics against an empty
        # shell carrying our axis labels, then the new names apply in place
        obj = self if inplace else self.copy()
        if self.ndim == 2:
            shell = pandas.DataFrame(index=self.index[:0], columns=self.columns)
            shell.rename_axis(
                mapper, index=index, columns=columns, axis=axis, inplace=True
            )
            if list(shell.index.names) != list(obj.index.names):
                obj.index = obj.index.set_names(shell.index.names)
            if list(shell.columns.names) != list(obj.columns.names):
                obj.columns = obj.columns.set_names(shell.columns.names)
        else:
            shell = pandas.Series(index=self.index[:0], dtype="float64")
            shell.rename_axis(mapper, index=index, axis=axis, inplace=True)
            if list(shell.index.names) != list(obj.index.names):
                obj.index = obj.index.set_names(shell.index.names)
        return None if inplace else obj

    def drop(
        self,
        labels: Any = None,
        *,
        axis: Any = 0,
        index: Any = None,
        columns: Any = None,
        level: Any = None,
        inplace: bool = False,
        errors: str = "raise",
    ):
        if labels is not None:
            if index is not None or columns is not None:
                raise ValueError("Cannot specify both 'labels' and 'index'/'columns'")
            axis_num = self._get_axis_number(axis)
            if axis_num == 0:
                index = labels
            else:
                columns = labels
        if level is not None:
            return self._create_or_update_from_compiler(
                self._default_to_pandas(
                    "drop", index=index, columns=columns, level=level, errors=errors
                )._query_compiler,
                inplace,
            )
        # validate labels exist when errors='raise'
        if errors == "raise":
            if index is not None:
                missing = pandas.Index(np.atleast_1d(np.asarray(index, dtype=object))).difference(self.index)
                if len(missing):
                    raise KeyError(f"{list(missing)} not found in axis")
            if columns is not None and self.ndim == 2:
                missing = pandas.Index(np.atleast_1d(np.asarray(columns, dtype=object))).difference(self.columns)
                if len(missing):
                    raise KeyError(f"{list(missing)} not found in axis")
        new_qc = self._query_compiler.drop(index=index, columns=columns, errors=errors)
        return self._create_or_update_from_compiler(new_qc, inplace)

    def reset_index(
        self,
        level: Any = None,
        *,
        drop: bool = False,
        inplace: bool = False,
        col_level: Any = 0,
        col_fill: Any = "",
        allow_duplicates: Any = no_default,
        names: Any = None,
    ):
        kwargs = {
            "level": level,
            "drop": drop,
            "col_level": col_level,
            "col_fill": col_fill,
            "names": names,
        }
        if self.ndim == 1:
            kwargs = {"level": level, "drop": drop, "names": names}
            if not drop:
                from modin_tpu_torch.pandas.series import Series

                return Series(query_compiler=self._query_compiler)._series_reset_index(
                    level, names, inplace
                )
        new_qc = self._query_compiler.reset_index(**kwargs)
        return self._create_or_update_from_compiler(new_qc, inplace)

    def set_axis(self, labels: Any, *, axis: Any = 0, copy: Any = None):
        obj = self.copy()
        setattr(obj, "index" if self._get_axis_number(axis) == 0 else "columns", labels)
        return obj

    def add_prefix(self, prefix: str, axis: Any = None):
        axis = self._get_axis_number(axis) if axis is not None else (0 if self.ndim == 1 else 1)
        return self._create_or_update_from_compiler(
            self._query_compiler.add_prefix(prefix, axis=axis)
            if self.ndim == 2
            else self._query_compiler.add_prefix(prefix)
        )

    def add_suffix(self, suffix: str, axis: Any = None):
        axis = self._get_axis_number(axis) if axis is not None else (0 if self.ndim == 1 else 1)
        return self._create_or_update_from_compiler(
            self._query_compiler.add_suffix(suffix, axis=axis)
            if self.ndim == 2
            else self._query_compiler.add_suffix(suffix)
        )

    def truncate(self, before: Any = None, after: Any = None, axis: Any = None, copy: Any = None):
        return self._default_to_pandas("truncate", before=before, after=after, axis=axis)

    def droplevel(self, level: Any, axis: Any = 0):
        return self._default_to_pandas("droplevel", level, axis=axis)

    def squeeze(self, axis: Any = None):
        axis = self._get_axis_number(axis) if axis is not None else None
        if self.ndim == 1:
            if len(self) == 1 and axis in (None, 0):
                return self._to_pandas().squeeze()
            return self.copy()
        # DataFrame
        nrows, ncols = len(self), len(self.columns)
        from modin_tpu_torch.pandas.series import Series

        if axis == 1 or (axis is None and ncols == 1):
            if ncols == 1:
                result_qc = self._query_compiler.columnarize()
                if axis is None and nrows == 1:
                    return self._to_pandas().squeeze()
                return Series(query_compiler=result_qc)
            if axis == 1:
                return self.copy()
        if axis == 0 or (axis is None and nrows == 1):
            if nrows == 1:
                return self._default_to_pandas("squeeze", axis=axis)
            if axis == 0:
                return self.copy()
        return self.copy()

    def between_time(self, start_time: Any, end_time: Any, inclusive: str = "both", axis: Any = None):
        return self._default_to_pandas(
            "between_time", start_time, end_time, inclusive=inclusive, axis=axis
        )

    def at_time(self, time: Any, asof: bool = False, axis: Any = None):
        return self._default_to_pandas("at_time", time, asof=asof, axis=axis)

    def first_valid_index(self):
        return self._query_compiler.first_valid_index()

    def last_valid_index(self):
        return self._query_compiler.last_valid_index()

    # ------------------------------------------------------------------ #
    # Function application
    # ------------------------------------------------------------------ #

    def pipe(self, func: Any, *args: Any, **kwargs: Any):
        if isinstance(func, tuple):
            func, target = func
            if target in kwargs:
                raise ValueError(f"{target} is both the pipe target and a keyword argument")
            kwargs[target] = self
            return func(*args, **kwargs)
        return func(self, *args, **kwargs)

    def transform(self, func: Any, axis: Any = 0, *args: Any, **kwargs: Any):
        return self._default_to_pandas("transform", func, axis, *args, **kwargs)

    # ------------------------------------------------------------------ #
    # Combination
    # ------------------------------------------------------------------ #

    def align(self, other: Any, **kwargs: Any):
        left, right = self._default_to_pandas(
            "align", other._to_pandas() if isinstance(other, BasePandasDataset) else other, **kwargs
        )
        return left, right

    def combine(self, other: Any, func: Any, fill_value: Any = None, **kwargs: Any):
        return self._binary_op("combine", other, func=func, fill_value=fill_value)

    def combine_first(self, other: Any):
        return self._binary_op("combine_first", other)

    def where(self, cond: Any, other: Any = np.nan, *, inplace: bool = False, axis: Any = None, level: Any = None):
        if callable(cond) or callable(other):
            return self._create_or_update_from_compiler(
                self._default_to_pandas(
                    "where", cond, other, axis=axis, level=level
                )._query_compiler,
                inplace,
            )
        if isinstance(cond, BasePandasDataset):
            cond = cond._query_compiler
        if isinstance(other, BasePandasDataset):
            other = other._query_compiler
        return self._create_or_update_from_compiler(
            self._query_compiler.where(cond, other, axis=axis, level=level), inplace
        )

    def mask(self, cond: Any, other: Any = np.nan, *, inplace: bool = False, axis: Any = None, level: Any = None):
        if callable(cond) or callable(other):
            return self._create_or_update_from_compiler(
                self._default_to_pandas(
                    "mask", cond, other, axis=axis, level=level
                )._query_compiler,
                inplace,
            )
        if isinstance(cond, BasePandasDataset):
            inverted = ~cond
        else:
            inverted = ~np.asarray(cond)
        return self.where(inverted, other, inplace=inplace, axis=axis, level=level)

    def isin(self, values: Any):
        ignore_indices = isinstance(values, BasePandasDataset) and values.ndim == 1
        if isinstance(values, BasePandasDataset):
            values = values._query_compiler
        return self._create_or_update_from_compiler(
            self._query_compiler.isin(values, ignore_indices=ignore_indices)
        )

    # ------------------------------------------------------------------ #
    # IO / export
    # ------------------------------------------------------------------ #

    def to_csv(self, path_or_buf: Any = None, **kwargs: Any):
        from modin_tpu_torch.core.execution.dispatching.factories.dispatcher import (
            FactoryDispatcher,
        )

        return FactoryDispatcher.to_csv(self._query_compiler, path_or_buf=path_or_buf, **kwargs)

    def to_json(self, path_or_buf: Any = None, **kwargs: Any):
        from modin_tpu_torch.core.execution.dispatching.factories.dispatcher import (
            FactoryDispatcher,
        )

        return FactoryDispatcher.to_json(self._query_compiler, path_or_buf=path_or_buf, **kwargs)

    def to_sql(self, name: str, con: Any, **kwargs: Any):
        from modin_tpu_torch.core.execution.dispatching.factories.dispatcher import (
            FactoryDispatcher,
        )

        return FactoryDispatcher.to_sql(self._query_compiler, name=name, con=con, **kwargs)

    def to_hdf(self, path_or_buf: Any, *, key: str, **kwargs: Any):
        from modin_tpu_torch.core.execution.dispatching.factories.dispatcher import (
            FactoryDispatcher,
        )

        return FactoryDispatcher.to_hdf(self._query_compiler, path_or_buf=path_or_buf, key=key, **kwargs)

    def to_excel(self, excel_writer: Any, *args: Any, **kwargs: Any):
        from modin_tpu_torch.core.execution.dispatching.factories.dispatcher import (
            FactoryDispatcher,
        )

        if args:
            # positionals (sheet_name, na_rep, ...) bound onto their names
            bound = inspect.signature(pandas.DataFrame.to_excel).bind(self, excel_writer, *args, **kwargs)
            kwargs = {k: v for k, v in bound.arguments.items() if k not in ("self", "excel_writer")}
        return FactoryDispatcher.to_excel(self._query_compiler, excel_writer=excel_writer, **kwargs)

    def to_dict(self, *args: Any, **kwargs: Any):
        return self._default_to_pandas("to_dict", *args, **kwargs)

    def to_string(self, *args: Any, **kwargs: Any):
        return self._default_to_pandas("to_string", *args, **kwargs)

    def to_latex(self, *args: Any, **kwargs: Any):
        return self._default_to_pandas("to_latex", *args, **kwargs)

    def to_markdown(self, *args: Any, **kwargs: Any):
        return self._default_to_pandas("to_markdown", *args, **kwargs)

    def to_clipboard(self, *args: Any, **kwargs: Any):
        return self._default_to_pandas("to_clipboard", *args, **kwargs)

    def to_xarray(self, *args: Any, **kwargs: Any):
        return self._default_to_pandas("to_xarray", *args, **kwargs)

    # ------------------------------------------------------------------ #
    # Pickle support (by value)
    # ------------------------------------------------------------------ #

    def __getstate__(self) -> dict:
        return {"_pandas_obj": self._to_pandas()}

    def __setstate__(self, state: dict) -> None:
        pandas_obj = state["_pandas_obj"]
        if isinstance(pandas_obj, pandas.Series):
            pandas_obj = pandas_obj.to_frame(
                pandas_obj.name if pandas_obj.name is not None else MODIN_UNNAMED_SERIES_LABEL
            )
            qc = TorchQueryCompiler.from_pandas(pandas_obj)
            qc._shape_hint = "column"
        else:
            qc = TorchQueryCompiler.from_pandas(pandas_obj)
        self._set_query_compiler(qc)

    # ------------------------------------------------------------------ #
    # Indexer properties (shared)
    # ------------------------------------------------------------------ #

    @property
    def loc(self):
        from modin_tpu_torch.pandas.indexing import _LocIndexer

        return _LocIndexer(self)

    @property
    def iloc(self):
        from modin_tpu_torch.pandas.indexing import _iLocIndexer

        return _iLocIndexer(self)

    @property
    def at(self):
        from modin_tpu_torch.pandas.indexing import _AtIndexer

        return _AtIndexer(self)

    @property
    def iat(self):
        from modin_tpu_torch.pandas.indexing import _iAtIndexer

        return _iAtIndexer(self)

    # ------------------------------------------------------------------ #
    # Misc
    # ------------------------------------------------------------------ #

    @property
    def flags(self):
        return self._default_to_pandas(lambda df: df.flags)

    @property
    def attrs(self) -> dict:
        if not hasattr(self, "_attrs"):
            object.__setattr__(self, "_attrs", {})
        return self._attrs

    @attrs.setter
    def attrs(self, value: dict) -> None:
        object.__setattr__(self, "_attrs", dict(value))

    def set_flags(self, *, copy: Any = None, allows_duplicate_labels: Any = None):
        return self._default_to_pandas(
            "set_flags", allows_duplicate_labels=allows_duplicate_labels
        )

    def get(self, key: Any, default: Any = None):
        try:
            return self.__getitem__(key)
        except (KeyError, ValueError, IndexError):
            return default

    def asof(self, where: Any, subset: Any = None):
        return self._default_to_pandas("asof", where, subset=subset)

    def interpolate(self, *args: Any, **kwargs: Any):
        return self._default_to_pandas("interpolate", *args, **kwargs)

    def xs(self, key: Any, axis: Any = 0, level: Any = None, drop_level: bool = True):
        return self._default_to_pandas("xs", key, axis=axis, level=level, drop_level=drop_level)

    def swaplevel(self, i: Any = -2, j: Any = -1, axis: Any = 0):
        return self._default_to_pandas("swaplevel", i=i, j=j, axis=axis)

    def reorder_levels(self, order: Any, axis: Any = 0):
        return self._default_to_pandas("reorder_levels", order, axis=axis)

    def tz_convert(self, tz: Any, axis: Any = 0, level: Any = None, copy: Any = None):
        return self._default_to_pandas("tz_convert", tz, axis=axis, level=level)

    def tz_localize(self, tz: Any, axis: Any = 0, level: Any = None, copy: Any = None, ambiguous: Any = "raise", nonexistent: Any = "raise"):
        return self._default_to_pandas(
            "tz_localize", tz, axis=axis, level=level, ambiguous=ambiguous, nonexistent=nonexistent
        )

    def to_period(self, *args: Any, **kwargs: Any):
        return self._default_to_pandas("to_period", *args, **kwargs)

    def to_timestamp(self, *args: Any, **kwargs: Any):
        return self._default_to_pandas("to_timestamp", *args, **kwargs)

    def asfreq(self, *args: Any, **kwargs: Any):
        return self._default_to_pandas("asfreq", *args, **kwargs)

    def filter(self, items: Any = None, like: Any = None, regex: Any = None, axis: Any = None):
        nkw = sum(x is not None for x in (items, like, regex))
        if nkw > 1:
            raise TypeError("Keyword arguments `items`, `like`, or `regex` are mutually exclusive")
        if axis is None:
            axis = 1 if self.ndim == 2 else 0
        axis = self._get_axis_number(axis)
        labels = self.columns if axis == 1 else self.index
        if items is not None:
            keep = [label for label in items if label in labels]
        elif like is not None:
            keep = [label for label in labels if like in str(label)]
        else:
            matcher = re.compile(regex)
            keep = [label for label in labels if matcher.search(str(label))]
        if axis == 1:
            return self[keep] if self.ndim == 2 else self
        return self.loc[keep]

    def __finalize__(self, other: Any, method: Any = None, **kwargs: Any):
        return self

    def __nonzero__(self):
        raise ValueError(
            f"The truth value of a {type(self).__name__} is ambiguous. Use a.empty, "
            "a.bool(), a.item(), a.any() or a.all()."
        )


def _install_fallbacks(modin_cls: type, pandas_cls: type) -> None:
    """Generate default-to-pandas wrappers for every pandas API member the
    port's class doesn't implement explicitly: this is how the whole pandas
    surface exists on the port."""

    def make_method(name: str, pandas_method: Any):
        @functools.wraps(pandas_method)
        def fallback(self, *args: Any, **kwargs: Any):
            return self._default_to_pandas(name, *args, **kwargs)

        fallback.__name__ = name
        return fallback

    def make_property(name: str):
        def getter(self):
            result = self._default_to_pandas(
                lambda pandas_obj: getattr(pandas_obj, name)
            )
            return result

        def setter(self, value):
            # materialize, delegate the assignment to pandas (so non-settable
            # properties raise pandas' own error), and resync in place
            pandas_obj = self._to_pandas()
            setattr(pandas_obj, name, value)
            self._update_inplace_from_pandas(pandas_obj)

        return property(getter, setter)

    def make_classmethod(name: str):
        def cm(cls, *args: Any, **kwargs: Any):
            result = getattr(pandas_cls, name)(*args, **kwargs)
            if isinstance(result, (pandas.DataFrame, pandas.Series)):
                return cls(result)
            return result

        cm.__name__ = name
        return classmethod(cm)

    defined = set()
    for klass in modin_cls.__mro__:
        if klass in (object,):
            continue
        if klass.__module__.startswith("modin_tpu_torch"):
            defined.update(vars(klass).keys())

    for name in dir(pandas_cls):
        if name in defined or name in _DEFAULT_BEHAVIOUR:
            continue
        if name.startswith("_") and not name.startswith("__"):
            continue
        try:
            attr = getattr(pandas_cls, name)
        except Exception:
            continue
        raw = inspect.getattr_static(pandas_cls, name)
        if isinstance(raw, (classmethod, staticmethod)):
            setattr(modin_cls, name, make_classmethod(name))
        elif isinstance(attr, property):
            setattr(modin_cls, name, make_property(name))
        elif isinstance(attr, functools.cached_property):
            setattr(modin_cls, name, make_property(name))
        elif callable(attr):
            setattr(modin_cls, name, make_method(name, attr))
        else:
            # plain class attribute (e.g. dtype sentinel) — copy the value
            try:
                setattr(modin_cls, name, attr)
            except Exception:
                pass
