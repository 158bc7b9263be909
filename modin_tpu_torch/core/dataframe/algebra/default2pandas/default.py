"""``DefaultMethod`` — build a QC method from any pandas callable by materializing.

The port's counterpart of ``modin_tpu/core/dataframe/algebra/default2pandas/
default.py``.  This is the correctness backstop: every query-compiler
operation has a default implementation that gathers the frame to host pandas,
applies the pandas kernel, and re-wraps the result.  The torch compiler
overrides the hot subset.  Each default passes through
``ErrorMessage.default_to_pandas``, which counts it in
``query_compiler.DEFAULTS_TO_PANDAS``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import pandas

from modin_tpu_torch.error_message import ErrorMessage
from modin_tpu_torch.utils import MODIN_UNNAMED_SERIES_LABEL


class ObjTypeDeterminer:
    """Pass-through target: look the function up on the object itself."""

    def __getattr__(self, key: str) -> Callable:
        def func(df: Any, *args: Any, **kwargs: Any) -> Any:
            return getattr(df, key)(*args, **kwargs)

        return func


class DefaultMethod:
    """Maker of default-to-pandas query-compiler methods.

    ``register(func)`` returns a ``caller(query_compiler, *args, **kwargs)``
    that materializes, applies ``func`` against the (possibly accessor-wrapped)
    pandas object, and wraps DataFrame/Series results back into a QC.
    """

    OBJECT_TYPE = "DataFrame"
    # the pandas class the registered function is applied against
    DEFAULT_OBJECT_TYPE = pandas.DataFrame

    @classmethod
    def frame_wrapper(cls, df: pandas.DataFrame) -> Any:
        """Extract the object to apply the function against (df, series, accessor...)."""
        return df

    @classmethod
    def get_func(cls, func: Union[str, property, Callable], obj_type: Any) -> Callable:
        if isinstance(func, str):
            fn = getattr(obj_type, func, None)
            if fn is None:
                fn = getattr(ObjTypeDeterminer(), func)
            func = fn
        if isinstance(func, property):
            fget = func.fget

            def applyier(df: Any, *args: Any, **kwargs: Any) -> Any:
                return fget(df)

            return applyier
        if not callable(func):
            raise TypeError(f"Cannot build a default method from {func!r}")
        return func

    @classmethod
    def register(
        cls,
        func: Union[str, property, Callable],
        obj_type: Optional[Any] = None,
        inplace: Optional[bool] = None,
        fn_name: Optional[str] = None,
        squeeze_self: bool = False,
    ) -> Callable:
        """Build a QC-level default method applying ``func`` via host pandas."""
        if obj_type is None:
            obj_type = cls.DEFAULT_OBJECT_TYPE
        fn = cls.get_func(func, obj_type)
        fn_display_name = fn_name or getattr(
            func, "__name__", getattr(fn, "__name__", str(func))
        )

        def caller(query_compiler: Any, *args: Any, **kwargs: Any) -> Any:
            df = query_compiler.to_pandas()
            if squeeze_self:
                df = df.squeeze(axis=1)
            target = cls.frame_wrapper(df)
            ErrorMessage.default_to_pandas(
                f"`{cls.OBJECT_TYPE}.{fn_display_name}`"
            )
            result = fn(target, *args, **kwargs)
            if inplace or (inplace is None and result is None):
                result = df
            return cls.build_output(query_compiler, result)

        caller.__name__ = fn_display_name
        # generated straight from the pandas callable: safe to invoke with
        # pandas-signature args (the routing tables key off this marker)
        caller._pandas_signature_default = True
        return caller

    @classmethod
    def build_output(cls, query_compiler: Any, result: Any) -> Any:
        """Wrap a pandas result back into a query compiler when 2-D/1-D."""
        was_series = isinstance(result, pandas.Series)
        if was_series:
            name = result.name if result.name is not None else MODIN_UNNAMED_SERIES_LABEL
            result = result.to_frame(name)
        if isinstance(result, pandas.DataFrame):
            out = query_compiler.__constructor__.from_pandas(result)
            if was_series:
                # consumers (API fallback routing) wrap hint=="column" results
                # back as Series
                out._shape_hint = "column"
            return out
        return result


class DataFrameDefault(DefaultMethod):
    OBJECT_TYPE = "DataFrame"
    DEFAULT_OBJECT_TYPE = pandas.DataFrame


class SeriesDefault(DefaultMethod):
    OBJECT_TYPE = "Series"
    DEFAULT_OBJECT_TYPE = pandas.Series

    @classmethod
    def frame_wrapper(cls, df: pandas.DataFrame) -> pandas.Series:
        series = df.squeeze(axis=1)
        if (
            isinstance(series, pandas.Series)
            and series.name == MODIN_UNNAMED_SERIES_LABEL
        ):
            # the internal placeholder must not leak into results that carry
            # the series name (e.g. value_counts' index name)
            series = series.rename(None)
        return series


class StrDefault(SeriesDefault):
    OBJECT_TYPE = "Series.str"
    DEFAULT_OBJECT_TYPE = pandas.core.strings.accessor.StringMethods

    @classmethod
    def frame_wrapper(cls, df: pandas.DataFrame) -> Any:
        return df.squeeze(axis=1).str


class DateTimeDefault(SeriesDefault):
    OBJECT_TYPE = "Series.dt"
    DEFAULT_OBJECT_TYPE = pandas.core.indexes.accessors.CombinedDatetimelikeProperties

    @classmethod
    def frame_wrapper(cls, df: pandas.DataFrame) -> Any:
        return df.squeeze(axis=1).dt


class CatDefault(SeriesDefault):
    OBJECT_TYPE = "Series.cat"
    DEFAULT_OBJECT_TYPE = pandas.core.arrays.categorical.CategoricalAccessor

    @classmethod
    def frame_wrapper(cls, df: pandas.DataFrame) -> Any:
        return df.squeeze(axis=1).cat


class _AccessorLookupOnly:
    """Sentinel DEFAULT_OBJECT_TYPE: forces string funcs through
    ObjTypeDeterminer so names that collide with pandas.Series methods
    (``__getitem__``, ``explode``...) resolve on the ACCESSOR object."""


class ListDefault(SeriesDefault):
    OBJECT_TYPE = "Series.list"
    DEFAULT_OBJECT_TYPE = _AccessorLookupOnly

    @classmethod
    def frame_wrapper(cls, df: pandas.DataFrame) -> Any:
        return df.squeeze(axis=1).list


class StructDefault(SeriesDefault):
    OBJECT_TYPE = "Series.struct"
    DEFAULT_OBJECT_TYPE = _AccessorLookupOnly

    @classmethod
    def frame_wrapper(cls, df: pandas.DataFrame) -> Any:
        return df.squeeze(axis=1).struct


class RollingDefault(DefaultMethod):
    """Defaults for rolling-window aggregations (fold-shaped ops)."""

    OBJECT_TYPE = "Rolling"

    @classmethod
    def register(cls, func: Union[str, Callable], squeeze_self: bool = False, **kw: Any) -> Callable:
        fn_name = kw.get("fn_name") or (
            func if isinstance(func, str) else getattr(func, "__name__", str(func))
        )

        def caller(
            query_compiler: Any, rolling_kwargs: dict, *args: Any, **kwargs: Any
        ) -> Any:
            from modin_tpu_torch.utils import qc_to_pandas_for_write

            # series-shaped compilers run through Series.rolling so
            # pandas' own result shapes/naming apply (cov/corr vs a Series)
            df = qc_to_pandas_for_write(query_compiler)
            if squeeze_self and isinstance(df, pandas.DataFrame):
                df = df.squeeze(axis=1)
            ErrorMessage.default_to_pandas(f"`Rolling.{fn_name}`")
            roller = df.rolling(**rolling_kwargs)
            fn = getattr(type(roller), func) if isinstance(func, str) else func
            return cls.build_output(query_compiler, fn(roller, *args, **kwargs))

        caller.__name__ = f"rolling_{fn_name}"
        return caller


class ExpandingDefault(DefaultMethod):
    OBJECT_TYPE = "Expanding"

    @classmethod
    def register(cls, func: Union[str, Callable], squeeze_self: bool = False, **kw: Any) -> Callable:
        fn_name = kw.get("fn_name") or (
            func if isinstance(func, str) else getattr(func, "__name__", str(func))
        )

        def caller(
            query_compiler: Any, expanding_args: list, *args: Any, **kwargs: Any
        ) -> Any:
            from modin_tpu_torch.utils import qc_to_pandas_for_write

            # series-shaped compilers run through Series.expanding so
            # pandas' own result shapes/naming apply (cov/corr vs a Series)
            df = qc_to_pandas_for_write(query_compiler)
            if squeeze_self and isinstance(df, pandas.DataFrame):
                df = df.squeeze(axis=1)
            ErrorMessage.default_to_pandas(f"`Expanding.{fn_name}`")
            roller = df.expanding(*expanding_args)
            fn = getattr(type(roller), func) if isinstance(func, str) else func
            return cls.build_output(query_compiler, fn(roller, *args, **kwargs))

        caller.__name__ = f"expanding_{fn_name}"
        return caller


class EwmDefault(DefaultMethod):
    """Defaults for exponentially-weighted-window aggregations."""

    OBJECT_TYPE = "Ewm"

    @classmethod
    def register(cls, func: Union[str, Callable], squeeze_self: bool = False, **kw: Any) -> Callable:
        fn_name = kw.get("fn_name") or (
            func if isinstance(func, str) else getattr(func, "__name__", str(func))
        )

        def caller(
            query_compiler: Any, ewm_kwargs: dict, *args: Any, **kwargs: Any
        ) -> Any:
            from modin_tpu_torch.utils import qc_to_pandas_for_write, try_cast_to_pandas

            # series-shaped compilers run through Series.ewm so pandas' own
            # result-naming conventions apply (cov/corr vs another Series)
            df = qc_to_pandas_for_write(query_compiler)
            if squeeze_self and isinstance(df, pandas.DataFrame):
                df = df.squeeze(axis=1)
            ErrorMessage.default_to_pandas(f"`ExponentialMovingWindow.{fn_name}`")
            roller = df.ewm(**ewm_kwargs)
            fn = getattr(type(roller), func) if isinstance(func, str) else func
            # raw compilers may arrive as `other` from the device pair path
            args = try_cast_to_pandas(args, squeeze=True)
            kwargs = try_cast_to_pandas(kwargs, squeeze=True)
            return cls.build_output(query_compiler, fn(roller, *args, **kwargs))

        caller.__name__ = f"ewm_{fn_name}"
        return caller


class ResampleDefault(DefaultMethod):
    OBJECT_TYPE = "Resampler"

    @classmethod
    def register(cls, func: Union[str, Callable], squeeze_self: bool = False, **kw: Any) -> Callable:
        fn_name = kw.get("fn_name") or (
            func if isinstance(func, str) else getattr(func, "__name__", str(func))
        )

        def caller(
            query_compiler: Any, resample_kwargs: dict, *args: Any, **kwargs: Any
        ) -> Any:
            df = query_compiler.to_pandas()
            if squeeze_self or query_compiler._shape_hint == "column":
                # a Series resample must run as a SERIES: frame resample
                # changes result shapes (ohlc -> MultiIndex columns)
                df = df.squeeze(axis=1)
                if (
                    isinstance(df, pandas.Series)
                    and df.name == MODIN_UNNAMED_SERIES_LABEL
                ):
                    df = df.rename(None)
            ErrorMessage.default_to_pandas(f"`Resampler.{fn_name}`")
            resampler = df.resample(**resample_kwargs)
            fn = getattr(type(resampler), func) if isinstance(func, str) else func
            return cls.build_output(query_compiler, fn(resampler, *args, **kwargs))

        caller.__name__ = f"resample_{fn_name}"
        return caller


class GroupByDefault(DefaultMethod):
    OBJECT_TYPE = "GroupBy"

    @classmethod
    def register(cls, func: Union[str, Callable], **kw: Any) -> Callable:
        fn_name = func if isinstance(func, str) else getattr(func, "__name__", str(func))

        def caller(
            query_compiler: Any,
            by: Any,
            agg_args: tuple = (),
            agg_kwargs: Optional[dict] = None,
            groupby_kwargs: Optional[dict] = None,
            drop: bool = False,
            **kwargs: Any,
        ) -> Any:
            from modin_tpu_torch.utils import try_cast_to_pandas

            df = query_compiler.to_pandas()
            by = try_cast_to_pandas(by, squeeze=True)
            groupby_kwargs = dict(groupby_kwargs or {})
            agg_kwargs = agg_kwargs or {}
            ErrorMessage.default_to_pandas(f"`GroupBy.{fn_name}`")
            grp = df.groupby(by=by, **groupby_kwargs)
            if callable(func):
                result = func(grp, *agg_args, **agg_kwargs)
            else:
                result = getattr(grp, fn_name)(*agg_args, **agg_kwargs)
            return cls.build_output(query_compiler, result)

        caller.__name__ = f"groupby_{fn_name}"
        return caller


class BinaryDefault(DefaultMethod):
    """Defaults for binary operations: aligns the ``other`` QC to pandas first."""

    @classmethod
    def register(cls, func: Union[str, Callable], squeeze_self: bool = False, **kw: Any) -> Callable:
        fn = cls.get_func(func, pandas.DataFrame)
        # lookup name (resolves the Series counterpart method) stays tied to
        # the pandas callable; fn_name only overrides the display/QC name
        lookup_name = (
            func if isinstance(func, str) else getattr(func, "__name__", str(func))
        )
        fn_name = kw.get("fn_name") or lookup_name

        def caller(
            query_compiler: Any, other: Any, *args: Any, **kwargs: Any
        ) -> Any:
            from modin_tpu_torch.utils import MODIN_UNNAMED_SERIES_LABEL, try_cast_to_pandas

            squeeze_other = kwargs.pop("squeeze_other", False)
            df = query_compiler.to_pandas()
            do_squeeze = squeeze_self or query_compiler._shape_hint == "column"
            if do_squeeze:
                df = df.squeeze(axis=1)
                if isinstance(df, pandas.Series) and df.name == MODIN_UNNAMED_SERIES_LABEL:
                    df.name = None
                if kwargs.get("axis") in ("columns", 1):
                    kwargs["axis"] = 0
            other = try_cast_to_pandas(other)
            if isinstance(other, pandas.DataFrame) and squeeze_other:
                other = other.squeeze(axis=1)
            ErrorMessage.default_to_pandas(f"`{fn_name}`")
            if fn_name.startswith("__"):
                # dunder binary ops take only `other`; the API layer's
                # axis/level hints don't apply (Series dunders align by index)
                kwargs = {
                    k: v for k, v in kwargs.items()
                    if k not in ("axis", "level", "fill_value")
                }
            if isinstance(df, pandas.Series):
                series_fn = getattr(pandas.Series, lookup_name, None)
                result = (
                    series_fn(df, other, *args, **kwargs)
                    if series_fn is not None
                    else fn(df, other, *args, **kwargs)
                )
            else:
                result = fn(df, other, *args, **kwargs)
            return cls.build_output(query_compiler, result)

        caller.__name__ = fn_name
        caller._pandas_signature_default = True
        return caller
