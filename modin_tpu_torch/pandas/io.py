"""Every ``read_*`` entry point of the port, dispatched through the factory.

The port's counterpart of ``modin_tpu/pandas/io.py``.  A reader binds its
arguments to pandas' own signature (defaults included) and hands them by
name to ``FactoryDispatcher``: ``read_csv``, ``read_table``,
``read_json``, ``read_fwf``, ``read_sql``, ``read_hdf``, ``read_parquet``
and ``read_feather`` read through their dispatchers and put the numeric
columns on the device; ``read_excel`` (and ``ExcelFile``) reads with pandas
where an Excel engine is installed and with the port's xlsx codec where
none is; the others read with pandas, counted as one default each.
"""

from __future__ import annotations

import inspect
from typing import Any

import pandas

from modin_tpu_torch.pandas.general import json_normalize  # noqa: F401


def _read(reader_name: str, **kwargs: Any) -> Any:
    """A ``read_*`` through the current factory, wrapped as port objects."""
    from modin_tpu_torch.core.execution.dispatching.factories.dispatcher import (
        FactoryDispatcher,
    )
    from modin_tpu_torch.pandas.dataframe import DataFrame
    from modin_tpu_torch.pandas.series import Series

    result = getattr(FactoryDispatcher, reader_name)(**kwargs)

    def wrap(qc: Any) -> Any:
        if hasattr(qc, "to_pandas"):
            if qc._shape_hint == "column":
                return Series(query_compiler=qc)
            return DataFrame(query_compiler=qc)
        return qc

    if isinstance(result, dict):
        return {k: wrap(v) for k, v in result.items()}
    if isinstance(result, list):
        return [wrap(v) for v in result]
    return wrap(result)


def _make_reader(name: str):
    pandas_fn = getattr(pandas, name)
    sig = inspect.signature(pandas_fn)

    def reader(*args: Any, **kwargs: Any) -> Any:
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        params: dict = {}
        for arg_name, value in bound.arguments.items():
            kind = sig.parameters[arg_name].kind
            if kind == inspect.Parameter.VAR_KEYWORD:
                params.update(value)
            elif kind == inspect.Parameter.VAR_POSITIONAL:
                raise TypeError(f"{name} takes no extra positional arguments in modin_tpu_torch")
            else:
                params[arg_name] = value
        return _read(name, **params)

    reader.__name__ = reader.__qualname__ = name
    reader.__doc__ = pandas_fn.__doc__
    reader.__signature__ = sig
    return reader


read_csv = _make_reader("read_csv")
read_table = _make_reader("read_table")
read_parquet = _make_reader("read_parquet")
read_json = _make_reader("read_json")
read_fwf = _make_reader("read_fwf")
read_excel = _make_reader("read_excel")
read_feather = _make_reader("read_feather")
read_stata = _make_reader("read_stata")
read_sas = _make_reader("read_sas")
read_pickle = _make_reader("read_pickle")
read_sql = _make_reader("read_sql")
read_sql_query = _make_reader("read_sql_query")
read_sql_table = _make_reader("read_sql_table")
read_html = _make_reader("read_html")
read_xml = _make_reader("read_xml")
read_clipboard = _make_reader("read_clipboard")
read_hdf = _make_reader("read_hdf")
read_spss = _make_reader("read_spss")
read_orc = _make_reader("read_orc")


def to_pickle(obj: Any, filepath_or_buffer: Any, **kwargs: Any) -> None:
    from modin_tpu_torch.pandas.base import BasePandasDataset

    if isinstance(obj, BasePandasDataset):
        obj.to_pickle(filepath_or_buffer, **kwargs)
        return
    pandas.to_pickle(obj, filepath_or_buffer, **kwargs)


class _NativeWorkbook:
    """What ``ExcelFile`` asks of its reader, over the port's xlsx codec."""

    def __init__(self, path: Any):
        from modin_tpu_torch.core.io.excel import sheet_names

        self.sheet_names = sheet_names(path)

    def close(self) -> None:
        pass


class ExcelFile(pandas.ExcelFile):
    """pandas' ExcelFile whose ``parse`` returns the port's frames.  Where
    no Excel engine is installed, the workbook opens over the port's xlsx
    codec and ``parse`` reads by ``read_excel``'s rule: the codec's forms,
    else ``ImportError``."""

    _native = False

    def __init__(self, path_or_buffer: Any, engine: Any = None, storage_options: Any = None,
                 engine_kwargs: Any = None):
        try:
            super().__init__(path_or_buffer, engine=engine, storage_options=storage_options,
                             engine_kwargs=engine_kwargs)
        except ImportError:
            from modin_tpu_torch.core.io.io import _no_excel_engine_installed

            if engine is not None or not _no_excel_engine_installed():
                raise
            self._native = True
            self.engine = None
            self.storage_options = storage_options
            self._reader = _NativeWorkbook(self._io)

    def parse(self, *args: Any, **kwargs: Any):
        from modin_tpu_torch.pandas.dataframe import DataFrame

        if self._native:
            bound = inspect.signature(pandas.ExcelFile.parse).bind(self, *args, **kwargs)
            params = {k: v for k, v in bound.arguments.items() if k != "self"}
            params.update(params.pop("kwds", {}))
            return read_excel(self._io, **params)
        result = super().parse(*args, **kwargs)
        if isinstance(result, dict):
            return {k: DataFrame(v) for k, v in result.items()}
        return DataFrame(result)


class HDFStore(pandas.HDFStore):
    """pandas' HDFStore whose item access returns the port's frames."""

    def __getitem__(self, key: Any):
        from modin_tpu_torch.pandas.dataframe import DataFrame

        result = super().__getitem__(key)
        if isinstance(result, pandas.DataFrame):
            return DataFrame(result)
        return result
