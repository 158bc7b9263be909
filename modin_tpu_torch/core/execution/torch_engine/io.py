"""IO bound to the torch storage format: ``CudaOnTorchIO``.

The port's counterpart of ``modin_tpu/core/execution/jax_engine/io.py``:
the format dispatchers bound to ``TorchQueryCompiler``.  ``read_csv`` and
``read_table`` parse record-aligned byte ranges on a thread pool,
``read_parquet`` and ``read_feather`` read on pyarrow's threads, and
``read_json``, ``read_fwf``, ``read_sql`` and ``read_hdf`` parse once in
pandas; each puts the numeric columns on the device (``read_csv`` and
``read_table`` of a plain local file defer into a plan first, under the
default ``MODIN_TPU_TORCH_PLAN=Auto``).  ``to_csv``,
``to_json(orient="records", lines=True)``, ``to_parquet`` and
``to_feather`` write in row windows, ``to_sql`` and ``to_hdf`` through
pandas.  Excel is ``BaseIO``'s (pandas with an engine, the port's xlsx
codec without one).  Every other reader and writer is ``BaseIO``'s, which
defaults to pandas, counted.
"""

from typing import Any

from modin_tpu_torch.core.io.column_stores.hdf_dispatcher import HDFDispatcher
from modin_tpu_torch.core.io.column_stores.parquet_dispatcher import (
    FeatherDispatcher,
    ParquetDispatcher,
)
from modin_tpu_torch.core.io.io import BaseIO
from modin_tpu_torch.core.io.sql.sql_dispatcher import SQLDispatcher
from modin_tpu_torch.core.io.text.csv_dispatcher import CSVDispatcher, TableDispatcher
from modin_tpu_torch.core.io.text.fwf_dispatcher import FWFDispatcher
from modin_tpu_torch.core.io.text.json_dispatcher import JSONDispatcher
from modin_tpu_torch.core.storage_formats.torch.query_compiler import TorchQueryCompiler


class TorchCSVDispatcher(CSVDispatcher):
    query_compiler_cls = TorchQueryCompiler


class TorchTableDispatcher(TableDispatcher):
    query_compiler_cls = TorchQueryCompiler


class TorchParquetDispatcher(ParquetDispatcher):
    query_compiler_cls = TorchQueryCompiler


class TorchFeatherDispatcher(FeatherDispatcher):
    query_compiler_cls = TorchQueryCompiler


class TorchJSONDispatcher(JSONDispatcher):
    query_compiler_cls = TorchQueryCompiler


class TorchFWFDispatcher(FWFDispatcher):
    query_compiler_cls = TorchQueryCompiler


class TorchHDFDispatcher(HDFDispatcher):
    query_compiler_cls = TorchQueryCompiler


class TorchSQLDispatcher(SQLDispatcher):
    query_compiler_cls = TorchQueryCompiler


class CudaOnTorchIO(BaseIO):
    """IO producing ``TorchQueryCompiler`` frames."""

    query_compiler_cls = TorchQueryCompiler

    @classmethod
    def read_csv(cls, **kwargs: Any):
        # a deferrable read becomes a Scan-rooted plan (plan/runtime.py): the
        # file is parsed at the first materialization point, with the
        # projection the rewrite rules pushed down in its usecols
        from modin_tpu_torch.plan import runtime as plan_runtime

        deferred = plan_runtime.defer_read(TorchCSVDispatcher, kwargs)
        if deferred is not None:
            return deferred
        return TorchCSVDispatcher.read(**kwargs)

    @classmethod
    def read_table(cls, **kwargs: Any):
        from modin_tpu_torch.plan import runtime as plan_runtime

        deferred = plan_runtime.defer_read(TorchTableDispatcher, kwargs)
        if deferred is not None:
            return deferred
        return TorchTableDispatcher.read(**kwargs)

    @classmethod
    def read_json(cls, **kwargs: Any):
        return TorchJSONDispatcher.read(**kwargs)

    @classmethod
    def read_fwf(cls, **kwargs: Any):
        return TorchFWFDispatcher.read(**kwargs)

    @classmethod
    def read_hdf(cls, **kwargs: Any):
        return TorchHDFDispatcher.read(**kwargs)

    @classmethod
    def read_sql(cls, **kwargs: Any):
        return TorchSQLDispatcher.read(**kwargs)

    @classmethod
    def read_parquet(cls, **kwargs: Any):
        return TorchParquetDispatcher.read(**kwargs)

    @classmethod
    def read_feather(cls, **kwargs: Any):
        return TorchFeatherDispatcher.read(**kwargs)

    @classmethod
    def to_csv(cls, qc: Any, path_or_buf: Any = None, **kwargs: Any):
        return TorchCSVDispatcher.write(qc, path_or_buf, **kwargs)

    @classmethod
    def to_json(cls, qc: Any, path_or_buf: Any = None, **kwargs: Any):
        return TorchJSONDispatcher.write(qc, path_or_buf, **kwargs)

    @classmethod
    def to_hdf(cls, qc: Any, path_or_buf: Any = None, **kwargs: Any):
        return TorchHDFDispatcher.write(qc, path_or_buf, **kwargs)

    @classmethod
    def to_sql(cls, qc: Any, **kwargs: Any):
        return TorchSQLDispatcher.write(qc, **kwargs)

    @classmethod
    def to_parquet(cls, qc: Any, path: Any = None, **kwargs: Any):
        return TorchParquetDispatcher.write(qc, path, **kwargs)

    @classmethod
    def to_feather(cls, qc: Any, path: Any = None, **kwargs: Any):
        return TorchFeatherDispatcher.write(qc, path, **kwargs)
