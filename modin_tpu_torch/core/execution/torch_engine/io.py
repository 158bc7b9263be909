"""IO bound to the torch storage format: ``CudaOnTorchIO``.

The port's counterpart of ``modin_tpu/core/execution/jax_engine/io.py``:
the format dispatchers bound to ``TorchQueryCompiler``.  ``read_csv``,
``read_table``, ``read_parquet`` and ``read_feather`` parse on the host in
parallel and put the numeric columns on the device (``read_csv`` and
``read_table`` of a plain local file defer into a plan first, under the
default ``MODIN_TPU_TORCH_PLAN=Auto``); ``to_csv``,
``to_parquet`` and ``to_feather`` write in row windows.  Every other reader
and writer is ``BaseIO``'s, which defaults to pandas, counted.
"""

from typing import Any

from modin_tpu_torch.core.io.column_stores.parquet_dispatcher import (
    FeatherDispatcher,
    ParquetDispatcher,
)
from modin_tpu_torch.core.io.io import BaseIO
from modin_tpu_torch.core.io.text.csv_dispatcher import CSVDispatcher, TableDispatcher
from modin_tpu_torch.core.storage_formats.torch.query_compiler import TorchQueryCompiler


class TorchCSVDispatcher(CSVDispatcher):
    query_compiler_cls = TorchQueryCompiler


class TorchTableDispatcher(TableDispatcher):
    query_compiler_cls = TorchQueryCompiler


class TorchParquetDispatcher(ParquetDispatcher):
    query_compiler_cls = TorchQueryCompiler


class TorchFeatherDispatcher(FeatherDispatcher):
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
    def read_parquet(cls, **kwargs: Any):
        return TorchParquetDispatcher.read(**kwargs)

    @classmethod
    def read_feather(cls, **kwargs: Any):
        return TorchFeatherDispatcher.read(**kwargs)

    @classmethod
    def to_csv(cls, qc: Any, path_or_buf: Any = None, **kwargs: Any):
        return TorchCSVDispatcher.write(qc, path_or_buf, **kwargs)

    @classmethod
    def to_parquet(cls, qc: Any, path: Any = None, **kwargs: Any):
        return TorchParquetDispatcher.write(qc, path, **kwargs)

    @classmethod
    def to_feather(cls, qc: Any, path: Any = None, **kwargs: Any):
        return TorchFeatherDispatcher.write(qc, path, **kwargs)
