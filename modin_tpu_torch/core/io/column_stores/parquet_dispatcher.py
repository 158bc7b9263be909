"""Parquet and Feather IO: one threaded pyarrow read, chunked write.

The port's counterpart of ``modin_tpu/core/io/column_stores/
parquet_dispatcher.py``:

- read: one ``pyarrow`` read on its own threads and one conversion to
  pandas, then ``from_pandas`` puts the numeric columns on the device.  The
  JAX package splits the row groups over a thread pool of its own; on an
  H100 host that split read a 2e7-row file three times slower than
  ``pandas.read_parquet``, so the port keeps pyarrow's threads;
- write: row windows of the frame stream through ``pyarrow.ParquetWriter``
  (Feather: one Arrow IPC file writer), each window's device columns
  fetched with one device-to-host copy (``csv_dispatcher.iter_write_chunks``).
"""

from __future__ import annotations

from typing import Any, List, Optional

import pandas

from modin_tpu_torch.core.io.file_dispatcher import FileDispatcher
from modin_tpu_torch.core.io.text.csv_dispatcher import iter_write_chunks


def _null_pinned_single_shot(pa, qc, schema, preserve_index, make_writer):
    """When the first window pinned a null-typed field (it held only nulls),
    later windows with values cannot cast into the schema: write the whole
    frame at once (pandas' whole-column inference).  Returns the writer
    after writing, or None when the schema is fine."""
    if not any(pa.types.is_null(f.type) for f in schema):
        return None
    table = pa.Table.from_pandas(qc.to_pandas(), preserve_index=preserve_index)
    writer = make_writer(table.schema)
    writer.write_table(table)
    return writer


def _is_default_range(idx: Any) -> bool:
    return (
        isinstance(idx, pandas.RangeIndex)
        and idx.start == 0
        and idx.step == 1
        and idx.name is None
    )


class ParquetDispatcher(FileDispatcher):
    @classmethod
    def _read(cls, path: Any = None, engine: str = "auto", columns: Optional[List] = None, **kwargs: Any):
        filters = kwargs.get("filters")
        try:
            import pyarrow.parquet as pq
        except ImportError:
            df = pandas.read_parquet(path, engine=engine, columns=columns, **kwargs)
            return cls.query_compiler_cls.from_pandas(df)
        extra = {
            k: v
            for k, v in kwargs.items()
            if k != "filters"
            and v not in (None, False)
            and not (k == "dtype_backend" and v is pandas.api.extensions.no_default)
        }
        if not isinstance(path, str) or extra or not cls.is_local_plain_file(cls.get_path(path)):
            # what the Arrow path cannot honor (dtype_backend, filesystem,
            # storage_options, buffers) takes pandas' reader
            df = pandas.read_parquet(path, engine=engine, columns=columns, **kwargs)
            return cls.query_compiler_cls.from_pandas(df)
        try:
            table = pq.read_table(
                cls.get_path(path), columns=columns, filters=filters, use_threads=True
            )
            df = table.to_pandas(split_blocks=True, self_destruct=True)
        except Exception:  # what pyarrow refuses, pandas reads (or raises)
            df = pandas.read_parquet(path, engine=engine, columns=columns, **kwargs)
        return cls.query_compiler_cls.from_pandas(df)

    @classmethod
    def write(cls, qc: Any, path: Any, **kwargs: Any):
        try:
            import pyarrow as pa
            import pyarrow.parquet as pq
        except ImportError:
            return qc.to_pandas().to_parquet(path, **kwargs)

        engine = kwargs.pop("engine", "auto")
        compression = kwargs.pop("compression", "snappy")
        index = kwargs.pop("index", None)
        if kwargs or engine not in ("auto", "pyarrow") or not isinstance(path, str):
            # partition_cols, storage_options, buffers: pandas writes
            kwargs.setdefault("compression", compression)
            if index is not None:
                kwargs["index"] = index
            return qc.to_pandas().to_parquet(path, engine=engine, **kwargs)

        # a RangeIndex is recorded per schema, so a chunked write would keep
        # the first window's only: the default RangeIndex is dropped (the
        # read rebuilds it), any other index is written as columns
        preserve = not _is_default_range(qc.index) if index is None else bool(index)
        writer = None
        schema = None
        try:
            for chunk in iter_write_chunks(qc):
                # the first window's schema is pinned: a later all-null window
                # would infer a null column type
                table = pa.Table.from_pandas(chunk, preserve_index=preserve, schema=schema)
                if writer is None:
                    schema = table.schema
                    writer = _null_pinned_single_shot(
                        pa, qc, schema, preserve,
                        lambda s: pq.ParquetWriter(path, s, compression=compression),
                    )
                    if writer is not None:
                        return None
                    writer = pq.ParquetWriter(path, schema, compression=compression)
                writer.write_table(table)
        finally:
            if writer is not None:
                writer.close()
        return None


class FeatherDispatcher(FileDispatcher):
    @classmethod
    def _read(cls, path: Any = None, columns: Optional[List] = None, **kwargs: Any):
        use_threads = kwargs.pop("use_threads", True)
        # the API binds every default of the signature: drop the defaulted
        extra = {
            k: v
            for k, v in kwargs.items()
            if v is not None
            and not (k == "dtype_backend" and v is pandas.api.extensions.no_default)
        }
        if not extra and isinstance(path, str):
            from pyarrow import ipc

            options = ipc.IpcReadOptions(use_threads=bool(use_threads))
            with ipc.open_file(cls.get_path(path), options=options) as reader:
                table = reader.read_all()
            if columns is not None:
                table = table.select(list(columns))  # the requested order
            df = table.to_pandas(split_blocks=True, self_destruct=True)
        else:
            df = pandas.read_feather(path, columns=columns, use_threads=use_threads, **kwargs)
        return cls.query_compiler_cls.from_pandas(df)

    @classmethod
    def write(cls, qc: Any, path: Any, **kwargs: Any):
        """Chunked feather write: row windows through one Arrow IPC writer."""
        import pyarrow as pa

        if kwargs or not isinstance(path, str) or not _is_default_range(qc.index):
            # buffers, write options, or an index pandas refuses: pandas
            return qc.to_pandas().to_feather(path, **kwargs)
        options = pa.ipc.IpcWriteOptions(compression="lz4")
        writer = None
        schema = None
        try:
            for chunk in iter_write_chunks(qc):
                table = pa.Table.from_pandas(chunk, preserve_index=False, schema=schema)
                if writer is None:
                    schema = table.schema
                    writer = _null_pinned_single_shot(
                        pa, qc, schema, False,
                        lambda s: pa.ipc.new_file(path, s, options=options),
                    )
                    if writer is not None:
                        return None
                    writer = pa.ipc.new_file(path, schema, options=options)
                writer.write_table(table)
        finally:
            if writer is not None:
                writer.close()
        return None
