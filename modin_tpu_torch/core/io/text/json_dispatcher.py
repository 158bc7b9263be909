"""``read_json`` in one pandas parse; ``to_json`` streamed in row windows.

The port's counterpart of ``modin_tpu/core/io/text/json_dispatcher.py``:

- read: one pandas parse, whose frame goes to the device in
  ``from_pandas``; ``typ="series"`` comes back as a column-shaped compiler
  and ``chunksize`` as pandas' ``JsonReader``.  The JAX package parses
  ``lines=True`` files in byte ranges on threads; on an H100 host that read
  of 1e6 records was 1.03-1.29x slower than one parse (pandas' ujson holds
  the interpreter lock; ``chip_smoke.py`` phase 14), so the port reads
  serially;
- write: ``to_json(orient="records", lines=True)`` of a local path appends
  row windows, each window's computed device columns fetched in one
  device-to-host copy; every other form is one counted pandas write.
"""

from __future__ import annotations

from typing import Any

import pandas

from modin_tpu_torch.core.io.file_dispatcher import FileDispatcher
from modin_tpu_torch.core.io.text.csv_dispatcher import (
    appendable_local_path,
    iter_write_chunks,
    serial_write,
)


class JSONDispatcher(FileDispatcher):
    """``read_json`` in one parse, the streamed ``to_json``."""

    @classmethod
    def _read(cls, path_or_buf: Any = None, **kwargs: Any):
        df = pandas.read_json(path_or_buf, **kwargs)
        if isinstance(df, pandas.Series):  # typ="series"
            from modin_tpu_torch.utils import MODIN_UNNAMED_SERIES_LABEL

            qc = cls.query_compiler_cls.from_pandas(
                df.to_frame(df.name if df.name is not None else MODIN_UNNAMED_SERIES_LABEL)
            )
            qc._shape_hint = "column"  # the API layer unwraps it to a Series
            return qc
        if isinstance(df, pandas.DataFrame):
            return cls.query_compiler_cls.from_pandas(df)
        return df  # a JsonReader (chunksize)

    @classmethod
    def write(cls, qc: Any, path_or_buf: Any = None, **kwargs: Any):
        """``to_json`` streamed in row windows for the appendable form
        (orient="records", lines=True); every other form is one pandas
        write."""
        streamable = (
            appendable_local_path(path_or_buf, kwargs.get("compression", "infer"))
            and kwargs.get("lines", False)
            # orient must be given: lines=True without orient="records"
            # raises in pandas, and the serial write raises the same
            and kwargs.get("orient") == "records"
            and kwargs.get("mode", "w") == "w"
            and qc._shape_hint != "column"  # a Series' records are bare values
        )
        if not streamable:
            return serial_write(qc, "to_json", path_or_buf, kwargs)
        kwargs.pop("mode", None)
        first = True
        for chunk in iter_write_chunks(qc):
            chunk.to_json(path_or_buf, mode="w" if first else "a", **kwargs)
            first = False
        return None
