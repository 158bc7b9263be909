"""``read_fwf`` in one pandas parse.

The port's counterpart of ``modin_tpu/core/io/text/fwf_dispatcher.py``.  The
JAX package infers the column spans once and parses byte ranges on threads;
on an H100 host that read of 5e5 rows took 0.90-1.10x of one parse
(``chip_smoke.py`` phase 14), so the port parses the file once, with
pandas' own span inference, and hands the frame to the device in
``from_pandas``.  ``iterator``/``chunksize`` return pandas' reader.
"""

from __future__ import annotations

from typing import Any

import pandas

from modin_tpu_torch.core.io.file_dispatcher import FileDispatcher


class FWFDispatcher(FileDispatcher):
    """``read_fwf`` in one parse."""

    @classmethod
    def _read(cls, filepath_or_buffer: Any = None, **kwargs: Any):
        df = pandas.read_fwf(filepath_or_buffer, **kwargs)
        if isinstance(df, pandas.DataFrame):
            return cls.query_compiler_cls.from_pandas(df)
        return df  # a TextFileReader (iterator/chunksize)
