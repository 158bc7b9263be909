"""HDF5 through pandas: one read or write, the frame on the device.

The port's counterpart of ``modin_tpu/core/io/column_stores/hdf_dispatcher.py``,
without its row windows: PyTables (``tables``) is installed neither where
the port's tests run nor on the H100 machine, so a windowed path could not
be checked.  Without PyTables pandas raises its own ``ImportError``
("Missing optional dependency 'pytables'"), and so does the port.
"""

from __future__ import annotations

from typing import Any

import pandas

from modin_tpu_torch.core.io.file_dispatcher import FileDispatcher


def _pytables_available() -> bool:
    try:
        import tables  # noqa: F401
    except ImportError:
        return False
    return True


class HDFDispatcher(FileDispatcher):
    @classmethod
    def _read(cls, path_or_buf: Any = None, key: Any = None, **kwargs: Any):
        result = pandas.read_hdf(path_or_buf, key=key, **kwargs)
        if isinstance(result, pandas.Series):
            result = result.to_frame()
        if not isinstance(result, pandas.DataFrame):
            return result  # iterator/chunksize: pandas' own
        return cls.query_compiler_cls.from_pandas(result)

    @classmethod
    def write(cls, qc: Any, path_or_buf: Any, key: Any = None, **kwargs: Any):
        from modin_tpu_torch.utils import qc_to_pandas_for_write

        return qc_to_pandas_for_write(qc).to_hdf(path_or_buf, key=key, **kwargs)
