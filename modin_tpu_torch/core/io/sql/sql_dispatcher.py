"""``read_sql`` in one pandas read; ``to_sql``.

The port's counterpart of ``modin_tpu/core/io/sql/sql_dispatcher.py``.  A
query reads through one connection (a
:class:`~modin_tpu_torch.db_conn.ModinDatabaseConnection` opens its own and
closes it after), and the frame goes to the device in ``from_pandas``;
``chunksize`` returns pandas' iterator untouched.  A descriptor also reads a
bare table name (``SELECT *`` of it), as the JAX package's does.  The JAX package fetches
a descriptor's query in LIMIT/OFFSET windows on threads; on an H100 host
that took 106.5 s for 1e6 sqlite3 rows against 2.7 s serially (sqlite3
releases and retakes the interpreter lock for every row it steps), and
windows in worker processes still took 1.8x the serial read
(``chip_smoke.py`` phase 14), so the port reads serially.
"""

from __future__ import annotations

import re
from typing import Any

import pandas

from modin_tpu_torch.core.io.file_dispatcher import FileDispatcher
from modin_tpu_torch.db_conn import ModinDatabaseConnection


class SQLDispatcher(FileDispatcher):
    @classmethod
    def _read(cls, sql: Any = None, con: Any = None, **kwargs: Any):
        if not isinstance(con, ModinDatabaseConnection):
            result = pandas.read_sql(sql, con, **kwargs)
        else:
            if isinstance(sql, str) and re.fullmatch(r"[A-Za-z_][\w.]*", sql.strip()):
                sql = f"SELECT * FROM {sql.strip()}"
            conn = con.get_connection()
            if kwargs.get("chunksize") is not None:
                # the iterator reads from the connection as it is consumed
                return pandas.read_sql(sql, conn, **kwargs)
            try:
                result = pandas.read_sql(sql, conn, **kwargs)
            finally:
                conn.close()
        if not isinstance(result, pandas.DataFrame):
            return result  # chunksize: pandas' iterator
        return cls.query_compiler_cls.from_pandas(result)

    @classmethod
    def write(cls, qc: Any, name: str, con: Any, **kwargs: Any):
        from modin_tpu_torch.utils import qc_to_pandas_for_write

        # a Series-shaped compiler writes with Series.to_sql's column naming
        df = qc_to_pandas_for_write(qc)
        if isinstance(con, ModinDatabaseConnection):
            connection = con.get_connection()
            try:
                return df.to_sql(name, connection, **kwargs)
            finally:
                connection.close()
        return df.to_sql(name, con, **kwargs)
