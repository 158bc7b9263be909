"""A database connection described, not held: ``ModinDatabaseConnection``.

The port's counterpart of ``modin_tpu/db_conn.py`` (modin's ``db_conn.py``):
a connection is its library and its arguments, so that each thread of a
partitioned ``read_sql`` opens its own (``sqlite3`` connections refuse other
threads).
"""

from __future__ import annotations

from typing import Any, Optional


class UnsupportedDatabaseException(Exception):
    pass


_PSYCOPG_LIB_NAME = "psycopg2"
_SQLALCHEMY_LIB_NAME = "sqlalchemy"
_SQLITE3_LIB_NAME = "sqlite3"


class ModinDatabaseConnection:
    """How to open a connection: the library's name and its arguments."""

    def __init__(self, lib: str, *args: Any, **kwargs: Any):
        lib = lib.lower()
        if lib not in (_PSYCOPG_LIB_NAME, _SQLALCHEMY_LIB_NAME, _SQLITE3_LIB_NAME):
            raise UnsupportedDatabaseException(f"Unsupported database library {lib}")
        self.lib = lib
        self.args = args
        self.kwargs = kwargs
        self._dialect_is_microsoft_sql_cache: Optional[bool] = None

    def _dialect_is_microsoft_sql(self) -> bool:
        if self._dialect_is_microsoft_sql_cache is None:
            self._dialect_is_microsoft_sql_cache = False
            if self.lib == _SQLALCHEMY_LIB_NAME:
                from sqlalchemy import create_engine

                self._dialect_is_microsoft_sql_cache = create_engine(
                    *self.args, **self.kwargs
                ).driver in ("pymssql", "pyodbc")
        return self._dialect_is_microsoft_sql_cache

    def get_connection(self) -> Any:
        """A new connection opened from the description."""
        if self.lib == _PSYCOPG_LIB_NAME:
            import psycopg2

            return psycopg2.connect(*self.args, **self.kwargs)
        if self.lib == _SQLALCHEMY_LIB_NAME:
            from sqlalchemy import create_engine

            return create_engine(*self.args, **self.kwargs).connect()
        import sqlite3

        return sqlite3.connect(*self.args, **self.kwargs)

    def column_names_query(self, query: str) -> str:
        return f"SELECT * FROM ({query}) AS _MODIN_COUNT_QUERY LIMIT 0"

    def row_count_query(self, query: str) -> str:
        return f"SELECT COUNT(*) FROM ({query}) AS _MODIN_COUNT_QUERY"

    def supports_stable_offset_partitioning(self) -> bool:
        """Whether LIMIT/OFFSET windows over independent connections are
        repeatable.  sqlite scans in rowid order; most server engines give
        no stable order without a total ORDER BY, so they read serially."""
        return self.lib == _SQLITE3_LIB_NAME

    def partition_query(self, query: str, limit: int, offset: int) -> str:
        """A query fetching rows [offset, offset + limit) of ``query``."""
        if self._dialect_is_microsoft_sql():
            return (
                f"SELECT * FROM ({query}) AS _MODIN_QUERY ORDER BY(SELECT NULL) "
                f"OFFSET {offset} ROWS FETCH NEXT {limit} ROWS ONLY"
            )
        return (
            f"SELECT * FROM ({query}) AS _MODIN_QUERY "
            f"LIMIT {limit} OFFSET {offset}"
        )
