"""The fleet's catalog queries, resolvable by name in every process.

The port's counterpart of ``modin_tpu/fleet/queries.py``.  A routed query
crosses the coordinator's socket to a replica, so its callable must import
on the far side: a lambda, or a function of ``__main__`` pickled by
reference, resolves against the replica's own main module and fails.
``fleet.submit`` therefore takes a name of this catalog (always safe) or a
module-level picklable callable.

Every query takes the dataset's frame first and returns a host (pandas)
result: answers pickle across the socket, and the local (fleet-off) path
returns the same object, so the two modes compare bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


def _host(result: Any) -> Any:
    return result._to_pandas() if hasattr(result, "_to_pandas") else result


def q_sum(frame: Any) -> Any:
    return _host(frame.sum())


def q_mean(frame: Any) -> Any:
    return _host(frame.mean())


def q_count(frame: Any) -> Any:
    return _host(frame.count())


def q_min(frame: Any) -> Any:
    return _host(frame.min())


def q_max(frame: Any) -> Any:
    return _host(frame.max())


def q_groupby_sum(frame: Any, key: str = "k") -> Any:
    return _host(frame.groupby(key).sum())


def q_filter_sum(frame: Any, column: str = "i", threshold: float = 0) -> Any:
    return _host(frame[frame[column] > threshold].sum())


QUERIES: Dict[str, Callable] = {
    "sum": q_sum,
    "mean": q_mean,
    "count": q_count,
    "min": q_min,
    "max": q_max,
    "groupby_sum": q_groupby_sum,
    "filter_sum": q_filter_sum,
}


def resolve(query: Any) -> Callable:
    """The callable of ``query``: a catalog name or a callable."""
    if callable(query):
        return query
    fn = QUERIES.get(query)
    if fn is None:
        raise KeyError(f"unknown fleet query {query!r}; catalog: {sorted(QUERIES)}")
    return fn
