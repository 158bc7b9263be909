"""Lazy row labels for the torch frame.

The port's counterpart of ``modin_tpu/core/dataframe/tpu/metadata.py``.  A
row index is a pandas Index, a thunk that builds one (a filter, sort or
concat maps its input's index lazily), the default range of ``length``
rows, or the sorted key arrays of a groupby result.  pandas is
imported only when somebody asks for the Index itself, so the frame and the
kernels below it run without pandas.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np


class LazyIndex:
    """Row labels, materialized into a pandas Index on first :meth:`get`."""

    def __init__(self, value: Any = None, length: Optional[int] = None):
        # value: pandas Index | callable -> Index | None (default range)
        self._value = None
        self._thunk: Optional[Callable[[], Any]] = None
        self.arrays: Optional[List[np.ndarray]] = None
        self.names: Optional[List[Any]] = None
        if value is None:
            if length is None:
                raise ValueError("a default range index needs its length")
        elif callable(value):
            self._thunk = value
        else:
            self._value = value
        self.is_default_range = value is None
        self._length = length if length is not None else (
            len(value) if self._value is not None else None
        )

    @classmethod
    def from_arrays(cls, arrays: Sequence[np.ndarray], names: Sequence[Any]) -> "LazyIndex":
        """Index of groupby keys: one array per level, with the level names."""
        arrays, names = list(arrays), list(names)

        def build():
            import pandas

            if len(arrays) == 1:
                return pandas.Index(arrays[0], name=names[0])
            return pandas.MultiIndex.from_arrays(arrays, names=names)

        index = cls(build, len(arrays[0]))
        index.arrays, index.names = arrays, names
        return index

    def map_after(self, fn: Callable[[Any], Any], length: Optional[int] = None) -> "LazyIndex":
        """A new LazyIndex applying ``fn`` to this one when materialized
        (a filter's, sort's or gather's row labels stay a thunk until
        ``to_pandas`` asks for them)."""
        return LazyIndex(lambda: fn(self.get()), length)

    @property
    def is_materialized(self) -> bool:
        return self._value is not None

    def _cheap(self) -> bool:
        """Whether :meth:`get` costs no thunk call."""
        return self.is_materialized or self.is_default_range

    def get(self) -> Any:
        if self._value is None:
            if self.is_default_range:
                import pandas

                self._value = pandas.RangeIndex(self._length)
            else:
                self._value = self._thunk()
                self._thunk = None
        self._value = ensure_index(self._value)
        return self._value

    def __len__(self) -> int:
        if self._length is None:
            self._length = len(self.get())
        return self._length

    def equals(self, other: "LazyIndex") -> bool:
        """Cheap alignment check that never materializes a lazy index."""
        if self is other:
            return True
        if self.is_default_range and other.is_default_range:
            return len(self) == len(other)
        if self._cheap() and other._cheap():
            a, b = self.get(), other.get()
            if a is b:
                return True
            import pandas

            if isinstance(a, pandas.RangeIndex) and isinstance(b, pandas.RangeIndex):
                return a.equals(b)
            if len(a) == len(b) and len(a) <= 100_000:
                return a.equals(b)
        return False


def ensure_index(value: Any) -> Any:
    import pandas

    if isinstance(value, pandas.Index):
        return value
    return pandas.Index(value)
