"""``modin_tpu_torch.pandas.plotting`` — pandas.plotting over materialized
frames (the port's counterpart of ``modin_tpu/pandas/plotting.py``)."""

from __future__ import annotations

from typing import Any

from pandas import plotting as pdplot

from modin_tpu_torch.utils import try_cast_to_pandas


class Plotting:
    """Proxy of pandas.plotting converting the port's objects to pandas first."""

    def __dir__(self):
        return dir(pdplot)

    def __getattr__(self, item: str) -> Any:
        target = getattr(pdplot, item)
        if callable(target):
            def wrapper(*args: Any, **kwargs: Any):
                return target(
                    *try_cast_to_pandas(list(args)), **try_cast_to_pandas(kwargs)
                )

            wrapper.__name__ = item
            return wrapper
        return target


Plotting = Plotting()
