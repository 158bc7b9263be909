"""Public API namespaces: ``interchange`` (the port's consumer) and pandas'
utility namespaces (``indexers``, ``types``, ``typing``, ``executors``),
passed through unchanged.  ``extensions`` is not ported yet."""

from pandas.api import indexers, types, typing  # noqa: F401

try:  # pandas >= 3 only
    from pandas.api import executors  # noqa: F401
except ImportError:
    executors = None

from modin_tpu_torch.pandas.api import interchange  # noqa: F401
