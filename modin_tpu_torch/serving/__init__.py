"""Multi-tenant query serving: admission, deadlines, degradation.

The port's counterpart of ``modin_tpu/serving/``::

    from modin_tpu_torch import serving

    result = serving.submit(
        lambda: df.groupby("key").sum(),
        tenant="alice",
        deadline_ms=250,
    )

With ``MODIN_TPU_TORCH_SERVING=0`` (the default) ``submit`` is a direct
call, allocating nothing.  With serving on, every submitted query is
admitted (bounded concurrency and device-byte headroom), queued (bounded
depth, weighted-fair wake order) or shed with a typed
:class:`QueryRejected`; a latency budget rides the query as a
:class:`CancellationToken` checked at the engine seams and surfaces as a
typed :class:`DeadlineExceeded`; and a query admitted while the device is
sick goes to pandas on the CPU and is shed (reason ``degraded``) on the
card.

Only :mod:`~modin_tpu_torch.serving.errors` and
:mod:`~modin_tpu_torch.serving.context` load eagerly: they are leaves, and
the resilience layer imports them at module scope.  The gate (which
imports resilience back) loads on first use.
"""

from modin_tpu_torch.serving import context, errors  # noqa: F401
from modin_tpu_torch.serving.context import (  # noqa: F401
    CancellationToken,
    QueryContext,
    context_alloc_count,
)
from modin_tpu_torch.serving.errors import (  # noqa: F401
    DeadlineExceeded,
    QueryRejected,
    ServingError,
)

# "gate" and "tenants" are not lazy-mapped to objects: importing a
# submodule binds the MODULE to the package attribute, so mapping
# `serving.gate` to the AdmissionGate instance would make the attribute's
# type depend on import order.  `serving.gate` is always the submodule; the
# instance is `serving.gate.gate`.
_LAZY = {
    "submit": "modin_tpu_torch.serving.gate",
    "AdmissionGate": "modin_tpu_torch.serving.gate",
    "Permit": "modin_tpu_torch.serving.gate",
    "serving_snapshot": "modin_tpu_torch.serving.gate",
}

__all__ = [
    "AdmissionGate",
    "CancellationToken",
    "DeadlineExceeded",
    "Permit",
    "QueryContext",
    "QueryRejected",
    "ServingError",
    "context",
    "context_alloc_count",
    "errors",
    "serving_snapshot",
    "submit",
]


def __getattr__(name: str):
    import importlib

    if name in ("gate", "tenants"):
        return importlib.import_module(f"modin_tpu_torch.serving.{name}")
    module_name = _LAZY.get(name)
    if module_name is None:
        raise AttributeError(f"module 'modin_tpu_torch.serving' has no attribute {name!r}")
    value = getattr(importlib.import_module(module_name), name)
    globals()[name] = value
    return value
