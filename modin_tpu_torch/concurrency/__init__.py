"""Named locks, the declared lock order, and runtime lockdep.

The port's counterpart of ``modin_tpu/concurrency/``.  A leaf package
(stdlib and the settings module at import time): every other module of the
port builds its locks through :func:`named_lock` / :func:`named_rlock`
while it imports.

See :mod:`modin_tpu_torch.concurrency.registry` for the LOCKS/LOCK_ORDER
data and :mod:`modin_tpu_torch.concurrency.lockdep` for the runtime
validator (``MODIN_TPU_TORCH_LOCKDEP=1``).
"""

from modin_tpu_torch.concurrency.registry import (
    LOCK_ORDER,
    LOCKS,
    NESTABLE,
    declared_kinds,
    order_edges,
    transitive_order,
    validate_registry,
)
from modin_tpu_torch.concurrency.lockdep import (
    DepLock,
    LockdepViolation,
    disable,
    enable,
    enabled,
    held_locks,
    lockdep_alloc_count,
    named_lock,
    named_rlock,
    observed_edges,
    reset_violations,
    violations,
)

__all__ = [
    "LOCKS",
    "LOCK_ORDER",
    "NESTABLE",
    "declared_kinds",
    "order_edges",
    "transitive_order",
    "validate_registry",
    "DepLock",
    "LockdepViolation",
    "named_lock",
    "named_rlock",
    "enable",
    "disable",
    "enabled",
    "violations",
    "reset_violations",
    "held_locks",
    "observed_edges",
    "lockdep_alloc_count",
]
