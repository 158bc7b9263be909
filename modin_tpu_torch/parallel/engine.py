"""The torch engine wrapper — the four-function engine contract.

The port's counterpart of ``modin_tpu/parallel/engine.py::JaxWrapper``:

- ``deploy``      -> call the function; torch enqueues its kernels on the
                     current CUDA stream and returns without waiting.  The
                     fused launches (``ops/lazy.run_fused``) and the gathers
                     and concatenations of ``ops/structural.py`` go through it
- ``put``         -> ``torch.as_tensor(x).to(device)`` (always a copy), after
                     the device ledger admits its bytes (``core/memory.py``:
                     under ``DeviceMemoryBudget`` cold columns spill first);
                     ``from_pandas``, the readers and a spilled column's
                     restore all upload through it
- ``materialize`` -> ``.cpu().numpy()`` (waits for the values)
- ``wait``        -> ``torch.cuda.synchronize()``, nothing on the CPU

Every method runs under the resilience policy (``core/execution/
resilience.py::engine_call``): torch's errors are classified into the
DeviceOOM / DeviceLost / TransientDeviceError taxonomy, transient ones retry
with backoff, an OOM gets the evict-then-retry leg and a loss one lineage
re-seat, and ``materialize``/``wait`` run under the watchdog when it is on.
``deploy`` and ``put`` record the provenance that the re-seat replays
(``core/execution/recovery.py``).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from modin_tpu_torch.core import memory
from modin_tpu_torch.core.execution import recovery
from modin_tpu_torch.core.execution.resilience import DeviceLost, count, engine_call


def _arg_storages(f_args: Any) -> set:
    """Storage keys of the tensors among ``f_args`` (nested tuples and
    lists): the evictor must not spill what the call itself reads."""
    keys = set()
    stack = [f_args]
    while stack:
        item = stack.pop()
        if isinstance(item, (tuple, list)):
            stack.extend(item)
        elif isinstance(item, torch.Tensor):
            keys.add(memory.storage_key(item))
    return keys


class TorchWrapper:
    """Uniform engine API over eager torch and device tensors."""

    @classmethod
    def deploy(
        cls, func: Callable, f_args: tuple = (), f_kwargs: Optional[dict] = None, record: bool = True
    ) -> Any:
        """Run ``func(*f_args, **f_kwargs)``; returns its tensors.

        Besides the seam's policy: the call's (func, args) is recorded,
        the tensors weakly, so op-replay lineage can make its outputs again
        (unless ``record`` is False: nothing can replay a call whose inputs
        are donated, or whose outputs feed no column);
        and when the seam's retry after a re-seat still fails with a
        DeviceLost (on a real loss that retry closed over dead tensors),
        the arguments are rebound to the re-seated columns and the call
        runs once more.  ``func`` must hold no tensor of its own: replay
        takes its tensors from ``f_args``.
        """
        kwargs = f_kwargs or {}
        try:
            result = engine_call(
                "deploy", lambda: func(*f_args, **kwargs), protect_ids=lambda: _arg_storages(f_args)
            )
        except DeviceLost:
            fresh_args = recovery.recover_args(f_args)
            if fresh_args is None:
                raise
            count("recovery.retry.rebind")
            result = engine_call("deploy", lambda: func(*fresh_args, **kwargs))
            f_args = fresh_args
        if record and recovery.RECOVERY_ON:
            recovery.record_deploy(func, f_args, f_kwargs, result)
        return result

    @classmethod
    def put(cls, data: Any, device: Optional[torch.device] = None) -> torch.Tensor:
        """Host -> device copy (the source array is only read)."""
        if device is None:
            from modin_tpu_torch.parallel.mesh import get_device

            device = get_device()
        with warnings.catch_warnings():
            # read-only numpy views (pandas copy-on-write) are fine here:
            # the tensor below is a copy, never written through
            warnings.simplefilter("ignore", UserWarning)
            src = torch.as_tensor(data)
        if memory._DEVICE_BUDGET is not None:
            memory.device_ledger.admit(src.numel() * src.element_size())
        result = engine_call("put", lambda: src.to(device, copy=True))
        if recovery.RECOVERY_ON:
            recovery.record_put(data, result)
        return result

    @classmethod
    def materialize(cls, obj: Any) -> Any:
        """Device -> host numpy (blocks until the values are computed)."""
        return engine_call("materialize", lambda: _to_host(obj), watchdog=True)

    @classmethod
    def wait(cls, obj: Any = None) -> None:
        """Block until queued device work completes (nothing to wait for on
        the CPU, where the call still passes the seam)."""
        engine_call("wait", _synchronize, watchdog=True)


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _to_host(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.cpu().numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(o) for o in obj)
    return np.asarray(obj)


def materialize(obj: Any) -> Any:
    """Engine-seam host fetch as a free function: kernel modules fetch
    scalars and counts through this, defined in one place."""
    return TorchWrapper.materialize(obj)
