"""The torch engine wrapper — the four-function engine contract.

The port's counterpart of ``modin_tpu/parallel/engine.py::JaxWrapper``:

- ``deploy``      -> call the function; torch enqueues its kernels on the
                     current CUDA stream and returns without waiting
- ``put``         -> ``torch.as_tensor(x).to(device)`` (always a copy), after
                     the device ledger admits its bytes (``core/memory.py``:
                     under ``DeviceMemoryBudget`` cold columns spill first);
                     ``from_pandas``, the readers and a spilled column's
                     restore all upload through it
- ``materialize`` -> ``.cpu().numpy()`` (waits for the values)
- ``wait``        -> ``torch.cuda.synchronize()``, nothing on the CPU
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from modin_tpu_torch.core import memory


class TorchWrapper:
    """Uniform engine API over eager torch and device tensors."""

    @classmethod
    def deploy(
        cls, func: Callable, f_args: tuple = (), f_kwargs: Optional[dict] = None
    ) -> Any:
        return func(*f_args, **(f_kwargs or {}))

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
        return src.to(device, copy=True)

    @classmethod
    def materialize(cls, obj: Any) -> Any:
        """Device -> host numpy (blocks until the values are computed)."""
        if isinstance(obj, torch.Tensor):
            return obj.cpu().numpy()
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.materialize(o) for o in obj)
        return np.asarray(obj)

    @classmethod
    def wait(cls, obj: Any = None) -> None:
        """Block until queued device work completes."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()


def materialize(obj: Any) -> Any:
    """Engine-seam host fetch as a free function: kernel modules fetch
    scalars and counts through this, defined in one place."""
    return TorchWrapper.materialize(obj)
