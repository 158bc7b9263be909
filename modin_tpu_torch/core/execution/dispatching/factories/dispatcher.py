"""``FactoryDispatcher`` — routes the IO functions to the factory.

The port's counterpart of ``modin_tpu/core/execution/dispatching/factories/
dispatcher.py``.  The port has one execution, so the factory is
``CudaOnTorchFactory``, prepared on first use; there is no engine setting
to follow.
"""

from __future__ import annotations

from typing import Any

from modin_tpu_torch.core.execution.dispatching.factories import factories
from modin_tpu_torch.core.io.io import READERS, WRITERS


class FactoryDispatcher:
    """Routes calls to the current factory."""

    __factory: type = None

    @classmethod
    def get_factory(cls) -> type:
        if cls.__factory is None:
            factories.CudaOnTorchFactory.prepare()
            cls.__factory = factories.CudaOnTorchFactory
        return cls.__factory


def _make_dispatch(name: str):
    @classmethod
    def dispatch(cls, *args: Any, **kwargs: Any):
        return getattr(cls.get_factory(), f"_{name}")(*args, **kwargs)

    dispatch.__func__.__name__ = name
    return dispatch


for _name in READERS + WRITERS + ("from_interchange_dataframe",):
    setattr(FactoryDispatcher, _name, _make_dispatch(_name))
