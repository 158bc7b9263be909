"""Execution factories: an execution's bound IO class.

The port's counterpart of ``modin_tpu/core/execution/dispatching/factories/
factories.py``.  The port has one execution, ``CudaOnTorch``: torch tensors
on one device (``CudaOnTorchFactory``, beside the JAX package's
``TpuOnJaxFactory``).  Every ``_read_*``/``_to_*`` (and
``_from_interchange_dataframe``) forwards to the bound IO class.
"""

from __future__ import annotations

from typing import Any

from modin_tpu_torch.core.io.io import READERS, WRITERS, BaseIO


class BaseFactory:
    """Base class of the execution factories."""

    io_cls: type = BaseIO

    @classmethod
    def prepare(cls) -> None:
        """Import and bind the IO class."""
        raise NotImplementedError(f"{cls.__name__} is used without instantiation")


def _make_io_forwarder(name: str):
    @classmethod
    def forwarder(cls, *args: Any, **kwargs: Any):
        return getattr(cls.io_cls, name)(*args, **kwargs)

    forwarder.__func__.__name__ = f"_{name}"
    return forwarder


for _name in READERS + WRITERS + ("from_interchange_dataframe",):
    setattr(BaseFactory, f"_{_name}", _make_io_forwarder(_name))


class CudaOnTorchFactory(BaseFactory):
    """Columns as torch tensors on one device (``cuda`` unless the caller
    asks for the CPU)."""

    @classmethod
    def prepare(cls) -> None:
        from modin_tpu_torch.core.execution.torch_engine.io import CudaOnTorchIO

        cls.io_cls = CudaOnTorchIO
