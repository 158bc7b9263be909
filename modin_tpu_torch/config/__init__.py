"""Settings of the torch port (see :mod:`modin_tpu_torch.config.envvars`)."""

from modin_tpu_torch.config.envvars import (
    Device,
    GroupbyRangeLimit,
    KernelRouterHistBound,
    Parameter,
)

__all__ = ["Device", "GroupbyRangeLimit", "KernelRouterHistBound", "Parameter"]
