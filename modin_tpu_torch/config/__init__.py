"""Settings of the torch port (see :mod:`modin_tpu_torch.config.envvars`)."""

from modin_tpu_torch.config.envvars import (
    CpuCount,
    Device,
    GroupbyRangeLimit,
    KernelRouterHistBound,
    Parameter,
)

__all__ = ["CpuCount", "Device", "GroupbyRangeLimit", "KernelRouterHistBound", "Parameter"]
