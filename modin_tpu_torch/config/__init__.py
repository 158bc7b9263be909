"""Settings of the torch port (see :mod:`modin_tpu_torch.config.envvars`)."""

from modin_tpu_torch.config.envvars import (
    CpuCount,
    Device,
    FusedCacheSize,
    GroupbyRangeLimit,
    KernelRouterHistBound,
    Parameter,
)

__all__ = ["CpuCount", "Device", "FusedCacheSize", "GroupbyRangeLimit", "KernelRouterHistBound", "Parameter"]
