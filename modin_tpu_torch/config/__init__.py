"""Settings of the torch port (see :mod:`modin_tpu_torch.config.envvars`)."""

from modin_tpu_torch.config.envvars import (
    CpuCount,
    Device,
    FusedCacheSize,
    FuseMinRows,
    FuseMode,
    GroupbyRangeLimit,
    KernelRouterHistBound,
    Parameter,
    PlanMaxPasses,
    PlanMode,
    PlanScanCacheBytes,
)

__all__ = [
    "CpuCount", "Device", "FusedCacheSize", "FuseMinRows", "FuseMode", "GroupbyRangeLimit",
    "KernelRouterHistBound", "Parameter", "PlanMaxPasses", "PlanMode", "PlanScanCacheBytes",
]
