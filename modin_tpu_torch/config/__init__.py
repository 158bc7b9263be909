"""Settings of the torch port (see :mod:`modin_tpu_torch.config.envvars`)."""

from modin_tpu_torch.config.envvars import (
    CacheDir,
    CpuCount,
    Device,
    DeviceMemoryBudget,
    FusedCacheSize,
    FuseMinRows,
    FuseMode,
    GroupbyRangeLimit,
    KernelRouterCalibrationRows,
    KernelRouterHistBound,
    KernelRouterMinRows,
    KernelRouterMode,
    Memory,
    OptMode,
    OptReplanFactor,
    Parameter,
    PlanMaxPasses,
    PlanMode,
    PlanScanCacheBytes,
    ViewsHostBudget,
    ViewsMaxChain,
    ViewsMaxEntries,
    ViewsMaxGroups,
    ViewsMode,
)

__all__ = [
    "CacheDir", "CpuCount", "Device", "DeviceMemoryBudget", "FusedCacheSize", "FuseMinRows", "FuseMode",
    "GroupbyRangeLimit", "KernelRouterCalibrationRows", "KernelRouterHistBound", "KernelRouterMinRows",
    "KernelRouterMode", "Memory", "OptMode", "OptReplanFactor", "Parameter", "PlanMaxPasses", "PlanMode",
    "PlanScanCacheBytes", "ViewsHostBudget", "ViewsMaxChain", "ViewsMaxEntries", "ViewsMaxGroups", "ViewsMode",
]
