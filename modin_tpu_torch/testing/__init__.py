"""Test-support utilities shipped with the port (fault injection at the engine seam and at the disk)."""

from modin_tpu_torch.testing.faults import (  # noqa: F401
    DiskFaultInjector,
    FaultInjector,
    MixedFaultInjector,
    OomBurstInjector,
    SequencedFaultInjector,
    inject_disk_faults,
    inject_faults,
    make_device_error,
    midquery_device_loss,
    oom_burst_until_eviction,
)
