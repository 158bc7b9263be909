"""Test-support utilities shipped with the port (fault injection at the engine seam, at the disk and
at the fleet's replica processes)."""

from modin_tpu_torch.testing.faults import (  # noqa: F401
    DiskFaultInjector,
    FaultInjector,
    MixedFaultInjector,
    OomBurstInjector,
    ReplicaFaultInjector,
    SequencedFaultInjector,
    inject_disk_faults,
    inject_faults,
    make_device_error,
    midquery_device_loss,
    oom_burst_until_eviction,
)
