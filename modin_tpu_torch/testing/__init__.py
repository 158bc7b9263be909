"""Test-support utilities shipped with the port (fault injection)."""

from modin_tpu_torch.testing.faults import (  # noqa: F401
    FaultInjector,
    MixedFaultInjector,
    OomBurstInjector,
    SequencedFaultInjector,
    inject_faults,
    make_device_error,
    midquery_device_loss,
    oom_burst_until_eviction,
)
