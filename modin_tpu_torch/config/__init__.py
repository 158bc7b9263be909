"""Settings of the torch port (see :mod:`modin_tpu_torch.config.envvars`)."""

from modin_tpu_torch.config.envvars import Device, GroupbyRangeLimit, Parameter

__all__ = ["Device", "GroupbyRangeLimit", "Parameter"]
