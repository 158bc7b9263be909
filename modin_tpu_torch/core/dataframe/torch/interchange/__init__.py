"""The DataFrame interchange protocol over the port's frames (the producer)."""

from modin_tpu_torch.core.dataframe.torch.interchange.dataframe import (
    TorchBuffer,
    TorchColumnXchg,
    TorchDataFrameXchg,
)

__all__ = ["TorchBuffer", "TorchColumnXchg", "TorchDataFrameXchg"]
