"""modin_tpu_torch — the modin_tpu dataframe on PyTorch and CUDA.

A port of ``modin_tpu`` (JAX on a TPU) to torch tensors on an NVIDIA GPU,
slice by slice.  Columns live on one device, chosen with :func:`set_device`
or ``MODIN_TPU_TORCH_DEVICE``: ``"cuda"`` by default, ``"cpu"`` only when
asked for.  Without a usable card the ``"cuda"`` default raises at the entry
points instead of carrying on on the CPU.

    import modin_tpu_torch.pandas as pd
    df = pd.DataFrame({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]})
    df.groupby("k").sum().modin.to_pandas()
"""

from modin_tpu_torch.config import Device

__version__ = "0.1.0"


def set_device(device: str) -> None:
    """Place the columns of frames built from now on: ``"cuda"`` or ``"cpu"``."""
    Device.put(device)


def get_device():
    """The ``torch.device`` that new columns go to (raises for ``"cuda"``
    when ``torch.cuda.is_available()`` is false)."""
    from modin_tpu_torch.parallel.mesh import get_device as _get_device

    return _get_device()


__all__ = ["set_device", "get_device", "__version__"]
