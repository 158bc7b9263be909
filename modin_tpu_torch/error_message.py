"""User-facing warnings of the torch port, and the count of defaults to pandas.

The port's counterpart of ``modin_tpu/error_message.py``.  Every operation
that goes to pandas passes through :meth:`ErrorMessage.default_to_pandas`,
which adds one to ``query_compiler.DEFAULTS_TO_PANDAS`` (the counter lives in
``core/storage_formats/torch/query_compiler.py``, where the tests and the chip
smoke read and reset it).
"""

from __future__ import annotations

import warnings


class ErrorMessage:
    printed_default_to_pandas = False

    @classmethod
    def default_to_pandas(cls, message: str = "") -> None:
        """Count one default to pandas and warn about it."""
        from modin_tpu_torch.core.storage_formats.torch import query_compiler

        query_compiler.DEFAULTS_TO_PANDAS += 1
        if message != "":
            message = f"{message} defaulting to in-process pandas implementation."
        else:
            message = "Defaulting to in-process pandas implementation."
        if not cls.printed_default_to_pandas:
            message += (
                "\nThis warning is shown once per process. The operation runs on the "
                "host CPU instead of the device; results are identical."
            )
            cls.printed_default_to_pandas = True
        warnings.warn(message)
