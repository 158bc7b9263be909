"""``ClassLogger``: a mixin that wraps every method of a subclass.

The port's counterpart of ``modin_tpu/logging/class_logger.py``."""

from __future__ import annotations

from typing import Dict, Optional

from modin_tpu_torch.logging.logger_decorator import enable_logging


class ClassLogger:
    """Trace every method of a subclass under a ``modin_layer`` tag::

        class TorchDataframe(ClassLogger, modin_layer="CORE-FRAME"):
            ...
    """

    _modin_logging_layer = "DEFAULT"

    @classmethod
    def __init_subclass__(
        cls,
        modin_layer: Optional[str] = None,
        class_name: Optional[str] = None,
        log_level: str = "info",
        **kwargs: Dict,
    ) -> None:
        super().__init_subclass__(**kwargs)
        modin_layer = modin_layer or cls._modin_logging_layer
        cls._modin_logging_layer = modin_layer
        enable_logging(modin_layer, class_name, log_level)(cls)
