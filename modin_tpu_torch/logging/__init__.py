"""Trace log, metrics and class-level instrumentation of the port.

The port's counterpart of ``modin_tpu/logging/``."""

from modin_tpu_torch.logging.class_logger import ClassLogger  # noqa: F401
from modin_tpu_torch.logging.config import get_logger  # noqa: F401
from modin_tpu_torch.logging.logger_decorator import (  # noqa: F401
    disable_logging,
    enable_logging,
)
from modin_tpu_torch.logging.metrics import (  # noqa: F401
    add_metric_handler,
    clear_metric_handler,
    emit_metric,
)
