"""Log-file set-up and the memory sampler thread.

The port's counterpart of ``modin_tpu/logging/config.py``: a rotating
job-scoped trace log under ``LogDir`` and, unless the mode is
Enable_Api_Only, a daemon thread that samples the process RSS and the
card's memory (``torch.cuda.mem_get_info``).  Where the JAX package logs
its version, its devices and their memory stats, the port logs torch's
version, the CUDA device's name and power limit, and the card's free and
total memory.  Nothing is written while ``LogMode`` is Disable.
"""

from __future__ import annotations

import datetime as dt
import logging
import logging.handlers
import os
import platform
import subprocess
import threading
import time
import uuid
from typing import Optional

from modin_tpu_torch.concurrency import named_lock
from modin_tpu_torch.config import LogDir, LogMode

__LOGGER_CONFIGURED__: bool = False

#: seconds between memory samples while logging is on
MEMORY_INTERVAL_S = 5
#: size (MB) of one log file before it rotates
LOG_FILE_MB = 10

# configure once: two threads racing through get_logger's first call must
# not add two handlers or start two samplers
_configure_lock = named_lock("logging.configure")
_mem_sampler: "threading.Thread | None" = None


class ModinFormatter(logging.Formatter):
    """Microsecond-resolution UTC timestamps."""

    def formatTime(self, record, datefmt=None):
        ct = dt.datetime.fromtimestamp(record.created, dt.timezone.utc)
        if datefmt:
            return ct.strftime(datefmt)
        return ct.strftime("%Y-%m-%d %H:%M:%S.%f")


def bytes_int_to_str(num_bytes: int, suffix: str = "B") -> str:
    factor = 1000
    for unit in ["", "K", "M", "G", "T", "P"]:
        if num_bytes < factor:
            return f"{num_bytes:.2f}{unit}{suffix}"
        num_bytes /= factor
    return f"{num_bytes * factor:.2f}P{suffix}"


def _create_logger(namespace: str, job_id: str, log_name: str, log_level: int) -> logging.Logger:
    logger = logging.getLogger(namespace)
    logdir = os.path.join(LogDir.get(), f"job_{job_id}")
    os.makedirs(logdir, exist_ok=True)
    handler = logging.handlers.RotatingFileHandler(
        filename=os.path.join(logdir, f"{log_name}.log"),
        backupCount=10,
        maxBytes=LOG_FILE_MB * int(1e6),
    )
    handler.setFormatter(ModinFormatter(fmt="%(process)d, %(thread)d, %(asctime)s, %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(log_level)
    return logger


def card_description() -> Optional[str]:
    """The CUDA device's name and power limit (``nvidia-smi``'s
    ``name,power.limit``), or None without a card."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(0)
    except Exception:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10,
        )
        limit = out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return f"{name} ({limit})"


def _card_memory() -> Optional[tuple]:
    """(free, total) bytes of the card, or None without an initialized one
    (the sampler never initializes CUDA itself)."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch.cuda.mem_get_info()
    except Exception:
        pass
    return None


def configure_logging() -> None:
    """Create the trace logger and start the memory sampler (once)."""
    global __LOGGER_CONFIGURED__, _mem_sampler
    with _configure_lock:
        if __LOGGER_CONFIGURED__:
            return
        import numpy

        import modin_tpu_torch

        job_id = uuid.uuid4().hex
        log_level = logging.INFO if LogMode.get() == "Enable_Api_Only" else logging.DEBUG
        logger = _create_logger("modin_tpu_torch.logger", job_id, f"trace__{platform.node()}", log_level)
        logger.info(f"OS Version: {platform.platform()}")
        logger.info(f"Python Version: {platform.python_version()}")
        logger.info(f"Modin-TPU-Torch Version: {modin_tpu_torch.__version__}")
        try:
            import pandas

            logger.info(f"Pandas Version: {pandas.__version__}")
        except ImportError:
            pass  # the port's core runs without pandas
        logger.info(f"Numpy Version: {numpy.__version__}")
        try:
            import torch

            logger.info(f"Torch Version: {torch.__version__} (CUDA {torch.version.cuda})")
        except Exception:
            pass
        card = card_description()
        if card is not None:
            logger.info(f"Device: {card}")
        mem = _card_memory()
        if mem is not None:
            logger.info(f"Device memory: {bytes_int_to_str(mem[0])} free of {bytes_int_to_str(mem[1])}")

        if LogMode.get() != "Enable_Api_Only":
            from modin_tpu_torch.observability import meters as _meters
            from modin_tpu_torch.observability import spans as _spans

            mem_logger = _create_logger("modin_tpu_torch_memory.logger", job_id, "memory", logging.DEBUG)
            _mem_sampler = threading.Thread(
                target=memory_thread,
                args=[mem_logger, MEMORY_INTERVAL_S, _spans.snapshot_stack(), _meters.snapshot_scopes()],
                daemon=True,
                name="modin-tpu-torch-memory-sampler",
            )
            _mem_sampler.start()

        __LOGGER_CONFIGURED__ = True


def memory_thread(logger: logging.Logger, sleep_time: int, span_stack=None, scopes=None) -> None:
    """Sample the host RSS and the card's memory in use forever."""
    from modin_tpu_torch.observability import meters as _meters
    from modin_tpu_torch.observability import spans as _spans

    # adopt the configuring thread's observability context
    _spans.seed_thread(span_stack)
    _meters.seed_thread_scopes(scopes)
    while True:
        rss = _process_rss_bytes()
        if rss is not None:
            logger.info(f"Host Memory RSS: {bytes_int_to_str(rss)}")
        mem = _card_memory()
        if mem is not None:
            logger.info(f"Device 0 memory in use: {bytes_int_to_str(mem[1] - mem[0])}")
        time.sleep(sleep_time)


def _process_rss_bytes():
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        import resource

        return pages * resource.getpagesize()
    except Exception:
        return None


def get_logger(namespace: str = "modin_tpu_torch.logger") -> logging.Logger:
    """The configured trace logger, configured on first use."""
    if not __LOGGER_CONFIGURED__ and LogMode.get() != "Disable":
        configure_logging()
    return logging.getLogger(namespace)
