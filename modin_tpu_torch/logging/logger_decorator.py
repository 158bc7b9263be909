"""``enable_logging``: the START/STOP trace, API timing and span decorator.

The port's counterpart of ``modin_tpu/logging/logger_decorator.py``.  A
wrapped call logs ``START::<layer>::<name>`` / ``STOP::...`` while
``LogMode`` is on, emits ``pandas-api.<name>`` seconds for API-layer calls
while a metric consumer listens, shows a progress line while
``ProgressBar`` is on, and opens a span tagged with its layer while tracing
is on.  When none of these is on (the default) the wrapper reads one module
attribute, :data:`_PLAIN`, and calls the method.

A class is wrapped method by method: its own public methods, classmethods
and staticmethods, and its special methods apart from those of attribute
access, representation, hashing, iteration and pickling (:data:`NEVER_WRAP`),
whose callers include pandas' and Python's own machinery.  Properties are
not wrapped, and a function already wrapped (inherited through an
assignment) is not wrapped twice.
"""

from __future__ import annotations

import re
import time
from functools import wraps
from types import FunctionType, MethodType
from typing import Any, Callable, Optional, Union

from modin_tpu_torch.config import LogMode, MetricsMode, ProgressBar
from modin_tpu_torch.logging import metrics as _metrics
from modin_tpu_torch.logging.config import get_logger
from modin_tpu_torch.observability import spans as _spans

_MODIN_LOGGER_NOWRAP = "__modin_logging_nowrap__"

#: special methods a class wrap leaves alone: attribute access (the API
#: classes dispatch columns through ``__getattr__``), representation,
#: hashing, truth, length, iteration, containment, pickling, copying and
#: numpy's protocols
NEVER_WRAP = frozenset(
    {
        "__getattr__", "__getattribute__", "__setattr__", "__delattr__", "__dir__",
        "__init_subclass__", "__class_getitem__", "__new__", "__del__",
        "__repr__", "__str__", "__format__", "__sizeof__", "__hash__", "__bool__",
        "__len__", "__iter__", "__next__", "__contains__", "__reduce__", "__reduce_ex__",
        "__getstate__", "__setstate__", "__copy__", "__deepcopy__", "__array__",
        "__array_ufunc__", "__array_function__", "__array_priority__", "__dataframe__",
        "__enter__", "__exit__",
    }
)

#: True while nothing observes a wrapped call: LogMode Disable, no progress
#: bar, tracing off and no metric consumer.  Kept by :func:`refresh`.
_PLAIN: bool = True


def refresh() -> None:
    """Recompute :data:`_PLAIN` (the settings' subscriptions, a handler
    added or removed, tracing or meters switched)."""
    global _PLAIN
    _PLAIN = (
        LogMode.get() == "Disable"
        and not ProgressBar.get()
        and not _spans.TRACE_ON
        and _metrics._aggregate is None
        and not _metrics._handlers_on
    )


def wraps_name(name: str) -> bool:
    """Does a class wrap take the attribute ``name``?"""
    if name.startswith("__") and name.endswith("__"):
        return name not in NEVER_WRAP
    return not name.startswith("_")


def disable_logging(func: Callable) -> Callable:
    """Mark a function to never be wrapped by ``enable_logging``."""
    setattr(func, _MODIN_LOGGER_NOWRAP, True)
    return func


def enable_logging(
    modin_layer: Union[str, Callable, classmethod, staticmethod] = "PANDAS-API",
    name: Optional[str] = None,
    log_level: str = "info",
) -> Callable:
    """Wrap a callable (or every method of a class, see the module note)
    with the trace log, timing metrics and spans.  Usable as
    ``@enable_logging`` and ``@enable_logging("LAYER")``."""
    if isinstance(modin_layer, (FunctionType, MethodType, classmethod, staticmethod)):
        return enable_logging()(modin_layer)

    def decorator(obj: Any) -> Any:
        if isinstance(obj, classmethod):
            return classmethod(decorator(obj.__func__))
        if isinstance(obj, staticmethod):
            return staticmethod(decorator(obj.__func__))
        if isinstance(obj, type):
            seen: dict = {}
            for attr_name, attr_value in list(vars(obj).items()):
                if not wraps_name(attr_name):
                    continue
                target = attr_value.__func__ if isinstance(attr_value, (classmethod, staticmethod)) else attr_value
                if isinstance(attr_value, (FunctionType, classmethod, staticmethod)) and not hasattr(
                    target, _MODIN_LOGGER_NOWRAP
                ):
                    wrapped = seen.setdefault(
                        attr_value,
                        enable_logging(modin_layer, f"{obj.__name__}.{attr_name}", log_level)(attr_value),
                    )
                    setattr(obj, attr_name, wrapped)
            return obj

        assert isinstance(modin_layer, str), "modin_layer is somehow not a string!"
        log_name = name or getattr(obj, "__qualname__", repr(obj))
        log_name = re.sub(r"[^a-zA-Z0-9\-_\.]", "_", log_name)
        full_name = f"{modin_layer}::{log_name}"
        is_api_layer = modin_layer.upper() in _spans.API_LAYERS

        @wraps(obj)
        def run_and_log(*args: Any, **kwargs: Any) -> Any:
            if _PLAIN:
                return obj(*args, **kwargs)
            if is_api_layer and ProgressBar.get():
                from modin_tpu_torch.core.execution.progress import call_progress_bar

                with call_progress_bar(log_name):
                    return _run_traced(args, kwargs)
            return _run_traced(args, kwargs)

        def _run_traced(args: tuple, kwargs: dict) -> Any:
            if not _spans.TRACE_ON:
                return _run_logged(args, kwargs)
            with _spans.layer_span(log_name, modin_layer):
                return _run_logged(args, kwargs)

        def _run_logged(args: tuple, kwargs: dict) -> Any:
            mode = LogMode.get()
            metrics_on = is_api_layer and (_metrics._aggregate is not None or _metrics._handlers_on)
            logged = mode == "Enable" or (mode == "Enable_Api_Only" and is_api_layer)
            if not logged and not metrics_on:
                return obj(*args, **kwargs)
            logger = get_logger() if logged else None
            if logger is not None:
                getattr(logger, log_level)(f"START::{full_name}")
            start = time.perf_counter()
            try:
                result = obj(*args, **kwargs)
            except BaseException as err:
                if logger is not None:
                    get_logger("modin_tpu_torch.logger.errors").exception(f"STOP::{full_name}", exc_info=err)
                raise
            finally:
                if metrics_on:
                    _metrics.emit_metric(
                        f"pandas-api.{log_name.lower().replace('.', '_', 1)}", time.perf_counter() - start
                    )
            if logger is not None:
                getattr(logger, log_level)(f"STOP::{full_name}")
            return result

        setattr(run_and_log, _MODIN_LOGGER_NOWRAP, True)
        return run_and_log

    return decorator


for _param in (LogMode, MetricsMode, ProgressBar):
    _param.subscribe(lambda _p: refresh())
