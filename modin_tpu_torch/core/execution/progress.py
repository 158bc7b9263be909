"""Live progress for API-layer operations.

The port's counterpart of ``modin_tpu/core/execution/progress.py``: a bar
(tqdm where installed, else a line) for an API call that outlives half a
second, per operation, gated by ``ProgressBar``.  The bar's thread adopts
the caller's span stack and meter scopes, so anything it emits bills the
caller.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

_LONG_OP_SECONDS = 0.5
_reentrancy = threading.local()


class _OpProgress:
    """Displays a spinner/bar for one long-running operation."""

    def __init__(self, name: str):
        self.name = name
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._span_stack: Any = None
        self._scopes: Any = None

    def __enter__(self) -> "_OpProgress":
        from modin_tpu_torch.observability import meters as _meters
        from modin_tpu_torch.observability import spans as _spans

        _reentrancy.active = True
        self._span_stack = _spans.snapshot_stack()
        self._scopes = _meters.snapshot_scopes()
        self._thread = threading.Thread(
            target=self._run,
            name=f"modin-tpu-torch-progress-{self.name}",
            daemon=True,
        )
        self._thread.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        _reentrancy.active = False
        self._done.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)

    def _run(self) -> None:
        from modin_tpu_torch.observability import meters as _meters
        from modin_tpu_torch.observability import spans as _spans

        # the spinner reports on the caller's operation: adopt its
        # span/QueryStats context so anything it emits bills the owner
        _spans.seed_thread(self._span_stack)
        _meters.seed_thread_scopes(self._scopes)
        try:
            # wait before showing anything: short ops stay silent
            if self._done.wait(_LONG_OP_SECONDS):
                return
            try:
                from tqdm.auto import tqdm

                bar = tqdm(
                    desc=f"modin_tpu_torch::{self.name}", total=None, leave=False
                )
                while not self._done.wait(0.25):
                    bar.update(1)
                bar.close()
            except ImportError:
                start = time.time()
                while not self._done.wait(1.0):
                    elapsed = time.time() - start
                    print(  # noqa: T201
                        f"\rmodin_tpu_torch::{self.name} running {elapsed:.0f}s",
                        end="",
                    )
                print("\r", end="")  # noqa: T201
        finally:
            _meters.seed_thread_scopes(None)
            _spans.seed_thread(None)


def call_progress_bar(name: str) -> Any:
    """Context manager showing progress for ``name`` when ProgressBar is on.

    Only the OUTERMOST API call gets a bar: nested API-layer calls inside an
    active operation are no-ops (re-entrancy guard).
    """
    import contextlib

    from modin_tpu_torch.config import ProgressBar

    if not ProgressBar.get() or getattr(_reentrancy, "active", False):
        return contextlib.nullcontext()
    return _OpProgress(name)
