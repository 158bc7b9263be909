"""Runtime lockdep: named locks + a debug-mode acquisition-order validator.

The port's counterpart of ``modin_tpu/concurrency/lockdep.py``.  Every
lock in the package is built by :func:`named_lock` /
:func:`named_rlock` against the ``LOCKS`` registry (concurrency/registry.py)
and returned as a :class:`DepLock` — a thin wrapper whose *disabled* fast
path is the raw lock's own C methods (``acquire``, ``release``,
``__enter__`` and ``__exit__``, bound once and handed back by C-level
getters, no Python frame), allocating nothing (``lockdep_alloc_count`` lets tests
assert exactly that, as ``span_alloc_count`` and ``meter_alloc_count`` do
for tracing and meters).

With ``MODIN_TPU_TORCH_LOCKDEP=1`` (or :func:`enable`), every acquisition is
validated against the declared partial order *before* it can block:

- **self-deadlock** — re-acquiring a non-reentrant lock this thread holds
  (the raw acquire would hang forever; lockdep raises instead);
- **instance pair** — holding two instances of the same lock name (torn
  SortedRep-pair class) unless the name is declared ``NESTABLE``;
- **declared contradiction** — acquiring ``A`` while holding ``B`` when the
  registry declares ``A`` before ``B`` (the dispatch-vs-reseat inversion
  class, caught even when the other thread never runs);
- **observed inversion** — acquiring ``A`` while holding ``B`` after some
  thread was *seen* holding ``A`` while acquiring ``B``: a real
  ABBA deadlock needs both interleavings to collide, lockdep needs each to
  merely *happen once*, ever, on any thread.

A violation is recorded (``violations()``), counted
(``concurrency.lockdep.violation``), flight-dumped while tracing is on (the failing
stack plus the first witness of the conflicting edge ride in the dump
detail), and —
in the default strict mode — raised as :class:`LockdepViolation`, so every
stress suite that enables lockdep doubles as an ordering oracle.

Released-out-of-order is *legal* (Python locks allow it; the gate's
wake-order code releases mid-stack): release removes the matching frame
wherever it sits in the per-thread stack.
"""

from __future__ import annotations

import sys
import threading
from operator import attrgetter
from typing import Dict, List, Optional, Set, Tuple

from modin_tpu_torch.concurrency import registry as _registry

__all__ = [
    "DepLock",
    "LockdepViolation",
    "named_lock",
    "named_rlock",
    "enable",
    "disable",
    "enabled",
    "violations",
    "reset_violations",
    "held_locks",
    "observed_edges",
    "lockdep_alloc_count",
]


class LockdepViolation(RuntimeError):
    """An acquisition that violates the declared/observed lock order."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


#: THE fast-path gate: ``None`` while lockdep is off.  DepLock's acquire/
#: release check this one module attribute and touch nothing else.
_validator: Optional["_Validator"] = None

#: validator-side objects ever allocated (zero-alloc-off assert)
_alloc_count = 0

_registry_validated = False


def lockdep_alloc_count() -> int:
    """Validator-side allocations ever made; unchanged while disabled."""
    return _alloc_count


def _note_alloc() -> None:
    global _alloc_count
    _alloc_count += 1


class DepLock:
    """A named lock.  Disabled mode: the raw C lock's own methods, zero
    allocations.  Enabled mode: full order validation."""

    __slots__ = ("name", "reentrant", "_raw", "_acquire", "_release", "_enter", "_exit")

    def __init__(self, name: str, raw, reentrant: bool):
        self.name = name
        self.reentrant = reentrant
        self._raw = raw
        # the raw lock's methods, bound once: the lockdep-off fast path
        self._acquire, self._release = raw.acquire, raw.release
        self._enter, self._exit = raw.__enter__, raw.__exit__

    # The validating methods.  ``enable``/``disable`` install them on the
    # class, or the raw lock's methods in their place (``_install``); each
    # still checks ``_validator``, since a thread may be inside one while
    # another thread switches lockdep off.

    def _checked_acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        v = _validator
        if v is None:
            return self._raw.acquire(blocking, timeout)
        # validate BEFORE blocking: a would-be deadlock raises instead of
        # hanging (the whole point of a runtime lockdep)
        v.check_acquire(self)
        ok = self._raw.acquire(blocking, timeout)
        if ok:
            v.note_acquired(self)
        return ok

    def _checked_release(self) -> None:
        v = _validator
        self._raw.release()
        if v is not None:
            v.note_released(self)

    def _checked_enter(self) -> "DepLock":
        self._checked_acquire()
        return self

    def _checked_exit(self, exc_type, exc, tb) -> bool:
        self._checked_release()
        return False

    acquire = _checked_acquire
    release = _checked_release
    __enter__ = _checked_enter
    __exit__ = _checked_exit

    def locked(self) -> bool:
        probe = getattr(self._raw, "locked", None)
        if probe is not None:
            return probe()
        # Py3.10 RLock has no locked(); a failed non-blocking acquire
        # means some thread (possibly this one) holds it
        if self._raw.acquire(False):
            self._raw.release()
            return False
        return True

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        kind = "rlock" if self.reentrant else "lock"
        return f"<DepLock {self.name} ({kind}) at {id(self):#x}>"


def named_lock(name: str) -> DepLock:
    """A non-reentrant lock declared as ``(name, "lock", ...)`` in LOCKS."""
    return DepLock(_check_declared(name, "lock"), threading.Lock(), False)


def named_rlock(name: str) -> DepLock:
    """A reentrant lock declared as ``(name, "rlock", ...)`` in LOCKS."""
    return DepLock(_check_declared(name, "rlock"), threading.RLock(), True)


def _check_declared(name: str, kind: str) -> str:
    global _registry_validated
    if not _registry_validated:
        _registry.validate_registry()
        _registry_validated = True
    declared = _registry.declared_kinds().get(name)
    if declared is None:
        raise ValueError(
            f"lock {name!r} is not declared in concurrency/registry.py:LOCKS "
            "— declare (name, kind, what-it-guards) first"
        )
    if declared != kind:
        raise ValueError(
            f"lock {name!r} is declared as {declared!r} but constructed as "
            f"{kind!r} — reentrancy intent is registry data, fix one side"
        )
    return name


# ---------------------------------------------------------------------- #
# the validator
# ---------------------------------------------------------------------- #


class _Violation:
    """One recorded violation (kept lightweight and picklable-ish)."""

    __slots__ = ("kind", "lock_name", "held", "thread", "site", "message")

    def __init__(
        self,
        kind: str,
        lock_name: str,
        held: Tuple[str, ...],
        thread: str,
        site: str,
        message: str,
    ):
        _note_alloc()
        self.kind = kind
        self.lock_name = lock_name
        self.held = held
        self.thread = thread
        self.site = site
        self.message = message

    def render(self) -> str:
        return (
            f"[{self.kind}] {self.message} (thread {self.thread!r} at "
            f"{self.site}; held: {', '.join(self.held) or '<none>'})"
        )


def _caller_site() -> str:
    """file:line of the acquire site outside this module (debug mode only)."""
    frame = sys._getframe(1)
    here = __file__
    while frame is not None and frame.f_code.co_filename == here:
        frame = frame.f_back
    if frame is None:  # pragma: no cover - only if called at module top
        return "<unknown>"
    return f"{frame.f_code.co_filename}:{frame.f_lineno}"


class _Validator:
    """Per-thread acquisition stacks + the process-wide observed edge set."""

    def __init__(self, strict: bool):
        _note_alloc()
        self.strict = strict
        self._tls = threading.local()
        # (before, after) -> first witness "thread at site"; guarded by a
        # RAW lock — the validator's own serialization must not validate
        # itself.
        self._edges: Dict[Tuple[str, str], str] = {}
        self._adjacency: Dict[str, Set[str]] = {}
        self._edge_lock = threading.Lock()
        self._declared_closure = _registry.transitive_order()
        self._nestable = _registry.NESTABLE
        self._leaves = _registry.LEAF_LOCKS
        self.violation_list: List[_Violation] = []

    # -- per-thread stack ------------------------------------------------ #

    def _stack(self) -> List[DepLock]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            _note_alloc()
            stack = []
            self._tls.stack = stack
        return stack

    # -- acquire / release ----------------------------------------------- #

    def check_acquire(self, dep: DepLock) -> None:
        tls = self._tls
        if getattr(tls, "in_validator", False):
            # THIS thread is already inside the edge machinery below,
            # holding the raw _edge_lock: the only way to get here is a
            # GC-fired weakref death callback (they run at any allocation
            # point, even mid-_find_path_witness) acquiring a DepLock.
            # Re-taking _edge_lock would self-deadlock the raw Lock and
            # wedge every validated acquire in the process — skip; the
            # callback's acquisition is a timing artifact, not coded
            # nesting.
            return
        stack = self._stack()
        if not stack:
            return
        held_names = tuple(d.name for d in stack)
        for held in stack:
            if held is dep:
                if dep.reentrant:
                    return  # owned re-acquire cannot block: no new edges
                self._violate(
                    "self-deadlock",
                    dep,
                    held_names,
                    f"re-acquiring non-reentrant lock {dep.name!r} this "
                    "thread already holds — the raw acquire would hang "
                    "forever",
                )
                return
        site = _caller_site()
        for held in stack:
            if held.name == dep.name:
                if dep.name not in self._nestable:
                    self._violate(
                        "instance-pair",
                        dep,
                        held_names,
                        f"acquiring a second instance of {dep.name!r} while "
                        "one is held — declare the name NESTABLE (with an "
                        "instance-order argument) or restructure",
                    )
                    return
                continue  # nestable same-name: legal, and never an edge
            if held.name in self._leaves:
                # A leaf lock's critical section acquires nothing by code;
                # being here while one is held means a GC-fired weakref
                # death callback is running inline (they fire under ANY
                # lock and re-enter the leaves).  An out-edge from a leaf
                # is a timing artifact, never coded nesting: neither
                # record it nor convict on it.
                continue
            if held.name in self._declared_closure.get(dep.name, ()):
                self._violate(
                    "declared-contradiction",
                    dep,
                    held_names,
                    f"acquiring {dep.name!r} while holding {held.name!r} "
                    f"contradicts the declared order {dep.name} -> "
                    f"{held.name} (concurrency/registry.py:LOCK_ORDER)",
                )
                return
            # The violation itself is raised OUTSIDE _edge_lock:
            # _violate's fan-out (metric emission, flight dump) acquires
            # DepLocks, which re-enter check_acquire and would
            # self-deadlock on the raw serialization.  in_validator marks
            # the _edge_lock region for the GC-reentrancy guard above.
            tls.in_validator = True
            try:
                with self._edge_lock:
                    reverse_witness = self._find_path_witness(
                        dep.name, held.name
                    )
                    if reverse_witness is None:
                        edge = (held.name, dep.name)
                        if edge not in self._edges:
                            self._edges[edge] = (
                                f"{threading.current_thread().name} "
                                f"at {site}"
                            )
                            self._adjacency.setdefault(
                                held.name, set()
                            ).add(dep.name)
            finally:
                tls.in_validator = False
            if reverse_witness is not None:
                self._violate_inversion(
                    dep, held, held_names, reverse_witness
                )
                return

    def note_acquired(self, dep: DepLock) -> None:
        self._stack().append(dep)

    def note_released(self, dep: DepLock) -> None:
        """Remove the newest matching frame, wherever it sits: releasing
        out of acquisition order is legal for Python locks."""
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is dep:
                del stack[i]
                return
        # acquired before enable() (or handed across threads): ignore

    # -- edge graph ------------------------------------------------------ #

    def _find_path_witness(self, start: str, goal: str) -> Optional[str]:
        """Witness of the first edge on an observed path start->...->goal,
        or None.  Caller holds ``_edge_lock``."""
        if start == goal:
            return None
        seen: Set[str] = set()
        stack: List[Tuple[str, str]] = [
            (nxt, self._edges[(start, nxt)])
            for nxt in self._adjacency.get(start, ())
        ]
        while stack:
            node, witness = stack.pop()
            if node == goal:
                return witness
            if node in seen:
                continue
            seen.add(node)
            stack.extend(
                (nxt, witness) for nxt in self._adjacency.get(node, ())
            )
        return None

    def _violate_inversion(
        self,
        dep: DepLock,
        held: DepLock,
        held_names: Tuple[str, ...],
        reverse_witness: str,
    ) -> None:
        self._violate(
            "observed-inversion",
            dep,
            held_names,
            f"acquiring {dep.name!r} while holding {held.name!r}, but "
            f"{dep.name} -> {held.name} was already observed "
            f"({reverse_witness}) — an ABBA deadlock waiting for the "
            "interleaving",
        )

    # -- violation plumbing ---------------------------------------------- #

    def _violate(
        self,
        kind: str,
        dep: DepLock,
        held: Tuple[str, ...],
        message: str,
    ) -> None:
        violation = _Violation(
            kind,
            dep.name,
            held,
            threading.current_thread().name,
            _caller_site(),
            message,
        )
        self.violation_list.append(violation)
        try:
            from modin_tpu_torch.logging.metrics import emit_metric

            emit_metric("concurrency.lockdep.violation", 1)
        except Exception:  # pragma: no cover - metrics must never block this
            pass
        try:
            from modin_tpu_torch.observability.flight_recorder import dump_flight_record

            dump_flight_record(
                f"lockdep-{kind}", detail=violation.render()
            )
        except Exception:  # pragma: no cover - the dump is best-effort
            pass
        if self.strict:
            raise LockdepViolation(kind, violation.render())


# ---------------------------------------------------------------------- #
# public switches / introspection
# ---------------------------------------------------------------------- #


#: DepLock's methods while lockdep is off: the raw lock's own, bound once
#: per lock and handed back by a C-level getter (``with`` looks
#: ``__enter__``/``__exit__`` up on the class, so each is a property over
#: the slot that holds the bound method), which leaves no Python frame
#: between a caller and the C lock
_RAW_METHODS = {name: property(attrgetter(slot)) for name, slot in (
    ("acquire", "_acquire"), ("release", "_release"), ("__enter__", "_enter"), ("__exit__", "_exit"))}
_CHECKED_METHODS = {"acquire": DepLock._checked_acquire, "release": DepLock._checked_release,
                    "__enter__": DepLock._checked_enter, "__exit__": DepLock._checked_exit}


def _install(methods: Dict[str, object]) -> None:
    for name, method in methods.items():
        setattr(DepLock, name, method)


def enable(strict: bool = True) -> None:
    """Install a fresh validator (clearing prior stacks/edges/violations).

    ``strict=False`` records violations without raising — smoke gates use
    it to count a whole workload's violations in one pass.
    """
    global _validator
    _validator = _Validator(strict)
    _install(_CHECKED_METHODS)


def disable() -> None:
    global _validator
    _validator = None
    _install(_RAW_METHODS)


def enabled() -> bool:
    return _validator is not None


def violations() -> List[_Violation]:
    """Violations recorded since :func:`enable` (empty while disabled)."""
    v = _validator
    return list(v.violation_list) if v is not None else []


def reset_violations() -> None:
    v = _validator
    if v is not None:
        v.violation_list.clear()


def held_locks() -> List[str]:
    """The calling thread's current named-acquisition stack (debug)."""
    v = _validator
    if v is None:
        return []
    return [d.name for d in v._stack()]


def observed_edges() -> Dict[Tuple[str, str], str]:
    """{(before, after): first witness} accumulated since enable()."""
    v = _validator
    if v is None:
        return {}
    # in_validator: the dict copy allocates under the raw _edge_lock, so a
    # GC-fired weakref callback acquiring a DepLock here must skip
    # validation or it would re-take _edge_lock on this same thread
    v._tls.in_validator = True
    try:
        with v._edge_lock:
            return dict(v._edges)
    finally:
        v._tls.in_validator = False


# Debug-mode opt-in at import.  The settings module imports nothing of the
# port, so it is importable before the first lock is built.
from modin_tpu_torch.config.envvars import LockdepEnabled as _LockdepEnabled  # noqa: E402

if _LockdepEnabled.get():
    enable()
else:
    _install(_RAW_METHODS)
