"""The LOCKS registry: every named lock of the port, and the partial order
in which they may nest.

The port's counterpart of ``modin_tpu/concurrency/registry.py``.  Every
module that holds a lock builds it through ``named_lock``/``named_rlock``
(``concurrency/lockdep.py``) under a name declared here, so two facts are
data instead of folklore: which locks exist, and in what order they may be
held.  The runtime validator (``MODIN_TPU_TORCH_LOCKDEP=1`` or
``lockdep.enable()``) records each thread's acquisition stack and raises on
an acquisition that contradicts :data:`LOCK_ORDER` or an order some thread
was seen taking the other way.

A lock with a counterpart in the JAX package keeps its name and kind there
(``serving.gate``, ``resilience.dispatch``, ``recovery.reseat``,
``memory.device_ledger``, ``views.registry``, ...).  The port's own locks
take names of the same shape: ``ops.cuda.build`` (the kernels' build-once),
``ops.router`` (the calibration table, reentrant: a calibration reads the
table it fills), ``compile_ledger.pending`` (the CUDA event pairs waiting to
resolve), ``metrics.counted`` (the always-on tally) and
``resilience.counts`` (the fallback count).  On the names both packages
declare, the declared order is the JAX package's
(``tests/test_torch_concurrency.py`` holds the two to each other).

This module is a leaf: data and pure helpers, no import of the port, since
locks are built while the port's modules import.

Declaration shape: ``("dotted.name", "lock" | "rlock", "what it guards")``.
An edge ``(before, after, why)`` of :data:`LOCK_ORDER` means ``before`` may
be held while ``after`` is acquired, so ``after`` must never be held while
``before`` is acquired.  Edges are declared only where code nests.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, Set, Tuple

#: every named lock of the port: (name, kind, what it guards).  The kind is
#: checked when the lock is built, so reentrancy is declared data.
LOCKS: Tuple[Tuple[str, str, str], ...] = (
    # -- serving front door ------------------------------------------------ #
    ("serving.gate", "lock", "admission gate counters, reservations, waiter queue"),
    ("serving.context_active", "lock", "active serving-context count behind CONTEXT_ON"),
    ("serving.tenants", "lock", "tenant table: weights, buckets, cost EWMAs, LRU"),
    # -- engine seam / resilience / recovery ------------------------------- #
    ("resilience.dispatch", "rlock", "launch serialization at the engine seam and the device paths while a serving context is active"),
    ("resilience.breaker", "lock", "one circuit breaker's state/strike transitions"),
    ("resilience.breakers", "lock", "the process-wide breaker name table"),
    ("resilience.counts", "lock", "the count of device-path calls pandas answered"),
    ("recovery.epoch", "lock", "device-epoch counter bumps"),
    ("recovery.reseat", "lock", "whole reseat passes + the reseat-once handshake"),
    ("recovery.provenance", "rlock", "deploy provenance table (weakref callbacks re-enter)"),
    # -- memory ------------------------------------------------------------ #
    ("memory.host_cache", "rlock", "host spill-cache ledger (weakref callbacks re-enter)"),
    ("memory.device_ledger", "rlock", "device residency ledger + LRU spill order (weakref callbacks re-enter)"),
    # -- ops / plan caches ------------------------------------------------- #
    ("ops.router", "rlock", "kernel-router calibration table resolve-once (a calibration reads the table it fills)"),
    ("ops.fused_cache", "lock", "fused-program LRU cache linkage"),
    ("ops.cuda.build", "lock", "the CUDA kernels' nvcc build and load, once per source"),
    ("plan.scan_cache", "lock", "scan-node parse cache (parses happen outside it)"),
    ("plan.optimizer", "lock", "optimizer priors resolve-once cache"),
    ("views.registry", "rlock", "THE derived-artifact cache (invalidation re-enters via drop hooks)"),
    ("parallel.mesh", "lock", "global mesh build-once"),
    ("io.chunker", "lock", "chunker native-library build-once"),
    # -- observability ----------------------------------------------------- #
    ("meters.scopes", "lock", "process-wide open QueryStats scope set + registry acquires"),
    ("meters.registry", "lock", "meter families: create/observe/snapshot"),
    ("meters.query_stats", "lock", "one QueryStats scope's accumulation vs close"),
    ("metrics.counted", "lock", "the always-on tally of emit_counted"),
    ("costs.padding", "lock", "global padding-waste accumulators"),
    ("costs.ledger", "lock", "per-signature cost entries joined with dispatch wall"),
    ("costs.peaks", "lock", "substrate peak measurement resolve-once"),
    ("spans.state", "lock", "tracing enable state + profile collectors"),
    ("spans.live", "lock", "live-span counter read-modify-write"),
    ("compile_ledger.entries", "lock", "per-signature launch accounting"),
    ("compile_ledger.pending", "lock", "CUDA event pairs waiting to resolve, and the event pool"),
    ("flight.dump", "lock", "flight-dump rate-limit claim token"),
    ("logging.configure", "lock", "log-handler + memory-sampler configure-once"),
    # -- test harness ------------------------------------------------------ #
    ("testing.faults", "lock", "fault-injector hook counters"),
)

#: names where holding several *instances* at once is legal (each instance
#: guards its own object and no path holds two in conflicting orders)
NESTABLE: FrozenSet[str] = frozenset(
    {
        # one QueryStats scope closing can fold into its parent scope
        "meters.query_stats",
    }
)

#: locks whose critical sections acquire nothing else, because weakref
#: death callbacks may fire while any lock is held and each callback
#: re-enters one of these.  The validator ignores edges out of a leaf: the
#: only way to hold one while acquiring another lock is such a callback.
LEAF_LOCKS: FrozenSet[str] = frozenset(
    {
        "memory.host_cache",
        "memory.device_ledger",
        "recovery.provenance",
    }
)

#: the intended partial order, ``(before, after, why)``: ``before`` may be
#: held while ``after`` is acquired.  Acquiring ``before`` while ``after``
#: is held is the checked contradiction.
LOCK_ORDER: Tuple[Tuple[str, str, str], ...] = (
    # the admission gate may admit into a dispatch (gate held -> engine
    # work), but the engine seam and recovery never call back into the gate
    ("serving.gate", "resilience.dispatch", "admission decides before the seam dispatches; seam code never re-enters the gate"),
    ("resilience.dispatch", "recovery.reseat", "a failed attempt under the dispatch serialization runs the reseat pass; reseat never dispatches back through the serialization it is under"),
    ("recovery.reseat", "recovery.provenance", "the reseat pass walks the provenance table per lost tensor"),
    ("recovery.reseat", "recovery.epoch", "the reseat pass advances the device epoch it completed"),
    ("recovery.reseat", "memory.device_ledger", "reseat re-registers recovered tensors with the residency ledger"),
    ("recovery.reseat", "parallel.mesh", "the reseat pass re-uploads through the mesh's device"),
    # the ledger/provenance locks are leaves: no outgoing edge, ever
    ("views.registry", "memory.device_ledger", "artifact drop deregisters its device payload under the registry serialization; ledger spill snapshots candidates under its own lock and drops outside it"),
    ("resilience.breakers", "resilience.breaker", "breaker lookup creates/reads one breaker under the table lock"),
    ("serving.tenants", "resilience.breakers", "tenant health/eviction reads its breaker under the tenant table lock"),
    ("meters.scopes", "meters.registry", "scope open/close folds into the registry; registry code never opens scopes"),
    ("meters.scopes", "meters.query_stats", "the spill/fold pass walks open scopes and accumulates into each"),
    ("serving.gate", "serving.tenants", "admission reads tenant weights/costs while deciding; tenant bookkeeping never re-enters the gate"),
)


def declared_kinds() -> Dict[str, str]:
    """{lock name: "lock" | "rlock"} from :data:`LOCKS`."""
    return {name: kind for name, kind, _ in LOCKS}


def order_edges() -> Set[Tuple[str, str]]:
    """The declared edge set, without rationale strings."""
    return {(before, after) for before, after, _ in LOCK_ORDER}


def transitive_order(edges: Iterable[Tuple[str, str]] = None) -> Dict[str, Set[str]]:
    """{name: every name it precedes}: the declared order's closure."""
    if edges is None:
        edges = order_edges()
    adjacency: Dict[str, Set[str]] = {}
    for before, after in edges:
        adjacency.setdefault(before, set()).add(after)
    closure: Dict[str, Set[str]] = {}
    for start in adjacency:
        seen: Set[str] = set()
        stack = list(adjacency[start])
        while stack:
            node = stack.pop()
            if node in seen:
                continue
            seen.add(node)
            stack.extend(adjacency.get(node, ()))
        closure[start] = seen
    return closure


def validate_registry() -> None:
    """Internal-consistency checks, run at the first ``named_lock`` call:
    duplicate declarations, order edges over undeclared names, self-edges,
    an order that cycles, and edges out of a leaf."""
    names = [name for name, _, _ in LOCKS]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate LOCKS declarations: {sorted(dupes)}")
    declared = set(names)
    for before, after, _ in LOCK_ORDER:
        if before == after:
            raise ValueError(f"self-edge in LOCK_ORDER: {before}")
        for name in (before, after):
            if name not in declared:
                raise ValueError(f"LOCK_ORDER references undeclared lock {name!r}")
    closure = transitive_order()
    for before, after in order_edges():
        if before in closure.get(after, ()):
            raise ValueError(
                f"LOCK_ORDER declares both {before} -> {after} and a path "
                f"{after} -> {before}: the declared order itself cycles"
            )
    for name in NESTABLE | LEAF_LOCKS:
        if name not in declared:
            raise ValueError(f"NESTABLE or LEAF_LOCKS references undeclared lock {name!r}")
    for before, _after, _ in LOCK_ORDER:
        if before in LEAF_LOCKS:
            raise ValueError(
                f"LOCK_ORDER declares an edge out of leaf lock {before!r}: leaves "
                "acquire nothing by design (weakref callbacks re-enter them under any lock)"
            )
