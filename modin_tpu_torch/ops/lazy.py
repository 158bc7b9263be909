"""Deferred elementwise expressions: the port's op-fusion layer.

The counterpart of ``modin_tpu/ops/lazy.py``.  Chained column expressions
accumulate into a small DAG of :class:`LazyExpr` nodes, and the whole chain
runs as ONE launch of the fused kernel (``ops/cuda/fused_kernels.py``) when a
consumer needs concrete data, so ``(a * b + c).sum()`` reads its three
columns once and writes no intermediate column.

- Leaves are concrete torch tensors (device columns) or Python/numpy scalars.
  Scalars are runtime arguments of the program, not part of its
  fingerprint, so ``df * 2`` and ``df * 3`` share one program; their tags
  (``int``, ``float``, ``bool`` or a numpy dtype) are part of it, since a
  Python scalar is weak in numpy's promotion and a numpy scalar is not.
- A node's dtype comes without computing: the eager op of the registry
  (``ops/elementwise.get_op``) applied to 0-length CPU tensors of the input
  dtypes and to the scalars themselves, so a fused dtype is the eager path's
  by construction.
- Graphs are linearized (postorder, a diamond's shared node once) into a
  structural fingerprint, and the compiled programs
  (``ops/cuda/fused_program.py``) are cached per fingerprint and tail in an
  LRU bounded by ``MODIN_TPU_TORCH_FUSED_CACHE_SIZE``.
- A fused run can end in a *tail*: the column reductions of
  ``ops/reductions.py`` fold into the same launch, and a moments tail
  (var/std/sem/skew/kurt) takes a second launch about the first one's means.
- ``_MAX_NODES`` caps a chain: past it the chain materializes, so a loop that
  updates a column thousands of times does not grow one graph without end.
- An op the kernel does not take (the scan-kernel cumulative ops, a float16
  result) is a *barrier*: its inputs materialize in one fused launch, it runs
  eagerly, and its result is a leaf.  ``BARRIERS`` counts them.
- A program-cache miss lowers the forest on the host (a ``fusion.lower``
  span, billed to the launch ledger as a compile); a hit counts
  ``fusion.cache.hit`` while meter accounting is on.

A chain holds references to its leaf tensors until it materializes, so no
path of the port writes into a column tensor in place.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from modin_tpu_torch.concurrency import named_lock
from modin_tpu_torch.core import memory as _memory
from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.observability import compile_ledger as _ledger
from modin_tpu_torch.observability import meters as _meters
from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.core.execution import recovery as _recovery
from modin_tpu_torch.ops.cuda import fused_kernels
from modin_tpu_torch.ops.cuda import fused_program as fp
from modin_tpu_torch.serving import context as serving_context

_MAX_NODES = 160

_SCALAR_TYPES = (int, float, bool, np.integer, np.floating, np.bool_)

# lazy nodes that ran eagerly because the fused kernel does not take them
BARRIERS = 0

# (fingerprint, tail) -> compiled programs, LRU-bounded by FusedCacheSize;
# every access holds _FUSED_LOCK (a move_to_end racing a popitem can corrupt
# an OrderedDict)
_FUSED_CACHE: "OrderedDict[Any, Any]" = OrderedDict()
_FUSED_LOCK = named_lock("ops.fused_cache")
_evictions = 0


def _fused_cache_get(key: Any) -> Optional[Any]:
    with _FUSED_LOCK:
        plan = _FUSED_CACHE.get(key)
        if plan is not None:
            _FUSED_CACHE.move_to_end(key)
    if plan is not None:
        if _meters.ACCOUNTING_ON:
            emit_metric("fusion.cache.hit", 1)
        if _ledger.LEDGER_ON:
            _ledger.note_cache_hit()
    return plan


def _fused_cache_put(key: Any, plan: Any) -> None:
    global _evictions
    from modin_tpu_torch.config import FusedCacheSize

    limit = FusedCacheSize.get()
    evicted = 0
    with _FUSED_LOCK:
        _FUSED_CACHE[key] = plan
        _FUSED_CACHE.move_to_end(key)
        if limit > 0:
            while len(_FUSED_CACHE) > limit:
                _FUSED_CACHE.popitem(last=False)
                evicted += 1
        _evictions += evicted
    if evicted:
        emit_metric("fusion.cache.evict", evicted)


def fused_cache_evictions() -> int:
    """Process-lifetime count of cached programs evicted by the LRU."""
    return _evictions


def fused_cache_len() -> int:
    return len(_FUSED_CACHE)


class LazyExpr:
    """One deferred op node: ``get_op(op)(*args, **dict(static))``.

    ``args`` are LazyExpr children, tensor leaves or scalars; ``static`` is a
    hashable tuple of keyword pairs compiled into the program (a round's
    decimals, an astype's target).
    """

    __slots__ = ("op", "args", "static", "dtype", "shape", "device", "size", "_result")

    def __init__(self, op: str, args: Tuple[Any, ...], static: Tuple, dtype: torch.dtype):
        self.op = op
        self.args = args
        self.static = static
        self.dtype = dtype
        self._result = None
        size = 1
        shape = device = None
        for a in args:
            if isinstance(a, LazyExpr) and a._result is None:
                size += a.size
            if isinstance(a, (LazyExpr, torch.Tensor)) and shape is None:
                shape, device = tuple(a.shape), a.device
        self.size = size
        self.shape = shape
        self.device = device

    def __repr__(self) -> str:
        return f"LazyExpr({self.op}, size={self.size}, dtype={self.dtype})"


def _eval_dtype(op: str, args: Tuple[Any, ...], static: Tuple) -> torch.dtype:
    """The node's dtype from the eager op over 0-length CPU tensors."""
    from modin_tpu_torch.ops.elementwise import get_op

    meta = [torch.empty(0, dtype=a.dtype) if isinstance(a, (LazyExpr, torch.Tensor)) else a for a in args]
    return get_op(op)(*meta, **dict(static)).dtype


def is_lazy(x: Any) -> bool:
    return isinstance(x, LazyExpr) and x._result is None


def _distinct_size(root: LazyExpr) -> int:
    """Exact count of distinct unmaterialized nodes (diamonds counted once)."""
    seen = set()
    stack = [root]
    while stack:
        e = stack.pop()
        if not isinstance(e, LazyExpr) or e._result is not None or id(e) in seen:
            continue
        seen.add(id(e))
        stack.extend(a for a in e.args if isinstance(a, LazyExpr))
    return len(seen)


def lazy_op(op: str, *args: Any, static: Tuple = ()) -> Any:
    """A deferred node of ``op`` over ``args``; an op the fused kernel does
    not take runs at once on materialized inputs (a barrier), and an
    oversized graph materializes."""
    global BARRIERS
    dtype = _eval_dtype(op, args, static)
    tensor_dtypes = [a.dtype for a in args if isinstance(a, (LazyExpr, torch.Tensor))]
    if not fp.fusable(op, tensor_dtypes, dtype):
        from modin_tpu_torch.ops.elementwise import get_op

        lazy_args = [a for a in args if is_lazy(a)]
        BARRIERS += bool(lazy_args)
        values = dict(zip(map(id, lazy_args), materialize_exprs(lazy_args)))
        concrete = [values.get(id(a), materialize(a)) if isinstance(a, LazyExpr) else a for a in args]
        return get_op(op)(*concrete, **dict(static))
    e = LazyExpr(op, args, static, dtype)
    if e.size > _MAX_NODES:
        # size double-counts diamond sharing: confirm with the exact count
        e.size = _distinct_size(e)
        if e.size > _MAX_NODES:
            materialize_exprs([e])
    return e


class Linearized(NamedTuple):
    nodes: List[Tuple]  # postorder (op, refs, static); a ref is ("n"|"l"|"s", i)
    node_exprs: List[LazyExpr]
    node_codes: List[int]
    out_refs: Tuple
    leaves: List[torch.Tensor]
    leaf_codes: List[int]
    scalars: List[Any]
    scalar_tags: List[Tuple[str, Any]]
    fingerprint: Tuple


# the int dtypes whose range decides a weak Python int's promotion
_INT_RANGES = tuple(np.iinfo(t) for t in (np.int8, np.uint8, np.int16, np.int32, np.int64))


def _scalar_tag(e: Any) -> str:
    """A scalar's part of the fingerprint: its numpy dtype (strong), or its
    Python type, and for an int the ranges that hold it (a comparison with
    an int its column's dtype cannot hold computes in int64)."""
    if isinstance(e, np.generic):
        return str(np.dtype(type(e)))
    if isinstance(e, int) and not isinstance(e, bool):
        return "int:" + "".join("1" if r.min <= e <= r.max else "0" for r in _INT_RANGES)
    return type(e).__name__


def _linearize(roots: Sequence[Any]) -> Linearized:
    """Flatten an expression forest: nodes in postorder (a diamond's shared
    node once), leaves and scalars in first-visit order, and the structural
    fingerprint (nodes, out refs, leaf dtypes and shapes, scalar tags)."""
    nodes: List[Tuple] = []
    node_exprs: List[LazyExpr] = []
    node_idx: Dict[int, int] = {}
    leaves: List[torch.Tensor] = []
    leaf_idx: Dict[int, int] = {}
    leaf_tags: List[Tuple] = []
    scalars: List[Any] = []
    scalar_tags: List[Tuple[str, Any]] = []

    def visit_leaf(x) -> Tuple[str, int]:
        i = leaf_idx.get(id(x))
        if i is None:
            i = len(leaves)
            leaves.append(x)
            leaf_idx[id(x)] = i
            leaf_tags.append((str(x.dtype), tuple(x.shape)))
        return ("l", i)

    def visit(e) -> Tuple[str, int]:
        if isinstance(e, LazyExpr):
            if e._result is not None:
                return visit_leaf(e._result)
            i = node_idx.get(id(e))
            if i is not None:
                return ("n", i)
            refs = tuple(visit(a) for a in e.args)
            nodes.append((e.op, refs, e.static))
            node_exprs.append(e)
            i = len(nodes) - 1
            node_idx[id(e)] = i
            return ("n", i)
        if isinstance(e, _SCALAR_TYPES):
            scalars.append(e)
            scalar_tags.append((_scalar_tag(e), e))
            return ("s", len(scalars) - 1)
        return visit_leaf(e)

    out_refs = tuple(visit(r) for r in roots)
    # the recursive closure is a reference cycle through its cell, and its
    # scope holds the leaf tensors and the nodes (their results too): break
    # it, or they outlive this call until the garbage collector runs, and a
    # spilled or donated column's storage with them
    visit = None
    fingerprint = (tuple(nodes), out_refs, tuple(leaf_tags), tuple(t for t, _ in scalar_tags))
    return Linearized(
        nodes, node_exprs, [fp.DTYPE_CODES[e.dtype] for e in node_exprs], out_refs,
        leaves, [fp.DTYPE_CODES[t.dtype] for t in leaves], scalars, scalar_tags, fingerprint,
    )


def _plan(roots: Sequence[Any], tail_key: Optional[Tuple]) -> Tuple[Linearized, List[fp.Program]]:
    """The linearized forest and its programs (from the cache, or compiled;
    nodes a root cannot fit around materialize first)."""
    while True:
        lin = _linearize(roots)
        # the device epoch joins the key: a re-seat compiles programs anew
        # rather than trusting one made before the loss
        key = (lin.fingerprint + (_recovery.current_epoch(),), tail_key)
        plan = _fused_cache_get(key)
        if plan is not None:
            return lin, plan
        t0 = time.perf_counter()
        with _spans.span("fusion.lower", "TORCH-ENGINE", nodes=len(lin.nodes)):
            plan = fp.compile_forest(lin.nodes, lin.node_codes, lin.out_refs, lin.leaf_codes,
                                     lin.scalar_tags, tail_key)
        if _ledger.LEDGER_ON:
            _ledger.note_lowering(time.perf_counter() - t0)
        if isinstance(plan, fp.Cut):
            materialize_exprs([lin.node_exprs[i] for i in plan.nodes])
            continue
        _fused_cache_put(key, plan)
        return lin, plan


def _leaf_args(lin: Linearized, program: fp.Program) -> List[torch.Tensor]:
    return [lin.leaves[i].contiguous() for i in program.leaves]


def _rows(lin: Linearized) -> Tuple[int, torch.device]:
    t = lin.leaves[0]
    return int(t.shape[0]), t.device


def _admit(lin: Linearized, out_bytes: int) -> None:
    """Make room for a launch's outputs under ``DeviceMemoryBudget``
    (``core/memory.py``), spilling none of the launch's own leaves."""
    from modin_tpu_torch.core import memory

    memory.device_ledger.admit(out_bytes, exclude_ids={memory.storage_key(t) for t in lin.leaves})


def _program_call(program: fp.Program, scalars: Sequence[Any], n: int, second_pass: bool = False) -> Callable:
    """One fused launch as a function of its tensors alone (the leaves and
    a first pass's accumulators): what ``TorchWrapper.deploy`` records for
    op replay, which must hold no tensor of its own."""

    def call(leaves: Tuple[torch.Tensor, ...], first: Optional[torch.Tensor] = None):
        return fused_kernels.run_program(program, list(leaves), scalars, n, second_pass=second_pass, first=first)

    return call


def _launch(lin: "Linearized", program: fp.Program, n: int, record: bool, second_pass: bool = False,
            first: Optional[torch.Tensor] = None):
    """``fused_kernels.run_program`` through the engine seam (the resilience
    policy, and op-replay provenance where ``record``): ``(outs,
    accumulators)``."""
    from modin_tpu_torch.parallel.engine import TorchWrapper

    return TorchWrapper.deploy(
        _program_call(program, lin.scalars, n, second_pass),
        (tuple(_leaf_args(lin, program)), first),
        record=record,
    )


def run_fused(
    roots: Sequence[Any],
    tail_key: Optional[Tuple] = None,
    tail_builder: Optional[Callable[..., Any]] = None,
    donated: bool = False,
):
    """Run the whole forest (and an optional tail) as fused launches.

    Without a tail: returns the concrete tensors of ``roots`` (tensors pass
    through) and memoizes each LazyExpr root's result; one launch serves
    all the lazy roots unless they exceed one program's caps.  With a tail
    (``("reduce", op, skipna, ddof, cast_bool)`` or ``("rows", op, skipna,
    cast_bool)``), ``tail_builder`` receives what the kernel gave: for
    ``reduce`` the accumulators of every root, ``[len(roots), 3]`` int64,
    and for a moments op the second pass's too; for ``rows`` the output
    column.  Its result is returned.  A masked reduce tail (a sixth item,
    True) takes the last root as the bool mask: ``first`` then holds the
    other roots' accumulators and, last, the mask's, whose count slot is the
    kept-row count.  Every launch goes through ``TorchWrapper.deploy``;
    ``donated`` says the caller drops the leaves' columns after the run, so
    no op-replay record is kept.  Nor is one kept for a reduce tail's
    launches: their accumulators feed the tail, never a column.
    """
    if serving_context.CONTEXT_ON:
        # a deferred query pays for its whole expression forest here: the
        # deadline is checked before the plan and the launches, not after
        serving_context.check_deadline("fusion.run_fused")
    if tail_key is None:
        lazy_roots = list({id(r): r for r in roots if is_lazy(r)}.values())
        if lazy_roots:
            lin, plan = _plan(lazy_roots, None)
            n, dev = _rows(lin)
            if _memory._DEVICE_BUDGET is not None:
                _admit(lin, sum(n * r.dtype.itemsize for r in lazy_roots))
            for program in plan:
                outs, _ = _launch(lin, program, n, not donated)
                for k, j in enumerate(program.roots):
                    lazy_roots[j]._result = outs[k]
        return [r._result if isinstance(r, LazyExpr) else r for r in roots]
    lin, plan = _plan(list(roots), tail_key)
    n, dev = _rows(lin)
    if _memory._DEVICE_BUDGET is not None:
        _admit(lin, n * 8 if tail_key[0] == "rows" else 0)
    if tail_key[0] == "rows":
        outs, _ = _launch(lin, plan[0], n, not donated)
        return tail_builder(outs[0]) if tail_builder is not None else outs[0]
    firsts = [_launch(lin, p, n, False)[1] for p in plan]
    seconds = None
    if tail_key[1] in fp.MOMENT_OPS:
        seconds = [_launch(lin, p, n, False, second_pass=True, first=f)[1] for p, f in zip(plan, firsts)]
    if fp.is_masked(tail_key):
        # each program ends with its kept-row count: keep the first one, last
        kept = firsts[0][-1:]
        firsts = [f[:-1] for f in firsts] + [kept]
        seconds = None if seconds is None else [s[:-1] for s in seconds]
    first = torch.cat(firsts)
    second = None if seconds is None else torch.cat(seconds)
    return tail_builder(first, second) if tail_builder is not None else (first, second)


def leaf_buffer_ids(roots: Sequence[Any]) -> frozenset:
    """``id()`` of every concrete tensor leaf an expression forest reads."""
    ids = set()
    seen = set()
    stack = list(roots)
    while stack:
        e = stack.pop()
        if isinstance(e, LazyExpr):
            if e._result is not None:
                ids.add(id(e._result))
                continue
            if id(e) in seen:
                continue
            seen.add(id(e))
            stack.extend(e.args)
        elif isinstance(e, torch.Tensor):
            ids.add(id(e))
    return frozenset(ids)


def materialize_exprs(items: Sequence[Any]) -> List[Any]:
    """Concrete tensors for a mixed list of tensors and exprs (one launch
    for all the lazy ones that fit one program)."""
    return run_fused(items)


def materialize(item: Any):
    if is_lazy(item):
        return run_fused([item])[0]
    return item._result if isinstance(item, LazyExpr) else item
