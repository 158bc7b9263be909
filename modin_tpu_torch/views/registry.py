"""The artifact registry: derived values shared across queries.

The port's counterpart of ``modin_tpu/views/registry.py``.  An artifact is
a value computed from a column's tensor that a later query on the same
tensor can reuse: a whole reduction result, a nunique/mode/median answer,
a small groupby table, and (``ops/sorted_cache.py``) the sorted
representation.

Identity
--------

A ``DeviceColumn`` gets a **view token**, a process-unique int, when the
registry first needs one.  Columns are replaced, never grown, by the
structural ops, so a token names one column.  ``concat_rows`` records the
appended column's **parent link** ``(parent token, parent length, parent
tensor version)``: the child's first ``parent length`` rows are the
parent's rows, so an artifact built from the parent answers for the
child's prefix and only the tail needs folding in.  Two appends onto one
parent get two child tokens, so a fold for one branch never serves the
other.

JAX arrays are immutable; torch tensors can be written in place and the
caching allocator reuses addresses.  So an artifact keys on the token,
holds a weak reference to the tensor it was computed from and that
tensor's ``_version`` (torch bumps it on every in-place write), and
answers only while both still match: an in-place write turns a hit into a
miss for one integer compare.  A parent link carries the parent's version
too.  Every buffer change of a column (spill, restore, materialization,
donation, replacement) drops its artifacts eagerly
(:func:`invalidate_column`).

Memory
------

An artifact with a device payload is a derived entry of the device ledger
(``core/memory.py``): pressure drops it before any column.  Host state
(scalars, tables) is bounded by the registry's LRU:
``MODIN_TPU_TORCH_VIEWS_MAX_ENTRIES`` entries and
``MODIN_TPU_TORCH_VIEWS_HOST_BUDGET`` bytes, coldest first.

Concurrency
-----------

One reentrant lock serializes lookup, store and invalidation.  A fold runs
lookup, compute, :func:`store`; the store re-checks under the lock that
the column still holds the tensor the caller read, so a spill (or any
buffer change) between lookup and commit makes the commit a no-op instead
of a stale write.

Events are emitted under the JAX package's metric names (``view.hit``,
``view.fold``, ``view.miss``, ``view.build``, ``view.evict``,
``view.spill``, ``view.chain_compact`` and ``view.invalidate.<reason>``)
through ``logging/metrics.py``'s always-on tally; :data:`COUNTS` reads it.
Every artifact is stamped with the device epoch of
``core/execution/recovery.py``: a re-seat pass bumps it, so no artifact
built before a device loss answers after it, and the pass drops the
artifacts (and the sorted representations) that hold device payloads
instead of replaying them.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from modin_tpu_torch.concurrency import named_rlock
from modin_tpu_torch.logging.metrics import CountView, emit_counted

#: the derived-cache lock (reentrant: a ledger spill drops artifacts under
#: it, and the sorted-representation shim re-enters through invalidation)
LOCK = named_rlock("views.registry")

#: events by the JAX package's metric names: a read of the metric layer's
#: tally
COUNTS = CountView(
    prefixes=("view.",),
    names=("view.hit", "view.miss", "view.fold", "view.build", "view.evict", "view.spill", "view.chain_compact"),
)

count = emit_counted


_token_counter = 0

#: (token, kind, params) -> DerivedArtifact, insertion order = LRU
_entries: "OrderedDict[Tuple[int, str, Any], Any]" = OrderedDict()
#: token -> its live ``_entries`` keys
_by_token: Dict[int, set] = {}
_host_bytes_total = 0

#: token -> its append-chain depth (parent links below it)
_link_depth: Dict[int, int] = {}
_walk_hops_total = 0
_walk_lookups = 0

#: token -> its own (parent token, parent length, parent version) link, so
#: a fold lookup walks chains whose intermediate columns are gone;
#: FIFO-bounded
_parent_links: "OrderedDict[int, Tuple[int, int, int]]" = OrderedDict()
_PARENT_LINKS_MAX = 65536


def ensure_token(col: Any) -> int:
    """``col``'s view token, allocated on first use."""
    tok = col._view_token
    if tok is not None:
        return tok
    global _token_counter
    with LOCK:
        tok = col._view_token
        if tok is None:
            _token_counter += 1
            tok = _token_counter
            col._view_token = tok
    return tok


def _tensor(col: Any) -> Any:
    """``col``'s concrete tensor, or None (spilled or deferred)."""
    t = col._data
    return None if t is None or col.is_lazy else t


def _max_chain() -> int:
    from modin_tpu_torch.config import ViewsMaxChain

    return int(ViewsMaxChain.get())


def _current_epoch() -> int:
    from modin_tpu_torch.core.execution import recovery

    return recovery.current_epoch()


def _mesh_key() -> str:
    from modin_tpu_torch.parallel.mesh import mesh_shape_key

    return mesh_shape_key()


def _note_link_locked(token: int, link: Tuple[int, int, int]) -> None:
    _parent_links[token] = link
    while len(_parent_links) > _PARENT_LINKS_MAX:
        old_tok, _ = _parent_links.popitem(last=False)
        _link_depth.pop(old_tok, None)


def _compact_link_locked(link: Tuple[int, int, int]) -> Tuple[Tuple[int, int, int], int]:
    """Follow ``link`` past tokens that hold no artifact: the first link
    whose token holds one (or the deepest reachable), and the links
    skipped.  A prefix of a prefix is a prefix, so nothing is lost."""
    skipped = 0
    bound = _max_chain()
    while skipped < bound:
        if link[0] in _by_token:
            break
        nxt = _parent_links.get(link[0])
        if nxt is None:
            break
        link = nxt
        skipped += 1
    return link, skipped


def note_append(child: Any, parent: Any) -> None:
    """Record that ``child``'s first ``parent.length`` rows are ``parent``'s
    rows (``concat_rows``).  A chain deeper than ``ViewsMaxChain`` is
    compacted: the child's link re-anchors past ancestors that hold no
    artifact, so a long run of appends keeps the walk short."""
    compacted = 0
    with LOCK:
        ptok = ensure_token(parent)
        ctok = ensure_token(child)
        pdata = _tensor(parent)
        link = (ptok, int(parent.length), -1 if pdata is None else int(pdata._version))
        depth = _link_depth.get(ptok, 0) + 1
        plink = parent._view_parent
        if plink is not None:
            _note_link_locked(ptok, plink)
        if depth > _max_chain():
            link, skipped = _compact_link_locked(link)
            if skipped:
                depth = _link_depth.get(link[0], 0) + 1
                compacted = 1
        child._view_parent = link
        _note_link_locked(ctok, link)
        _link_depth[ctok] = depth
    if compacted:
        count("view.chain_compact")


class DerivedArtifact:
    """One cached derived value.

    ``state`` is the host payload (a dict the cache layer owns);
    ``_payload`` an optional device tensor, a derived entry of the device
    ledger.  ``token``/``length``/``_source``/``version``/``epoch``/
    ``mesh_key`` are the validity stamps; ``can_fold`` marks state that
    admits an append-only combine (``views/incremental.py``).
    """

    __slots__ = (
        "kind", "params", "token", "length", "_source", "version", "epoch",
        "mesh_key", "state", "can_fold", "host_bytes", "_payload",
        "_dev_key", "owner_ref", "__weakref__",
    )

    #: the device ledger drops a derived entry instead of copying it out
    is_derived_cache = True
    is_lazy = False

    def __init__(
        self,
        kind: str,
        params: Any,
        token: int,
        length: int,
        source: Any,
        state: Optional[dict],
        can_fold: bool = False,
        payload: Any = None,
        host_bytes: int = 0,
    ):
        self.kind = kind
        self.params = params
        self.token = token
        self.length = int(length)
        self._source = None if source is None else weakref.ref(source)
        self.version = -1 if source is None else int(source._version)
        self.epoch = _current_epoch()
        self.mesh_key = _mesh_key()
        self.state = state
        self.can_fold = bool(can_fold)
        self.host_bytes = int(host_bytes)
        self._payload = payload
        self._dev_key = None
        self.owner_ref = None

    @property
    def _data(self) -> Any:
        """Ledger protocol: the device payload this entry accounts for."""
        return self._payload

    @property
    def live(self) -> bool:
        return self.state is not None or self._payload is not None

    def answers_for(self, tensor: Any) -> bool:
        """Whether this artifact was computed from ``tensor`` as it stands."""
        return (
            tensor is not None
            and self._source is not None
            and self._source() is tensor
            and int(tensor._version) == self.version
        )

    def drop(self) -> int:
        """Release payload and state; returns the device bytes freed."""
        global _host_bytes_total
        with LOCK:
            freed = 0
            if self._payload is not None:
                from modin_tpu_torch.core.memory import device_ledger

                freed = device_ledger.deregister(self)
                self._payload = None
            if self.state is not None:
                self.state = None
                _host_bytes_total -= self.host_bytes
                self.host_bytes = 0
            key = (self.token, self.kind, self.params)
            if _entries.get(key) is self:
                _entries.pop(key, None)
                toks = _by_token.get(self.token)
                if toks is not None:
                    toks.discard(key)
                    if not toks:
                        _by_token.pop(self.token, None)
            return freed

    def spill(self) -> int:
        """Ledger spill protocol: derived data is dropped, not copied out."""
        freed = self.drop()
        if freed:
            count("view.spill")
        return freed


def _enforce_locked() -> int:
    """Evict the coldest artifacts past the entry and host-byte budgets;
    returns how many went."""
    from modin_tpu_torch.config import ViewsHostBudget, ViewsMaxEntries

    max_entries = int(ViewsMaxEntries.get())
    max_bytes = int(ViewsHostBudget.get())
    evicted = 0
    while _entries and (len(_entries) > max_entries or _host_bytes_total > max_bytes):
        _key, art = next(iter(_entries.items()))
        art.drop()
        evicted += 1
    return evicted


def _drop_locked(art: Any, reason: str, pending: List[str]) -> None:
    art.drop()
    pending.append(reason)


def _count_dropped(pending: List[str]) -> None:
    for reason in pending:
        count(f"view.invalidate.{reason}")


def _valid_locked(art: Any, col: Any) -> Optional[str]:
    """None when ``art`` is a live answer for ``col``; else why not (''
    = not this column's, not stale: keep it)."""
    if not art.live:
        return "dead"
    if art.epoch != _current_epoch():
        return "device_epoch"
    if art.mesh_key != _mesh_key():
        return "mesh_reshape"
    if art.token != col._view_token:
        return ""
    if art.length != col.length or not art.answers_for(_tensor(col)):
        return "buffer"
    return None


def column_artifact_kinds(col: Any) -> List[str]:
    """The kinds live now for ``col``'s own token: the optimizer's planning
    probe (nothing counted, no LRU touch, no parent walk)."""
    tok = col._view_token
    if tok is None or _tensor(col) is None:
        return []
    kinds: List[str] = []
    with LOCK:
        for key in _by_token.get(tok, ()):
            art = _entries.get(key)
            if art is not None and _valid_locked(art, col) is None:
                kinds.append(key[1])
    return kinds


def lookup(col: Any, kind: str, params: Any, consume: bool = True) -> Tuple[str, Optional[dict], int]:
    """Consult the registry for ``col``'s ``(kind, params)`` artifact:

    - ``("hit", state, col.length)``: a live answer for this tensor;
    - ``("fold", state, base_length)``: an ancestor's artifact whose state
      covers rows ``[0, base_length)``; the caller folds the tail and
      commits with :func:`store`;
    - ``("miss", None, 0)``: compute from scratch.

    ``consume=False`` is a planning peek: nothing counted, no LRU touch;
    the caller confirms a served answer with :func:`consume_hit`.  The
    returned state is the artifact's own: callers do not mutate it.
    """
    global _walk_hops_total, _walk_lookups
    tok = col._view_token
    if tok is None or _tensor(col) is None:
        return ("miss", None, 0)
    pending: List[str] = []
    outcome: Tuple[str, Optional[dict], int] = ("miss", None, 0)
    compacted = 0
    with LOCK:
        key = (tok, kind, params)
        art = _entries.get(key)
        if art is not None:
            why = _valid_locked(art, col)
            if why is None:
                if consume:
                    _entries.move_to_end(key)
                    if art._payload is not None:
                        from modin_tpu_torch.core.memory import device_ledger

                        device_ledger.touch(art)
                outcome = ("hit", art.state, col.length)
            elif why:
                _drop_locked(art, why, pending)
        if outcome[0] == "miss":
            # walk the parent chain for a foldable ancestor's artifact
            link = col._view_parent
            hops = 0
            bound = _max_chain()
            passed_clean = True  # every token walked past holds nothing
            while link is not None and hops < bound:
                ptok, plen, pver = link
                akey = (ptok, kind, params)
                art = _entries.get(akey)
                if art is not None and art.live:
                    if (
                        art.epoch == _current_epoch()
                        and art.mesh_key == _mesh_key()
                        and art.length == plen
                        and art.version == pver
                    ):
                        if art.can_fold:
                            _entries.move_to_end(akey)
                            outcome = ("fold", art.state, plen)
                            if hops > 0 and passed_clean:
                                # path compression: the tokens walked past
                                # hold nothing for any kind, so the column
                                # re-anchors straight to this ancestor
                                col._view_parent = link
                                _note_link_locked(tok, link)
                                _link_depth[tok] = _link_depth.get(ptok, 0) + 1
                                compacted = 1
                        else:
                            # this artifact cannot absorb an append: drop it
                            # only once its column is gone (a live parent
                            # keeps its warm answer; the child misses)
                            owner = art.owner_ref() if art.owner_ref else None
                            if owner is None:
                                _drop_locked(art, "not_incremental", pending)
                    break
                if ptok in _by_token:
                    passed_clean = False
                link = _parent_links.get(ptok)
                hops += 1
            _walk_hops_total += hops
            _walk_lookups += 1
    _count_dropped(pending)
    if compacted:
        count("view.chain_compact")
    if consume:
        if outcome[0] == "hit":
            count("view.hit")
        elif outcome[0] == "miss":
            count("view.miss")
    return outcome


def consume_hit(col: Any, kind: str, params: Any) -> None:
    """Mark a peeked answer as served: LRU touch and ``view.hit``.  A
    no-op when the entry went meanwhile (the value the caller holds is
    still right; it just no longer warms the cache)."""
    tok = col._view_token
    if tok is None:
        return
    touched = False
    with LOCK:
        art = _entries.get((tok, kind, params))
        if art is not None and _valid_locked(art, col) is None:
            _entries.move_to_end((tok, kind, params))
            touched = True
    if touched:
        count("view.hit")


def store(
    col: Any,
    kind: str,
    params: Any,
    state: dict,
    can_fold: bool = False,
    payload: Any = None,
    host_bytes: int = 0,
    folded: bool = False,
    source: Any = None,
) -> bool:
    """Commit an artifact for ``col``, computed from ``source`` (the tensor
    the caller read; by default the column's tensor now).  Returns False
    when the column no longer holds that tensor as it was (a spill,
    donation or write since): the stale-write guard.  The result is still
    right for the caller to return; it is just not cached."""
    global _host_bytes_total
    tensor = _tensor(col)
    if source is None:
        source = tensor
    if tensor is None or source is not tensor:
        return False
    tok = ensure_token(col)
    with LOCK:
        if _tensor(col) is not source:  # re-checked under the lock
            return False
        link = col._view_parent
        if link is not None:
            _note_link_locked(tok, link)
        old = _entries.pop((tok, kind, params), None)
        if old is not None:
            old.drop()
        art = DerivedArtifact(
            kind, params, tok, col.length, source, state,
            can_fold=can_fold, payload=payload, host_bytes=host_bytes,
        )
        art.owner_ref = weakref.ref(col)
        _entries[(tok, kind, params)] = art
        _by_token.setdefault(tok, set()).add((tok, kind, params))
        _host_bytes_total += art.host_bytes
        if payload is not None:
            from modin_tpu_torch.core.memory import device_ledger

            device_ledger.register(art)
        evicted = _enforce_locked()
    if evicted:
        count("view.evict", evicted)
    count("view.fold" if folded else "view.build")
    return True


def _walk_to_ancestor_locked(col: Any, kind: str, params: Any, base_len: Optional[int] = None):
    """The live ancestor artifact a fold for ``col`` would consume."""
    link = col._view_parent
    hops = 0
    bound = _max_chain()
    while link is not None and hops < bound:
        ptok, plen, _pver = link
        art = _entries.get((ptok, kind, params))
        if art is not None and art.live and (base_len is None or art.length == base_len):
            return art
        link = _parent_links.get(ptok)
        hops += 1
    return None


def invalidate_ancestor(col: Any, kind: str, params: Any, reason: str) -> None:
    """Drop the ancestor artifact a fold for ``col`` would consume: the
    caller found that folding it can never succeed (the combined groupby
    table passed the cacheable bound)."""
    pending: List[str] = []
    with LOCK:
        art = _walk_to_ancestor_locked(col, kind, params)
        if art is not None:
            _drop_locked(art, reason, pending)
    _count_dropped(pending)


def amend_ancestor_state(
    col: Any, kind: str, params: Any, base_len: int, key: str, value: Any, extra_bytes: int = 0,
) -> None:
    """Record an auxiliary ``state[key]`` derived from the ancestor's own
    rows (the mean fold's valid counts) on the ancestor artifact a fold
    for ``col`` consumed, so later folds from it skip deriving it."""
    global _host_bytes_total
    with LOCK:
        art = _walk_to_ancestor_locked(col, kind, params, base_len)
        if art is not None and art.state.get(key) is None:
            art.state[key] = value
            art.host_bytes += int(extra_bytes)
            _host_bytes_total += int(extra_bytes)


def invalidate_column(col: Any, reason: str = "buffer") -> None:
    """Drop every artifact under ``col``'s token (its tensor changed)."""
    tok = col._view_token
    if tok is None:
        return
    pending: List[str] = []
    with LOCK:
        for key in list(_by_token.get(tok, ())):
            art = _entries.get(key)
            if art is not None:
                _drop_locked(art, reason, pending)
    _count_dropped(pending)


def stats() -> dict:
    """Entries, host bytes and tokens with artifacts."""
    with LOCK:
        return {"entries": len(_entries), "host_bytes": _host_bytes_total, "tokens": len(_by_token)}


def walk_stats() -> dict:
    """Lookups that walked the parent chain, their hops, and the chain
    compactions (``view.chain_compact``)."""
    with LOCK:
        return {"lookups": _walk_lookups, "hops": _walk_hops_total,
                "compactions": COUNTS["view.chain_compact"]}


def live_artifacts() -> List[Any]:
    with LOCK:
        return list(_entries.values())


def reset() -> None:
    """Drop every artifact and link, and zero the walk accounting (tests)."""
    global _walk_hops_total, _walk_lookups
    with LOCK:
        for art in list(_entries.values()):
            art.drop()
        _entries.clear()
        _by_token.clear()
        _parent_links.clear()
        _link_depth.clear()
        _walk_hops_total = 0
        _walk_lookups = 0
