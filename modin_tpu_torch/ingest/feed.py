"""Feeds: named continuous-ingestion targets with live views.

The port's counterpart of ``modin_tpu/ingest/feed.py``.  A :class:`Feed`
owns one growing port frame on the device and its host mirror.
Micro-batches (a pandas frame, a dict of columns or CSV text) are
validated against the schema (a typed
:class:`~modin_tpu_torch.ingest.errors.IngestRejected` on a mismatch),
then appended to the mirror with ``pandas.concat`` and to the frame with
the port's ``concat`` (one device concat a column, linked in the views
registry by ``note_append``, so an ad-hoc query on ``feed.frame`` folds the
batch instead of recomputing).  Registered live views (``live.py``) are
maintained per batch: every fold leaves a per-batch partial in the view's
log and updates the running state, so a retention trim refolds without
touching rows.

Appends and reads go through the serving gate (``serving.submit``) under
the caller's tenant.  ``read(..., fresh_within_ms=...)`` answers from the
maintained state while the fold lag (the age of the oldest unfolded batch)
is inside the bound, and folds synchronously first otherwise.

Locks: ``ingest.feeds`` guards the name table; each feed's ``ingest.feed``
rlock serializes its frame, log and views.  Metrics go out after the locks
are released.

One departure from the JAX package: a batch column whose dtype numpy
cannot interpret (pandas' ``str``) is a typed ``dtype`` rejection, where
the JAX package's ``np.can_cast`` raises a bare ``TypeError``; such a
column against an ``object`` schema column casts to ``object``, as a safe
cast of any numpy dtype to ``object`` does.  With the watch service on,
every view read feeds its fold lag into the SLO series of the tenant
``view:<feed>/<view>`` (``watch.observe_view_read``), and the service's
``fold_lag`` tripwire reads :func:`max_fold_lag_ms`.
"""

from __future__ import annotations

import io
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

import numpy as np

from modin_tpu_torch.concurrency import named_lock, named_rlock
from modin_tpu_torch.ingest.errors import IngestError, IngestRejected
from modin_tpu_torch.ingest.live import LiveView, note_alloc, predicate_mask
from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.observability.spans import span

#: test seam: seconds slept per batch inside the fold loop (0.0 in use)
_FOLD_DELAY_S = 0.0


class _BatchRecord:
    """One admitted micro-batch: its sequence number, row span, arrival
    stamps, and (until every view folded it) its host rows."""

    __slots__ = ("seq", "rows", "abs_start", "t_mono", "t_wall", "pdf")

    def __init__(self, seq: int, rows: int, abs_start: int, pdf: Any) -> None:
        note_alloc()
        self.seq = seq
        self.rows = rows
        self.abs_start = abs_start
        self.t_mono = time.monotonic()
        self.t_wall = time.time()
        self.pdf = pdf


class ViewRead:
    """One staleness-bounded read's answer and its freshness."""

    __slots__ = ("value", "lag_ms", "forced", "covered_rows", "base_offset", "seq")

    def __init__(self, value, lag_ms, forced, covered_rows, base_offset, seq):
        self.value = value
        self.lag_ms = lag_ms
        self.forced = forced
        self.covered_rows = covered_rows
        self.base_offset = base_offset
        self.seq = seq

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<ViewRead lag={self.lag_ms:.1f}ms forced={self.forced} covered={self.covered_rows}>"


def _config():
    import modin_tpu_torch.config as config

    return config


def _castable(got: Any, want: np.dtype) -> bool:
    """Whether a batch column of dtype ``got`` casts to the schema's
    ``want``: numpy's safe casting; a dtype numpy cannot interpret casts
    only where it is a pandas string column and ``want`` is ``object``."""
    import pandas

    try:
        return bool(np.can_cast(got, want, casting="safe"))
    except TypeError:
        return want == np.dtype(object) and isinstance(got, pandas.StringDtype)


class Feed:
    """One named ingestion target; made by :func:`create_feed`."""

    def __init__(self, name: str, schema: Dict[str, Any], key: Optional[str] = None,
                 retention_rows: Optional[int] = None, retention_age_s: Optional[float] = None) -> None:
        import pandas

        note_alloc()
        self.name = name
        self.schema: "OrderedDict[str, np.dtype]" = OrderedDict((col, np.dtype(dt)) for col, dt in schema.items())
        if key is not None and key not in self.schema:
            raise IngestError(f"feed {name!r}: key column {key!r} is not in the schema")
        if retention_rows is not None and retention_rows < 0:
            raise IngestError(f"feed {name!r}: retention_rows must be >= 0, got {retention_rows}")
        if retention_age_s is not None and retention_age_s < 0:
            raise IngestError(f"feed {name!r}: retention_age_s must be >= 0, got {retention_age_s}")
        self.key = key
        #: per-feed retention; None reads IngestRetentionRows / _AgeS at trim
        self.retention_rows = retention_rows
        self.retention_age_s = retention_age_s
        self._lock = named_rlock("ingest.feed")
        self._mirror = pandas.DataFrame({c: pandas.Series(dtype=d) for c, d in self.schema.items()})
        self._frame = self._upload(self._mirror)
        self._batches: "deque[_BatchRecord]" = deque()
        self._pending: "deque[_BatchRecord]" = deque()  # not yet folded
        self._views: Dict[str, LiveView] = {}
        self._key_index: Dict[Any, int] = {}  # key value -> retained position
        self._seq = -1
        self._rows = 0
        self._base_offset = 0  # absolute id of the first retained row
        #: the durability manager of a feed opened with durable=True; None is
        #: all that durability costs an ordinary feed (one check a batch)
        self._wal = None

    # -- public surface (through the serving gate) ---------------------- #

    @property
    def frame(self):
        """The feed's port frame (ad-hoc queries fold through the views
        registry)."""
        return self._frame

    @property
    def rows(self) -> int:
        return self._rows

    def append(self, batch: Any, tenant: str = "default"):
        """Admit one append micro-batch; returns the retained row count.
        Raises :class:`IngestRejected` on a schema mismatch (and, on a keyed
        feed, when the batch repeats a stored key: that is :meth:`upsert`'s)."""
        pdf = self._admit(batch)
        from modin_tpu_torch import serving

        return serving.submit(self._append_sync, pdf, False, tenant=tenant, label=f"ingest.{self.name}")

    def upsert(self, batch: Any, tenant: str = "default"):
        """Admit one upsert micro-batch (keyed feeds): rows whose key is
        stored update in place (the batch's last wins), the rest append."""
        if self.key is None:
            emit_metric("ingest.reject", 1)
            self._reject("not_keyed", detail="feed has no key column")
        pdf = self._admit(batch)
        from modin_tpu_torch import serving

        return serving.submit(self._append_sync, pdf, True, tenant=tenant, label=f"ingest.{self.name}")

    def register_view(self, name: str, plan: Dict[str, Any]) -> LiveView:
        """Register a named live view, maintained on every batch from now on
        (the retained rows fold in as its bootstrap partial).  A plan with
        no exact fold raises :class:`ViewNotIncrementalizable`."""
        try:
            view = LiveView(self.name, name, plan, self.schema)
        except Exception:
            emit_metric("ingest.view.refused", 1)
            raise
        dur = self._wal
        # a refused plan raised above; the record is pickled here, outside
        # the lock
        encoded = dur.encode_register(name, plan) if dur is not None else None
        dur_events = [] if dur is not None else None
        try:
            with self._lock:
                if name in self._views:
                    raise IngestError(f"feed {self.name!r}: view {name!r} already registered")
                if encoded is not None:
                    # on disk before the view exists in memory
                    dur.log_encoded(encoded, dur_events)
                self._fold_pending_locked()
                if self._rows:
                    view.rebuild(self._mirror, self._base_offset, self._seq)
                else:
                    view.folded_seq = self._seq
                self._views[name] = view
        finally:
            if dur is not None:
                dur.fanout(dur_events)
        return view

    def read(self, view_name: str, fresh_within_ms: Optional[float] = None, tenant: str = "default") -> ViewRead:
        """One staleness-bounded read under ``tenant``: the maintained state
        while the fold lag is within ``fresh_within_ms``, else the pending
        batches are folded first."""
        from modin_tpu_torch import serving

        return serving.submit(self._read_sync, view_name, fresh_within_ms, tenant=tenant,
                              label=f"ingest.read.{self.name}")

    def fold_now(self) -> None:
        """Fold every pending batch (tests, draining)."""
        with self._lock:
            folded = self._fold_pending_locked()
        if folded:
            emit_metric("ingest.fold", folded)

    def fold_lag_ms(self) -> float:
        with self._lock:
            return self._fold_lag_ms_locked()

    def views(self) -> List[str]:
        with self._lock:
            return sorted(self._views)

    def recompute(self, view_name: str) -> Any:
        """The view's answer computed from scratch on the port frame (the
        device's kernels; no maintained state read): the differential
        baseline."""
        with self._lock:
            view = self._views.get(view_name)
            if view is None:
                raise IngestError(f"feed {self.name!r} has no view {view_name!r}")
            plan = view.plan
            kind = view.kind
            frame = self._frame
        col = plan.get("column")
        if kind == "scalar":
            return getattr(frame[col], plan["agg"])()
        if kind == "filtered":
            pcol, op, val = plan["predicate"]
            return getattr(frame[col][predicate_mask(frame[pcol], op, val)], plan["agg"])()
        if kind == "groupby":
            agg = plan["agg"]
            if agg == "size":
                result = frame.groupby(plan["by"]).size()
            else:
                result = getattr(frame.groupby(plan["by"])[col], agg)()
            return result._to_pandas()
        # top-k and windowed views recompute over the fetched frame
        pdf = frame._to_pandas().reset_index(drop=True)
        if kind == "topk":
            return pdf[col].nlargest(plan["k"], keep="first")
        ts = pdf[plan["time_column"]]
        keep = ts.notna()
        keys = np.floor(ts[keep].to_numpy(dtype=np.float64) / plan["bucket_s"]).astype(np.int64)
        return getattr(pdf[col][keep].groupby(keys), plan["agg"])()

    # -- internals ------------------------------------------------------ #

    def _reject(self, reason: str, **kwargs) -> None:
        """Raise the typed rejection.  Raise only: callers count
        ``ingest.reject`` after the locks they hold are released."""
        raise IngestRejected(self.name, reason, **kwargs)

    def _admit(self, batch: Any) -> Any:
        """Normalize an incoming batch outside any lock, counting a
        rejection here."""
        try:
            return self._normalize(batch)
        except IngestRejected:
            emit_metric("ingest.reject", 1)
            raise

    def _normalize(self, batch: Any) -> Any:
        """A batch (pandas, dict or CSV text) as a pandas frame of exactly
        the schema, or :class:`IngestRejected`."""
        import pandas

        if isinstance(batch, str):
            try:
                pdf = pandas.read_csv(io.StringIO(batch))
            except Exception as err:
                self._reject("malformed", detail=f"CSV parse failed: {err}")
        elif isinstance(batch, dict):
            try:
                pdf = pandas.DataFrame(batch)
            except Exception as err:
                self._reject("malformed", detail=str(err))
        elif isinstance(batch, pandas.DataFrame):
            pdf = batch.copy()
        elif hasattr(batch, "_to_pandas"):
            pdf = batch._to_pandas()
        else:
            self._reject("unsupported_type", got=type(batch).__name__, expected="DataFrame | dict | CSV text")
        got_cols = set(pdf.columns)
        for col in self.schema:
            if col not in got_cols:
                self._reject("missing_column", column=col)
        for col in pdf.columns:
            if col not in self.schema:
                self._reject("extra_column", column=str(col))
        pdf = pdf[list(self.schema)].reset_index(drop=True)
        for col, want in self.schema.items():
            got = pdf[col].dtype
            if got == want:
                continue
            if _castable(got, want):
                pdf[col] = pdf[col].astype(want)
            else:
                self._reject("dtype", column=col, expected=str(want), got=str(got))
        return pdf

    def _append_sync(self, pdf: Any, is_upsert: bool) -> int:
        dur = self._wal
        # the WAL record is pickled outside every lock; None: nothing to log
        # (not durable, the WAL degraded, or this call is the replay)
        encoded = dur.encode_batch(pdf, is_upsert) if dur is not None else None
        dur_events = [] if dur is not None else None
        try:
            try:
                rows, upserted, appended, folded, trimmed = self._append_locked(pdf, is_upsert, encoded, dur_events)
            except IngestRejected:
                # a key violation raises under the feed lock; counted here
                emit_metric("ingest.reject", 1)
                raise
        finally:
            # wal.* events (a refusing DurabilityError's too) go out lock-free
            if dur is not None:
                dur.fanout(dur_events)
        if appended:
            emit_metric("ingest.batch", 1)
            emit_metric("ingest.rows", appended)
        if upserted:
            emit_metric("ingest.upsert", upserted)
        if folded:
            emit_metric("ingest.fold", folded)
        if trimmed:
            emit_metric("ingest.trim.rows", trimmed)
        if dur is not None:
            dur.maybe_checkpoint()
        return rows

    def _append_locked(self, pdf: Any, is_upsert: bool, encoded=None, dur_events=None):
        upserted = appended = folded = trimmed = 0
        with span("ingest.append", layer="APP", feed=self.name, rows=len(pdf)):
            with self._lock:
                if not is_upsert and self.key is not None and len(pdf):
                    # key violations reject before the WAL sees the batch
                    if bool(pdf[self.key].duplicated(keep=False).any()):
                        self._reject("duplicate_key", column=self.key,
                                     detail="batch repeats a key; keys must be unique within an append")
                    for k in pdf[self.key]:
                        if k in self._key_index:
                            self._reject("key_exists", column=self.key, got=k,
                                         detail="append repeats a stored key — use upsert")
                if encoded is not None and len(pdf):
                    # write-ahead: the record is on disk (per the fsync
                    # policy) before any change below; an exhausted ENOSPC
                    # raises here with the feed untouched
                    self._wal.log_encoded(encoded, dur_events)
                if is_upsert and len(pdf):
                    # the batch's last row of a key wins
                    pdf = pdf.drop_duplicates(subset=[self.key], keep="last").reset_index(drop=True)
                    hit = pdf[self.key].map(lambda k: k in self._key_index).to_numpy(dtype=bool)
                    updates, pdf = pdf[hit], pdf[~hit].reset_index(drop=True)
                    if len(updates):
                        positions = [self._key_index[k] for k in updates[self.key]]
                        for col in self.schema:
                            self._mirror.loc[positions, col] = updates[col].to_numpy()
                        self._rebuild_frame_locked()
                        self._rebuild_views_locked()
                        upserted = len(updates)
                if len(pdf):
                    self._seq += 1
                    rec = _BatchRecord(self._seq, len(pdf), self._base_offset + self._rows, pdf)
                    if self.key is not None:
                        base = self._rows
                        for i, k in enumerate(pdf[self.key]):
                            self._key_index[k] = base + i
                    self._concat_mirror_locked(pdf)
                    self._concat_frame_locked(self._upload(pdf))
                    self._rows += len(pdf)
                    self._batches.append(rec)
                    self._pending.append(rec)
                    appended = len(pdf)
                    every = int(_config().IngestFoldEvery.get())
                    if every <= 1 or (self._seq + 1) % every == 0:
                        folded = self._fold_pending_locked()
                trimmed = self._trim_locked()
                rows = self._rows
        return rows, upserted, appended, folded, trimmed

    def _upload(self, pdf: Any) -> Any:
        """``pdf`` as a port frame on the port's device."""
        import modin_tpu_torch.pandas as tpd

        return tpd.DataFrame(pdf)

    def _concat_mirror_locked(self, pdf: Any) -> None:
        import pandas

        self._mirror = pandas.concat([self._mirror, pdf], ignore_index=True)

    def _concat_frame_locked(self, delta: Any) -> None:
        """Grow the frame by the uploaded batch ``delta`` (one device concat
        a column, its append link recorded in the views registry)."""
        import modin_tpu_torch.pandas as tpd

        self._frame = tpd.concat([self._frame, delta], ignore_index=True)

    def _rebuild_frame_locked(self) -> None:
        """Upload the whole mirror again (upserts and trims)."""
        self._frame = self._upload(self._mirror)

    def _rebuild_key_index_locked(self) -> None:
        """Key value -> retained position, from the key column alone (keys
        are unique; Python scalars, as the append path stores them)."""
        self._key_index = dict(zip(self._mirror[self.key].tolist(), range(len(self._mirror))))

    def _rebuild_views_locked(self) -> None:
        """Collapse every view into a bootstrap partial over the retained
        rows (an upsert, a trim into a bootstrap span): the exact rebuild.
        The pending batches are covered by it and drain."""
        self._pending.clear()
        for rec in self._batches:
            rec.pdf = None
        rebuilt = 0
        for view in self._views.values():
            view.rebuild(self._mirror, self._base_offset, self._seq)
            rebuilt += 1
        if rebuilt:
            emit_metric("ingest.rebuild", rebuilt)

    def _fold_pending_locked(self) -> int:
        folded = 0
        while self._pending:
            rec = self._pending.popleft()
            with span("ingest.fold", layer="APP", feed=self.name, seq=rec.seq):
                if _FOLD_DELAY_S > 0.0:
                    time.sleep(_FOLD_DELAY_S)
                for view in self._views.values():
                    view.fold_batch(rec.seq, rec.pdf, rec.abs_start)
            rec.pdf = None
            folded += 1
        return folded

    def _fold_lag_ms_locked(self) -> float:
        if not self._pending:
            return 0.0
        return (time.monotonic() - self._pending[0].t_mono) * 1e3

    def _trim_locked(self) -> int:
        """Retention: drop the oldest whole batches past the row or age
        bounds.  The views refold from their kept partials (host combines
        only), unless the trim reaches into a view's bootstrap span, which
        rebuilds it exactly."""
        config = _config()
        max_rows = (int(self.retention_rows) if self.retention_rows is not None
                    else int(config.IngestRetentionRows.get()))
        max_age = (float(self.retention_age_s) if self.retention_age_s is not None
                   else float(config.IngestRetentionAgeS.get()))
        now = time.monotonic()
        dropped: List[_BatchRecord] = []
        remaining = self._rows
        while len(self._batches) > 1 and (
            (max_rows > 0 and remaining > max_rows)
            or (max_age > 0.0 and now - self._batches[0].t_mono > max_age)
        ):
            rec = self._batches.popleft()
            remaining -= rec.rows
            dropped.append(rec)
        if not dropped:
            return 0
        trimmed_rows = sum(rec.rows for rec in dropped)
        dropped_seqs = [rec.seq for rec in dropped]
        pending_dropped = set(dropped_seqs)
        self._pending = deque(rec for rec in self._pending if rec.seq not in pending_dropped)
        self._mirror = self._mirror.iloc[trimmed_rows:].reset_index(drop=True)
        self._rows -= trimmed_rows
        self._base_offset += trimmed_rows
        self._rebuild_frame_locked()
        if self.key is not None:
            self._rebuild_key_index_locked()
        needs_rebuild = False
        for view in self._views.values():
            if view.drop_batches(dropped_seqs):
                needs_rebuild = True
        if needs_rebuild:
            self._rebuild_views_locked()
        return trimmed_rows

    def _read_sync(self, view_name: str, fresh_within_ms: Optional[float]) -> ViewRead:
        forced = False
        with span("ingest.read", layer="APP", feed=self.name, view=view_name):
            with self._lock:
                view = self._views.get(view_name)
                if view is None:
                    raise IngestError(f"feed {self.name!r} has no view {view_name!r}")
                lag = self._fold_lag_ms_locked()
                if fresh_within_ms is not None and lag > fresh_within_ms:
                    forced = True
                    self._fold_pending_locked()
                    lag = 0.0
                value = view.value(self._base_offset)
                covered = self._rows - sum(rec.rows for rec in self._pending)
                result = ViewRead(value, lag, forced, covered, self._base_offset, view.folded_seq)
        emit_metric("ingest.read.forced_fold" if forced else "ingest.read.served", 1)
        emit_metric("view.lag_ms", lag)
        from modin_tpu_torch.observability import watch as _watch

        if _watch.WATCH_ON:
            _watch.observe_view_read(f"{self.name}/{view_name}", lag / 1e3)
        return result


# --------------------------------------------------------------------- #
# the feeds table
# --------------------------------------------------------------------- #

_FEEDS_LOCK = named_lock("ingest.feeds")
_feeds: Dict[str, Feed] = {}


def _require_ingest() -> None:
    from modin_tpu_torch import ingest as _ingest

    if not _ingest.INGEST_ON:
        raise IngestError(
            "continuous ingestion is disabled; set MODIN_TPU_TORCH_INGEST=1 (config.IngestEnabled.enable())"
        )


def create_feed(name: str, schema: Dict[str, Any], key: Optional[str] = None,
                retention_rows: Optional[int] = None, retention_age_s: Optional[float] = None) -> Feed:
    """Create and register a named feed.  Needs ``MODIN_TPU_TORCH_INGEST=1``.
    ``retention_rows`` / ``retention_age_s`` override the
    ``IngestRetentionRows`` / ``IngestRetentionAgeS`` defaults for this feed
    (0: unbounded, None: the setting)."""
    _require_ingest()
    feed = Feed(name, schema, key=key, retention_rows=retention_rows, retention_age_s=retention_age_s)
    with _FEEDS_LOCK:
        if name in _feeds:
            raise IngestError(f"feed {name!r} already exists")
        _feeds[name] = feed
    return feed


def open_feed(name: str, schema: Optional[Dict[str, Any]] = None, key: Optional[str] = None,
              retention_rows: Optional[int] = None, retention_age_s: Optional[float] = None,
              durable: bool = False, durability_dir: Optional[str] = None) -> Feed:
    """:func:`create_feed`, or with ``durable=True`` a write-ahead-logged
    feed under ``durability_dir`` (default ``WalDir``, else
    ``<CacheDir>/wal``).  ``durable=False`` does not import ``durability``.
    A durability directory that exists is recovered (the newest valid
    checkpoint, then the WAL tail replayed through the ingest path as the
    serving gate's ``maintenance`` tenant), and ``schema`` may be left out:
    ``meta.json`` has it (a contradicting one is a typed
    ``DurabilityError``)."""
    if not durable:
        if schema is None:
            raise IngestError(f"feed {name!r}: a non-durable open_feed needs a schema")
        return create_feed(name, schema, key=key, retention_rows=retention_rows, retention_age_s=retention_age_s)
    _require_ingest()
    from modin_tpu_torch import durability as _durability

    feed = _durability.open_durable_feed(name, schema, key=key, retention_rows=retention_rows,
                                         retention_age_s=retention_age_s, root_dir=durability_dir)
    with _FEEDS_LOCK:
        conflict = name in _feeds
        if not conflict:
            _feeds[name] = feed
    if conflict:
        feed._wal.close()  # outside the table lock (a thread join)
        raise IngestError(f"feed {name!r} already exists")
    return feed


def get_feed(name: str) -> Feed:
    with _FEEDS_LOCK:
        feed = _feeds.get(name)
    if feed is None:
        raise IngestError(f"no feed named {name!r}")
    return feed


def drop_feed(name: str) -> None:
    with _FEEDS_LOCK:
        feed = _feeds.pop(name, None)
    if feed is not None and feed._wal is not None:
        # the last fsync and the flusher's join, outside the table lock
        feed._wal.close()


def feeds() -> List[str]:
    with _FEEDS_LOCK:
        return sorted(_feeds)


def max_fold_lag_ms() -> float:
    """The largest fold lag of the live feeds (what the watch layer's
    ``fold_lag`` tripwire reads), each feed probed under the table lock."""
    with _FEEDS_LOCK:
        return max((feed.fold_lag_ms() for feed in _feeds.values()), default=0.0)


def reset() -> None:
    """Drop every feed (tests)."""
    with _FEEDS_LOCK:
        snapshot = list(_feeds.values())
        _feeds.clear()
    for feed in snapshot:
        if feed._wal is not None:
            feed._wal.close()
