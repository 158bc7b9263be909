"""A durable feed's manager: the WAL hooks, checkpoints and recovery.

The port's counterpart of ``modin_tpu/durability/manager.py``.
:class:`FeedDurability` is a durable feed's ``_wal``.  Its work with
``ingest/feed.py``:

- ``encode_batch`` / ``encode_register`` pickle a record outside every
  lock and return ``None`` while the feed is degraded or replaying, so the
  hot path skips the log with one ``is None`` check;
- ``log_encoded`` runs under the feed's lock, before the change in memory
  the record describes; a :class:`DurabilityError` raised there refuses the
  batch with the feed untouched;
- ``maybe_checkpoint`` runs after the feed's lock is released and
  snapshots the feed and every view's fold state once the WAL holds more
  than ``MODIN_TPU_TORCH_WAL_MAX_REPLAY_BATCHES`` records past the newest
  checkpoint;
- ``recover`` rebuilds the feed from the newest valid checkpoint and
  replays the WAL tail through the feed's own ingest path (sequence
  numbers make it idempotent; a torn tail is cut and counted).

A snapshot holds host objects only (the mirror, pandas partials, numpy
scalars); ``_restore`` uploads the mirror to the port's device again.
Every method collects ``(name, value)`` events and sends them through
:meth:`fanout` after every lock is released, one literal ``emit_metric``
a family.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from modin_tpu_torch.durability import checkpoint as ckpt
from modin_tpu_torch.durability import wal
from modin_tpu_torch.durability.errors import DurabilityError
from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.observability.spans import span
from modin_tpu_torch.utils.atomic_io import atomic_write_json

_META_NAME = "meta.json"

Events = List[Tuple[str, int]]


def _config():
    import modin_tpu_torch.config as config

    return config


class FeedDurability:
    """One durable feed's WAL writer + checkpointer + recovery engine."""

    def __init__(self, feed: Any, feed_dir: str) -> None:
        from modin_tpu_torch.durability import _note_alloc

        _note_alloc()
        config = _config()
        self._feed = feed
        self.feed_dir = feed_dir
        self.tag = wal.schema_tag(feed.schema)
        self.policy = str(config.WalFsync.get())
        self.group_ms = float(config.WalGroupCommitMs.get())
        self.max_replay = int(config.WalMaxReplayBatches.get())
        self.writer = wal.SegmentWriter(
            feed.name,
            feed_dir,
            0,
            self.policy,
            int(config.WalSegmentBytes.get()),
            self._reclaim_under_wal_lock,
        )
        #: newest wal_seq applied to the in-memory feed (feed rlock)
        self._applied_seq = -1
        #: wal_seq the newest durable checkpoint covers
        self._ckpt_seq = -1
        self._ckpt_claimed = False  # writer lock guards the claim flag
        self._replaying = False
        self.replayed_batches = 0  # last recovery's replay count (tests)
        self._stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        self._obs_span_stack: Any = None
        self._obs_scopes: Any = None

    @property
    def degraded(self) -> bool:
        return self.writer.degraded

    # -- hot-path hooks (called from ingest/feed.py) -------------------- #

    def encode_batch(self, pdf: Any, is_upsert: bool) -> Optional[Tuple[int, bytes]]:
        """Pickle one admitted micro-batch outside any lock; ``None``: nothing
        to log (the breaker is open, or the batch is being replayed)."""
        if self.writer.degraded or self._replaying or not len(pdf):
            return None
        return wal.encode_batch(self.tag, pdf, is_upsert)

    def encode_register(self, name: str, plan: Dict[str, Any]) -> Optional[Tuple[int, bytes]]:
        if self.writer.degraded or self._replaying:
            return None
        return wal.encode_register(self.tag, name, plan)

    def log_encoded(self, encoded: Tuple[int, bytes], events: Events) -> None:
        """Append one pre-encoded record — the caller holds the feed
        rlock and has NOT yet mutated feed state.  DurabilityError
        (exhausted ENOSPC) propagates: the batch is refused whole."""
        opcode, payload = encoded
        seq = self.writer.append(opcode, payload, events)
        if seq is not None:
            self._applied_seq = seq

    def maybe_checkpoint(self) -> bool:
        """Checkpoint when the un-checkpointed WAL tail exceeds the
        replay bound.  Called after the feed lock releases."""
        if self._replaying:
            return False
        if self._applied_seq - self._ckpt_seq < self.max_replay:
            return False
        return self.checkpoint()

    # -- checkpoints ---------------------------------------------------- #

    def _try_claim_checkpoint(self) -> bool:
        with self.writer._lock:
            if self._ckpt_claimed:
                return False
            self._ckpt_claimed = True
            return True

    def _release_checkpoint(self) -> None:
        with self.writer._lock:
            self._ckpt_claimed = False

    def checkpoint(self) -> bool:
        """Write one crash-consistent snapshot (feed frame + every view's
        fold state), then truncate WAL segments it fully covers.  Returns
        True when a checkpoint landed.  A disk failure here loses nothing
        — the WAL still holds every record — so it degrades replay time,
        not correctness, and is reported by the absence of
        ``checkpoint.write`` progress."""
        if self.writer.degraded or not self._try_claim_checkpoint():
            return False
        events: Events = []
        wrote = False
        try:
            with span("checkpoint.write", layer="APP", feed=self._feed.name):
                snapshot = self._snapshot()
                if snapshot is None:
                    return False
                payload = ckpt.serialize_snapshot(snapshot)  # outside locks
                try:
                    ckpt.write_checkpoint(
                        self.feed_dir, snapshot["wal_seq"], payload
                    )
                except OSError:
                    return False
                wrote = True
                self._ckpt_seq = snapshot["wal_seq"]
                events.append(("checkpoint.write", 1))
                events.append(("checkpoint.bytes", len(payload)))
                self._truncate_covered(events)
        finally:
            self._release_checkpoint()
            self.fanout(events)
        return wrote

    def _snapshot(self) -> Optional[Dict[str, Any]]:
        """Copy everything recovery needs, under the feed rlock.  The
        mirror is copied (upserts mutate it in place); view partials and
        states are shared by reference — the fold algebra replaces them
        functionally, never mutates."""
        feed = self._feed
        with feed._lock:
            if self._applied_seq < 0:
                return None
            feed._fold_pending_locked()
            views: Dict[str, Dict[str, Any]] = {}
            for vname, view in feed._views.items():
                views[vname] = {
                    "plan": dict(view.plan),
                    "bootstrap": view._bootstrap,
                    "bootstrap_seq": view._bootstrap_seq,
                    "partials": OrderedDict(view._partials),
                    "state": view._state,
                    "folded_seq": view.folded_seq,
                    "folds": view.folds,
                    "rebuilds": view.rebuilds,
                    "late_buckets": view.late_buckets,
                }
            return {
                "format": 1,
                "feed": feed.name,
                "schema_tag": self.tag,
                "wal_seq": self._applied_seq,
                "feed_seq": feed._seq,
                "rows": feed._rows,
                "base_offset": feed._base_offset,
                "mirror": feed._mirror.copy(),
                "key_index": dict(feed._key_index),
                "batches": [
                    (rec.seq, rec.rows, rec.abs_start)
                    for rec in feed._batches
                ],
                "views": views,
            }

    def _truncate_covered(self, events: Events) -> None:
        """Delete WAL segments fully covered by the newest checkpoint and
        every older checkpoint file (outside the writer lock)."""
        active = self.writer.active_path()
        removed = self._drop_covered_files(self._ckpt_seq, active, events)
        if removed:
            events.append(("wal.truncate.segments", removed))

    def _reclaim_under_wal_lock(self, events: Events) -> int:
        """The ENOSPC reclaim, called by the SegmentWriter while it holds
        the ``durability.wal`` lock (so it must not take it again)."""
        return self._drop_covered_files(
            self._ckpt_seq, self.writer._fh_path, events
        )

    def _drop_covered_files(
        self, through_seq: int, active: Optional[str], events: Events
    ) -> int:
        removed = 0
        segments = wal.list_segments(self.feed_dir)
        for i, (first, path) in enumerate(segments):
            if path == active or i + 1 >= len(segments):
                continue  # never the active or the newest segment
            next_first = segments[i + 1][0]
            if next_first <= through_seq + 1:
                try:
                    wal.disk_op("checkpoint.truncate")
                    os.unlink(path)
                    removed += 1
                except OSError:
                    continue
        checkpoints = ckpt.list_checkpoints(self.feed_dir)
        for seq, path in checkpoints[:-1]:  # keep only the newest
            try:
                wal.disk_op("checkpoint.truncate")
                os.unlink(path)
                removed += 1
            except OSError:
                continue
        return removed

    # -- recovery ------------------------------------------------------- #

    def recover(self) -> int:
        """Rebuild the in-memory feed: newest valid checkpoint, then
        replay the WAL tail through the ordinary ingest path.  Runs
        pre-publish (no concurrent appends) under the serving gate as a
        maintenance query.  Returns the number of replayed records."""
        events: Events = []
        replayed = skipped = 0
        feed = self._feed
        try:
            with span("recovery.replay", layer="APP", feed=feed.name):
                snapshot = self._load_newest_checkpoint(events)
                if snapshot is not None:
                    self._restore(snapshot)
                    events.append(("checkpoint.load", 1))
                self._replaying = True
                try:
                    replayed, skipped = self._replay_segments(events)
                finally:
                    self._replaying = False
                self.writer.next_seq = self._applied_seq + 1
                segments = wal.list_segments(self.feed_dir)
                if segments:
                    self.writer.adopt_segment(segments[-1][0])
                if replayed:
                    events.append(("wal.replay.batches", replayed))
                if skipped:
                    events.append(("wal.replay.skipped", skipped))
                events.append(("recovery.feed", 1))
        finally:
            self.fanout(events)
        self.replayed_batches = replayed
        return replayed

    def _load_newest_checkpoint(self, events: Events) -> Optional[Dict[str, Any]]:
        for seq, path in reversed(ckpt.list_checkpoints(self.feed_dir)):
            snapshot = ckpt.load_checkpoint(path)
            if (
                snapshot is None
                or snapshot.get("format") != 1
                or snapshot.get("schema_tag") != self.tag
            ):
                # corrupt, torn-at-rename, or foreign: fall back older
                events.append(("checkpoint.invalid", 1))
                continue
            return snapshot
        return None

    def _restore(self, snapshot: Dict[str, Any]) -> None:
        from modin_tpu_torch.ingest.feed import _BatchRecord
        from modin_tpu_torch.ingest.live import LiveView

        feed = self._feed
        with feed._lock:
            feed._mirror = snapshot["mirror"]
            feed._frame = feed._upload(feed._mirror)
            feed._key_index = dict(snapshot["key_index"])
            feed._seq = snapshot["feed_seq"]
            feed._rows = snapshot["rows"]
            feed._base_offset = snapshot["base_offset"]
            feed._batches = deque(
                _BatchRecord(seq, rows, abs_start, None)
                for seq, rows, abs_start in snapshot["batches"]
            )
            feed._pending = deque()  # a checkpoint is always fully folded
            feed._views = {}
            for vname, vs in snapshot["views"].items():
                view = LiveView(feed.name, vname, vs["plan"], feed.schema)
                view._bootstrap = vs["bootstrap"]
                view._bootstrap_seq = vs["bootstrap_seq"]
                view._partials = OrderedDict(vs["partials"])
                view._state = vs["state"]
                view.folded_seq = vs["folded_seq"]
                view.folds = vs["folds"]
                view.rebuilds = vs["rebuilds"]
                view.late_buckets = vs["late_buckets"]
                feed._views[vname] = view
            self._applied_seq = snapshot["wal_seq"]
            self._ckpt_seq = snapshot["wal_seq"]

    def _replay_segments(self, events: Events) -> Tuple[int, int]:
        from modin_tpu_torch.ingest.errors import IngestRejected

        feed = self._feed
        replayed = skipped = 0
        segments = wal.list_segments(self.feed_dir)
        for i, (first, path) in enumerate(segments):
            records, valid_bytes, torn = wal.read_segment(path)
            for seq, opcode, payload in records:
                if seq <= self._applied_seq:
                    skipped += 1  # the checkpoint already covers it
                    continue
                data = wal.decode_payload(opcode, payload)
                if opcode == wal.OP_REGISTER:
                    tag, vname, plan = data
                    self._check_tag(tag)
                    if vname not in feed._views:
                        feed.register_view(vname, plan)
                else:
                    tag, pdf = data
                    self._check_tag(tag)
                    try:
                        feed._append_sync(pdf, opcode == wal.OP_UPSERT)
                    except IngestRejected:
                        # idempotence backstop: a record the state already
                        # absorbed (e.g. keys present) is skipped, not fatal
                        skipped += 1
                        self._applied_seq = seq
                        continue
                replayed += 1
                self._applied_seq = seq
            if torn:
                # everything past valid_bytes is a crashed writer's
                # garbage; truncate it and drop unreachable later segments
                wal.disk_op("wal.truncate")
                try:
                    os.truncate(path, valid_bytes)
                except OSError:
                    pass
                events.append(("wal.torn_tail", 1))
                dropped = 0
                for _, later in segments[i + 1:]:
                    try:
                        os.unlink(later)
                        dropped += 1
                    except OSError:
                        pass
                if dropped:
                    events.append(("wal.truncate.segments", dropped))
                break
        return replayed, skipped

    def _check_tag(self, tag: int) -> None:
        if tag != self.tag:
            raise DurabilityError(
                self._feed.name,
                "schema_mismatch",
                "WAL record's schema tag contradicts the feed schema",
            )

    # -- group-commit flusher ------------------------------------------- #

    def start(self) -> None:
        """Start the group-commit flusher (GroupCommit policy only)."""
        if self.policy != "GroupCommit" or self._flusher is not None:
            return
        from modin_tpu_torch.observability import meters, spans

        self._obs_span_stack = spans.snapshot_stack()
        self._obs_scopes = meters.snapshot_scopes()
        thread = threading.Thread(
            target=self._flush_loop,
            name=f"modin-tpu-torch-wal-flush-{self._feed.name}",
            daemon=True,
        )
        self._flusher = thread
        thread.start()

    def _flush_loop(self) -> None:
        from modin_tpu_torch.observability import meters, spans

        spans.seed_thread(self._obs_span_stack)
        meters.seed_thread_scopes(self._obs_scopes)
        interval_s = max(self.group_ms, 1.0) / 1e3
        while not self._stop.wait(interval_s):
            events: Events = []
            self.writer.flush_if_dirty(events)
            self.fanout(events)
            self.maybe_checkpoint()
        events = []
        self.writer.flush_if_dirty(events)
        self.fanout(events)

    def close(self) -> None:
        """Stop the flusher and close the segment (final fsync included).
        Called outside the feeds table's lock (it joins a thread)."""
        self._stop.set()
        thread = self._flusher
        if thread is not None:
            thread.join(timeout=5.0)
            self._flusher = None
        self.writer.close()

    # -- metric fan-out (after every lock releases) --------------------- #

    def fanout(self, events: Events) -> None:
        if not events:
            return
        totals: Dict[str, int] = {}
        for name, value in events:
            totals[name] = totals.get(name, 0) + value
        value = totals.get("wal.append")
        if value:
            emit_metric("wal.append", value)
        value = totals.get("wal.append.bytes")
        if value:
            emit_metric("wal.append.bytes", value)
        value = totals.get("wal.fsync")
        if value:
            emit_metric("wal.fsync", value)
        value = totals.get("wal.segment.roll")
        if value:
            emit_metric("wal.segment.roll", value)
        value = totals.get("wal.truncate.segments")
        if value:
            emit_metric("wal.truncate.segments", value)
        value = totals.get("wal.torn_tail")
        if value:
            emit_metric("wal.torn_tail", value)
        value = totals.get("wal.degraded")
        if value:
            emit_metric("wal.degraded", value)
        value = totals.get("wal.enospc.reclaim")
        if value:
            emit_metric("wal.enospc.reclaim", value)
        value = totals.get("wal.replay.batches")
        if value:
            emit_metric("wal.replay.batches", value)
        value = totals.get("wal.replay.skipped")
        if value:
            emit_metric("wal.replay.skipped", value)
        value = totals.get("checkpoint.write")
        if value:
            emit_metric("checkpoint.write", value)
        value = totals.get("checkpoint.bytes")
        if value:
            emit_metric("checkpoint.bytes", value)
        value = totals.get("checkpoint.load")
        if value:
            emit_metric("checkpoint.load", value)
        value = totals.get("checkpoint.invalid")
        if value:
            emit_metric("checkpoint.invalid", value)
        value = totals.get("recovery.feed")
        if value:
            emit_metric("recovery.feed", value)


# --------------------------------------------------------------------- #
# durable feed construction and the recovery sweep of a root
# --------------------------------------------------------------------- #


def _schema_to_meta(schema: Dict[str, Any]) -> List[List[str]]:
    import numpy as np

    return [[col, np.dtype(dt).str] for col, dt in schema.items()]


def _schema_from_meta(pairs: Any) -> "OrderedDict[str, Any]":
    import numpy as np

    return OrderedDict((col, np.dtype(s)) for col, s in pairs)


def resolve_root_dir(explicit: Optional[str] = None) -> str:
    """The durability root: the argument, else ``WalDir``, else
    ``<CacheDir>/wal``."""
    if explicit:
        return explicit
    config = _config()
    configured = str(config.WalDir.get())
    if configured:
        return configured
    return os.path.join(str(config.CacheDir.get()), "wal")


def open_durable_feed(
    name: str,
    schema: Optional[Dict[str, Any]] = None,
    key: Optional[str] = None,
    retention_rows: Optional[int] = None,
    retention_age_s: Optional[float] = None,
    root_dir: Optional[str] = None,
) -> Any:
    """Create or recover one durable feed (not registered in the feeds
    table: :func:`modin_tpu_torch.ingest.open_feed` does that).  A new feed
    writes ``meta.json`` atomically; a directory that exists is recovered
    (the newest valid checkpoint, the WAL tail replayed through the serving
    gate as the ``maintenance`` tenant, a torn tail cut and counted)."""
    from modin_tpu_torch.ingest.feed import Feed

    root = resolve_root_dir(root_dir)
    feed_dir = os.path.join(root, name)
    meta_path = os.path.join(feed_dir, _META_NAME)
    existing = os.path.exists(meta_path)
    if existing:
        try:
            with open(meta_path, "r", encoding="utf-8") as f:
                meta = json.load(f)
            disk_schema = _schema_from_meta(meta["schema"])
        except (OSError, ValueError, KeyError, TypeError) as err:
            raise DurabilityError(
                name, "corrupt_meta", f"unreadable {meta_path}: {err}"
            )
        if schema is not None and wal.schema_tag(
            OrderedDict(schema)
        ) != wal.schema_tag(disk_schema):
            raise DurabilityError(
                name,
                "schema_mismatch",
                "supplied schema contradicts the on-disk meta.json",
            )
        schema = disk_schema
        if key is None:
            key = meta.get("key")
        if retention_rows is None:
            retention_rows = meta.get("retention_rows")
        if retention_age_s is None:
            retention_age_s = meta.get("retention_age_s")
    else:
        if schema is None:
            raise DurabilityError(
                name, "corrupt_meta",
                "new durable feed needs an explicit schema",
            )
        os.makedirs(feed_dir, exist_ok=True)
        atomic_write_json(
            meta_path,
            {
                "format": 1,
                "name": name,
                "schema": _schema_to_meta(OrderedDict(schema)),
                "key": key,
                "retention_rows": retention_rows,
                "retention_age_s": retention_age_s,
            },
            durable_rename=True,
        )
    feed = Feed(
        name, schema, key=key,
        retention_rows=retention_rows, retention_age_s=retention_age_s,
    )
    manager = FeedDurability(feed, feed_dir)
    feed._wal = manager
    from modin_tpu_torch import durability as _durability

    _durability._mark_active()
    if existing:
        from modin_tpu_torch import serving

        serving.submit(
            manager.recover,
            tenant="maintenance", label=f"recovery.{name}",
        )
    manager.start()
    return feed


def recover_feeds(root_dir: Optional[str] = None) -> int:
    """Open (and so recover) every durable feed under the root; feeds
    already registered are left alone.  Returns the feeds opened."""
    from modin_tpu_torch import ingest as _ingest

    root = resolve_root_dir(root_dir)
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return 0
    opened = 0
    known = set(_ingest.feeds())
    for name in names:
        if name in known:
            continue
        if not os.path.exists(os.path.join(root, name, _META_NAME)):
            continue
        _ingest.open_feed(name, durable=True, durability_dir=root)
        opened += 1
    return opened
