"""Registered live views: the fold algebra past scalars and groupbys.

The port's counterpart of ``modin_tpu/ingest/live.py``.  The views layer
(``views/incremental.py``) folds scalar reductions and groupby tables over
an appended tail; a registered live view extends that algebra to three
more shapes:

- **filtered** scalar aggregates: the predicate applies to each
  micro-batch before its partial folds, so ``x where y > 0`` maintains
  like a plain scalar view;
- **top-k**: each batch contributes its own ``nlargest(k)`` rows keyed by
  absolute row id.  A row outside its batch's top-k has k dominators in
  that batch alone, so it never enters the global top-k: the bounded
  partials are exact, and ties keep pandas' ``keep="first"`` order because
  partials concatenate in batch (row) order;
- **windowed** aggregates over time buckets: scalar partials per bucket
  ``floor(t / bucket_s)``.  A fold touches only the buckets of the new
  batch; late rows fold exactly into their old bucket and are counted.

Every folded batch leaves a per-batch partial in the view's log and is
folded into the running state.  A read is O(1) off the state; a
retention trim drops the trimmed batches' partials and refolds the state
from the log, host combines only, no row touched.

All of it is host work on pandas and numpy objects: a partial or a state
never holds a device tensor, so a checkpoint of it ties no file to a CUDA
context.  Exactness is the views layer's: count/min/max/any/all and
integer sum/prod fold bit for bit; float sum/prod/mean re-associate the
accumulation (in batch order).  Anything else is refused at registration
with a typed :class:`ViewNotIncrementalizable`.
"""

from __future__ import annotations

import operator
from collections import OrderedDict
from typing import Any, Dict

import numpy as np

from modin_tpu_torch.ingest.errors import ViewNotIncrementalizable
from modin_tpu_torch.views.incremental import (
    FOLDABLE_GROUPBYS,
    FOLDABLE_REDUCES,
    combine_groupby,
    combine_mean,
    combine_scalar,
)

#: scalar aggregates a live view may maintain (the views layer's foldable set)
SCALAR_AGGS = frozenset(FOLDABLE_REDUCES)
#: groupby aggregates (the foldable set: sum/count/min/max/mean/size)
GROUPBY_AGGS = frozenset(FOLDABLE_GROUPBYS)
#: windowed per-bucket aggregates (any/all excluded: no pandas groupby
#: ground truth worth promising for boolean buckets)
WINDOW_AGGS = frozenset({"sum", "count", "min", "max", "mean"})
#: the predicate operators a filtered view accepts
_PREDICATES = {">": operator.gt, ">=": operator.ge, "<": operator.lt, "<=": operator.le, "==": operator.eq,
               "!=": operator.ne}
PREDICATE_OPS = frozenset(_PREDICATES)


def predicate_mask(lhs: Any, op: str, val: Any) -> Any:
    """``lhs <op> val``: a filtered view's mask (a pandas or a port Series)."""
    return _PREDICATES[op](lhs, val)

#: the aggregates that do not fold, named in refusals
NON_FOLDABLE_AGGS = frozenset(
    {"var", "std", "sem", "skew", "kurt", "median", "nunique", "mode",
     "quantile"}
)

_alloc_count = 0


def note_alloc() -> None:
    global _alloc_count
    _alloc_count += 1


def ingest_alloc_count() -> int:
    """Ingestion objects ever made (feeds, views, batch records): the
    counter behind the ingest-off zero-allocation check."""
    return _alloc_count


# --------------------------------------------------------------------- #
# scalar partial algebra (shared by scalar / filtered / windowed kinds)
# --------------------------------------------------------------------- #

#: pandas empty-series reduction identities, per aggregate
_EMPTY_SCALAR = {
    "sum": np.float64(0.0),
    "count": np.int64(0),
    "prod": np.float64(1.0),
    "min": np.float64(np.nan),
    "max": np.float64(np.nan),
    "mean": np.float64(np.nan),
    "any": np.bool_(False),
    "all": np.bool_(True),
}


def _scalar_partial(series: Any, agg: str) -> Any:
    """One batch's contribution for a scalar aggregate: the pandas result
    itself, except mean which carries its (mean, valid-count) pair.

    An empty series (a filtered batch matching zero predicate rows) has
    no min/max contribution: pandas answers NaN there, which is NOT the
    fold identity — folded into an int-dtyped running state it would
    poison the state and the next fmin/fmax fold would drop all history.
    ``None`` is the skip sentinel :func:`_scalar_fold` understands;
    :func:`_scalar_value` still answers the pandas empty reduction for an
    all-empty view.
    """
    if agg == "mean":
        return (series.mean(), int(series.count()))
    if len(series) == 0 and agg in ("min", "max"):
        return None
    return getattr(series, agg)()


def _scalar_fold(agg: str, state: Any, part: Any) -> Any:
    if part is None:  # empty-batch partial: the fold identity, skip
        return state
    if state is None:
        return part
    if agg == "mean":
        mean, k = combine_mean(state[0], state[1], part[0], part[1])
        return (mean, k)
    return combine_scalar(agg, True, state, part)


def _scalar_value(agg: str, state: Any) -> Any:
    if state is None:
        return _EMPTY_SCALAR[agg]
    if agg == "mean":
        return np.float64(state[0]) if state[1] else np.float64(np.nan)
    return state


# --------------------------------------------------------------------- #
# the view
# --------------------------------------------------------------------- #


class LiveView:
    """One registered, incrementally-maintained query over a feed.

    Construction validates the plan and refuses non-incrementalizable
    shapes; :meth:`fold_batch` absorbs one micro-batch; :meth:`value`
    answers O(1) off the running state; :meth:`drop_batches` +
    :meth:`refold` service retention trims; :meth:`rebuild` collapses the
    whole log to one bootstrap partial (upserts, bootstrap-intersecting
    trims — the exact-rebuild escape hatch).
    """

    def __init__(self, feed: str, name: str, plan: Dict[str, Any],
                 schema: Dict[str, Any]) -> None:
        note_alloc()
        self.feed = feed
        self.name = name
        self.plan = dict(plan)
        self.kind = self._validate(schema)
        #: bootstrap partial covering every batch with seq <= _bootstrap_seq
        self._bootstrap: Any = None
        self._bootstrap_seq = -1
        #: seq -> per-batch partial, insertion order = fold (= batch) order
        self._partials: "OrderedDict[int, Any]" = OrderedDict()
        self._state: Any = None
        self.folded_seq = -1
        self.folds = 0
        self.rebuilds = 0
        self.late_buckets = 0

    # -- validation ---------------------------------------------------- #

    def _refuse(self, reason: str, detail: str = "") -> None:
        raise ViewNotIncrementalizable(self.name, reason, detail)

    def _need_column(self, col: Any, schema: Dict[str, Any]) -> None:
        if col not in schema:
            self._refuse("unknown_column", f"column {col!r} not in feed schema")

    def _validate(self, schema: Dict[str, Any]) -> str:
        plan = self.plan
        kind = plan.get("kind")
        if kind not in ("scalar", "groupby", "filtered", "topk", "windowed"):
            self._refuse("unknown_kind", f"kind={kind!r}")
        self._need_column(plan.get("column"), schema)
        if kind in ("scalar", "filtered", "groupby", "windowed"):
            agg = plan.get("agg")
            allowed = {
                "scalar": SCALAR_AGGS, "filtered": SCALAR_AGGS,
                "groupby": GROUPBY_AGGS, "windowed": WINDOW_AGGS,
            }[kind]
            if agg not in allowed:
                if kind == "filtered" and agg is None:
                    # an agg-less filtered registration is a row-set view:
                    # its state is O(matching rows), unbounded under a
                    # sustained stream — refuse instead of pretending
                    self._refuse(
                        "row_view_unbounded",
                        "filtered views need an aggregate; bare row sets "
                        "grow without bound under continuous ingest",
                    )
                known = (
                    agg in NON_FOLDABLE_AGGS or agg in SCALAR_AGGS
                    or agg in GROUPBY_AGGS
                )
                if known:
                    self._refuse(
                        "non_foldable_agg",
                        f"agg={agg!r} has no exact fold for kind={kind!r}",
                    )
                self._refuse(
                    "unknown_agg", f"agg={agg!r} is not a recognized aggregate"
                )
        if kind == "filtered":
            pred = plan.get("predicate")
            if (
                not isinstance(pred, (tuple, list)) or len(pred) != 3
                or pred[1] not in PREDICATE_OPS
            ):
                self._refuse("bad_predicate", f"predicate={pred!r}")
            self._need_column(pred[0], schema)
        if kind == "groupby":
            self._need_column(plan.get("by"), schema)
        if kind == "topk":
            k = plan.get("k")
            if not isinstance(k, int) or isinstance(k, bool) or k <= 0:
                self._refuse("bad_k", f"k={k!r}")
            if np.dtype(schema[plan["column"]]).kind not in "iuf":
                self._refuse(
                    "bad_column_dtype",
                    f"top-k needs a numeric column, got "
                    f"{schema[plan['column']]}",
                )
        if kind == "windowed":
            tcol = plan.get("time_column")
            if tcol is None:
                self._refuse("bad_window", "time_column is required")
            self._need_column(tcol, schema)
            bucket = plan.get("bucket_s")
            if not isinstance(bucket, (int, float)) or bucket <= 0:
                self._refuse("bad_window", f"bucket_s={bucket!r}")
            if np.dtype(schema[tcol]).kind not in "iuf":
                self._refuse(
                    "bad_window",
                    f"time column must be numeric seconds, got "
                    f"{schema[tcol]}",
                )
        return kind

    # -- per-batch partials -------------------------------------------- #

    def _partial(self, pdf: Any, abs_start: int) -> Any:
        plan = self.plan
        col = plan["column"]
        if self.kind == "scalar":
            return _scalar_partial(pdf[col], plan["agg"])
        if self.kind == "filtered":
            pcol, op, val = plan["predicate"]
            return _scalar_partial(pdf[col][predicate_mask(pdf[pcol], op, val)], plan["agg"])
        if self.kind == "groupby":
            by, agg = plan["by"], plan["agg"]
            grouped = pdf.groupby(by)[col]
            if agg == "mean":
                return (grouped.mean(), grouped.count())
            if agg == "size":
                return pdf.groupby(by).size()
            return getattr(grouped, agg)()
        if self.kind == "topk":
            s = pdf[col].copy()
            s.index = np.arange(abs_start, abs_start + len(s), dtype=np.int64)
            return s.nlargest(plan["k"], keep="first")
        # windowed: bucket -> scalar partial (NaN timestamps drop, matching
        # pandas groupby dropna)
        tcol, agg = plan["time_column"], plan["agg"]
        bucket_s = plan["bucket_s"]
        ts = pdf[tcol]
        keep = ts.notna()
        sub, ts = pdf[col][keep], ts[keep]
        keys = np.floor(ts.to_numpy(dtype=np.float64) / bucket_s).astype(
            np.int64
        )
        out: Dict[int, Any] = {}
        for key, series in sub.groupby(keys):
            out[int(key)] = _scalar_partial(series, agg)
        return out

    def _fold(self, state: Any, part: Any) -> Any:
        plan = self.plan
        if self.kind in ("scalar", "filtered"):
            return _scalar_fold(plan["agg"], state, part)
        if self.kind == "groupby":
            if state is None:
                return part
            agg = plan["agg"]
            if agg == "mean":
                means, counts = combine_groupby(
                    "mean", state[0], part[0], state[1], part[1]
                )
                return (means, counts)
            combined, _ = combine_groupby(
                "sum" if agg == "size" else agg, state, part
            )
            return combined
        if self.kind == "topk":
            if state is None:
                return part.copy()
            import pandas

            # state rows all precede the new batch's absolute ids, so the
            # concat order replays pandas keep="first" tie order exactly
            return pandas.concat([state, part]).nlargest(
                self.plan["k"], keep="first"
            )
        # windowed
        if state is None:
            state = {}
        else:
            state = dict(state)
        if state and part:
            newest = max(state)
            self.late_buckets += sum(1 for b in part if b < newest)
        agg = plan["agg"]
        for bucket, p in part.items():
            state[bucket] = _scalar_fold(agg, state.get(bucket), p)
        return state

    # -- maintenance entry points (feed lock held) --------------------- #

    def fold_batch(self, seq: int, pdf: Any, abs_start: int) -> None:
        part = self._partial(pdf, abs_start)
        self._partials[seq] = part
        self._state = self._fold(self._state, part)
        self.folded_seq = seq
        self.folds += 1

    def refold(self) -> None:
        """Rebuild the running state from bootstrap + retained partials —
        pure host-side combines, no row data (retention trims)."""
        state = None
        if self._bootstrap is not None:
            state = self._fold(None, self._bootstrap)
        for part in self._partials.values():
            state = self._fold(state, part)
        self._state = state

    def drop_batches(self, seqs: Any) -> bool:
        """Forget trimmed batches' partials; returns True when the
        bootstrap partial was invalidated (caller must :meth:`rebuild`)."""
        for seq in seqs:
            self._partials.pop(seq, None)
        if self._bootstrap is not None and any(
            seq <= self._bootstrap_seq for seq in seqs
        ):
            self._bootstrap = None
            self._bootstrap_seq = -1
            return True
        self.refold()
        return False

    def rebuild(self, pdf: Any, abs_start: int, through_seq: int) -> None:
        """Collapse the whole retained frame into one bootstrap partial —
        the exact-rebuild path for upserts (in-place value changes no fold
        can express; the top-k eviction-boundary ambiguity lands here too)
        and bootstrap-intersecting trims."""
        self._partials.clear()
        self._bootstrap = self._partial(pdf, abs_start) if len(pdf) else None
        self._bootstrap_seq = through_seq
        self.folded_seq = through_seq
        self.rebuilds += 1
        self.refold()

    # -- reads --------------------------------------------------------- #

    def value(self, base_offset: int = 0) -> Any:
        """The maintained answer, shaped like its pandas ground truth.

        Scalar/filtered -> numpy scalar; groupby -> key-sorted Series;
        topk -> value-descending Series positioned against the CURRENT
        retained frame (absolute ids shifted by ``base_offset``);
        windowed -> bucket-index-sorted Series.
        """
        import pandas

        plan = self.plan
        if self.kind in ("scalar", "filtered"):
            return _scalar_value(plan["agg"], self._state)
        if self.kind == "groupby":
            if self._state is None:
                return pandas.Series(dtype=np.float64)
            if plan["agg"] == "mean":
                return self._state[0].copy()
            return self._state.copy()
        if self.kind == "topk":
            if self._state is None:
                return pandas.Series(dtype=np.float64)
            out = self._state.copy()
            out.index = out.index - base_offset
            return out
        if self._state is None:
            return pandas.Series(dtype=np.float64)
        agg = plan["agg"]
        buckets = sorted(self._state)
        return pandas.Series(
            [_scalar_value(agg, self._state[b]) for b in buckets],
            index=np.asarray(buckets, dtype=np.int64),
        )
