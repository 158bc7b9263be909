"""The range-partition shuffle over the row-shard mesh.

The port's counterpart of ``modin_tpu/parallel/shuffle.py``: the same
sample, pivots, split and recombine as the JAX package's, whose split is
one ``shard_map`` program with a ``lax.all_to_all`` inside.  The port keeps
the one controller: a column is one tensor on the primary device, seen as
``S`` row blocks of ``ceil(n / S)`` rows (``parallel/mesh.row_blocks``), and
each shard's step runs on its own device (``mesh.shard_devices``):

1. **sample**: a strided sample of the key (the JAX package's stride,
   ``pad_len(n) // 4096`` at its padding) to the host, NaN dropped, and the
   ``S - 1`` quantile pivots (``inverted_cdf``), so the pivots equal the
   JAX package's at the same ``S``;
2. **count**: per shard, bucketize the block against the pivots
   (``torch.searchsorted``, NaN last in both directions) and count the
   rows for each destination with the port's bincount route
   (``ops/cuda/groupby_kernels.bincount``, ``bincount.cu`` on the card);
   one fetch brings the ``[S, S]`` counts to the host;
3. **pack**: each shard groups its rows stably by destination
   (``torch.sort(stable=True)`` of the buckets) and gathers every column
   in that order: a compact send buffer of the shard's own rows, whose
   destination d's rows start where the counts of the destinations before
   it end.  The JAX package packs ``[S, capacity]`` blocks, ``capacity =
   max(8, ceil(n / S) / S * slack)``, and doubles the slack on overflow;
   the port's pack has no capacity, but the counts decide on the host the
   retries the JAX package's loop makes (``resilience.shuffle.slack_retry``)
   and, past ``max_slack``, raise :class:`ShuffleSkewError` as it does
   (``resilience.shuffle.skew_fallback``: the caller's local path
   answers).  At the default ``max_slack`` a mesh of up to 51 row shards
   never declines: at a slack of 51.2 a capacity holds a whole block;
4. **exchange**: the ``S x S`` copies of sender s's rows for destination d
   to device(d) (peer copies between cards, local copies where shards
   share a device): the all-to-all.  Each copy lands after the earlier
   senders' rows, so the arrivals are compact in sender order, which is
   the original row order, and no validity mask travels.  A copy between
   devices orders itself after the sender's work and before the
   receiver's (torch syncs both devices' current streams), so a shard
   reads its rows only once they have arrived;
5. **compaction**: under ``local_sort`` each shard sorts its arrivals by
   value, stably, NaN last;
6. **gather**: the shards' rows go back onto the primary device in shard
   order (a shard on the primary device writes them there in place): ``n``
   rows, range-partitioned (shard s holds the keys between pivots ``s - 1``
   and ``s``), globally sorted under ``local_sort``.

Only the sample and the counts wait for the device; the rest is enqueued.
``costs.note_collective("shuffle.all_to_all", ...)`` bills the exchanged
rows' bytes.  While :data:`TIME_STAGES` is set, :data:`LAST_STAGES_MS` holds
the last shuffle's stage times (CUDA events on the primary device, after
the other shard devices reach each stage boundary; host clock on the CPU).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from modin_tpu_torch.observability import spans as _spans

#: the sample's size: the JAX package's ``num_samples``
NUM_SAMPLES = 4096

#: whether each shuffle times its stages into :data:`LAST_STAGES_MS`
TIME_STAGES = False
#: ``{"sample", "pack", "exchange", "compaction", "gather"}`` milliseconds
#: of the last shuffle run with :data:`TIME_STAGES` set
LAST_STAGES_MS: Dict[str, float] = {}
#: the last shuffle's shards, slack retries, rows per shard and the JAX
#: package's padded capacity at that slack (not allocated here)
LAST_RUN: Dict[str, Any] = {}


class ShuffleSkewError(RuntimeError):
    """The capacity slack ran out on pathologically skewed keys.

    A semantic signal, not a device failure: callers catch it and take
    their local path."""


def _jax_pad_len(n: int, shards: int) -> int:
    """The JAX package's column length at ``shards`` row shards (the sample
    stride is taken over it, so the samples are the same rows)."""
    return max(-(-int(n) // shards) * shards, shards)


def _sortable(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a dtype ``torch.sort`` and ``torch.searchsorted`` take (a
    bool key as its 0/1 bytes)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def sample_pivots(key: torch.Tensor, n: int, num_partitions: int, num_samples: int = NUM_SAMPLES) -> np.ndarray:
    """The ``num_partitions - 1`` quantile pivots of a strided sample of the
    key (one small fetch)."""
    from modin_tpu_torch.parallel.engine import materialize

    with _spans.span("shuffle.sample_pivots", "SHUFFLE", rows=int(n), shards=int(num_partitions)):
        step = max(1, _jax_pad_len(n, num_partitions) // num_samples)
        sample = np.asarray(materialize(_sortable(key[:n:step]).contiguous()))
        if sample.dtype.kind == "f":
            sample = sample[~np.isnan(sample)]
        if len(sample) == 0:
            return np.zeros(max(num_partitions - 1, 1), dtype=sample.dtype)
        qs = np.linspace(0, 1, num_partitions + 1)[1:-1]
        return np.asarray(np.quantile(sample, qs, method="inverted_cdf"), dtype=sample.dtype)


class _StageClock:
    """Stage boundaries of one shuffle while :data:`TIME_STAGES` is set."""

    def __init__(self, devices: Sequence[torch.device]):
        self.on = TIME_STAGES
        if not self.on:
            return
        self.primary = devices[0]
        self.cuda = self.primary.type == "cuda"
        self.others = sorted({d for d in devices if d != self.primary}, key=str)
        self.marks: List[Tuple[str, Any]] = []
        self.mark("start")

    def mark(self, stage: str) -> None:
        if not self.on:
            return
        if not self.cuda:
            self.marks.append((stage, time.perf_counter()))
            return
        stream = torch.cuda.current_stream(self.primary)
        for dev in self.others:
            # the boundary is where every shard device has reached it
            reached = torch.cuda.Event()
            reached.record(torch.cuda.current_stream(dev))
            stream.wait_event(reached)
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        self.marks.append((stage, event))

    def finish(self) -> None:
        global LAST_STAGES_MS
        if not self.on:
            return
        if self.cuda:
            self.marks[-1][1].synchronize()
            elapsed = [a[1].elapsed_time(b[1]) for a, b in zip(self.marks, self.marks[1:])]
        else:
            elapsed = [(b[1] - a[1]) * 1e3 for a, b in zip(self.marks, self.marks[1:])]
        LAST_STAGES_MS = {stage: ms for (stage, _), ms in zip(self.marks[1:], elapsed)}


def _bucketize(k: torch.Tensor, pivots: torch.Tensor, descending: bool, shards: int) -> torch.Tensor:
    """Each row's destination shard: ascending, the pivots' ``right`` side
    (shard s takes keys up to pivot s); descending, the mirror image; NaN
    goes to the last shard either way (na_position='last')."""
    is_f = k.dtype.is_floating_point
    kk = torch.where(torch.isnan(k), float("inf"), k) if is_f else k
    bucket = torch.searchsorted(pivots, kk, side="left" if descending else "right")
    if descending:
        bucket = (shards - 1) - bucket
        if is_f:
            bucket = torch.where(torch.isnan(k), shards - 1, bucket)
    return bucket


def _capacity(block_rows: int, shards: int, slack: float) -> int:
    return int(max(8, int(block_rows / max(shards, 1) * slack)))


def _local_order(k: torch.Tensor, descending: bool) -> torch.Tensor:
    """Stable order of one shard's arrivals by value, NaN last: two stable
    passes, as the JAX package's composed argsorts (no sentinel, so real
    +/-inf order exactly as pandas puts them)."""
    if not k.dtype.is_floating_point:
        return torch.sort(k, stable=True, descending=descending).indices
    nan = torch.isnan(k)
    order = torch.sort(torch.where(nan, 0.0, k), stable=True, descending=descending).indices
    return order[torch.sort(nan[order].view(torch.uint8), stable=True).indices]


def exchange(send: List[List[torch.Tensor]], sent: np.ndarray, devices: Sequence[torch.device],
             into: Optional[List[Optional[List[torch.Tensor]]]] = None) -> List[List[torch.Tensor]]:
    """The all-to-all: ``send[s][j]`` is shard s's column j grouped by
    destination, ``sent[s, d]`` rows for device(d) after those for the
    destinations before d.  Returns ``recv[d][j]``: the rows that reached
    device(d), sender by sender, written into the tensors ``into[d]`` where
    it is not None."""
    starts = np.cumsum(sent, axis=1) - sent
    recv = []
    for d, dev in enumerate(devices):
        arrived = int(sent[:, d].sum())
        per_col = []
        for j, block0 in enumerate(send[0]):
            target = into[d] if into is not None else None
            out = target[j] if target is not None else torch.empty(arrived, dtype=block0.dtype, device=dev)
            offset = 0
            for s, blocks in enumerate(send):
                m, a = int(sent[s, d]), int(starts[s, d])
                if m:
                    out[offset:offset + m].copy_(blocks[j][a:a + m], non_blocking=True)
                offset += m
            per_col.append(out)
        recv.append(per_col)
    return recv


def range_shuffle(
    key: torch.Tensor,
    cols: List[torch.Tensor],
    n: int,
    descending: bool = False,
    slack: float = 1.6,
    local_sort: bool = False,
    max_slack: float = 64.0,
) -> Tuple[torch.Tensor, List[torch.Tensor], np.ndarray, np.ndarray]:
    """Redistribute the rows so that shard s holds the s-th key range.

    Returns ``(key_out, cols_out, shard_counts, pivots)``: ``n``-row tensors
    on the key's device in shard order (within a shard, arrival order, or
    sorted under ``local_sort``), the rows each shard received, and the
    pivots.  Raises :class:`ShuffleSkewError` where the slack passes
    ``max_slack``."""
    from modin_tpu_torch.core.execution.resilience import count
    from modin_tpu_torch.observability import costs as _costs
    from modin_tpu_torch.ops.cuda.groupby_kernels import bincount
    from modin_tpu_torch.parallel.engine import materialize
    from modin_tpu_torch.parallel.mesh import row_blocks, shard_devices

    n = int(n)
    for c in (key, *cols):
        if c.shape[0] != n:
            raise ValueError(f"range_shuffle: a column of {c.shape[0]} rows for {n} rows")
    with _spans.span("shuffle.range_shuffle", "SHUFFLE", rows=n, n_cols=len(cols),
                     local_sort=bool(local_sort)) as sp:
        devices = shard_devices()
        S = len(devices)
        primary = key.device
        clock = _StageClock(devices)
        blocks = row_blocks(n, S)
        block_rows = -(-n // S)
        k_all = _sortable(key)
        pivots = sample_pivots(key, n, S)
        pivots_on = {}
        for dev in devices:
            if dev not in pivots_on:
                pivots_on[dev] = torch.as_tensor(pivots).to(dev)
        clock.mark("sample")

        # count: each shard's rows per destination, through bincount
        shard_keys, buckets, counts_dev = [], [], []
        for s, (lo, hi) in enumerate(blocks):
            k_s = k_all[lo:hi].to(devices[s], non_blocking=True)
            bucket = _bucketize(k_s, pivots_on[devices[s]], descending, S)
            shard_keys.append(k_s)
            buckets.append(bucket)
            counts_dev.append(bincount(bucket, S))
        # [sender, destination]: the one fetch of the counts
        sent = np.asarray(materialize(torch.stack([c.to(primary, non_blocking=True) for c in counts_dev])))

        # the JAX package's retry rule, decided on the counts: its padded
        # capacity, which the compact pack below does not allocate
        slack_retries = 0
        while True:
            capacity = _capacity(block_rows, S, slack)
            if not (sent > capacity).any():
                break
            slack *= 2.0
            slack_retries += 1
            count("resilience.shuffle.slack_retry")
            if slack > max_slack:
                count("resilience.shuffle.skew_fallback")
                raise ShuffleSkewError("range_shuffle: pathological key skew")

        # pack: every column of shard s in its rows' destination order,
        # each destination's rows in row order
        payload = [key, *cols]
        send: List[List[torch.Tensor]] = []
        for s, (lo, hi) in enumerate(blocks):
            dev = devices[s]
            order = torch.sort(buckets[s], stable=True).indices
            shard_cols = [shard_keys[s].view(key.dtype)] + [c[lo:hi].to(dev, non_blocking=True) for c in cols]
            send.append([torch.index_select(c, 0, order) for c in shard_cols])
        del shard_keys, buckets, shard_cols
        clock.mark("pack")

        # exchange: shard s's rows for d -> device(d); a shard on the primary
        # device that keeps its arrival order receives straight into the
        # output, else the output is allocated once the send buffers are
        # freed (the peak holds two copies of the rows, not three)
        counts = sent.sum(axis=0).astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        direct = [not local_sort and dev == primary for dev in devices]

        def allocate() -> List[torch.Tensor]:
            return [torch.empty(n, dtype=c.dtype, device=primary) for c in payload]

        outs = allocate() if any(direct) else None
        into = [[out[offsets[d]:offsets[d + 1]] for out in outs] if direct[d] else None for d in range(S)]
        recv: List[Optional[List[torch.Tensor]]] = exchange(send, sent, devices, into)
        del send
        if outs is None:
            outs = allocate()
        clock.mark("exchange")

        # compaction: the arrivals sorted by value under local_sort, written
        # into the output where the shard is on the primary device
        for d, dev in enumerate(devices):
            if direct[d] or not local_sort or recv[d][0].shape[0] < 2:
                continue
            order = _local_order(_sortable(recv[d][0]), descending)
            if dev == primary:
                for out, r in zip(outs, recv[d]):
                    torch.index_select(r, 0, order, out=out[offsets[d]:offsets[d + 1]])
                recv[d] = None
            else:
                recv[d] = [torch.index_select(r, 0, order) for r in recv[d]]
        clock.mark("compaction")

        # gather: the shards' rows not yet in the output, in shard order
        for d in range(S):
            if not direct[d] and recv[d] is not None:
                for out, r in zip(outs, recv[d]):
                    out[offsets[d]:offsets[d + 1]].copy_(r, non_blocking=True)
            recv[d] = None
        clock.mark("gather")
        clock.finish()
        if int(offsets[-1]) != n:
            raise AssertionError(f"range_shuffle: {int(offsets[-1])} rows arrived of {n}")

        # every row of every routed column crosses once
        exchange_bytes = n * sum(c.element_size() for c in payload)
        if _costs.COST_ON:
            _costs.note_collective("shuffle.all_to_all", exchange_bytes)
        if sp is not None:
            sp.attrs.update(shards=S, capacity=capacity, slack_retries=slack_retries)
        LAST_RUN.update(shards=S, capacity=capacity, slack_retries=slack_retries, counts=counts.tolist(),
                        exchange_bytes=exchange_bytes)
        return outs[0], outs[1:], counts, pivots
