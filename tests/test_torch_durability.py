"""Durable ingestion of the torch port against the JAX package's.

Every case of ``tests/test_durability.py`` runs through both packages (the
JAX package on the CPU mesh, the port on the CPU), each in its own
``tmp_path`` directory: round trips under every fsync policy, checkpoints
bounding the replay, torn tails and flipped bytes, the disk faults
(ENOSPC reclaim, the typed ENOSPC refusal, EIO and fsync failures into
memory-only mode), the zero-overhead contract, and the port's kill -9
grid in subprocesses.  The two packages' observations (frames, view
answers, replay counts, the ``wal.*``/``checkpoint.*``/``recovery.*``
metric events) must be equal, and both write the same bytes: a WAL or a
checkpoint directory written by either package is recovered by the other
with the same frame and views, and a ``pickletools`` scan finds no module
of either package named in any record or checkpoint.
"""

import os
import pickletools
import shutil
import signal
import subprocess
import sys
import types

import pandas
import pytest

from modin_tpu import config as jcfg
from modin_tpu import durability as j_durability
from modin_tpu import ingest as j_ingest
from modin_tpu.durability import checkpoint as j_ckpt
from modin_tpu.durability import wal as j_wal
from modin_tpu.logging.metrics import add_metric_handler as j_add
from modin_tpu.logging.metrics import clear_metric_handler as j_clear
from modin_tpu.testing import faults as j_faults
from modin_tpu.views import registry as j_registry

import modin_tpu_torch
from modin_tpu_torch import config as tcfg
from modin_tpu_torch import durability as t_durability
from modin_tpu_torch import ingest as t_ingest
from modin_tpu_torch.durability import checkpoint as t_ckpt
from modin_tpu_torch.durability import wal as t_wal
from modin_tpu_torch.logging.metrics import add_metric_handler as t_add
from modin_tpu_torch.logging.metrics import clear_metric_handler as t_clear
from modin_tpu_torch.testing import faults as t_faults
from modin_tpu_torch.views import registry as t_registry

from tests.test_durability import _BATCH_ROWS, _PLANS, _SCHEMA, _batch, _control
from tests.test_torch_ingest import _same, assert_declared
from tests.utils import require_tpu_execution

JAX = types.SimpleNamespace(name="jax", ingest=j_ingest, durability=j_durability, wal=j_wal, ckpt=j_ckpt,
                            cfg=jcfg, registry=j_registry, faults=j_faults, add=j_add, clear=j_clear,
                            prefix="modin_tpu.")
PORT = types.SimpleNamespace(name="port", ingest=t_ingest, durability=t_durability, wal=t_wal, ckpt=t_ckpt,
                             cfg=tcfg, registry=t_registry, faults=t_faults, add=t_add, clear=t_clear,
                             prefix="modin_tpu_torch.")
PACKAGES = (JAX, PORT)
_KNOBS = ("IngestEnabled", "WalFsync", "WalGroupCommitMs", "WalMaxReplayBatches", "WalSegmentBytes", "WalDir")
_FAMILIES = ("wal.", "checkpoint.", "recovery.feed")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _durability_env():
    require_tpu_execution()
    modin_tpu_torch.set_device("cpu")
    saved = [(getattr(P.cfg, k), getattr(P.cfg, k).get()) for P in PACKAGES for k in _KNOBS]
    for P in PACKAGES:
        P.registry.reset()
        P.ingest.reset()
        P.cfg.IngestEnabled.put(True)
    yield
    for P in PACKAGES:
        P.ingest.reset()
        P.registry.reset()
        # a test that died inside an injector must not leave its hook behind
        P.wal._disk_fault_hook = None
    for param, value in saved:
        param.put(value)


def _run(P, scenario, root, *args):
    seen = []

    def handler(name, value):
        seen.append((name[len(P.prefix):], value))

    P.add(handler)
    try:
        observed = dict(scenario(P, str(root), *args) or {})
    finally:
        P.clear(handler)
    totals = {}
    # the group-commit flusher's fsyncs follow the clock, not the stream
    ticking = P.cfg.WalFsync.get() == "GroupCommit"
    for name, value in seen:
        if name.startswith(_FAMILIES) and not (ticking and name == "wal.fsync"):
            counts = totals.setdefault(name, [0, 0])
            counts[0] += 1
            counts[1] += value if name != "wal.append.bytes" and name != "checkpoint.bytes" else 0
    observed["metrics"] = {k: tuple(v) for k, v in totals.items()}
    if P is PORT:
        assert_declared([name for name, _value in seen])
    return observed


def _both(scenario, tmp_path, *args):
    """The scenario on each package in a directory of its own; the port's
    observations equal the JAX package's."""
    jax_seen = _run(JAX, scenario, tmp_path / "jax", *args)
    port_seen = _run(PORT, scenario, tmp_path / "port", *args)
    _same(port_seen, jax_seen)
    return port_seen


def _count(seen, name):
    return seen["metrics"].get(name, (0, 0))[0]


def _total(seen, name):
    return seen["metrics"].get(name, (0, 0))[1]


def _frame(feed):
    return feed.frame._to_pandas().reset_index(drop=True)


def _views(feed):
    return {"total": feed.read("total").value, "by_group": pandas.Series(feed.read("by_group").value)}


def _assert_feed(feed, control, views=True):
    pandas.testing.assert_frame_equal(_frame(feed), control.reset_index(drop=True))
    if views:
        assert feed.read("total").value == control["i"].sum()
        if "by_group" in feed.views():
            pandas.testing.assert_series_equal(pandas.Series(feed.read("by_group").value),
                                               control.groupby("g")["i"].sum(), check_names=False,
                                               check_index_type=False)


def _open(P, root, name, **kwargs):
    return P.ingest.open_feed(name, durable=True, durability_dir=root, **kwargs)


def _segments(feed_dir):
    return sorted(os.path.join(feed_dir, f) for f in os.listdir(feed_dir) if f.startswith("wal_") and f.endswith(".seg"))


def _files(feed_dir):
    return {f: open(os.path.join(feed_dir, f), "rb").read() for f in sorted(os.listdir(feed_dir))}


# ====================================================================== #
# round trips
# ====================================================================== #


class TestRoundTrip:
    @pytest.mark.parametrize("policy", ["PerBatch", "GroupCommit", "Off"])
    def test_recover_bit_exact(self, tmp_path, policy):
        def scenario(P, root):
            P.cfg.WalFsync.put(policy)
            P.cfg.WalGroupCommitMs.put(5.0)
            feed = _open(P, root, "events", schema=_SCHEMA)
            for name, plan in _PLANS.items():
                feed.register_view(name, plan)
            for b in range(6):
                feed.append(_batch(b))
            _assert_feed(feed, _control(6))
            P.ingest.reset()  # a clean close: the last flush and the flusher's join
            feed = _open(P, root, "events")
            replayed = feed._wal.replayed_batches
            _assert_feed(feed, _control(6))
            first = {"frame": _frame(feed), "views": _views(feed), "replayed": replayed}
            feed.append(_batch(6))
            P.ingest.reset()
            feed = _open(P, root, "events")
            _assert_feed(feed, _control(7))
            return {"first": first, "frame": _frame(feed), "views": _views(feed)}

        seen = _both(scenario, tmp_path)
        # no checkpoint was due (bound 256): 2 registrations and 6 batches
        assert seen["first"]["replayed"] == 8 and _count(seen, "recovery.feed") == 2

    def test_upsert_key_index_recovered(self, tmp_path):
        def scenario(P, root):
            feed = _open(P, root, "keyed", schema=_SCHEMA, key="k")
            for b in range(4):
                feed.append(_batch(b))
            up = _batch(9, n=20, key_start=50)  # 14 updates and 6 new keys
            feed.upsert(up)
            want = _frame(feed)
            P.ingest.reset()
            feed = _open(P, root, "keyed")
            assert feed.key == "k"  # from meta.json
            pandas.testing.assert_frame_equal(_frame(feed), want)
            rows_before = feed.rows
            feed.upsert(up)  # the key index came back: updates in place
            return {"frame": want, "rows": (rows_before, feed.rows)}

        rows = _both(scenario, tmp_path)["rows"]
        assert rows[0] == rows[1]

    def test_checkpoint_bounds_replay(self, tmp_path):
        def scenario(P, root):
            P.cfg.WalMaxReplayBatches.put(4)
            P.cfg.WalSegmentBytes.put(1024)  # several segments
            feed = _open(P, root, "ckpt", schema=_SCHEMA)
            feed.register_view("total", _PLANS["total"])
            for b in range(12):
                feed.append(_batch(b))
            P.ingest.reset()
            feed = _open(P, root, "ckpt")
            _assert_feed(feed, _control(12))
            return {"replayed": feed._wal.replayed_batches, "frame": _frame(feed),
                    "files": sorted(os.listdir(os.path.join(root, "ckpt")))}

        seen = _both(scenario, tmp_path)
        assert _count(seen, "checkpoint.write") >= 2 and _total(seen, "wal.truncate.segments") > 0
        assert _count(seen, "checkpoint.load") == 1 and seen["replayed"] <= 4

    def test_schema_mismatch_refused(self, tmp_path):
        def scenario(P, root):
            _open(P, root, "strict", schema=_SCHEMA)
            P.ingest.reset()
            with pytest.raises(P.durability.DurabilityError) as err:
                _open(P, root, "strict", schema={"other": "float64"})
            return {"reason": err.value.reason}

        assert _both(scenario, tmp_path)["reason"] == "schema_mismatch"

    def test_recover_feeds_scans_root(self, tmp_path):
        def scenario(P, root):
            for name in ("alpha", "beta"):
                feed = _open(P, root, name, schema=_SCHEMA)
                feed.register_view("total", _PLANS["total"])
                for b in range(3):
                    feed.append(_batch(b))
            P.ingest.reset()
            opened = P.durability.recover_feeds(root)
            listed = P.ingest.feeds()
            for name in ("alpha", "beta"):
                _assert_feed(P.ingest.get_feed(name), _control(3))
            return {"opened": opened, "listed": listed, "again": P.durability.recover_feeds(root)}

        seen = _both(scenario, tmp_path)
        assert (seen["opened"], seen["listed"], seen["again"]) == (2, ["alpha", "beta"], 0)

    def test_durability_root_resolution(self, tmp_path):
        """The root: the argument, else ``WalDir``, else ``<CacheDir>/wal``
        (the fleet's replicas, which hand the root on in their environment,
        wait for ``fleet/``)."""
        for P in PACKAGES:
            assert P.durability.resolve_root_dir(str(tmp_path)) == str(tmp_path)
            P.cfg.WalDir.put(str(tmp_path / "configured"))
            assert P.durability.resolve_root_dir() == str(tmp_path / "configured")
            P.cfg.WalDir.put("")
            assert P.durability.resolve_root_dir() == os.path.join(str(P.cfg.CacheDir.get()), "wal")


# ====================================================================== #
# the same bytes, recovered across the packages
# ====================================================================== #


def _cross_stream(P, root):
    """A stream that writes every kind of record and a checkpoint: keyed
    appends, an upsert, view registrations before and after a checkpoint."""
    P.cfg.WalMaxReplayBatches.put(5)
    P.cfg.WalSegmentBytes.put(4096)
    feed = _open(P, root, "shared", schema=_SCHEMA, key="k")
    feed.register_view("total", _PLANS["total"])
    feed.register_view("by_group", _PLANS["by_group"])
    for b in range(7):
        feed.append(_batch(b))
    feed.upsert(_batch(20, n=24, key_start=100))  # 12 updates and 12 new keys
    feed.register_view("top", {"kind": "topk", "column": "x", "k": 5})
    for b in range(8, 10):
        feed.append(_batch(b))
    state = {"frame": _frame(feed), "views": _views(feed), "top": feed.read("top").value}
    P.ingest.reset()
    return state


def _recovered(P, root):
    """The recovered feed, then an upsert into it (the restored key index
    places it)."""
    feed = _open(P, root, "shared")
    state = {"frame": _frame(feed), "views": _views(feed), "top": feed.read("top").value,
             "replayed": feed._wal.replayed_batches, "key_index": dict(feed._key_index)}
    feed.upsert(_batch(21, n=16, key_start=8))  # stored keys only: updates in place
    state["upserted"] = (feed.rows, _frame(feed))
    return state


def _module_names(data: bytes):
    """The modules a pickle's GLOBAL and STACK_GLOBAL opcodes load: the
    operand of a STACK_GLOBAL is the pair of strings pushed before it,
    literally or from the memo."""
    memo, pushed, names = {}, [], []
    for op, arg, _pos in pickletools.genops(data):
        if op.name in ("SHORT_BINUNICODE", "BINUNICODE", "UNICODE", "BINUNICODE8"):
            pushed.append(arg)
        elif op.name == "MEMOIZE":
            memo[len(memo)] = pushed[-1] if pushed else None
        elif op.name in ("PUT", "BINPUT", "LONG_BINPUT"):
            memo[arg] = pushed[-1] if pushed else None
        elif op.name in ("GET", "BINGET", "LONG_BINGET"):
            pushed.append(memo.get(arg))
        elif op.name == "GLOBAL":
            names.append(arg.split(" ")[0])
        elif op.name == "STACK_GLOBAL":
            names.append(pushed[-2])
            pushed.append(None)
        else:
            pushed.append(None)
    return names


class TestAcrossPackages:
    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_one_package_recovers_the_others_directory(self, tmp_path, writer):
        W, R = (JAX, PORT) if writer == "jax" else (PORT, JAX)
        root = tmp_path / "root"
        written = _cross_stream(W, str(root))
        files = _files(str(root / "shared"))
        assert any(f.startswith("ckpt_") for f in files) and any(f.startswith("wal_") for f in files)
        shutil.copytree(root, tmp_path / "copy")
        by_reader = _recovered(R, str(root))
        by_writer = _recovered(W, str(tmp_path / "copy"))
        _same(by_reader, by_writer, f"{R.name} recovering {W.name}'s files")
        _same({k: by_reader[k] for k in written}, written, "recovered against written")
        assert by_reader["replayed"] > 0
        assert by_reader["key_index"] == dict(zip(written["frame"]["k"].tolist(), range(len(written["frame"]))))
        assert by_reader["upserted"][0] == len(written["frame"])

    def test_both_packages_write_the_same_bytes(self, tmp_path):
        for P in PACKAGES:
            _cross_stream(P, str(tmp_path / P.name))
        jax_files, port_files = (_files(str(tmp_path / P.name / "shared")) for P in PACKAGES)
        assert sorted(jax_files) == sorted(port_files)
        for name in jax_files:
            assert port_files[name] == jax_files[name], name

    def test_no_record_or_checkpoint_names_a_package_module(self, tmp_path):
        for P in PACKAGES:
            feed_dir = str(tmp_path / P.name / "shared")
            _cross_stream(P, str(tmp_path / P.name))
            payloads = []
            for _first, path in P.wal.list_segments(feed_dir):
                records, _valid, torn = P.wal.read_segment(path)
                assert not torn
                payloads += [payload for _seq, _op, payload in records]
            for _seq, path in P.ckpt.list_checkpoints(feed_dir):
                payloads.append(open(path, "rb").read()[4:])
            assert len(payloads) > 3
            modules = {m for data in payloads for m in _module_names(data)}
            assert modules and not [m for m in modules if m.split(".")[0] in ("modin_tpu", "modin_tpu_torch")], modules
            # host libraries only (pandas' str labels pickle through pyarrow)
            assert {m.split(".")[0] for m in modules} <= {"pandas", "numpy", "pyarrow", "builtins", "collections",
                                                          "copyreg", "_codecs", "datetime"}, modules


# ====================================================================== #
# torn tails and corruption
# ====================================================================== #


class TestTornAndCorrupt:
    def test_torn_tail_truncated(self, tmp_path):
        def scenario(P, root):
            feed = _open(P, root, "torn", schema=_SCHEMA)
            feed.register_view("total", _PLANS["total"])
            for b in range(5):
                feed.append(_batch(b))
            P.ingest.reset()
            with open(_segments(os.path.join(root, "torn"))[-1], "ab") as fh:
                fh.write(b"\x07torn")  # a crash mid-write: less than a header
            feed = _open(P, root, "torn")
            _assert_feed(feed, _control(5))
            feed.append(_batch(5))  # the cut segment is adopted
            P.ingest.reset()
            feed = _open(P, root, "torn")
            _assert_feed(feed, _control(6))
            return {"frame": _frame(feed)}

        assert _count(_both(scenario, tmp_path), "wal.torn_tail") == 1

    def test_flipped_byte_prefix_recovery(self, tmp_path):
        def scenario(P, root):
            feed = _open(P, root, "flip", schema=_SCHEMA)
            for b in range(5):
                feed.append(_batch(b))
            P.ingest.reset()
            seg = _segments(os.path.join(root, "flip"))[-1]
            data = bytearray(open(seg, "rb").read())
            data[-10] ^= 0xFF  # inside the last record: its CRC fails
            with open(seg, "wb") as fh:
                fh.write(bytes(data))
            feed = _open(P, root, "flip")
            _assert_feed(feed, _control(4), views=False)
            return {"rows": feed.rows}

        seen = _both(scenario, tmp_path)
        assert seen["rows"] == 4 * _BATCH_ROWS and _count(seen, "wal.torn_tail") == 1


# ====================================================================== #
# disk faults
# ====================================================================== #


class TestDiskFaults:
    def test_enospc_reclaims_then_succeeds(self, tmp_path):
        def scenario(P, root):
            feed = _open(P, root, "nospc", schema=_SCHEMA)
            feed.append(_batch(0))
            with P.faults.inject_disk_faults("enospc", ops=("wal.write",), times=1):
                feed.append(_batch(1))  # a reclaim pass, then the retry lands
            degraded = feed._wal.degraded
            _assert_feed(feed, _control(2), views=False)
            P.ingest.reset()
            feed = _open(P, root, "nospc")
            _assert_feed(feed, _control(2), views=False)
            return {"degraded": degraded}

        seen = _both(scenario, tmp_path)
        assert _count(seen, "wal.enospc.reclaim") == 1 and not seen["degraded"]

    def test_enospc_exhausted_is_typed_refusal(self, tmp_path):
        def scenario(P, root):
            feed = _open(P, root, "full", schema=_SCHEMA)
            feed.append(_batch(0))
            with P.faults.inject_disk_faults("enospc", ops=("wal.write",), times=2):
                with pytest.raises(P.durability.DurabilityError) as err:
                    feed.append(_batch(1))
            refused = (err.value.reason, feed.rows, feed._wal.degraded)
            feed.append(_batch(1))  # room again: durable again
            _assert_feed(feed, _control(2), views=False)
            P.ingest.reset()
            feed = _open(P, root, "full")
            _assert_feed(feed, _control(2), views=False)
            return {"refused": refused}

        assert _both(scenario, tmp_path)["refused"] == ("enospc", _BATCH_ROWS, False)

    def test_eio_degrades_to_memory_only(self, tmp_path):
        def scenario(P, root):
            feed = _open(P, root, "sick", schema=_SCHEMA)
            feed.register_view("total", _PLANS["total"])
            feed.append(_batch(0))
            with P.faults.inject_disk_faults("eio", ops=("wal.write",), times=1):
                feed.append(_batch(1))  # the write dies; ingestion does not
            degraded = feed._wal.degraded
            feed.append(_batch(2))  # memory only from here on
            _assert_feed(feed, _control(3))
            P.ingest.reset()
            feed = _open(P, root, "sick")  # durability was lost at the breaker
            _assert_feed(feed, _control(1))
            return {"degraded": degraded}

        seen = _both(scenario, tmp_path)
        assert seen["degraded"] and _count(seen, "wal.degraded") == 1

    def test_fsync_failure_degrades(self, tmp_path):
        def scenario(P, root):
            feed = _open(P, root, "nosync", schema=_SCHEMA)
            with P.faults.inject_disk_faults("fsync_fail", ops=("wal.fsync",), times=1):
                feed.append(_batch(0))
            return {"degraded": feed._wal.degraded, "rows": feed.rows}

        seen = _both(scenario, tmp_path)
        assert seen == {"degraded": True, "rows": _BATCH_ROWS, "metrics": seen["metrics"]}
        assert _count(seen, "wal.degraded") == 1

    def test_injector_validation(self):
        for P in PACKAGES:
            with pytest.raises(ValueError):
                P.faults.DiskFaultInjector("melt")
            with pytest.raises(ValueError):
                P.faults.DiskFaultInjector("torn_write", ops=("wal.fsync",))
            with pytest.raises(ValueError):
                P.faults.DiskFaultInjector("eio", ops=("disk.spin",))


# ====================================================================== #
# the kill -9 grid (the port in a child process)
# ====================================================================== #

_CHILD = r"""
import os
os.environ["MODIN_TPU_TORCH_DEVICE"] = "cpu"
os.environ["MODIN_TPU_TORCH_INGEST"] = "1"
import numpy as np
import pandas
from modin_tpu_torch import ingest
from modin_tpu_torch.config import WalFsync, WalMaxReplayBatches, WalSegmentBytes
from modin_tpu_torch.testing import DiskFaultInjector

WalFsync.put(os.environ["DUR_FSYNC"])
WalMaxReplayBatches.put(int(os.environ["DUR_MAX_REPLAY"]))
WalSegmentBytes.put(int(os.environ["DUR_SEG_BYTES"]))
feed = ingest.open_feed(
    "grid", schema={"k": "int64", "i": "int64", "x": "float64", "g": "int64"},
    durable=True, durability_dir=os.environ["DUR_DIR"],
)
feed.register_view("total", {"kind": "scalar", "column": "i", "agg": "sum"})
inj = DiskFaultInjector(kind=os.environ["DUR_KIND"], ops=(os.environ["DUR_OP"],), times=1,
                        skip=int(os.environ["DUR_SKIP"]))
inj.__enter__()  # never exits: the injected fault SIGKILLs this process
for b in range(int(os.environ["DUR_TOTAL"])):
    rng = np.random.default_rng(7000 + b)
    n = 16
    feed.append(pandas.DataFrame({
        "k": np.arange(b * n, b * n + n, dtype=np.int64),
        "i": rng.integers(-1000, 1000, n),
        "x": rng.normal(size=n),
        "g": rng.integers(0, 5, n),
    }))
    print("ACKED", b + 1, flush=True)
print("SURVIVED", flush=True)
"""

#: (label, fault kind, faulted op, skip count, fsync policy, max replay)
_KILL_GRID = [
    ("mid_record", "torn_write", "wal.write", 5, "PerBatch", 256),
    ("mid_checkpoint", "kill", "checkpoint.write", 0, "PerBatch", 3),
    ("mid_truncate", "kill", "checkpoint.truncate", 0, "PerBatch", 3),
    ("mid_stream_groupcommit", "kill", "wal.write", 6, "GroupCommit", 256),
]


class TestKillGrid:
    @pytest.mark.parametrize("label,kind,op,skip,fsync,max_replay", _KILL_GRID, ids=[r[0] for r in _KILL_GRID])
    def test_kill_recover_bit_exact(self, tmp_path, label, kind, op, skip, fsync, max_replay):
        """The port's child is SIGKILLed mid-stream; the port and the JAX
        package each recover a copy of its directory, bit for bit an
        uninterrupted control at R batches with acked <= R <= acked + 1."""
        total = 10
        root = tmp_path / "root"
        env = dict(os.environ, DUR_DIR=str(root), DUR_FSYNC=fsync, DUR_MAX_REPLAY=str(max_replay),
                   DUR_SEG_BYTES="1024", DUR_KIND=kind, DUR_OP=op, DUR_SKIP=str(skip), DUR_TOTAL=str(total),
                   PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run([sys.executable, "-c", _CHILD], env=env, capture_output=True, text=True, timeout=180)
        assert "SURVIVED" not in proc.stdout, f"the injected {kind}@{op} never fired:\n{proc.stdout}\n{proc.stderr}"
        assert proc.returncode == -signal.SIGKILL, (proc.returncode, proc.stdout, proc.stderr)
        acked = sum(1 for line in proc.stdout.splitlines() if line.startswith("ACKED"))
        assert acked > 0, (proc.stdout, proc.stderr)
        shutil.copytree(root, tmp_path / "copy")
        recovered = {}
        for P, where in ((PORT, root), (JAX, tmp_path / "copy")):
            seen = []
            handler = lambda name, value, seen=seen: seen.append(name)  # noqa: E731
            P.add(handler)
            try:
                feed = _open(P, str(where), "grid")
            finally:
                P.clear(handler)
            assert feed.rows % _BATCH_ROWS == 0, f"{P.name} recovered a partial batch: {feed.rows} rows"
            count = feed.rows // _BATCH_ROWS
            assert acked <= count <= min(acked + 1, total), (label, P.name, acked, count)
            _assert_feed(feed, _control(count))
            assert seen.count(f"{P.prefix}recovery.feed") == 1
            recovered[P.name] = (count, _frame(feed))
        assert recovered["port"][0] == recovered["jax"][0]
        pandas.testing.assert_frame_equal(recovered["port"][1], recovered["jax"][1])


# ====================================================================== #
# zero overhead for non-durable feeds
# ====================================================================== #

_PLAIN_CHILD = r"""
import os
os.environ["MODIN_TPU_TORCH_DEVICE"] = "cpu"
os.environ["MODIN_TPU_TORCH_INGEST"] = "1"
import sys
import numpy as np
import pandas
from modin_tpu_torch import ingest

feed = ingest.open_feed("plain", schema={"i": "int64"})
feed.register_view("total", {"kind": "scalar", "column": "i", "agg": "sum"})
for b in range(3):
    feed.append(pandas.DataFrame({"i": np.arange(8, dtype=np.int64)}))
assert feed.rows == 24
assert feed.read("total").value == 3 * 28
assert feed._wal is None
assert "modin_tpu_torch.durability" not in sys.modules, "durability was imported on the non-durable path"
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "modin_tpu")]
print("CLEAN")
"""


class TestZeroOverhead:
    def test_non_durable_never_imports_durability(self):
        env = dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run([sys.executable, "-c", _PLAIN_CHILD], env=env, capture_output=True, text=True,
                              timeout=180)
        assert proc.returncode == 0, (proc.stdout, proc.stderr)
        assert "CLEAN" in proc.stdout

    def test_alloc_counter_contract(self, tmp_path):
        for P in PACKAGES:
            before = P.durability.durability_alloc_count()
            plain = P.ingest.create_feed("plain", _SCHEMA)
            for b in range(4):
                plain.append(_batch(b))
            assert plain._wal is None and P.durability.durability_alloc_count() == before
            # a durable feed allocates its manager and its segment writer
            _open(P, str(tmp_path / P.name), "heavy", schema=_SCHEMA)
            assert P.durability.durability_alloc_count() == before + 2
            assert P.durability.DURABILITY_ON


# ====================================================================== #
# the flight recorder's dump through the shared atomic write
# ====================================================================== #


class TestFlightRecorderClaim:
    def test_partial_write_releases_claim(self, monkeypatch, tmp_path):
        """A dump whose write dies leaves no file and gives back the claim
        window: the next dump goes out at once."""
        import modin_tpu_torch.observability as tobs
        from modin_tpu_torch.config import TraceDir, TraceEnabled
        from modin_tpu_torch.observability import flight_recorder
        from modin_tpu_torch.utils import atomic_io

        monkeypatch.setattr(flight_recorder, "MIN_DUMP_INTERVAL_S", 3600.0)
        real = atomic_io.atomic_write_json
        fails = {"n": 1}

        def flaky(path, obj, **kwargs):
            if fails["n"] > 0:
                fails["n"] -= 1
                raise OSError(5, "injected mid-write failure")
            return real(path, obj, **kwargs)

        monkeypatch.setattr(atomic_io, "atomic_write_json", flaky)
        with TraceDir.context(str(tmp_path)), TraceEnabled.context(True):
            flight_recorder.reset_for_tests()
            with tobs.layer_span("TestDur.claim", "QUERY-COMPILER"):
                pass
            assert flight_recorder.dump_flight_record("dur_fault") is None
            assert not list(tmp_path.iterdir()), "a failed dump left a file"
            path = flight_recorder.dump_flight_record("dur_fault")
            assert path is not None and os.path.exists(path)

    def test_atomic_write_leaves_old_file_on_failure(self, tmp_path):
        from modin_tpu_torch.utils import atomic_io

        path = str(tmp_path / "table.json")
        atomic_io.atomic_write_json(path, {"a": 1}, durable_rename=True)
        with pytest.raises(TypeError):
            atomic_io.atomic_write_json(path, {"a": object()})
        assert open(path).read() == '{"a": 1}' and os.listdir(tmp_path) == ["table.json"]
