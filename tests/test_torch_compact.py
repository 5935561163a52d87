"""The port's key-based compaction (``iotml_torch.store.compact``) held
against the JAX package's on the CPU.

Each case of ``tests/test_compact.py`` that covers ported code runs on
both packages from the same records; the survivors (offsets, keys,
values, timestamps), the pass statistics, the dirty ratios, the retained
bases and the compacted segment files must be equal, and the JAX test's
own assertions hold on the port.  The follower-replica case
(``test_replica_mirrors_compacted_topic_with_holes``) is in
tests/test_torch_replica.py, from a leader of either package.
"""

import os
import types
from pathlib import Path

import pytest

from iotml.store import OffsetsFile as JOffsetsFile
from iotml.store import SegmentedLog as JSegmentedLog
from iotml.store import StorePolicy as JStorePolicy
from iotml.store import compact as j_cp
from iotml.store import segment as j_seg
from iotml.stream.broker import Broker as JBroker
from iotml.stream.kafka_wire import KafkaWireBroker as JWireBroker
from iotml.stream.kafka_wire import KafkaWireServer as JWireServer
from iotml_torch.chaos import faults
from iotml_torch.store import OffsetsFile, SegmentedLog, StorePolicy
from iotml_torch.store import compact as t_cp
from iotml_torch.store import segment as t_seg
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.kafka_wire import KafkaWireBroker, KafkaWireServer
from iotml_torch.stream.native_kafka import NativeKafkaBroker

PORT = types.SimpleNamespace(
    name="port", seg=t_seg, cp=t_cp, SegmentedLog=SegmentedLog,
    StorePolicy=StorePolicy, OffsetsFile=OffsetsFile, Broker=Broker,
    WireServer=KafkaWireServer, WireBroker=KafkaWireBroker)
JAX = types.SimpleNamespace(
    name="jax", seg=j_seg, cp=j_cp, SegmentedLog=JSegmentedLog,
    StorePolicy=JStorePolicy, OffsetsFile=JOffsetsFile, Broker=JBroker,
    WireServer=JWireServer, WireBroker=JWireBroker)
PKGS = (PORT, JAX)


def _both(case, tmp_path):
    got = [case(pkg, None if tmp_path is None else tmp_path / pkg.name)
           for pkg in PKGS]
    assert got[0] == got[1]
    return got[0]


def _pol(pkg, **kw):
    kw.setdefault("fsync", "never")
    kw.setdefault("segment_bytes", 10 ** 9)
    return pkg.StorePolicy(**kw)


def _offsets(log):
    return [r[0] for r in log.read_from(log.base_offset, 10 ** 6)]


def _records(log):
    return log.read_from(log.base_offset, 10 ** 6)


def _logs(d: Path) -> dict:
    """{name: bytes} of the segment files in ``d``."""
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))
            if n.endswith(".log")}


def _stats(s):
    return (s.segments_rewritten, s.records_removed, s.bytes_reclaimed)


def _drain(b, topic, p=0):
    out, off = [], b.begin_offset(topic, p)
    end = b.end_offset(topic, p)
    while off < end:
        batch = b.fetch(topic, p, off, 10 ** 6)
        if not batch:
            break
        out += batch
        off = batch[-1].offset + 1
    return out


# ---------------------------------------------------------- the decision
def test_tombstone_frame_is_byte_distinct_from_empty():
    dead = t_seg.encode_record(5, b"k", None, 10, None)
    empty = t_seg.encode_record(5, b"k", b"", 10, None)
    assert dead != empty
    assert dead == j_seg.encode_record(5, b"k", None, 10, None)
    assert empty == j_seg.encode_record(5, b"k", b"", 10, None)
    (_p, _e, _o, _k, v_dead, _t, _h), = t_seg.scan_records(dead)
    (_p, _e, _o, _k, v_empty, _t, _h), = t_seg.scan_records(empty)
    assert v_dead is None and v_empty == b""


def test_keep_rule_latest_per_key_unkeyed_and_grace():
    recs = [(0, b"a", b"1", 100, None), (1, None, b"x", 110, None),
            (2, b"a", b"2", 120, None), (3, b"b", None, 130, None)]

    def case(pkg, _d):
        latest = pkg.cp.latest_offsets(recs)
        return [latest] + [pkg.cp.keep(r, latest, 130, grace_ms=10 ** 6)
                           for r in recs[:3]] + [
            pkg.cp.keep(recs[3], latest, newest_ts=200, grace_ms=100),
            pkg.cp.keep(recs[3], latest, newest_ts=300, grace_ms=100),
            pkg.cp.keep(recs[3], latest, newest_ts=10 ** 9, grace_ms=None)]

    assert _both(case, None) == [{b"a": 2, b"b": 3}, False, True, True,
                                 True, False, True]


# ----------------------------------------------------- segment compactor
def test_compact_keeps_latest_per_key_and_preserves_offsets(tmp_path):
    def case(pkg, d):
        log = pkg.SegmentedLog(str(d), _pol(pkg, segment_bytes=256))
        try:
            for rnd in range(6):
                for k in range(4):
                    log.append(f"k{k}".encode(), f"v{rnd}".encode(),
                               1000 + rnd * 10 + k)
            log.append(None, b"unkeyed", 2000)
            log.roll()
            nseg = len(log._segments)
            before = {r[0]: r for r in _records(log)}
            stats = _stats(log.compact())
            after = _records(log)
            assert all(before[r[0]] == r for r in after)
            return [nseg, stats, after, _stats(log.compact()), _logs(d)]
        finally:
            log.close()

    nseg, stats, after, again, _f = _both(case, tmp_path)
    assert nseg > 2 and stats[1] > 0 and stats[2] > 0
    by_key = {key: value for _o, key, value, _t, _h in after
              if key is not None}
    assert by_key == {f"k{k}".encode(): b"v5" for k in range(4)}
    assert any(key is None for _o, key, _v, _t, _h in after)
    assert again[0] == 0


def test_dirty_ratio_trigger_and_broker_gate(tmp_path):
    def case(pkg, d):
        b = pkg.Broker(store_dir=str(d),
                       store_policy=_pol(pkg, segment_bytes=256,
                                         compact_min_dirty_ratio=0.5))
        try:
            b.create_topic("C", cleanup_policy="compact")
            b.create_topic("D")
            slog = b.store.log_for("C", 0)
            out = [slog.dirty_ratio()]
            for rnd in range(8):
                for k in range(4):
                    b.produce("C", f"v{rnd}".encode(), key=f"k{k}".encode(),
                              partition=0, timestamp_ms=1000 + rnd)
                    b.produce("D", b"x", key=b"k", partition=0)
            slog.roll()
            out.append(slog.dirty_ratio())
            first = b.run_compaction()
            out += [sorted(first), {k: _stats(v) for k, v in first.items()},
                    slog.dirty_ratio()]
            b.produce("C", b"v9", key=b"k0", partition=0, timestamp_ms=2000)
            b.store.log_for("C", 0).roll()
            out += [b.store.log_for("C", 0).dirty_ratio(),
                    b.run_compaction(),
                    sorted(b.run_compaction(force=True))]
            return out
        finally:
            b.close()

    zero, full, keys, _st, clean, small, gated, forced = \
        _both(case, tmp_path)
    assert zero == 0.0 and full == 1.0 and clean == 0.0
    assert ("C", 0) in keys and ("D", 0) not in keys
    assert 0.0 < small < 0.5 and gated == {} and forced == [("C", 0)]


def test_tombstone_grace_expiry(tmp_path):
    def case(pkg, d):
        log = pkg.SegmentedLog(str(d), _pol(pkg))
        try:
            log.append(b"a", b"v1", 1000)
            log.append(b"a", None, 2000)
            log.append(b"b", b"v2", 2500)
            log.roll()
            log.compact(grace_ms=1000)
            inside = _records(log)
            log.compact(grace_ms=100)
            return [inside, _records(log)]
        finally:
            log.close()

    inside, past = _both(case, tmp_path)
    assert (1, b"a", None, 2000, None) in inside
    assert [r[0] for r in past] == [2] and all(r[1] != b"a" for r in past)


def test_compaction_composes_with_retention(tmp_path):
    def case(pkg, d):
        b = pkg.Broker(store_dir=str(d),
                       store_policy=_pol(pkg, segment_bytes=256))
        try:
            b.create_topic("C", cleanup_policy="compact",
                           retention_messages=16)
            for k in range(40):
                b.produce("C", b"first", key=f"u{k:02d}".encode(),
                          partition=0, timestamp_ms=1000 + k)
            trimmed = b.begin_offset("C", 0)
            for rnd in range(8):
                b.produce("C", f"v{rnd}".encode(), key=b"hot", partition=0,
                          timestamp_ms=2000 + rnd)
            b.store.log_for("C", 0).roll()
            base_before = b.begin_offset("C", 0)
            out = b.run_compaction(force=True)
            return [trimmed, base_before, b.begin_offset("C", 0),
                    _stats(out[("C", 0)]),
                    [(m.offset, m.key, m.value) for m in _drain(b, "C")]]
        finally:
            b.close()

    trimmed, before, after, stats, rows = _both(case, tmp_path)
    assert trimmed > 0 and stats[1] > 0 and before == after
    live = {k: v for _o, k, v in rows}
    assert live[b"hot"] == b"v7"
    assert sum(1 for k in live if k.startswith(b"u")) == len(live) - 1


def test_index_rebuild_and_reads_over_compacted_segments(tmp_path):
    def case(pkg, d):
        pol = _pol(pkg, segment_bytes=256, index_interval_bytes=64)
        log = pkg.SegmentedLog(str(d), pol)
        for rnd in range(8):
            for k in range(4):
                log.append(f"k{k}".encode(), b"v%d" % rnd,
                           1000 + rnd * 10 + k)
        log.roll()
        log.compact()
        survivors = _offsets(log)
        got, off = [], 0
        while True:
            chunk = log.read_from(off, 3)
            if not chunk:
                break
            offs = [r[0] for r in chunk]
            assert offs == list(range(offs[0], offs[0] + len(offs)))
            got += offs
            off = offs[-1] + 1
        off_for = log.offset_for_timestamp(1050)
        end = log.end_offset
        log.close()
        log2 = pkg.SegmentedLog(str(d), pol)
        out = [survivors, got, off_for, end, _offsets(log2),
               log2.offset_for_timestamp(1050)]
        log2.close()
        for n in list(os.listdir(str(d))):
            if n.endswith((".index", ".timeindex")):
                os.remove(str(d / n))
        log3 = pkg.SegmentedLog(str(d), pol)
        out.append(_offsets(log3))
        log3.close()
        return out

    survivors, got, off_for, end, again, off_again, rescan = \
        _both(case, tmp_path)
    assert got == survivors == again == rescan
    assert off_for in survivors or off_for == end
    assert off_again == off_for


def test_compacted_reads_byte_stable_across_remount(tmp_path):
    def case(pkg, d):
        pol = _pol(pkg, segment_bytes=256)
        log = pkg.SegmentedLog(str(d), pol)
        for rnd in range(8):
            for k in range(4):
                log.append(f"k{k}".encode(), b"v%d" % rnd, 1000 + rnd)
        log.append(b"k0", None, 1100)
        log.roll()
        log.compact(grace_ms=10 ** 9)
        want = _records(log)
        files = dict(list(_logs(d).items())[:-1])  # sealed segments
        log.close()
        log2 = pkg.SegmentedLog(str(d), pol)
        try:
            return [want, _records(log2) == want,
                    all(_logs(d)[n] == blob for n, blob in files.items()),
                    files]
        finally:
            log2.close()

    _want, same, stable, _files = _both(case, tmp_path)
    assert same and stable


def test_fully_dead_segments_drop_but_head_keeps_base(tmp_path):
    def case(pkg, d):
        log = pkg.SegmentedLog(str(d), _pol(pkg, segment_bytes=200))
        for rnd in range(12):
            log.append(b"one-key", b"v%02d" % rnd, 1000 + rnd)
        log.roll()
        n_before = len(log._segments)
        log.compact()
        out = [n_before, len(log._segments), log.base_offset,
               [r[:3] for r in _records(log)]]
        log.close()
        log2 = pkg.SegmentedLog(str(d), _pol(pkg, segment_bytes=200))
        out += [log2.base_offset, _offsets(log2)]
        log2.close()
        return out

    before, after, base, rows, base2, offs = _both(case, tmp_path)
    assert before > 3 and after < before and base == base2 == 0
    assert rows == [(11, b"one-key", b"v11")] and offs == [11]


def test_stale_cleaned_tmp_swept_at_mount(tmp_path):
    def case(pkg, d):
        log = pkg.SegmentedLog(str(d), _pol(pkg))
        log.append(b"k", b"v", 1)
        log.close()
        stale = d / ("00000000000000000000.log" + pkg.cp.CLEANED_SUFFIX)
        stale.write_bytes(b"half-finished rewrite")
        log2 = pkg.SegmentedLog(str(d), _pol(pkg))
        try:
            return [stale.exists(), _offsets(log2)]
        finally:
            log2.close()

    assert _both(case, tmp_path) == [False, [0]]


def test_compaction_killed_before_its_swap_leaves_the_segment(tmp_path):
    """The store.compact_swap fault point: an error between the durable
    rewrite and its publication leaves the live segment untouched and
    the .cleaned tmp beside it, which the next mount sweeps."""
    log = SegmentedLog(str(tmp_path), _pol(PORT, segment_bytes=256))
    for rnd in range(6):
        for k in range(4):
            log.append(f"k{k}".encode(), b"v%d" % rnd, 1000 + rnd)
    log.roll()
    before = _records(log)
    files = _logs(tmp_path)
    engine = faults.ChaosEngine([faults.FaultEvent(
        1, "store.compact_swap", "error", (("exc", "OSError"),))])
    try:
        faults.arm(engine)
        with pytest.raises(OSError, match="store.compact_swap"):
            log.compact()
    finally:
        faults.disarm()
    assert engine.injected == {"store.compact_swap:error": 1}
    assert _records(log) == before and _logs(tmp_path) == files
    assert any(n.endswith(t_cp.CLEANED_SUFFIX) for n in os.listdir(tmp_path))
    log.close()
    log2 = SegmentedLog(str(tmp_path), _pol(PORT, segment_bytes=256))
    assert not any(n.endswith(t_cp.CLEANED_SUFFIX)
                   for n in os.listdir(tmp_path))
    assert _records(log2) == before
    assert log2.compact().segments_rewritten > 0
    log2.close()


# ------------------------------------------------- offsets-file migration
def test_offsets_file_routes_through_generic_compactor(tmp_path, monkeypatch):
    def case(pkg, d):
        calls = []
        real_keep = pkg.cp.keep

        def spy(record, latest, newest_ts, grace_ms):
            calls.append(record)
            return real_keep(record, latest, newest_ts, grace_ms)

        monkeypatch.setattr(pkg.cp, "keep", spy)
        f = pkg.OffsetsFile(str(d / "offsets"), fsync="never",
                            compact_ratio=10 ** 9)
        for i in range(20):
            f.commit("g", "t", 0, i)
        f.compact()
        out = [bool(calls), f.table()[("g", "t", 0)]]
        f.close()
        f2 = pkg.OffsetsFile(str(d / "offsets"), fsync="never")
        out += [f2.table()[("g", "t", 0)], (d / "offsets" /
                                            "offsets").read_bytes()]
        f2.close()
        return out

    called, latest, reloaded, _blob = _both(case, tmp_path)
    assert called and latest == reloaded == 19


# ----------------------------------------------- tombstone transport e2e
def test_tombstone_survives_durable_broker_remount(tmp_path):
    def case(pkg, d):
        b = pkg.Broker(store_dir=str(d), store_policy=_pol(pkg))
        b.create_topic("C", cleanup_policy="compact")
        b.produce("C", b"v", key=b"k", partition=0, timestamp_ms=1)
        b.produce("C", None, key=b"k", partition=0, timestamp_ms=2)
        first = [m.value for m in b.fetch("C", 0, 0, 10)]
        b.close()
        b2 = pkg.Broker(store_dir=str(d), store_policy=_pol(pkg))
        try:
            return [first, b2.topic("C").cleanup_policy,
                    [m.value for m in b2.fetch("C", 0, 0, 10)]]
        finally:
            b2.close()

    assert _both(case, tmp_path) == [[b"v", None], "compact", [b"v", None]]


def test_tombstone_and_cleanup_policy_over_the_wire():
    """Every client × server pair: the policy reaches the topic, a bad one
    is refused, a tombstone comes back None with its key."""
    for server in PKGS:
        for client_cls in (KafkaWireBroker, JWireBroker):
            b = server.Broker()
            with server.WireServer(b) as srv:
                client = client_cls(f"127.0.0.1:{srv.port}")
                try:
                    client.create_topic("C", partitions=1,
                                        cleanup_policy="compact")
                    assert b.topic("C").cleanup_policy == "compact"
                    with pytest.raises(ValueError):
                        client.create_topic("bad",
                                            cleanup_policy="sometimes")
                    client.produce("C", b"v", key=b"k", partition=0)
                    client.produce("C", None, key=b"k", partition=0)
                    got = client.fetch("C", 0, 0)
                    assert [m.value for m in got] == [b"v", None]
                    assert got[1].key == b"k"
                finally:
                    client.close()


def test_tombstone_through_native_client():
    for server in PKGS:
        b = server.Broker()
        with server.WireServer(b) as srv:
            client = NativeKafkaBroker(f"127.0.0.1:{srv.port}")
            try:
                client.create_topic("C", cleanup_policy="compact")
                assert b.topic("C").cleanup_policy == "compact"
                client.produce_many("C", [(b"k", b"v", 1), (b"k", None, 2),
                                          (b"j", b"w", 3)], partition=0)
                got = client.fetch("C", 0, 0)
                assert [(m.key, m.value) for m in got] == \
                    [(b"k", b"v"), (b"k", None), (b"j", b"w")]
            finally:
                client.close()


def test_in_memory_tombstone_and_compact_policy_metadata():
    def case(pkg, _d):
        b = pkg.Broker()
        spec = b.create_topic("C", cleanup_policy="compact")
        with pytest.raises(ValueError):
            b.create_topic("bad", cleanup_policy="compact,delete")
        b.produce("C", None, key=b"k", partition=0)
        (m,) = b.fetch("C", 0, 0, 10)
        return [spec.cleanup_policy, m.value, b.run_compaction()]

    assert _both(case, None) == ["compact", None, {}]
