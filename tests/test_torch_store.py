"""The port's durable store (``iotml_torch.store``: segment, log, offsets,
mount; the broker's durable backend) held against the JAX package's on
the CPU.

- Every case of ``tests/test_store.py`` runs on both packages from the
  same seeded records; what each package reads back (records, offsets,
  recovered bytes, index entries, committed offsets, retained bases,
  metrics) must be equal, and the JAX test's own assertions hold on the
  port.
- A store directory written by one package mounts in the other, and the
  same calls in both packages leave byte-identical directories
  (segments, index sidecars, manifest, offsets file).
- CRC32C: the native engine == ``google_crc32c`` == JAX's ``_crc32c_py``;
  frames: the native ``frame_entries`` == the per-record codec == JAX's,
  byte for byte (hypothesis, with null keys, tombstones, empty values).
- Recovery at every byte cut of the last frame.

Every child process has a deadline; every mount is closed in a
``finally`` or dropped on purpose (a simulated crash).
"""

import os
import random
import struct
import subprocess
import sys
import types
from pathlib import Path

import google_crc32c
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from iotml.config import load_config as j_load_config
from iotml.obs import metrics as j_metrics
from iotml.ops import framing as j_framing
from iotml.store import OffsetsFile as JOffsetsFile
from iotml.store import SegmentedLog as JSegmentedLog
from iotml.store import SegmentWriter as JSegmentWriter
from iotml.store import StorePolicy as JStorePolicy
from iotml.store import segment as j_seg
from iotml.store.log import store_replay_records as j_replay
from iotml.store.log import store_segment_bytes as j_segment_bytes
from iotml.store.mount import _dirname_for as j_dirname_for
from iotml.stream.broker import Broker as JBroker
from iotml.stream.broker import OffsetOutOfRangeError as JOutOfRange
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.kafka_wire import KafkaWireBroker as JWireBroker
from iotml.stream.kafka_wire import KafkaWireServer as JWireServer
from iotml.train.artifacts import ArtifactStore as JArtifactStore
from iotml.train.live import ContinuousTrainer as JContinuousTrainer
from iotml_torch.config import load_config as t_load_config
from iotml_torch.obs import metrics as t_metrics
from iotml_torch.ops import framing as t_framing
from iotml_torch.store import OffsetsFile, SegmentedLog, SegmentWriter
from iotml_torch.store import StorePolicy
from iotml_torch.store import segment as t_seg
from iotml_torch.store.log import store_replay_records as t_replay
from iotml_torch.store.log import store_segment_bytes as t_segment_bytes
from iotml_torch.store.mount import _dirname_for as t_dirname_for
from iotml_torch.stream import native
from iotml_torch.stream.broker import Broker, OffsetOutOfRangeError
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.kafka_wire import KafkaWireBroker, KafkaWireServer
from iotml_torch.train.artifacts import ArtifactStore
from iotml_torch.train.live import ContinuousTrainer

ROOT = Path(__file__).resolve().parent.parent

PORT = types.SimpleNamespace(
    name="port", seg=t_seg, SegmentedLog=SegmentedLog, StorePolicy=StorePolicy,
    SegmentWriter=SegmentWriter, OffsetsFile=OffsetsFile, Broker=Broker,
    OutOfRange=OffsetOutOfRangeError, StreamConsumer=StreamConsumer,
    WireServer=KafkaWireServer, WireBroker=KafkaWireBroker,
    replay=t_replay, segment_bytes=t_segment_bytes, metrics=t_metrics,
    dirname_for=t_dirname_for, load_config=t_load_config,
    ArtifactStore=ArtifactStore, framing=t_framing,
    trainer=lambda *a, **kw: ContinuousTrainer(*a, device="cpu", **kw),
    module="iotml_torch.stream.broker")
JAX = types.SimpleNamespace(
    name="jax", seg=j_seg, SegmentedLog=JSegmentedLog,
    StorePolicy=JStorePolicy, SegmentWriter=JSegmentWriter,
    OffsetsFile=JOffsetsFile, Broker=JBroker, OutOfRange=JOutOfRange,
    StreamConsumer=JStreamConsumer, WireServer=JWireServer,
    WireBroker=JWireBroker, replay=j_replay, segment_bytes=j_segment_bytes,
    metrics=j_metrics, dirname_for=j_dirname_for, load_config=j_load_config,
    ArtifactStore=JArtifactStore, framing=j_framing,
    trainer=JContinuousTrainer, module="iotml.stream.broker")
PKGS = (PORT, JAX)


def _both(case, tmp_path):
    """``case(pkg, dir)`` in each package's own directory; the two results
    must be equal.  Returns the port's."""
    got = [case(pkg, None if tmp_path is None else tmp_path / pkg.name)
           for pkg in PKGS]
    assert got[0] == got[1]
    return got[0]


def _fill(log, n, ts0=1000, payload=b"v"):
    for i in range(n):
        log.append(f"k{i}".encode() if i % 3 else None,
                   payload + str(i).encode(), ts0 + i)


def _dump(log):
    return log.read_from(log.base_offset, 10 ** 6)


def _files(d: Path) -> dict:
    """{relative path: bytes} of every file under ``d``."""
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


# ------------------------------------------------------------- framing
def test_crc32c_known_answer_and_engine_parity():
    assert t_seg.crc32c(b"123456789") == 0xE3069283
    assert t_seg._crc32c_py(b"123456789") == 0xE3069283
    rng = random.Random(7)
    for _ in range(64):
        blob = bytes(rng.randrange(256) for _ in range(rng.randrange(200)))
        assert t_seg.crc32c(blob) == t_seg._crc32c_py(blob) == \
            j_seg._crc32c_py(blob) == j_seg.crc32c(blob)


@settings(max_examples=200, deadline=None)
@given(st.binary(max_size=2048), st.integers(0, 2 ** 32 - 1))
def test_native_crc32c_equals_google_and_jax(blob, crc):
    want = google_crc32c.extend(crc, blob)
    assert native.crc32c(blob, crc) == want
    assert t_seg.crc32c(blob, crc) == want
    assert j_seg._crc32c_py(blob, crc) == want
    assert t_seg._crc32c_py(blob, crc) == want


_entries = st.lists(st.tuples(
    st.one_of(st.none(), st.binary(max_size=40)),
    st.one_of(st.none(), st.binary(max_size=300)),
    st.integers(-2 ** 63, 2 ** 63 - 1)), max_size=40)


@settings(max_examples=150, deadline=None)
@given(_entries, st.integers(0, 2 ** 40))
def test_native_frames_equal_the_codec_and_jax(entries, base):
    """The fused framing (one engine call) is the per-record codec's
    bytes, and JAX's ``frame_entries``' bytes, for null keys, tombstones
    and empty values alike; the frames parse back to the records."""
    got = t_framing.frame_entries(entries, base)
    plain = t_framing.encode_frame_batch(
        (base + i, k, v, ts, None) for i, (k, v, ts) in enumerate(entries))
    assert got == plain == j_framing.frame_entries(entries, base)
    assert list(t_framing.iter_frame_entries(got)) == [
        (base + i, k, v, ts, None) for i, (k, v, ts) in enumerate(entries)]


def test_traced_entries_take_the_per_record_codec():
    hdrs = (("iotml_trace", b"ctx"),)
    entries = [(b"k", b"v", 1, hdrs), (None, None, 2, None)]
    got = t_framing.frame_entries(entries, 5)
    assert got == j_framing.frame_entries(entries, 5)
    assert [e[4] for e in t_framing.iter_frame_entries(got)] == \
        [hdrs, None]


def test_record_roundtrip_with_and_without_headers():
    hdrs = (("iotml_trace", b"wire-bytes"), ("other", "strval"))
    frame = t_seg.encode_record(42, b"key", b"value", 1234, hdrs)
    assert frame == j_seg.encode_record(42, b"key", b"value", 1234, hdrs)
    rows = list(t_seg.scan_records(frame))
    assert len(rows) == 1
    _pos, end, off, key, value, ts, got = rows[0]
    assert (off, key, value, ts) == (42, b"key", b"value", 1234)
    assert got == (("iotml_trace", b"wire-bytes"), ("other", b"strval"))
    assert end == len(frame)
    frame2 = t_seg.encode_record(0, None, b"v", 0, None)
    assert frame2 == j_seg.encode_record(0, None, b"v", 0, None)
    (_p, _e, off, key, value, ts, hdrs2), = t_seg.scan_records(frame2)
    assert key is None and hdrs2 is None


def test_scan_stops_at_corrupt_frame():
    def case(pkg, _d):
        a = pkg.seg.encode_record(0, None, b"a", 1, None)
        b = pkg.seg.encode_record(1, None, b"b", 2, None)
        flipped = bytearray(a + b)
        flipped[-1] ^= 0xFF  # corrupt b's payload: its CRC must fail
        return [r[2] for r in pkg.seg.scan_records(bytes(flipped))]

    assert _both(case, None) == [0]


def test_segment_writer_rejects_bad_fsync_policy(tmp_path):
    for pkg in PKGS:
        with pytest.raises(ValueError, match="never|interval|always"):
            pkg.SegmentWriter(str(tmp_path / "x.log"), fsync="sometimes")
        with pytest.raises(ValueError):
            pkg.StorePolicy(fsync="bogus")


# ------------------------------------------------------ log + recovery
def test_roll_retention_and_sparse_index(tmp_path):
    def case(pkg, d):
        pol = pkg.StorePolicy(fsync="never", segment_bytes=300,
                              index_interval_bytes=128)
        log = pkg.SegmentedLog(str(d), pol)
        try:
            _fill(log, 60)
            out = [len(log._segments), log.end_offset,
                   log.index_entries(), log.read_from(17, 5)]
            log.policy.retention_bytes = 600
            dropped = log.enforce_retention()
            out += [dropped, log.base_offset]
            with pytest.raises(LookupError):
                log.read_from(0)
            out.append(_dump(log))
        finally:
            log.close()
        out.append(_files(d))
        return out

    nseg, end, index, chunk, dropped, base, _rows, _files_ = \
        _both(case, tmp_path)
    assert nseg > 3 and end == 60
    assert 0 < len(index) < 20
    assert [r[0] for r in chunk] == [17, 18, 19, 20, 21]
    assert dropped > 0 and base == dropped


def test_retention_by_age_against_newest_timestamp(tmp_path):
    def case(pkg, d):
        pol = pkg.StorePolicy(fsync="never", segment_bytes=200,
                              retention_ms=50)
        log = pkg.SegmentedLog(str(d), pol)
        try:
            _fill(log, 30, ts0=1000)
            first = log.enforce_retention()
            log.append(None, b"new", 5000)
            return [first, log.enforce_retention(), _dump(log)]
        finally:
            log.close()

    first, dropped, rows = _both(case, tmp_path)
    assert first == 0 and dropped > 0
    assert any(r[3] == 5000 for r in rows)


def test_recovery_truncates_torn_tail_and_replays_byte_identically(tmp_path):
    """The torn blob's shape comes from the JAX chaos schedule's seed (the
    scenario itself is ROADMAP A14), so the corruption pattern replays."""
    from iotml.chaos.scenarios import build

    seed = build("broker-crash-recover", seed=13, records=100).seed

    def case(pkg, d):
        rng = random.Random(seed)
        pol = pkg.StorePolicy(fsync="always", segment_bytes=400)
        log = pkg.SegmentedLog(str(d), pol)
        _fill(log, 40)
        before = _dump(log)
        torn = bytes(rng.randrange(256) for _ in range(rng.randrange(8, 64)))
        n = log.simulate_torn_write(struct.pack(">I", 1 << 30) + torn)
        # no close(): the process "dies" here
        log2 = pkg.SegmentedLog(str(d), pol)
        out = [n, log2.recovered_truncated_bytes, _dump(log2) == before,
               log2.append(None, b"after", 9999)]
        log2.close()
        log3 = pkg.SegmentedLog(str(d), pol)
        out += [log3.recovered_truncated_bytes, _dump(log3)]
        log3.close()
        log.close()
        return out + [_files(d)]

    n, recovered, same, after, again, rows, _f = _both(case, tmp_path)
    assert recovered == n and same and after == 40
    assert again == 0 and [r[0] for r in rows] == list(range(41))


def test_recovery_at_every_byte_cut_of_the_last_frame(tmp_path):
    """The active segment cut at every byte inside its last frame: the
    mount truncates to the frame before it (both packages, same counts),
    serves the earlier records unchanged and appends at its offset."""
    pol = dict(fsync="never", segment_bytes=10 ** 9)
    src = tmp_path / "src"
    log = SegmentedLog(str(src), StorePolicy(**pol))
    _fill(log, 6)
    log.append(b"last", b"the-final-value", 7777)
    frames = _dump(log)
    log.close()
    path = src / "00000000000000000000.log"
    data = path.read_bytes()
    last = len(t_seg.encode_record(6, b"last", b"the-final-value", 7777,
                                   None))
    start = len(data) - last
    for cut in range(start, len(data)):
        got = []
        for pkg in PKGS:
            d = tmp_path / f"{pkg.name}-{cut}"
            d.mkdir()
            (d / path.name).write_bytes(data[:cut])
            cl = pkg.SegmentedLog(str(d), pkg.StorePolicy(**pol))
            try:
                got.append((cl.recovered_truncated_bytes, _dump(cl),
                            cl.append(None, b"x", 1),
                            (d / path.name).stat().st_size))
            finally:
                cl.close()
        assert got[0] == got[1]
        assert got[0][0] == cut - start
        assert got[0][1] == frames[:6] and got[0][2] == 6


def test_recovery_drops_empty_tail_segment(tmp_path):
    def case(pkg, d):
        pol = pkg.StorePolicy(fsync="never", segment_bytes=10 ** 9)
        log = pkg.SegmentedLog(str(d), pol)
        _fill(log, 10)
        log.roll()
        log.close()
        empties = [n for n in os.listdir(str(d)) if n.endswith(".log")
                   and os.path.getsize(d / n) == 0]
        log2 = pkg.SegmentedLog(str(d), pol)
        try:
            return [empties, log2.end_offset,
                    log2.recovered_truncated_bytes,
                    log2.append(None, b"next", 0),
                    [r[0] for r in _dump(log2)]]
        finally:
            log2.close()

    empties, end, torn, nxt, offs = _both(case, tmp_path)
    assert empties and end == 10 and torn == 0 and nxt == 10
    assert offs == list(range(11))


def _flip_last_byte(path, size):
    with open(path, "r+b") as fh:
        fh.seek(size - 1)
        b = fh.read(1)
        fh.seek(size - 1)
        fh.write(bytes([b[0] ^ 0xFF]))


def _drain(log):
    got, off = [], 0
    while True:
        chunk = log.read_from(off, 1000)
        if not chunk:
            return got
        offs = [r[0] for r in chunk]
        assert offs == list(range(offs[0], offs[0] + len(offs)))
        got += offs
        off = offs[-1] + 1


def test_corrupt_sealed_segment_gap_is_jumped_not_stalled(tmp_path):
    def case(pkg, d):
        pol = pkg.StorePolicy(fsync="never", segment_bytes=200)
        log = pkg.SegmentedLog(str(d), pol)
        _fill(log, 40)
        victim = log._segments[1]
        log.close()
        _flip_last_byte(victim.path, victim.size)
        log2 = pkg.SegmentedLog(str(d), pol)
        out = [victim.base_offset, log2.recovered_truncated_bytes,
               _drain(log2)]
        log2.close()
        for n in list(os.listdir(str(d))):
            if n.endswith((".index", ".timeindex")):
                os.remove(str(d / n))
        log3 = pkg.SegmentedLog(str(d), pol)
        got = _drain(log3)
        hole = set(range(40)) - set(got)
        out += [log3.recovered_truncated_bytes, got,
                log3.read_from(min(hole), 10)[0][0]]
        log3.close()
        return out

    base, torn2, got2, torn3, got3, inside = _both(case, tmp_path)
    for torn, got in ((None, got2), (torn3, got3)):
        assert got[0] == 0 and got[-1] == 39
        hole = set(range(40)) - set(got)
        assert hole and all(base <= o < 40 for o in hole)
    assert torn2 == 0 and torn3 > 0
    assert inside == max(set(range(40)) - set(got3)) + 1


def test_index_log_mismatch_rebuilt_from_log(tmp_path):
    def case(pkg, d):
        pol = pkg.StorePolicy(fsync="never", segment_bytes=300)
        log = pkg.SegmentedLog(str(d), pol)
        _fill(log, 50)
        before = _dump(log)
        ts_probe = log.offset_for_timestamp(1025)
        log.close()
        sidecars = sorted(n for n in os.listdir(str(d))
                          if n.endswith((".index", ".timeindex")))
        for i, name in enumerate(sidecars):
            p = str(d / name)
            if i % 2:
                os.remove(p)
            else:
                with open(p, "wb") as fh:
                    fh.write(b"\xff" * 24)
        log2 = pkg.SegmentedLog(str(d), pol)
        try:
            return [bool(sidecars), _dump(log2) == before, ts_probe,
                    log2.offset_for_timestamp(1025), _files(d)]
        finally:
            log2.close()

    had, same, probe, again, _f = _both(case, tmp_path)
    assert had and same and probe == again == 25


def test_timestamp_index_and_read_since(tmp_path):
    def case(pkg, d):
        log = pkg.SegmentedLog(str(d), pkg.StorePolicy(fsync="never",
                                                       segment_bytes=250))
        try:
            _fill(log, 40, ts0=100)
            out = [log.offset_for_timestamp(0), log.offset_for_timestamp(120),
                   log.offset_for_timestamp(10 ** 9) == log.end_offset,
                   [r[0] for r in log.read_since(135, 10)]]
            log.append(None, b"late", 50)
            return out + [log.offset_for_timestamp(120)]
        finally:
            log.close()

    assert _both(case, tmp_path) == [0, 20, True, [35, 36, 37, 38, 39], 20]


def test_align_base_and_reset(tmp_path):
    def case(pkg, d):
        log = pkg.SegmentedLog(str(d), pkg.StorePolicy(fsync="never"))
        try:
            log.align_base(500)
            out = [log.base_offset, log.end_offset,
                   log.append(None, b"v", 0)]
            with pytest.raises(ValueError):
                log.align_base(900)
            log.reset(42)
            return out + [log.base_offset, log.end_offset,
                          log.append(None, b"w", 0), _files(d)]
        finally:
            log.close()

    assert _both(case, tmp_path)[:6] == [500, 500, 500, 42, 42, 42]


# -------------------------------------------------------------- offsets
def test_offsets_file_compacts_and_survives_torn_tail(tmp_path):
    def case(pkg, d):
        of = pkg.OffsetsFile(str(d), fsync="always", compact_ratio=4)
        for i in range(100):
            of.commit("g", "t", i % 3, i)
        out = [of._records, os.path.getsize(of.path)]
        of.commit_many("g2", "t", [(0, 7), (1, 9)])
        of.close()
        of2 = pkg.OffsetsFile(str(d))
        out += [of2.get("g", "t", 0), of2.get("g2", "t", 1), of2.table()]
        of2.close()
        with open(of2.path, "ab") as fh:
            fh.write(b"\x00\x00\x10\x00partial")
        of3 = pkg.OffsetsFile(str(d))
        out += [of3.recovered_truncated_bytes, of3.get("g", "t", 0)]
        of3.close()
        return out + [_files(d)]

    records, size, g0, g21, _t, torn, again, _f = _both(case, tmp_path)
    assert records < 100 and size < 100 * 40
    assert g0 == 99 and g21 == 9 and torn > 0 and again == 99


def test_an_unchanged_commit_appends_nothing(tmp_path):
    """Consumers commit their unchanged cursors on every idle poll.  JAX's
    file takes each such commit as a record and compacts every few; the
    port's appends nothing, so its file stays as it was.  The tables are
    equal, and each package mounts the other's file to the same table."""
    got = {}
    for pkg in PKGS:
        of = pkg.OffsetsFile(str(tmp_path / pkg.name), fsync="always",
                             compact_ratio=4)
        of.commit_many("g", "t", [(0, 5), (1, 7)])
        before = (tmp_path / pkg.name / "offsets").read_bytes()
        for _ in range(49):
            of.commit_many("g", "t", [(0, 5), (1, 7)])
            of.commit("g", "t", 1, 7)
        idle = (tmp_path / pkg.name / "offsets").read_bytes()
        of.commit("g", "t", 0, 6)
        got[pkg.name] = (of.table(), of._records, before, idle)
        of.close()
    table, records, before, idle = got["port"]
    assert table == got["jax"][0] == {("g", "t", 0): 6, ("g", "t", 1): 7}
    assert records == 3 and idle == before
    assert got["jax"][2] == before and got["jax"][3] != before
    for writer, reader in ((PORT, JAX), (JAX, PORT)):
        of = reader.OffsetsFile(str(tmp_path / writer.name))
        assert of.table() == table
        of.close()


def test_an_unchanged_commit_keeps_the_fsync_interval(tmp_path):
    """Under ``fsync=interval`` an unchanged commit appends nothing but
    still syncs an earlier append once the interval has passed: the loss
    stays bounded by the interval."""
    of = OffsetsFile(str(tmp_path), fsync="interval",
                     fsync_interval_s=3600.0)
    syncs = []
    real = of._writer.sync
    of._writer.sync = lambda: (syncs.append(1), real())[1]
    of.commit("g", "t", 0, 5)
    of.commit("g", "t", 0, 5)
    assert syncs == []
    of.fsync_interval_s = 0.0
    of.commit("g", "t", 0, 5)
    of.commit("g", "t", 0, 5)
    assert syncs == [1]
    of.close()


# ----------------------------------------------------- broker (durable)
def _fetch_all(b, topic, parts):
    return [[(m.offset, m.key, m.value, m.timestamp_ms, m.headers)
             for m in b.fetch(topic, p, b.begin_offset(topic, p), 10 ** 6)]
            for p in parts]


def test_durable_broker_restart_resumes_everything(tmp_path):
    def case(pkg, d):
        pol = dict(fsync="always", segment_bytes=500)
        b = pkg.Broker(store_dir=str(d), store_policy=pkg.StorePolicy(**pol))
        b.create_topic("t", partitions=2, retention_bytes=0)
        for i in range(30):
            b.produce("t", f"v{i}".encode(), key=f"k{i % 4}".encode(),
                      timestamp_ms=i)
        b.produce_many("t", [(None, b"bulk", 99), (b"k", b"bulk2", 100)])
        b.commit("g", "t", 0, 5)
        b.commit_many("g", "t", [(0, 7), (1, 3)])
        ends = [b.end_offset("t", p) for p in (0, 1)]
        rows = _fetch_all(b, "t", (0, 1))
        b.close()
        b2 = pkg.Broker(store_dir=str(d),
                        store_policy=pkg.StorePolicy(**pol))
        try:
            return [b2.durable, b2.topic("t").partitions, ends,
                    [b2.end_offset("t", p) for p in (0, 1)],
                    _fetch_all(b2, "t", (0, 1)) == rows, rows,
                    b2.committed("g", "t", 0), b2.committed("g", "t", 1)]
        finally:
            b2.close()

    durable, parts, ends, ends2, same, _rows, c0, c1 = _both(case, tmp_path)
    assert durable and parts == 2 and ends == ends2 and same
    assert (c0, c1) == (7, 3)


def test_durable_broker_replay_api_and_metric(tmp_path):
    def case(pkg, d):
        b = pkg.Broker(store_dir=str(d))
        try:
            b.create_topic("t")
            for i in range(20):
                b.produce("t", str(i).encode(), partition=0,
                          timestamp_ms=1000 + i)
            before = pkg.replay.value()
            msgs = b.read_since("t", 0, 1015, 100)
            return [[m.offset for m in msgs],
                    b.offset_for_timestamp("t", 0, 1015),
                    pkg.replay.value() - before]
        finally:
            b.close()

    assert _both(case, tmp_path) == [[15, 16, 17, 18, 19], 15, 5]


def test_durable_retention_segment_granular(tmp_path):
    def case(pkg, d):
        b = pkg.Broker(store_dir=str(d),
                       store_policy=pkg.StorePolicy(fsync="never",
                                                    segment_bytes=300))
        try:
            b.create_topic("t", retention_bytes=700)
            for _ in range(100):
                b.produce("t", b"x" * 20, partition=0)
            out = [b.begin_offset("t", 0), b.end_offset("t", 0)]
            with pytest.raises(pkg.OutOfRange):
                b.fetch("t", 0, 0)
            b.create_topic("tc", retention_messages=10)
            for _ in range(100):
                b.produce("tc", b"y" * 20, partition=0)
            return out + [b.end_offset("tc", 0) - b.begin_offset("tc", 0)]
        finally:
            b.close()

    base, end, retained = _both(case, tmp_path)
    assert base > 0 and end == 100 and 10 <= retained < 40


def test_durable_topic_retention_inherit_vs_explicit_unlimited(tmp_path):
    """None (unset) inherits the store-wide retention default; 0 (the
    wire's -1 sentinel) explicitly opts the topic out of it."""
    def case(pkg, d):
        b = pkg.Broker(store_dir=str(d),
                       store_policy=pkg.StorePolicy(
                           fsync="never", segment_bytes=300,
                           retention_bytes=700))
        try:
            b.create_topic("inherits")
            b.create_topic("unlimited", retention_bytes=0)
            for _ in range(100):
                b.produce("inherits", b"x" * 20, partition=0)
                b.produce("unlimited", b"x" * 20, partition=0)
            return [b.begin_offset("inherits", 0),
                    b.begin_offset("unlimited", 0),
                    b.end_offset("unlimited", 0),
                    b.topic("inherits").retention_bytes,
                    b.topic("unlimited").retention_bytes]
        finally:
            b.close()

    inherit, unlimited, end, spec_none, spec_zero = _both(case, tmp_path)
    assert inherit > 0 and unlimited == 0 and end == 100
    assert spec_none is None and spec_zero == 0


def test_store_metrics_registered_and_live(tmp_path):
    def case(pkg, d):
        b = pkg.Broker(store_dir=str(d))
        try:
            b.create_topic("t")
            b.produce("t", b"v", partition=0)
            rendered = pkg.metrics.default_registry.render()
            return [[f in rendered for f in (
                "iotml_store_segment_bytes", "iotml_store_fsync_seconds",
                "iotml_store_recovery_truncated_bytes",
                "iotml_store_replay_records_total")],
                pkg.segment_bytes.value(topic="t", partition="0")]
        finally:
            b.close()

    present, size = _both(case, tmp_path)
    assert all(present) and size > 0


# --------------------------------------------------------- wire + store
def test_wire_out_of_range_and_timestamp_listing(tmp_path):
    def case(pkg, _d):
        b = pkg.Broker()
        b.create_topic("t", retention_messages=5)
        for i in range(20):
            b.produce("t", str(i).encode(), partition=0, timestamp_ms=i)
        with pkg.WireServer(b) as srv:
            client = pkg.WireBroker(f"127.0.0.1:{srv.port}")
            try:
                with pytest.raises(pkg.OutOfRange) as ei:
                    client.fetch("t", 0, 0)
                c = pkg.StreamConsumer(client, ["t:0:0"], group="g",
                                       eof=False)
                return [ei.value.earliest,
                        client.offset_for_timestamp("t", 0, 17),
                        [m.offset for m in c.poll()]]
            finally:
                client.close()

    assert _both(case, tmp_path) == [15, 17, [15, 16, 17, 18, 19]]


def test_wire_create_topic_carries_retention_configs(tmp_path):
    """Both servers, both clients: the configs land on the broker's spec,
    -1 becomes an explicit 0, a compact policy reaches the topic."""
    def case(pkg, d):
        out = []
        b = pkg.Broker(store_dir=str(d))
        try:
            with pkg.WireServer(b) as srv:
                for client_cls in (KafkaWireBroker, JWireBroker):
                    client = client_cls(f"127.0.0.1:{srv.port}")
                    tag = client_cls.__module__.split(".")[0]
                    try:
                        client.create_topic(f"t-{tag}", partitions=2,
                                            retention_messages=9,
                                            retention_bytes=1234,
                                            retention_ms=5678)
                        with pytest.raises(ValueError):
                            client.create_topic(f"neg-{tag}",
                                                retention_ms=-4)
                        client.create_topic(f"unlim-{tag}", retention_ms=-1)
                        client.create_topic(f"c-{tag}",
                                            cleanup_policy="compact")
                        with pytest.raises(ValueError):
                            client.create_topic(f"bad-{tag}",
                                                cleanup_policy="sometimes")
                    finally:
                        client.close()
                    spec = b.topic(f"t-{tag}")
                    out.append([(spec.retention_messages,
                                 spec.retention_bytes, spec.retention_ms),
                                b.topic(f"unlim-{tag}").retention_ms,
                                b.topic(f"c-{tag}").cleanup_policy,
                                f"neg-{tag}" in b.topics()])
        finally:
            b.close()
        return out + [sorted(_files(d / "segments"))]

    got = _both(case, tmp_path)
    for spec, unlim, policy, neg in got[:2]:
        assert spec == (9, 1234, 5678) and unlim == 0
        assert policy == "compact" and not neg


# ---------------------------------------------------- trainer backfill
def test_trainer_backfills_from_timestamp_on_cold_start(tmp_path):
    """A first incarnation (no committed cursor) starts at the replay
    offset; a partition WITH a commit resumes from it untouched."""
    def case(pkg, d):
        b = pkg.Broker(store_dir=str(d / "s"))
        try:
            b.create_topic("t", partitions=2)
            for i in range(50):
                b.produce("t", str(i).encode(), partition=i % 2,
                          timestamp_ms=1000 + i)
            b.commit("cold", "t", 1, 11)
            ct = pkg.trainer(b, "t", pkg.ArtifactStore(str(d / "art")),
                             group="cold", backfill_since_ms=1030)
            pos = dict((p, off) for _t, p, off in ct.consumer.positions())
            return [pos, b.offset_for_timestamp("t", 0, 1030)]
        finally:
            b.close()

    pos, replay = _both(case, tmp_path)
    assert pos[0] == replay > 0 and pos[1] == 11


def test_consumer_seek_to_timestamp(tmp_path):
    def case(pkg, d):
        b = pkg.Broker(store_dir=str(d))
        try:
            b.create_topic("t")
            for i in range(10):
                b.produce("t", str(i).encode(), partition=0,
                          timestamp_ms=100 + i)
            c = pkg.StreamConsumer(b, ["t:0:0"], group="g")
            c.seek_to_timestamp(106)
            return [m.offset for m in c.poll()]
        finally:
            b.close()

    assert _both(case, tmp_path) == [6, 7, 8, 9]


def test_sanitized_topic_names_never_share_a_directory(tmp_path):
    for name in ("a b", "a_b", "plain-topic.ok", "", "ü/x", "a" * 300):
        assert t_dirname_for(name) == j_dirname_for(name)
    assert t_dirname_for("a b") != t_dirname_for("a_b")

    def case(pkg, d):
        b = pkg.Broker(store_dir=str(d))
        try:
            b.create_topic("a b")
            b.create_topic("a_b")
            b.produce("a b", b"spaced", partition=0)
            b.produce("a_b", b"underscored", partition=0)
            return [b.fetch("a b", 0, 0)[0].value,
                    b.fetch("a_b", 0, 0)[0].value,
                    sorted(os.listdir(d / "segments"))]
        finally:
            b.close()

    spaced, under, _dirs = _both(case, tmp_path)
    assert (spaced, under) == (b"spaced", b"underscored")


def _child(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(ROOT), timeout=120)


def test_store_dir_single_writer_lock(tmp_path):
    """Two broker PROCESSES never share one store dir, across the two
    packages too; a remount in the SAME process works."""
    d = str(tmp_path / "s")
    b = Broker(store_dir=d)
    b2 = None
    try:
        b.create_topic("t")
        b2 = Broker(store_dir=d)  # same-process remount: allowed
        assert "t" in b2.topics()
        for pkg in PKGS:
            probe = _child(f"from {pkg.module} import Broker\n"
                           f"Broker(store_dir={d!r})")
            assert probe.returncode != 0
            assert "locked by another broker process" in probe.stderr
    finally:
        b.close()
        if b2 is not None:
            b2.close()
    for pkg in PKGS:
        probe = _child(f"from {pkg.module} import Broker\n"
                       f"br = Broker(store_dir={d!r}); br.close()")
        assert probe.returncode == 0, probe.stderr


# -------------------------------------------------- cross-package mounts
def _script(pkg, d: Path) -> None:
    """The same calls in either package: topics of both policies, keyed
    and unkeyed, bulk and single produces, tombstones, headers, rolls,
    commits, a torn tail recovered by a remount."""
    pol = pkg.StorePolicy(fsync="always", segment_bytes=700,
                          index_interval_bytes=100)
    b = pkg.Broker(store_dir=str(d), store_policy=pol)
    try:
        b.create_topic("SENSOR_DATA_S_AVRO", partitions=3)
        b.create_topic("odd name/ü", partitions=1, retention_ms=0,
                       cleanup_policy="compact")
        rng = random.Random(5)
        for rnd in range(6):
            b.produce_many("SENSOR_DATA_S_AVRO", [
                (f"car-{i:03d}".encode(), bytes(rng.randrange(256) for _ in
                                                range(rng.randrange(60))),
                 1000 * rnd + i) for i in range(25)])
            b.produce("odd name/ü", None if rnd == 3 else b"v%d" % rnd,
                      key=b"k", partition=0, timestamp_ms=rnd)
        b.produce("SENSOR_DATA_S_AVRO", b"traced", key=b"x", partition=1,
                  timestamp_ms=7, headers=(("iotml_trace", b"ctx"),))
        b.produce_many("SENSOR_DATA_S_AVRO", [(None, b"", 8), (None, None, 9)],
                       partition=2)
        b.commit("g", "SENSOR_DATA_S_AVRO", 0, 11)
        b.commit_many("g", "SENSOR_DATA_S_AVRO", [(1, 5), (2, 9)])
        b.store.log_for("SENSOR_DATA_S_AVRO", 2).roll()
        b.store.log_for("SENSOR_DATA_S_AVRO", 1).simulate_torn_write()
    finally:
        b.close()


def _read_back(pkg, d: Path):
    b = pkg.Broker(store_dir=str(d),
                   store_policy=pkg.StorePolicy(fsync="always",
                                                segment_bytes=700,
                                                index_interval_bytes=100))
    try:
        return [b.topics(), [(t, b.topic(t).partitions,
                              b.topic(t).cleanup_policy,
                              b.topic(t).retention_ms) for t in b.topics()],
                _fetch_all(b, "SENSOR_DATA_S_AVRO", range(3)),
                _fetch_all(b, "odd name/ü", (0,)),
                [b.committed("g", "SENSOR_DATA_S_AVRO", p)
                 for p in range(3)],
                b.store.recovered_truncated_bytes(),
                b.offset_for_timestamp("SENSOR_DATA_S_AVRO", 0, 3000)]
    finally:
        b.close()


def test_the_same_calls_write_byte_identical_directories(tmp_path):
    for pkg in PKGS:
        _script(pkg, tmp_path / pkg.name)
    port, jax_ = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(jax_)
    assert any(n.endswith(".index") for n in port)
    assert "topics.json" in port and "offsets" in port
    for name in port:
        assert port[name] == jax_[name], name


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_directory_mounts_in_the_other_package(tmp_path, writer):
    """Written (torn tail included) by one package, mounted by the other:
    the same topics, records, committed offsets and recovered bytes as
    the writer's own remount, and the recovered files byte-identical."""
    w, r = (PORT, JAX) if writer == "port" else (JAX, PORT)
    for name in ("own", "other"):
        _script(w, tmp_path / name)
    own = _read_back(w, tmp_path / "own")
    other = _read_back(r, tmp_path / "other")
    assert other == own
    assert own[5] > 0  # the torn tail was there to recover
    assert _files(tmp_path / "own") == _files(tmp_path / "other")


# -------------------------------------------------- platform / config
def test_store_config_section_resolves_from_env():
    env = {"IOTML_STORE_DIR": "/data/x", "IOTML_STORE_FSYNC": "always",
           "IOTML_STORE_RETENTION_MS": "100000"}
    pols = []
    for pkg in PKGS:
        cfg, _ = pkg.load_config([], env=env)
        assert (cfg.store.dir, cfg.store.fsync, cfg.store.retention_ms) == \
            ("/data/x", "always", 100000)
        pol = pkg.StorePolicy.from_config(cfg.store)
        pols.append(vars(pol))
        with pytest.raises(ValueError):
            pkg.load_config([], env={"IOTML_STORE_FSYNCK": "always"})
    assert pols[0] == pols[1]
    assert pols[0]["fsync"] == "always"
    assert pols[0]["retention_ms"] == 100000


def test_raw_produce_off_takes_the_per_record_encoder(tmp_path, monkeypatch):
    """IOTML_RAW_PRODUCE=off (the debug escape hatch): the durable
    produce_many frames record by record; the bytes on disk are the
    fused path's, and a bad value fails loudly."""
    from iotml_torch.data import pipeline

    calls = []
    real = native.frames_encode_values
    monkeypatch.setattr(native, "frames_encode_values",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    entries = [(f"k{i}".encode(), b"v" * i, i) for i in range(12)]
    files = []
    for mode in ("auto", "off"):
        monkeypatch.setenv("IOTML_RAW_PRODUCE", mode)
        assert pipeline.raw_produce_mode() == mode
        d = tmp_path / mode
        b = Broker(store_dir=str(d))
        try:
            b.create_topic("t", partitions=2)
            b.produce_many("t", entries)
        finally:
            b.close()
        files.append(_files(d / "segments"))
        # the fused run framed each partition in one call; off in none
        assert len(calls) == 2
    monkeypatch.setenv("IOTML_RAW_PRODUCE", "sideways")
    with pytest.raises(ValueError, match="IOTML_RAW_PRODUCE"):
        pipeline.raw_produce_mode()
    monkeypatch.delenv("IOTML_RAW_PRODUCE")
    # the index sidecars differ by design (one sparse entry a batch vs a
    # record); the frames themselves are the same bytes
    logs = [{k: v for k, v in f.items() if k.endswith(".log")}
            for f in files]
    assert logs[0] == logs[1]
    with pytest.raises(ValueError):
        pipeline.set_knobs(raw_produce="sideways")
    pipeline.set_knobs(raw_produce="off")
    assert pipeline.raw_produce_mode() == "off"
    monkeypatch.delenv("IOTML_RAW_PRODUCE")


@pytest.mark.parametrize("max_bytes", [4096, 65536])
def test_read_raw_deep_in_one_batch_starts_at_the_cursor_frame(
        tmp_path, max_bytes):
    """One produce_many batch is one sparse-index entry.  Where JAX's raw
    window from that entry holds a whole frame at/after the cursor the
    port's bytes are JAX's; where it ends before (a batch over
    ``max_bytes``, JAX's readers fall back to FETCH) the port's window
    starts at the cursor's own frame and holds whole frames from it."""
    rng = random.Random(5)
    entries = [(b"k%d" % i, bytes(rng.getrandbits(8)
                                  for _ in range(rng.randint(40, 300))), i)
               for i in range(1500)]
    logs = {}
    for name, cls in (("port", Broker), ("jax", JBroker)):
        b = cls(store_dir=str(tmp_path / name))
        b.create_topic("big")
        b.produce_many("big", entries)
        logs[name] = b
    try:
        moved = 0
        for off in (0, 1, 17, 200, 640, 1100, 1499):
            t = logs["port"].fetch_raw("big", 0, off, max_bytes=max_bytes)
            j = logs["jax"].fetch_raw("big", 0, off, max_bytes=max_bytes)
            vj = t_framing.validate_frame_batch_py(j.data, start_offset=off)
            vt = t_framing.validate_frame_batch_py(t.data, start_offset=off)
            assert t.start_offset == j.start_offset == off
            if vj["count"]:
                assert t.data == j.data
                continue
            moved += 1
            assert vt["first"] == off and vt["start_pos"] == 0
            assert vt["count"] >= 1
            assert len(t.data) == max_bytes or \
                vt["last"] == len(entries) - 1  # the window reached the end
            want = [(k, v) for k, v, _ in entries[off:off + vt["count"]]]
            got = [(m.key, m.value) for m in logs["port"].fetch(
                "big", 0, off, max_messages=vt["count"])]
            assert got == want
        # the batch (~255 KB) outgrows both windows past its head
        assert moved >= 3
    finally:
        for b in logs.values():
            b.close()
