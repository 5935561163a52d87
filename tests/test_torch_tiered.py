"""The port's tiered log storage (``iotml_torch.store.remote`` and
``tiered``; ``ArtifactStore.list`` / ``delete``) held against the JAX
package's on the CPU.

Each case of ``tests/test_tiered.py`` runs on both packages from the
same records: what each serves (through the remote fall-through, after
eviction, after a killed upload, after a compacted re-upload), the
manifests, the stats of every pass and the remote blob listings must be
equal, and the JAX test's own assertions hold on the port.  A bucket
written by one package serves a cold mount of the other.
"""

import json
import os
import sys
import types

import pytest

from iotml.obs import metrics as j_metrics
from iotml.store import RemoteSegmentCache as JRemoteSegmentCache
from iotml.store import RemoteTier as JRemoteTier
from iotml.store import SegmentedLog as JSegmentedLog
from iotml.store import StorePolicy as JStorePolicy
from iotml.store import TieredLog as JTieredLog
from iotml.store import TierPolicy as JTierPolicy
from iotml.store import TierUploader as JTierUploader
from iotml.store import segment as j_seg
from iotml.stream.broker import Broker as JBroker
from iotml.stream.broker import OffsetOutOfRangeError as JOutOfRange
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.train.artifacts import ArtifactStore as JArtifactStore
from iotml_torch.chaos import faults
from iotml_torch.config import load_config as t_load_config
from iotml_torch.obs import metrics as t_metrics
from iotml_torch.store import (RemoteSegmentCache, RemoteTier, SegmentedLog,
                               StorePolicy, TieredLog, TierPolicy,
                               TierUploader)
from iotml_torch.store import segment as t_seg
from iotml_torch.stream.broker import Broker, OffsetOutOfRangeError
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.train.artifacts import ArtifactStore

PORT = types.SimpleNamespace(
    name="port", seg=t_seg, metrics=t_metrics, ArtifactStore=ArtifactStore,
    RemoteTier=RemoteTier, RemoteSegmentCache=RemoteSegmentCache,
    SegmentedLog=SegmentedLog, StorePolicy=StorePolicy, TieredLog=TieredLog,
    TierPolicy=TierPolicy, TierUploader=TierUploader, Broker=Broker,
    OutOfRange=OffsetOutOfRangeError, StreamConsumer=StreamConsumer)
JAX = types.SimpleNamespace(
    name="jax", seg=j_seg, metrics=j_metrics, ArtifactStore=JArtifactStore,
    RemoteTier=JRemoteTier, RemoteSegmentCache=JRemoteSegmentCache,
    SegmentedLog=JSegmentedLog, StorePolicy=JStorePolicy,
    TieredLog=JTieredLog, TierPolicy=JTierPolicy, TierUploader=JTierUploader,
    Broker=JBroker, OutOfRange=JOutOfRange, StreamConsumer=JStreamConsumer)
PKGS = (PORT, JAX)


def _both(case, tmp_path):
    got = [case(pkg, tmp_path / pkg.name) for pkg in PKGS]
    assert got[0] == got[1]
    return got[0]


def _tiered(pkg, d, segment_bytes=512, **tier_kw):
    """A standalone TieredLog over a local-directory 'bucket'."""
    store = pkg.ArtifactStore(str(d / "bucket"))
    remote = pkg.RemoteTier(store, prefix="tiered/T/0")
    log = pkg.TieredLog(str(d / "local"),
                        policy=pkg.StorePolicy(fsync="never",
                                               segment_bytes=segment_bytes),
                        remote=remote,
                        tier=pkg.TierPolicy(uri=str(d / "bucket"), **tier_kw))
    return log, remote, store


def _fill(log, n, ts0=1000, payload=b"payload-"):
    for i in range(n):
        log.append(f"k{i % 7}".encode(), payload + str(i).encode(), ts0 + i)


def _dump(log):
    return log.read_from(log.base_offset, 10 ** 6)


def _metas(log):
    return [tuple(m) for m in log.remote_metas()]


def _remote_records(pkg):
    return pkg.metrics.default_registry.counter(
        "iotml_tier_remote_records_total", "").value()


# ----------------------------------------------------- artifact store
def test_artifact_store_local_list_delete_atomic(tmp_path):
    def case(pkg, d):
        st = pkg.ArtifactStore(str(d / "b"))
        src = d / "src.bin"
        src.write_bytes(b"x" * 100)
        st.upload(str(src), "a/one.log")
        st.upload(str(src), "a/two.log")
        st.put_text("a/manifest.json", "{}")
        st.put_text("other/three.txt", "t")
        out = [st.list("a"), st.list(),
               any(".tmp." in f for _, _, fs in os.walk(st.root)
                   for f in fs),
               st.delete("a/one.log"), st.delete("a/one.log"), st.list("a")]
        return out

    a, every, tmp, first, again, after = _both(case, tmp_path)
    assert a == ["a/manifest.json", "a/one.log", "a/two.log"]
    assert every == a + ["other/three.txt"]
    assert not tmp and first is True and again is False
    assert after == ["a/manifest.json", "a/two.log"]


class _FakeBlob:
    """google-cloud-storage blob duck backed by a shared dict."""

    def __init__(self, objects, name):
        self._objects, self.name = objects, name

    def upload_from_filename(self, path):
        with open(path, "rb") as fh:
            self._objects[self.name] = fh.read()

    def upload_from_string(self, text):
        self._objects[self.name] = text.encode()

    def download_to_filename(self, path):
        with open(path, "wb") as fh:
            fh.write(self._objects[self.name])

    def download_as_bytes(self):
        return self._objects[self.name]

    def exists(self):
        return self.name in self._objects

    def delete(self):
        del self._objects[self.name]


class _FakeBucket:
    def __init__(self, objects):
        self._objects = objects

    def blob(self, name):
        return _FakeBlob(self._objects, name)

    def list_blobs(self, prefix=""):
        return [_FakeBlob(self._objects, n) for n in sorted(self._objects)
                if n.startswith(prefix)]


def _gcs_store(cls, objects, prefix="pfx"):
    st = cls.__new__(cls)
    st.root = "gs://bucket/" + prefix
    st._gcs = True
    st._prefix = prefix
    st._bucket = _FakeBucket(objects)
    return st


def test_artifact_store_gcs_local_parity(tmp_path):
    """One operation script, two backends, two packages: the same
    observable behaviour and the same objects in the (faked) bucket."""
    src = tmp_path / "src.bin"
    src.write_bytes(b"blobbytes")

    def script(st):
        out = []
        st.upload(str(src), "t/0/seg.log")
        st.put_text("t/0/manifest.json", '{"v": 1}')
        out.append(st.list("t/0"))
        out.append(st.get_text("t/0/manifest.json"))
        out.append(st.get_text("t/0/missing"))
        out.append(st.exists("t/0/seg.log"))
        out.append(st.delete("t/0/seg.log"))
        out.append(st.delete("t/0/seg.log"))
        out.append(st.list())
        return out

    results, buckets = [], []
    for pkg in PKGS:
        objects = {}
        results.append(script(pkg.ArtifactStore(str(tmp_path / pkg.name))))
        results.append(script(_gcs_store(pkg.ArtifactStore, objects)))
        buckets.append(objects)
    assert all(r == results[0] for r in results)
    assert buckets[0] == buckets[1]


def test_gs_root_without_google_cloud_storage_says_so(monkeypatch):
    monkeypatch.setitem(sys.modules, "google.cloud", None)
    monkeypatch.setitem(sys.modules, "google.cloud.storage", None)
    with pytest.raises(ImportError, match="google-cloud-storage"):
        ArtifactStore("gs://bucket/prefix")


# ------------------------------------------------------- fall-through
def test_remote_fall_through_byte_identical_to_pre_trim(tmp_path):
    def case(pkg, d):
        log, _remote, _store = _tiered(pkg, d)
        try:
            _fill(log, 200)
            log.roll()
            before = _dump(log)
            stats = log.tier_sync()
            served = _remote_records(pkg)
            evicted = log.evict_hot(budget_bytes=0)
            out = [len(before), stats, evicted, log.local_base_offset,
                   log.base_offset, _dump(log) == before,
                   _remote_records(pkg) > served, _metas(log)]
            with pytest.raises(LookupError):
                log.read_from(-1, 10)
            return out
        finally:
            log.close()

    n, stats, evicted, local, base, same, served, _m = _both(case, tmp_path)
    assert n == 200 and stats["uploaded"] >= 2 and stats["bytes"] > 0
    assert evicted > 0 and local > 0 and base == 0 and same and served


def test_timestamp_seek_and_read_since_span_tiers(tmp_path):
    def case(pkg, d):
        log, _remote, _store = _tiered(pkg, d)
        try:
            _fill(log, 150, ts0=1000)
            log.roll()
            seek_pre = {ts: log.offset_for_timestamp(ts)
                        for ts in (1000, 1010, 1075, 1149, 2000)}
            since_pre = log.read_since(1010, max_records=10 ** 6)
            log.tier_sync()
            log.evict_hot(budget_bytes=0)
            return [log.local_base_offset, seek_pre,
                    {ts: log.offset_for_timestamp(ts) for ts in seek_pre},
                    log.read_since(1010, max_records=10 ** 6) == since_pre]
        finally:
            log.close()

    local, pre, post, same = _both(case, tmp_path)
    assert local > 10 and pre == post and same


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cold_mount_serves_remote_history(tmp_path, writer):
    """A fresh empty local dir over an existing remote tier replays the
    committed history, in either package over either package's
    bucket."""
    w = PORT if writer == "port" else JAX
    log, _remote, store = _tiered(w, tmp_path)
    _fill(log, 120)
    log.roll()
    log.tier_sync()
    committed_end = max(m.next for m in log.remote_metas())
    want = [r for r in _dump(log) if r[0] < committed_end]
    log.close()
    for pkg in PKGS:
        cold = pkg.TieredLog(
            str(tmp_path / f"cold-{pkg.name}"),
            policy=pkg.StorePolicy(fsync="never"),
            remote=pkg.RemoteTier(pkg.ArtifactStore(store.root),
                                  prefix="tiered/T/0"),
            tier=pkg.TierPolicy(uri=store.root))
        try:
            assert cold.base_offset == 0
            assert cold.read_from(0, 10 ** 6) == want
        finally:
            cold.close()


# --------------------------------------------------- commit marker
def test_kill_mid_upload_serves_only_committed(tmp_path, monkeypatch):
    def case(pkg, d):
        log, remote, store = _tiered(pkg, d)
        _fill(log, 200)
        log.roll()
        full = _dump(log)
        calls = {"n": 0}
        orig = pkg.RemoteTier._commit

        def dying_commit(self, metas):
            if calls["n"] >= 2:
                raise OSError("killed mid-upload")
            calls["n"] += 1
            return orig(self, metas)

        monkeypatch.setattr(pkg.RemoteTier, "_commit", dying_commit)
        with pytest.raises(OSError):
            log.tier_sync()
        monkeypatch.setattr(pkg.RemoteTier, "_commit", orig)
        committed = _metas(log)
        committed_end = max(m[1] for m in committed)
        listed = store.list("tiered/T/0")
        cold = pkg.TieredLog(str(d / "cold"),
                             policy=pkg.StorePolicy(fsync="never"),
                             remote=pkg.RemoteTier(store,
                                                   prefix="tiered/T/0"),
                             tier=pkg.TierPolicy(uri=str(d / "bucket")))
        got = cold.read_from(0, 10 ** 6)
        cold.close()
        out = [committed, listed, got == [r for r in full
                                          if r[0] < committed_end],
               _dump(log) == full]
        log.evict_hot(budget_bytes=0)
        out += [log.local_base_offset <= committed_end, _dump(log) == full]
        stats = log.tier_sync()
        out += [stats, store.list("tiered/T/0"), _metas(log)]
        log.evict_hot(budget_bytes=0)
        out.append(_dump(log) == full)
        log.close()
        return out

    (committed, listed, cold_ok, whole, below, whole2, stats, after, metas,
     whole3) = _both(case, tmp_path)
    assert len(committed) == 2 and cold_ok and whole and below and whole2
    referenced = {"tiered/T/0/manifest.json"} | {
        f"tiered/T/0/{m[0]:020d}{sfx}" for m in committed
        for sfx in (".log", ".index", ".timeindex")}
    assert [n for n in listed if n not in referenced]  # the torn footprint
    assert stats["uploaded"] >= 1 and whole3
    assert not [n for n in after if n.endswith(".stage")]
    assert set(after) == {"tiered/T/0/manifest.json"} | {
        f"tiered/T/0/{m[0]:020d}{sfx}" for m in metas
        for sfx in (".log", ".index", ".timeindex")}


def test_tier_upload_fault_point_leaves_the_segment_uncommitted(tmp_path):
    """The store.tier_upload fault point fires between the blobs and the
    manifest commit: nothing is servable, the local copy stays, and the
    next pass commits it."""
    log, _remote, store = _tiered(PORT, tmp_path)
    _fill(log, 100)
    log.roll()
    full = _dump(log)
    engine = faults.ChaosEngine([faults.FaultEvent(
        1, "store.tier_upload", "error", (("exc", "OSError"),))])
    try:
        faults.arm(engine)
        with pytest.raises(OSError, match="store.tier_upload"):
            log.tier_sync()
    finally:
        faults.disarm()
    assert log.remote_metas() == [] and store.get_text(
        "tiered/T/0/manifest.json") is None
    assert any(n.endswith(".stage") for n in store.list("tiered/T/0"))
    assert log.evict_hot(budget_bytes=0) == 0 and _dump(log) == full
    assert log.tier_sync()["uploaded"] >= 1
    log.evict_hot(budget_bytes=0)
    assert log.local_base_offset > 0 and _dump(log) == full
    log.close()


def test_torn_remote_blob_never_served(tmp_path):
    def case(pkg, d):
        log, remote, store = _tiered(pkg, d)
        _fill(log, 120)
        log.roll()
        log.tier_sync()
        log.evict_hot(budget_bytes=0)
        served = bool(_dump(log))
        log.cache.clear()
        victim = log.remote_metas()[0]
        blob_path = os.path.join(store.root,
                                 f"tiered/T/0/{victim.base:020d}.log")
        blob = bytearray(open(blob_path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        with open(blob_path, "wb") as fh:
            fh.write(bytes(blob))
        with pytest.raises(LookupError):
            log.read_from(victim.base, 10)
        cache = pkg.RemoteSegmentCache(str(d / "c2"), max_segments=2)
        with pytest.raises(OSError):
            cache.get(victim, remote)
        log.close()
        return [served, victim.base]

    assert _both(case, tmp_path)[0]


# ------------------------------------------------ consumer integration
def test_consumer_poll_below_local_base_no_autoreset(tmp_path):
    def case(pkg, d):
        broker = pkg.Broker(store_dir=str(d / "store"),
                            store_policy=pkg.StorePolicy(fsync="never",
                                                         segment_bytes=1024),
                            tier=pkg.TierPolicy(uri=str(d / "bucket")))
        try:
            broker.create_topic("T", partitions=1)
            for i in range(100):
                broker.produce("T", b"value-%d" % i, key=b"k",
                               timestamp_ms=i)
            log = broker.store.log_for("T", 0)
            log.roll()
            tiering = broker.run_tiering()
            log.evict_hot(budget_bytes=0)
            before = pkg.metrics.consumer_autoresets.value(topic="T")
            consumer = pkg.StreamConsumer(broker, ["T:0:0"], group="tier-g")
            got = []
            for _ in range(50):
                batch = consumer.poll(64)
                if not batch:
                    break
                got.extend(batch)
            out = [sorted(tiering), log.local_base_offset,
                   broker.begin_offset("T", 0),
                   [(m.offset, m.value) for m in got],
                   pkg.metrics.consumer_autoresets.value(topic="T") - before]
            with pytest.raises(pkg.OutOfRange):
                broker.fetch("T", 0, -5, 10)
            return out
        finally:
            broker.close()

    _tiers, local, begin, rows, resets = _both(case, tmp_path)
    assert local > 0 and begin == 0 and resets == 0
    assert rows == [(i, b"value-%d" % i) for i in range(100)]


def test_remote_read_rides_the_one_frame_scanner(tmp_path, monkeypatch):
    def case(pkg, d):
        log, _remote, _store = _tiered(pkg, d)
        _fill(log, 150)
        log.roll()
        log.tier_sync()
        log.evict_hot(budget_bytes=0)
        log.cache.clear()
        _fill(log, 5, ts0=5000)
        seen = []
        orig = pkg.seg.iter_frames

        def counting(path, start_pos=0):
            seen.append(path)
            return orig(path, start_pos)

        monkeypatch.setattr(pkg.seg, "iter_frames", counting)
        out = log.read_from(0, 10 ** 6)
        monkeypatch.setattr(pkg.seg, "iter_frames", orig)
        log.close()
        return [len(out), any(".tiercache" in p for p in seen),
                any(".tiercache" not in p for p in seen)]

    assert _both(case, tmp_path) == [155, True, True]


# -------------------------------------------------- tiering mechanics
def test_quorum_ceiling_bounds_tiering(tmp_path):
    def case(pkg, d):
        log, _remote, _store = _tiered(pkg, d)
        try:
            _fill(log, 150)
            log.roll()
            stats = log.tier_sync(ceiling=60)
            metas = _metas(log)
            log.evict_hot(budget_bytes=0)
            out = [stats, metas, log.local_base_offset, _dump(log)[0][0]]
            log.tier_sync(ceiling=150)
            return out + [max(m.next for m in log.remote_metas())]
        finally:
            log.close()

    stats, metas, local, first, top = _both(case, tmp_path)
    assert stats["uploaded"] >= 1 and all(m[1] <= 60 for m in metas)
    assert local <= 60 and first == 0 and top > 60


def test_upload_lag_defers_fresh_seals(tmp_path):
    def case(pkg, d):
        log, _remote, _store = _tiered(pkg, d, upload_lag_s=3600.0)
        try:
            _fill(log, 100)
            log.roll()
            deferred = log.tier_sync()
            return [deferred, _metas(log), log.tier_sync(upload_lag_s=0.0)]
        finally:
            log.close()

    deferred, metas, now = _both(case, tmp_path)
    assert deferred["uploaded"] == 0 and metas == [] and now["uploaded"] >= 1


def test_hot_byte_budget_and_remote_retention(tmp_path):
    def case(pkg, d):
        log, _remote, store = _tiered(pkg, d, local_hot_bytes=2048,
                                      remote_retention_ms=50)
        try:
            _fill(log, 200, ts0=1000)
            log.roll()
            stats = log.tier_sync()
            metas = _metas(log)
            out = [stats, log.total_bytes(), log.local_base_offset, metas,
                   store.list("tiered/T/0"), log.base_offset]
            if log.base_offset > 0:
                with pytest.raises(LookupError):
                    log.read_from(0, 1)
            return out
        finally:
            log.close()

    _stats, _size, local, metas, listed, _base = _both(case, tmp_path)
    assert local > 0
    newest = 1000 + 199
    assert all(m[3] >= newest - 50 or m[3] < 0 for m in metas)
    for n in listed:
        if n.endswith(".log"):
            assert any(m[0] == int(os.path.basename(n)[:-4]) for m in metas)


def test_compacted_rewrite_reuploads_same_base(tmp_path):
    def case(pkg, d):
        log, _remote, _store = _tiered(pkg, d, segment_bytes=1024)
        try:
            for i in range(200):
                log.append(b"k%d" % (i % 3), b"v-%d" % i, 1000 + i)
            log.roll()
            stats = log.tier_sync()
            pre = {m.base: m.size for m in log.remote_metas()}
            st = log.compact(grace_ms=0)
            latest = {r[1]: r for r in _dump(log)}
            stats2 = log.tier_sync()
            post = {m.base: m.size for m in log.remote_metas()}
            log.evict_hot(budget_bytes=0)
            return [stats, st.segments_rewritten, stats2, pre, post,
                    {r[1]: r for r in _dump(log)} == latest]
        finally:
            log.close()

    stats, rewritten, stats2, pre, post, same = _both(case, tmp_path)
    assert stats["uploaded"] >= 1 and rewritten >= 1
    assert stats2["uploaded"] >= 1 and same
    assert [b for b in post if b in pre and post[b] != pre[b]]


def test_uploader_lifecycle_and_idempotent_pass(tmp_path):
    def case(pkg, d):
        broker = pkg.Broker(store_dir=str(d / "store"),
                            store_policy=pkg.StorePolicy(fsync="never",
                                                         segment_bytes=1024),
                            tier=pkg.TierPolicy(uri=str(d / "bucket")))
        for i in range(60):
            broker.produce("T", b"v%d" % i, timestamp_ms=i)
        broker.store.log_for("T", 0).roll()
        up = pkg.TierUploader(broker, interval_s=3600.0)
        out = [up.run_once(), up.run_once()]
        up.start()
        out.append(up._thread.name)
        up.stop()
        out.append(up._thread)
        broker.close()
        plain = pkg.Broker(store_dir=str(d / "plain"),
                           store_policy=pkg.StorePolicy(fsync="never"))
        out.append(pkg.TierUploader(plain).run_once())
        plain.close()
        return out

    first, again, name, thread, plain = _both(case, tmp_path)
    assert first and all(s["uploaded"] >= 1 for s in first.values())
    assert again == {} and name == "iotml-tier-uploader"
    assert thread is None and plain == {}


def test_tier_config_env_keys(monkeypatch):
    monkeypatch.setenv("IOTML_TIER_URI", "/data/tier")
    monkeypatch.setenv("IOTML_TIER_LOCAL_HOT_BYTES", "4096")
    monkeypatch.setenv("IOTML_TIER_UPLOAD_LAG_S", "2.5")
    monkeypatch.setenv("IOTML_TIER_REMOTE_RETENTION_MS", "604800000")
    cfg, _ = t_load_config([])
    assert cfg.tier.uri == "/data/tier"
    assert cfg.tier.local_hot_bytes == 4096
    assert cfg.tier.upload_lag_s == 2.5
    assert cfg.tier.remote_retention_ms == 604800000
    pol = TierPolicy.from_config(cfg.tier)
    assert vars(pol) == vars(JTierPolicy(
        uri="/data/tier", local_hot_bytes=4096, upload_lag_s=2.5,
        remote_retention_ms=604800000))
    assert bool(pol) and not TierPolicy()


def test_manifest_is_the_commit_marker(tmp_path):
    def case(pkg, d):
        log, remote, store = _tiered(pkg, d)
        try:
            _fill(log, 100)
            log.roll()
            log.tier_sync()
            doc = json.loads(store.get_text("tiered/T/0/manifest.json"))
            store.put_text("tiered/T/0/99999999999999999999.stage", "{}")
            return [doc, _metas(log), remote.sweep(), remote.sweep()]
        finally:
            log.close()

    doc, metas, swept, again = _both(case, tmp_path)
    assert {e["base"] for e in doc["segments"]} == {m[0] for m in metas}
    for e in doc["segments"]:
        assert e["size"] > 0 and e["crc"] >= 0 and e["next"] > e["base"]
    assert (swept, again) == (1, 0)
