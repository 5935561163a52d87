"""The port's digital twin (``iotml_torch.twin``) held against the JAX
package: the ten cases of tests/test_twin.py, each run through both
packages on the same seeded inputs, the drill's report, the CLI and the
scorer's feature-store join.

Tolerances:
- exact (byte-equal): canonical changelog values and table snapshots,
  every changelog record (key, value, partition, offset, timestamp; a
  tombstone's timestamp is the wall clock, so it is held to the wall
  clock's window instead), the rebuild after compaction, the sharding;
  ``TwinFeatureStore.vector`` / ``matrix`` (the same float64 means and
  normalizer); the drill's report and the CLI's output;
- REST documents equal as JSON;
- the joined scorer, from params converted from one JAX init: payload
  values parsed at atol 1e-6, per-row errors rtol 1e-5 (float32 forwards
  in another order), the verdict mean over the live columns only.
"""

import contextlib
import io
import json
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from iotml import connect as j_connect
from iotml import twin as j_twin
from iotml.core.schema import KSQL_CAR_SCHEMA
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.gen import simulator as j_sim
from iotml.models.autoencoder import DenseAutoencoder as JDenseAutoencoder
from iotml.serve.scorer import StreamScorer as JStreamScorer
from iotml.store import StorePolicy as JStorePolicy
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.producer import OutputSequence as JOutputSequence
from iotml.train.loop import Trainer as JTrainer
from iotml.twin import drill as j_drill
from iotml.twin.__main__ import main as j_twin_main
from iotml_torch import connect as t_connect
from iotml_torch import twin as t_twin
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen import simulator as t_sim
from iotml_torch.models.autoencoder import AutoencoderSpec
from iotml_torch.models.convert import params_from_jax, params_to_jax
from iotml_torch.serve import scorer as t_scorer
from iotml_torch.store import StorePolicy
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.twin import drill as t_drill
from iotml_torch.twin.__main__ import main as t_twin_main

IN = "SENSOR_DATA_S_AVRO"
F = len(KSQL_CAR_SCHEMA.sensor_fields)
PKGS = {"port": (t_twin, Broker, t_sim, StorePolicy, t_connect),
        "jax": (j_twin, JBroker, j_sim, JStorePolicy, j_connect)}


def _publish(sim, broker, n_ticks=6, cars=6, seed=3, partitions=2):
    gen = sim.FleetGenerator(sim.FleetScenario(num_cars=cars, seed=seed,
                                               failure_rate=0.2))
    return gen.publish(broker, IN, n_ticks=n_ticks, partitions=partitions)


def _changelog(b, topic="CAR_TWIN"):
    out = []
    for p in range(b.topic(topic).partitions):
        off = b.begin_offset(topic, p)
        end = b.end_offset(topic, p)
        while off < end:
            batch = b.fetch(topic, p, off, 1 << 20)
            if not batch:
                break
            out += [(m.partition, m.offset, m.key, m.value, m.timestamp_ms)
                    for m in batch]
            off = batch[-1].offset + 1
    return out


def _pump(svc):
    while svc.pump_once():
        pass


# ------------------------------------------------------------ state fold
@pytest.mark.parametrize("window", [2, 8])
def test_car_twin_fold_aggregates_and_canonical_codec(window):
    rng = np.random.default_rng(5)
    rows = [[float(v) for v in rng.normal(size=F).astype(np.float32)]
            for _ in range(11)]
    got = {}
    for kind, (twin, *_rest) in PKGS.items():
        t = twin.CarTwin("car-1", partition=1)
        blobs = []
        for i, row in enumerate(rows):
            t.absorb(row, ts=100 + i, offset=i, failure=(i % 3 == 1),
                     window=window)
            blobs.append(t.encode())
        blob = t.encode()
        assert twin.CarTwin.decode(blob).encode() == blob
        got[kind] = (blobs, t.aggregates(), t.to_doc())
    assert got["port"] == got["jax"]
    agg = got["port"][1]
    assert agg["window_len"] == window and agg["count"] == 11
    assert agg["failures"] == 4 and agg["failure_rate"] == 4 / 11
    assert t_twin.CarTwin("x").aggregates() == \
        j_twin.CarTwin("x").aggregates()


def test_twin_table_idempotent_fold_and_resume_offsets():
    got = {}
    for kind, (twin, *_rest) in PKGS.items():
        tbl = twin.TwinTable(window=4)
        seq = [tbl.apply("a", 0, 5, [1.0], 100, False),
               tbl.apply("a", 0, 5, [9.0], 100, False),  # redelivery
               tbl.apply("a", 0, 4, [9.0], 90, False),   # behind it
               tbl.apply("a", 0, 6, [2.0], 110, False),
               tbl.apply("b", 1, 2, [3.0], 120, True),
               tbl.apply("a", 1, 0, [4.0], 130, False)]  # moved partition
        resume = tbl.resume_offsets()
        snap = tbl.snapshot()
        tbl.apply_changelog("a", None)
        tbl.apply_changelog("c", snap["b"].replace(b'"b"', b'"c"'))
        got[kind] = (seq, resume, snap, tbl.cars(), tbl.snapshot(),
                     len(tbl))
    assert got["port"] == got["jax"]
    assert got["port"][0] == [True, False, False, True, True, True]
    assert got["port"][3] == ["b", "c"]


def _seeded_table(twin, cars=12, ticks=10, seed=9):
    rng = np.random.default_rng(seed)
    tbl = twin.TwinTable()
    for t in range(ticks):
        for c in range(cars):
            if (c + t) % 5 == 0:
                continue
            row = [float(v) for v in
                   rng.normal(50, 30, size=F).astype(np.float32)]
            tbl.apply(f"car-{c}", c % 2, t, row, 1000 * t,
                      bool(rng.random() < 0.2))
    return tbl


def test_feature_store_vector_layout_and_cold_start():
    stores = {kind: twin.TwinFeatureStore(_seeded_table(twin))
              for kind, (twin, *_rest) in PKGS.items()}
    fs, jfs = stores["port"], stores["jax"]
    assert fs.dim == jfs.dim == F + 2
    assert not fs.vector(None).any() and not fs.vector(b"ghost").any()
    keys = [f"car-{c}".encode() for c in range(12)] + [None, b"ghost",
                                                       "car-3"]
    for k in keys:
        v = fs.vector(k)
        assert v.dtype == np.float32 and v.shape == (F + 2,)
        np.testing.assert_array_equal(v, jfs.vector(k))
    for n in (len(keys) - 3, len(keys), len(keys) + 4):
        m = fs.matrix(np.array(keys[:-1], dtype=object), n)
        np.testing.assert_array_equal(
            m, jfs.matrix(np.array(keys[:-1], dtype=object), n))
        assert m.shape == (n, F + 2) and m.dtype == np.float32
    assert not fs.matrix(None, 3).any()
    twin = fs.table.get("car-1")
    v = fs.vector(b"car-1")
    assert v[F] == np.float32(np.tanh(twin.count / 100.0))
    assert v[F + 1] == np.float32(twin.failures / twin.count)


# ----------------------------------------------------- service lifecycle
def test_service_materialises_changelogs_and_rebuilds():
    got = {}
    for kind, (twin, broker_cls, sim, *_rest) in PKGS.items():
        b = broker_cls()
        b.create_topic(IN, partitions=2)
        published = _publish(sim, b)
        svc = twin.TwinService(b)
        _pump(svc)
        svc2 = twin.TwinService(b)
        rebuilt = svc2.table.snapshot()
        _pump(svc2)
        got[kind] = (published, svc.applied, svc.emitted, len(svc.table),
                     b.topic("CAR_TWIN").cleanup_policy,
                     svc.table.snapshot(), rebuilt, svc2.rebuilt_records,
                     svc2.applied, svc2.table.snapshot(), _changelog(b),
                     [b.committed("iotml-twin", IN, p) for p in range(2)],
                     svc.cars(), svc.cars("electric-vehicle-0000"),
                     [svc.get(c) for c in svc.cars()])
    assert got["port"] == got["jax"]
    published, applied, emitted, n, policy, snap, rebuilt, replayed, \
        reapplied, snap2 = got["port"][:10]
    assert applied == published and n == 6 and emitted > 0
    assert policy == "compact" and rebuilt == snap == snap2
    assert replayed > 0 and reapplied == 0


def test_rebuild_after_compaction_equals_snapshot(tmp_path):
    got = {}
    for kind, (twin, broker_cls, sim, policy_cls, _) in PKGS.items():
        b = broker_cls(store_dir=str(tmp_path / kind),
                       store_policy=policy_cls(fsync="never",
                                               segment_bytes=4 * 1024,
                                               compact_grace_ms=10 ** 9))
        b.create_topic(IN, partitions=2)
        svc = twin.TwinService(b)
        gen = sim.FleetGenerator(sim.FleetScenario(num_cars=6, seed=3,
                                                   failure_rate=0.2))
        for _ in range(8):
            gen.publish(b, IN, n_ticks=1, partitions=2)
            svc.pump_once()
        _pump(svc)
        snapshot = svc.table.snapshot()
        emitted = svc.emitted
        before = _changelog(b)
        del svc  # killed: no flush, the changelog is the only trace
        for p in range(2):
            b.store.log_for("CAR_TWIN", p).roll()
        stats = b.run_compaction(force=True)
        removed = sum(s.records_removed for s in stats.values())
        svc2 = twin.TwinService(b)
        got[kind] = (snapshot, emitted, before, removed, _changelog(b),
                     svc2.table.snapshot(), svc2.rebuilt_records)
        b.close()
    assert got["port"] == got["jax"]
    snapshot, emitted, _, removed, _, rebuilt, replayed = got["port"]
    assert removed > 0 and rebuilt == snapshot
    assert replayed <= len(snapshot) + 2 < emitted


def test_retire_tombstones_and_stays_retired():
    got = {}
    for kind, (twin, broker_cls, sim, *_rest) in PKGS.items():
        b = broker_cls()
        b.create_topic(IN, partitions=2)
        svc = twin.TwinService(b)
        _publish(sim, b)
        _pump(svc)
        car = svc.cars()[0]
        t0 = int(time.time() * 1000)
        first = svc.retire(car)
        t1 = int(time.time() * 1000)
        again = svc.retire(car)
        svc2 = twin.TwinService(b)
        log = _changelog(b)
        (dead,) = [r for r in log if r[2] == car.encode() and r[3] is None]
        assert t0 <= dead[4] <= t1  # the tombstone is stamped now
        tap = twin.TwinService(b, changelog=False)
        with pytest.raises(RuntimeError, match="read-only"):
            tap.retire(tap.cars()[0])
        got[kind] = (car, first, again, svc.get(car), svc2.cars(),
                     [r for r in log if r[3] is not None], dead[:4],
                     tap.cars(), tap.emitted)
    assert got["port"] == got["jax"]
    car, first, again, doc, cars2 = got["port"][:5]
    assert first and not again and doc is None and car not in cars2


def test_partition_parallel_sharding():
    """Two service instances, one partition each: disjoint car sets,
    union == whole fleet, changelogs in their OWN partitions."""
    got = {}
    for kind, (twin, broker_cls, sim, *_rest) in PKGS.items():
        b = broker_cls()
        b.create_topic(IN, partitions=2)
        _publish(sim, b, cars=8)
        s0 = twin.TwinService(b, partitions=[0], group="twin-p0")
        s1 = twin.TwinService(b, partitions=[1], group="twin-p1")
        while s0.pump_once() or s1.pump_once():
            pass
        cars0, cars1 = set(s0.cars()), set(s1.cars())
        assert cars0 and cars1 and not (cars0 & cars1)
        assert len(cars0 | cars1) == 8
        for m in _changelog(b):
            owner = s0 if m[2].decode() in cars0 else s1
            assert m[0] in owner.partitions
        got[kind] = (sorted(cars0), sorted(cars1), s0.table.snapshot(),
                     s1.table.snapshot(), _changelog(b))
    assert got["port"] == got["jax"]


# ------------------------------------------------------------ REST + e2e
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _delete(url):
    req = urllib.request.Request(url, method="DELETE")
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_rest_twin_endpoints():
    got = {}
    for kind, (twin, broker_cls, sim, _, conn) in PKGS.items():
        b = broker_cls()
        b.create_topic(IN, partitions=2)
        _publish(sim, b)
        svc = twin.TwinService(b)
        _pump(svc)
        srv = conn.ConnectServer(conn.ConnectWorker(b)).start()
        try:
            srv.attach_twin(svc)
            listing = _get(f"{srv.url}/twin")
            car = listing[1]["cars"][0]
            got[kind] = [
                listing,
                _get(f"{srv.url}/twin?count_only=true"),
                _get(f"{srv.url}/twin?limit=2&offset=1"),
                _get(f"{srv.url}/twin?limit=2&offset=5"),
                _get(f"{srv.url}/twin?limit=x"),
                _get(f"{srv.url}/twin?limit=-1"),
                _get(f"{srv.url}/twin/{car}"),
                _get(f"{srv.url}/twin/no-such-car"),
                _delete(f"{srv.url}/twin/{car}"),
                _get(f"{srv.url}/twin/{car}"),
                _delete(f"{srv.url}/twin/{car}"),
                _get(f"{srv.url}/twin?count_only=1"),
            ]
        finally:
            srv.stop()
    assert got["port"] == got["jax"]
    status, doc = got["port"][6]
    assert status == 200 and set(doc["latest"]) == \
        {f.name for f in KSQL_CAR_SCHEMA.sensor_fields}
    assert doc["aggregates"]["window_len"] > 0
    assert len(doc["aggregates"]["mean"]) == F
    assert got["port"][0][1]["count"] == 6
    assert [g[0] if isinstance(g, tuple) else g
            for g in got["port"][7:]] == [404, 204, 404, 404, 200]


def _joined_params(seed=0):
    """One JAX init of the joined autoencoder (18 live + 20 twin
    columns): the flax tree and the port's state_dict from it."""
    model = JDenseAutoencoder(input_dim=F + F + 2)
    trainer = JTrainer(model, rng=jax.random.PRNGKey(seed))
    trainer._ensure_state(np.zeros((100, F + F + 2), np.float32))
    tree = jax.tree.map(np.asarray, trainer.state.params)
    return model, tree, params_from_jax(tree)


def test_params_cross_at_the_joined_width():
    _, tree, params = _joined_params()
    assert params["encoder0.weight"].shape == (14, F + F + 2)
    assert params["decoder1.weight"].shape == (F + F + 2, 7)
    back = params_to_jax(params)
    for layer, leaves in tree.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(back[layer][k], v)
    model = AutoencoderSpec(input_dim=F + F + 2).build("cpu")
    model.load_state_dict(params)  # the shapes are the model's


def _parse(msg):
    parts = (msg if isinstance(msg, str) else msg.decode()).split("|")
    return np.array(parts[0].strip("[]").split(), np.float64), parts[1:]


@pytest.mark.parametrize("threshold", [None, 0.02])
def test_scorer_joins_twin_features_while_rest_serves(threshold):
    """GET /twin/<car_id> answers latest state + rolling aggregates over
    connect REST while each package's StreamScorer joins the same twin's
    features onto the live rows it scores; the port's payloads and
    errors equal JAX's, and the verdict mean reads the live columns."""
    model, tree, params = _joined_params()
    runs = {}
    for kind, (twin, broker_cls, sim, _, conn) in PKGS.items():
        b = broker_cls()
        b.create_topic(IN, partitions=2)
        published = _publish(sim, b, n_ticks=8)
        svc = twin.TwinService(b)
        _pump(svc)
        fs = twin.TwinFeatureStore(svc)
        specs = [f"{IN}:{p}:0" for p in range(2)]
        mask = np.ones((F,), bool)
        if kind == "port":
            consumer = StreamConsumer(b, specs, group="twin-scorer")
            batches = SensorBatches(consumer, batch_size=100,
                                    keep_keys=True)
            out = OutputSequence(b, "model-predictions", partition=0)
            scorer = t_scorer.StreamScorer(
                AutoencoderSpec(input_dim=F + fs.dim), params, batches,
                out, feature_store=fs, verdict_mask=mask,
                threshold=threshold, device="cpu")
        else:
            consumer = JStreamConsumer(b, specs, group="twin-scorer")
            batches = JSensorBatches(consumer, batch_size=100,
                                     keep_keys=True)
            out = JOutputSequence(b, "model-predictions", partition=0)
            scorer = JStreamScorer(model, tree, batches, out,
                                   feature_store=fs, verdict_mask=mask,
                                   threshold=threshold)
        srv = conn.ConnectServer(conn.ConnectWorker(b)).start()
        try:
            srv.attach_twin(svc)
            scored = scorer.score_available()
            car = svc.cars()[0]
            doc = _get(f"{srv.url}/twin/{car}")
        finally:
            srv.stop()
        assert scored == published == b.end_offset("model-predictions", 0)
        assert fs.vector(car.encode()).any()
        rows = [m.value for m in b.fetch("model-predictions", 0, 0, 1 << 30)]
        # the live rows and joined features each record was scored with
        xs = np.concatenate([np.concatenate(
            [x.x[: x.n_valid], fs.matrix(x.keys, x.x.shape[0])[: x.n_valid]],
            axis=1) for x in (SensorBatches if kind == "port"
                              else JSensorBatches)(
            (StreamConsumer if kind == "port" else JStreamConsumer)(
                b, specs, group="twin-replay"), batch_size=100,
            keep_keys=True)])
        runs[kind] = (rows, doc, xs, scorer.quality)
    t_rows, t_doc, t_xs, t_quality = runs["port"]
    j_rows, j_doc, j_xs, j_quality = runs["jax"]
    assert t_doc == j_doc and t_doc[1]["aggregates"]["window_len"] > 0
    np.testing.assert_array_equal(t_xs, j_xs)
    assert t_xs.shape == (len(t_rows), F + F + 2)
    assert t_quality == j_quality
    assert len(t_rows) == len(j_rows) > 0
    preds = []
    for tm, jm in zip(t_rows, j_rows):
        t_vals, t_tail = _parse(tm)
        j_vals, j_tail = _parse(jm)
        assert t_vals.shape == j_vals.shape == (F + F + 2,)
        np.testing.assert_allclose(t_vals, j_vals, rtol=0, atol=1e-6)
        preds.append(t_vals)
        if threshold is None:
            assert t_tail == j_tail == []
        else:
            assert abs(float(t_tail[1]) - float(j_tail[1])) <= 1.5e-6
            t_err, j_err = float(t_tail[1]), float(j_tail[1])
            if abs(j_err - threshold) > 1e-4:
                assert t_tail[0] == j_tail[0]
            np.testing.assert_allclose(t_err, j_err, rtol=1e-5, atol=1e-6)
    if threshold is not None:
        # the printed error is the live columns' mean, not the joined
        # row's
        preds = np.stack(preds)
        live_mean = np.mean(np.square(preds[:, :F] - t_xs[:, :F]), axis=1)
        all_mean = np.mean(np.square(preds - t_xs), axis=1)
        printed = np.array([float(_parse(m)[1][1]) for m in t_rows])
        np.testing.assert_allclose(printed, live_mean, rtol=0, atol=2e-6)
        assert np.abs(printed - all_mean).max() > 1e-4


def test_row_errors_widen_a_short_mask_as_jax():
    rng = np.random.default_rng(3)
    preds = rng.normal(size=(2, 5, F + F + 2)).astype(np.float32)
    xs = rng.normal(size=(2, 5, F + F + 2)).astype(np.float32)
    mask = rng.random(F) < 0.6
    got = t_scorer.row_errors(preds, xs, mask)
    want = np.square(preds - xs)[:, :, :F][:, :, mask].mean(axis=2)
    np.testing.assert_array_equal(got, want)
    full = np.concatenate([mask, np.zeros(F + 2, bool)])
    np.testing.assert_array_equal(got, t_scorer.row_errors(preds, xs, full))


def test_carhealth_heads_see_the_live_columns_of_joined_rows():
    """Where the car-health feature heads meet joined rows they are fed
    the live columns only (the JAX scorer's ``[:, :n_live]``)."""
    seen = []

    class Heads:
        feature_heads = True

        def update(self, keys, errs, ferrs=None, fvals=None):
            seen.append((ferrs.shape, fvals.shape))
            return []

        def notify_model_swap(self):
            pass

    b = Broker()
    b.create_topic(IN, partitions=1)
    _publish(t_sim, b, n_ticks=3, partitions=1)
    svc = t_twin.TwinService(b)
    _pump(svc)
    fs = t_twin.TwinFeatureStore(svc)
    batches = SensorBatches(StreamConsumer(b, [f"{IN}:0:0"], group="h"),
                            batch_size=4, keep_keys=True)
    sc = t_scorer.StreamScorer(AutoencoderSpec(input_dim=F + fs.dim),
                               _joined_params()[2], batches,
                               OutputSequence(), feature_store=fs,
                               carhealth=Heads(), device="cpu")
    assert sc.score_available() == 18
    assert seen and all(f == v and f[1] == F for f, v in seen)


# ------------------------------------------------------------- the drill
@pytest.mark.parametrize("seed,records", [(11, 300), (7, 1500)])
def test_twin_rebuild_drill_equals_jax(seed, records):
    report = t_drill.run_twin_rebuild_drill(seed=seed, records=records)
    want = j_drill.run_twin_rebuild_drill(seed=seed, records=records)
    assert report.ok, [i.detail for i in report.invariants if not i.ok]
    assert report.to_dict() == want.to_dict()
    assert report.compaction_removed > 0


@pytest.mark.parametrize("json_flag", [False, True])
def test_twin_cli_prints_what_jax_prints(json_flag):
    argv = ["drill", "--seed", "11", "--records", "300"] + (
        ["--json"] if json_flag else [])
    outs = []
    for main in (t_twin_main, j_twin_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "rebuild_equals_snapshot" in outs[0]


def test_twin_metric_families_equal_jax():
    from iotml.twin import service as j_service
    from iotml_torch.obs import metrics as t_metrics
    from iotml_torch.twin import service as t_service

    def describe(m):
        return (type(m).__name__, m.name, m.help,
                getattr(m, "buckets", None))

    names = ("twin_applied", "twin_changelog", "twin_rebuild", "twin_cars",
             "twin_query_seconds")
    for n in names:
        assert describe(getattr(t_service, n)) == \
            describe(getattr(j_service, n))
        assert getattr(t_service, n).name in \
            t_metrics.default_registry._metrics
    assert t_service.CHANGELOG_TOPIC == j_service.CHANGELOG_TOPIC


def test_twin_watermark_and_counters_move_as_jax():
    """One pass over the same records moves the port's twin counters by
    what JAX's move, and the ``twin`` watermark stage is observed."""
    from iotml.obs import watermark as j_watermark
    from iotml.twin import service as j_service
    from iotml_torch.obs import watermark as t_watermark
    from iotml_torch.twin import service as t_service

    deltas = {}
    for kind, (twin, broker_cls, sim, *_rest), svc_mod, wm in (
            ("port",) + (PKGS["port"], t_service, t_watermark),
            ("jax",) + (PKGS["jax"], j_service, j_watermark)):
        def values():
            return [svc_mod.twin_applied.value(),
                    svc_mod.twin_changelog.value(),
                    svc_mod.twin_rebuild.value()]
        before = values()
        b = broker_cls()
        b.create_topic(IN, partitions=2)
        _publish(sim, b)
        svc = twin.TwinService(b, group="wm-twin")
        _pump(svc)
        twin.TwinService(b, group="wm-twin-2")
        deltas[kind] = [a - z for a, z in zip(values(), before)]
        deltas[kind].append(svc_mod.twin_cars.value())
    assert deltas["port"] == deltas["jax"]
    assert deltas["port"][0] == 36
