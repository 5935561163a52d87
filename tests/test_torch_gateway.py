"""The port's gateway serving plane (``iotml_torch.gateway``) held against
the JAX package: the ten gateway cases of tests/test_gateway.py, each run
through both packages on the same seeded inputs, the drill's barrier, the
metric families, the CLI and the scorer's join through ``GatewayClient``.

Tolerances:
- exact: the partition, shard and front policies; shard info and the
  421 fence; ``get`` / ``mget`` / ``cars`` / ``count`` / ``aggregate`` /
  ``retire`` answers; the router's REST answers as JSON (shard URLs
  aside: each server has its own port); table snapshots byte-equal;
  ``GatewayClient.matrix`` bit-equal to ``TwinFeatureStore.matrix`` (the
  rows cross as JSON doubles, which hold a float32 exactly);
- the drill's deterministic report fields (seed, records, cars, shards,
  published, killed shard, invariant names) equal; its verdicts equal
  where JAX's run passes (JAX's drill has a barrier race, shown below);
  storm counts and timings are left out;
- the joined scorer, from params converted from one JAX init: payload
  values parsed at atol 1e-6, per-row errors rtol 1e-5 (float32
  forwards in another order).

Every server binds 127.0.0.1:0, every durable store lives under the
test's own tmp_path, and every wait has a timeout.
"""

import contextlib
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from iotml import gateway as j_gateway
from iotml import twin as j_twin
from iotml.core.schema import KSQL_CAR_SCHEMA
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.gateway import drill as j_drill
from iotml.gateway import shards as j_shards
from iotml.gen import simulator as j_sim
from iotml.models.autoencoder import DenseAutoencoder as JDenseAutoencoder
from iotml.serve.scorer import StreamScorer as JStreamScorer
from iotml.store import StorePolicy as JStorePolicy
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.producer import OutputSequence as JOutputSequence
from iotml.train.loop import Trainer as JTrainer
from iotml.utils import rest as j_rest
from iotml_torch import gateway as t_gateway
from iotml_torch import twin as t_twin
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gateway import drill as t_drill
from iotml_torch.gateway import shards as t_shards
from iotml_torch.gateway.__main__ import main as t_main
from iotml_torch.gen import simulator as t_sim
from iotml_torch.models.autoencoder import AutoencoderSpec
from iotml_torch.models.convert import params_from_jax
from iotml_torch.serve import scorer as t_scorer
from iotml_torch.store import StorePolicy
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.utils import rest as t_rest

IN = "SENSOR_DATA_S_AVRO"
F = len(KSQL_CAR_SCHEMA.sensor_fields)
PKGS = {"port": (t_gateway, t_twin, Broker, t_sim, StorePolicy, t_rest),
        "jax": (j_gateway, j_twin, JBroker, j_sim, JStorePolicy, j_rest)}


def _publish(sim, broker, n_ticks=6, cars=8, seed=5, partitions=4):
    gen = sim.FleetGenerator(sim.FleetScenario(num_cars=cars, seed=seed,
                                               failure_rate=0.2))
    return gen.publish(broker, IN, n_ticks=n_ticks, partitions=partitions)


def _await(cond, timeout_s=20.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() >= deadline:
            raise TimeoutError(f"{what} not reached in {timeout_s}s")
        time.sleep(0.02)


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, json.loads(resp.read())


def _status(url, method="GET", body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            raw = resp.read()
            return resp.status, json.loads(raw) if raw else None
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


@contextlib.contextmanager
def _cluster(gw, broker, **kw):
    cluster = gw.GatewayCluster(broker, n_shards=2, **kw).start()
    client = gw.GatewayClient(cluster)
    try:
        yield cluster, client
    finally:
        client.close()
        cluster.stop()


# --------------------------------------------------------- pure policy
def test_partition_policy_matches_broker_keyed_produce():
    """partition_for_key is each package's broker's keyed partitioner,
    the shard policy composes, and both packages agree on every key."""
    keys = [f"car_{i}" for i in range(64)]
    for kind, (gw, _, broker_cls, *_rest) in PKGS.items():
        b = broker_cls()
        b.create_topic("t", partitions=4)
        for k in keys:
            b.produce("t", b"v", key=k.encode())
        for k in keys:
            p = gw.partition_for_key(k, 4)
            assert any(m.key == k.encode()
                       for m in b.fetch("t", p, 0, 1 << 20)), kind
            assert gw.shard_for_key(k, 4, 2) == p % 2
            assert gw.partition_for_key(k.encode(), 4) == p
    for n_parts in (1, 4, 8, 10):
        for n_shards in (1, 2, 3):
            assert [t_gateway.shard_for_key(k, n_parts, n_shards)
                    for k in keys] == \
                [j_gateway.shard_for_key(k, n_parts, n_shards) for k in keys]


def test_front_for_is_consistent_and_total():
    ids = [f"car_{i}" for i in range(100)]
    for n in (1, 2, 3, 5):
        assign = [t_gateway.front_for(c, n) for c in ids]
        assert assign == [j_gateway.front_for(c, n) for c in ids]
        assert set(assign) == set(range(n))


# --------------------------------------------------- shards + ownership
def test_shard_ownership_info_and_421_fencing():
    got = {}
    for kind, (gw, _, broker_cls, sim, *_rest) in PKGS.items():
        b = broker_cls()
        b.create_topic(IN, partitions=4)
        _publish(sim, b)
        with _cluster(gw, b, standbys=False) as (cluster, client):
            _await(lambda: client.count() == 8, what="shards drained")
            infos = [_get(f"{s.url}/shard/info")[1] for s in cluster.shards]
            assert infos[0]["partitions"] == [0, 2]
            assert infos[1]["partitions"] == [1, 3]
            # a direct hit on the WRONG shard is fenced with 421
            fenced = []
            for car in client.cars():
                wrong = cluster.shards[1 - client.shard_of(car)]
                fenced.append(_status(f"{wrong.url}/shard/twin/{car}"))
                fenced.append(_status(f"{wrong.url}/shard/twin/{car}",
                                      method="DELETE"))
            mixed = _status(f"{cluster.shards[0].url}/shard/mget", "POST",
                            {"keys": client.cars()})
            got[kind] = (infos, fenced, mixed)
    assert got["port"] == got["jax"]
    assert {code for code, _ in got["port"][1]} == {421}
    assert got["port"][2][1]["not_owned"]


def test_gateway_client_point_batch_and_fanout_queries():
    got = {}
    for kind, (gw, twin, broker_cls, sim, *_rest) in PKGS.items():
        b = broker_cls()
        b.create_topic(IN, partitions=4)
        published = _publish(sim, b)
        ref = twin.TwinService(b, group="gw-test-ref", changelog=False)
        while ref.pump_once():
            pass
        with _cluster(gw, b, standbys=False) as (cluster, client):
            _await(lambda: client.aggregate()["records"] == published,
                   what="shards drained")
            cars = client.cars()
            assert cars == ref.cars() and len(cars) == 8
            docs = [client.get(car) for car in cars]
            assert docs == [ref.get(car) for car in cars]
            out = {
                "docs": docs,
                "ghost": client.get("no-such-car"),
                "mget": client.mget(cars + ["ghost"]),
                "count": client.count(),
                "aggregate": client.aggregate(),
                "pages": [client.cars(limit=3), client.cars(limit=3,
                                                            offset=6),
                          client.cars(prefix=cars[0][:-1])],
                "shard_of": [client.shard_of(c) for c in cars],
                "retire": [client.retire(cars[0]), client.get(cars[0]),
                           client.retire(cars[0])],
                "after": [client.count(), client.cars()],
            }
            assert out["mget"][-1] is None
            for car, slim in zip(cars, out["mget"]):
                assert slim["car"] == car
                assert slim["ts"] == ref.get(car)["timestamp_ms"]
                assert slim["partition"] == gw.partition_for_key(car, 4)
            assert out["aggregate"]["records"] == published
            got[kind] = out
    assert got["port"] == got["jax"]
    assert got["port"]["retire"] == [True, None, False]


def test_gateway_client_duck_types_feature_store():
    """``GatewayClient.matrix`` / ``vector`` / ``dim``, bit-equal to the
    port's local ``TwinFeatureStore`` and to JAX's client and store."""
    got = {}
    for kind, (gw, twin, broker_cls, sim, *_rest) in PKGS.items():
        b = broker_cls()
        b.create_topic(IN, partitions=4)
        _publish(sim, b)
        ref = twin.TwinService(b, group="gw-test-ref", changelog=False)
        while ref.pump_once():
            pass
        fs = twin.TwinFeatureStore(ref)
        with _cluster(gw, b, standbys=False) as (cluster, client):
            _await(lambda: client.count() == 8, what="shards drained")
            assert client.dim == fs.dim == F + 2
            keys = [c.encode() for c in ref.cars()] + [None, b"ghost", b""]
            n = len(keys) + 2  # padding rows
            local = fs.matrix(keys, n)
            remote = client.matrix(keys, n)
            assert remote.dtype == np.float32 and remote.shape == (n, fs.dim)
            np.testing.assert_array_equal(remote, local)
            assert remote[:8].any() and not remote[8:].any()
            np.testing.assert_array_equal(client.vector(keys[0]),
                                          fs.vector(keys[0]))
            np.testing.assert_array_equal(client.matrix(None, 3),
                                          np.zeros((3, fs.dim), np.float32))
            got[kind] = remote
    np.testing.assert_array_equal(got["port"], got["jax"])


# ------------------------------------------------------------- router
def _router_answers(gw, rest_mod, cluster, client):
    rest = rest_mod.RestServer(name="iotml-gw-router-test")
    gw.GatewayRouter(cluster, client).mount(rest)
    rest.start()
    try:
        _await(lambda: client.count() == 8, what="shards drained")
        code, mp = _get(f"{rest.url}/gateway/map")
        assert all(s["url"].startswith("http://") for s in mp["shards"])
        for s in mp["shards"]:
            s.pop("url")  # each server has its own port
        remote = gw.GatewayClient(rest.url)
        cars = remote.cars()
        remote.close()
        out = {"map": (code, mp), "remote_cars": cars}
        for q in ("limit=3", "limit=5&offset=3", "count_only=1",
                  "limit=x", "offset=-1", "limit=2&prefix=" + cars[0][:-1]):
            out[q] = _status(f"{rest.url}/twin?{q}")
        out["get"] = _status(f"{rest.url}/twin/{cars[0]}")
        out["get_ghost"] = _status(f"{rest.url}/twin/ghost")
        out["mget"] = _status(f"{rest.url}/gateway/mget", "POST",
                              {"keys": [cars[0], "ghost"]})
        out["mget_bad"] = _status(f"{rest.url}/gateway/mget", "POST",
                                  {"keys": "x"})
        out["aggregate"] = _status(f"{rest.url}/gateway/aggregate")
        out["retire"] = _status(f"{rest.url}/twin/{cars[0]}", "DELETE")
        out["retire_again"] = _status(f"{rest.url}/twin/{cars[0]}",
                                      "DELETE")
        out["gone"] = _status(f"{rest.url}/twin/{cars[0]}")
        return out
    finally:
        rest.stop()


def test_gateway_router_rest_surface():
    got = {}
    for kind, (gw, _, broker_cls, sim, _, rest_mod) in PKGS.items():
        b = broker_cls()
        b.create_topic(IN, partitions=4)
        _publish(sim, b)
        with _cluster(gw, b, standbys=False) as (cluster, client):
            got[kind] = _router_answers(gw, rest_mod, cluster, client)
    assert got["port"] == got["jax"]
    t = got["port"]
    assert t["map"][1]["n_shards"] == 2 and t["map"][1]["n_partitions"] == 4
    assert t["limit=3"][1]["count"] == 8 and t["limit=3"][1]["next_offset"] == 3
    assert t["count_only=1"] == (200, {"count": 8})
    assert t["limit=x"][0] == 400 and t["offset=-1"][0] == 400
    assert t["retire"][0] == 204 and t["retire_again"][0] == 404
    assert t["gone"][0] == 404 and t["mget_bad"][0] == 400


# --------------------------------- standbys: rebalance + failover
def _standby_run(gw, twin, broker_cls, sim, policy_cls, store_dir):
    b = broker_cls(store_dir=str(store_dir),
                   store_policy=policy_cls(fsync="never",
                                           segment_bytes=8 * 1024,
                                           compact_grace_ms=10 ** 9))
    b.create_topic(IN, partitions=4)
    cluster = gw.GatewayCluster(b, n_shards=2).start()
    client = gw.GatewayClient(cluster)
    published = 0

    def drained(what):
        # the sound barrier: tables hold every record, every primary has
        # committed to the source end (so the changelog holds every
        # fold), then every standby has applied the changelog
        _await(lambda: client.aggregate()["records"] == published,
               what=f"{what}: shards drained")
        _await(lambda: t_drill.sources_committed(cluster),
               what=f"{what}: sources committed")
        _await(lambda: all(s.lag() == 0 for s in cluster.standbys.values()),
               what=f"{what}: standby catch-up")

    try:
        for _ in range(4):
            published += _publish(sim, b, n_ticks=1)
            drained("tick")
        for p in range(4):
            b.store.log_for(twin.CHANGELOG_TOPIC, p).roll()
        stats = b.run_compaction(force=True)
        removed = sum(s.records_removed for s in stats.values())
        assert removed > 0
        published += _publish(sim, b, n_ticks=2)
        drained("post-compaction")
        snaps = []
        for shard in cluster.shards:
            primary = shard.service.table.snapshot()
            assert cluster.standbys[shard.shard_id].table.snapshot() == \
                primary
            snaps.append(primary)
        pre_cars = [c for c in client.cars() if client.shard_of(c) == 0]
        cluster.kill_shard(0)
        promote_s = cluster.promote(0)
        assert promote_s < gw.GatewayCluster.PROMOTE_SLO_S
        promoted = cluster.shards[0].service.table.snapshot()
        assert promoted == snaps[0]
        client.refresh()
        assert [client.get(c)["car"] for c in pre_cars] == pre_cars
        assert client.aggregate()["records"] == published
        _await(lambda: cluster.standbys[0].lag() == 0,
               what="fresh standby catch-up")
        assert cluster.standbys[0].table.snapshot() == promoted
        return snaps, promoted, removed, cluster.map_doc()["shards"][0]
    finally:
        client.close()
        cluster.stop()
        b.close()


def test_standby_byte_identical_across_compaction_and_failover(tmp_path):
    """Each shard's warm standby is byte-equal to its primary across a
    compaction pass, the promoted standby serves the exact pre-kill
    state, and every snapshot is byte-equal to JAX's."""
    got = {}
    for kind, (gw, twin, broker_cls, sim, policy_cls, _) in PKGS.items():
        got[kind] = _standby_run(gw, twin, broker_cls, sim, policy_cls,
                                 tmp_path / kind)
    t_snaps, t_promoted, t_removed, t_cell = got["port"]
    j_snaps, j_promoted, j_removed, j_cell = got["jax"]
    assert t_snaps == j_snaps and t_promoted == j_promoted
    assert t_removed == j_removed
    assert t_cell["epoch"] == j_cell["epoch"] == 1


def test_client_survives_shard_kill_mid_queries():
    """A client on persistent connections sees the kill as a connection
    error (never a zombie answer) and retries onto the promoted shard."""
    got = {}
    for kind, (gw, _, broker_cls, sim, *_rest) in PKGS.items():
        b = broker_cls()
        b.create_topic(IN, partitions=4)
        _publish(sim, b)
        cluster = gw.GatewayCluster(b, n_shards=2).start()
        client = gw.GatewayClient(cluster, retry_deadline_s=10.0)
        try:
            _await(lambda: client.count() == 8, what="shards drained")
            cars0 = [c for c in client.cars() if client.shard_of(c) == 0]
            assert client.get(cars0[0])["car"] == cars0[0]  # conn warm
            _await(lambda: cluster.standbys[0].lag() == 0,
                   what="standby catch-up")
            cluster.kill_shard(0)
            cluster.promote(0)
            docs = [client.get(car) for car in cars0]
            assert [d["car"] for d in docs] == cars0
            assert client.refreshes >= 2  # the retry path ran
            got[kind] = docs
        finally:
            client.close()
            cluster.stop()
    assert got["port"] == got["jax"]


def test_client_errors_after_its_deadline_with_no_live_owner():
    b = Broker()
    b.create_topic(IN, partitions=4)
    _publish(t_sim, b)
    cluster = t_gateway.GatewayCluster(b, n_shards=2, standbys=False).start()
    client = t_gateway.GatewayClient(cluster, retry_deadline_s=0.3)
    try:
        _await(lambda: client.count() == 8, what="shards drained")
        car = next(c for c in client.cars() if client.shard_of(c) == 0)
        cluster.kill_shard(0)
        with pytest.raises(t_gateway.GatewayError, match="no live owner"):
            client.get(car)
        with pytest.raises(ValueError, match="no standby"):
            cluster.promote(0)
    finally:
        client.close()
        cluster.stop()


def test_gateway_metric_families_equal_jax():
    from iotml_torch.obs import metrics as t_metrics

    def describe(m):
        return (type(m).__name__, m.name, m.help)

    for n in ("gateway_promotions", "gateway_standby_lag"):
        assert describe(getattr(t_shards, n)) == \
            describe(getattr(j_shards, n))
        assert getattr(t_shards, n).name in \
            t_metrics.default_registry._metrics
    assert t_shards.GatewayCluster.PROMOTE_SLO_S == \
        j_shards.GatewayCluster.PROMOTE_SLO_S
    assert t_drill.STALENESS_SLO_S == j_drill.STALENESS_SLO_S
    b = Broker()
    b.create_topic(IN, partitions=4)
    _publish(t_sim, b)
    cluster = t_gateway.GatewayCluster(b, n_shards=2).start()
    try:
        before = t_shards.gateway_promotions.value(shard="1")
        _await(lambda: cluster.standbys[1].lag() == 0,
               what="standby catch-up")
        cluster.kill_shard(1)
        cluster.promote(1)
        assert t_shards.gateway_promotions.value(shard="1") == before + 1
        _await(lambda: t_shards.gateway_standby_lag.value(shard="1") == 0,
               what="lag gauge set")
    finally:
        cluster.stop()


# ---------------------------------------------------- federation
def test_federated_fleet_small_end_to_end():
    """Two front PROCESSES of each package over its wire server, one keyed
    stream, a sharded gateway answering for cars of every front; the
    reports equal but the wall time and the port's codec name."""
    got = {}
    for kind, (gw, *_rest) in PKGS.items():
        report = gw.run_federated_fleet(cars=40, fronts=2, ticks=1,
                                        shards=2, partitions=4,
                                        probe_per_front=2, timeout_s=120.0)
        assert report["ok"], (kind, report)
        report.pop("elapsed_s")
        got[kind] = report
    assert got["port"].pop("codec") == "native"
    assert got["port"] == got["jax"]
    assert got["port"]["published"] == got["port"]["folded"] == 40
    assert got["port"]["fleet_cars_served"] == 40
    assert got["port"]["native_fronts"] == 2
    assert got["port"]["per_front_lookups_ok"] == [True, True]


# ------------------------------------------------------------ the drill
DETERMINISTIC = ("seed", "records", "cars", "n_shards", "published",
                 "killed_shard")


def test_gateway_drill_equals_jax():
    """The drill at seed 11 / 600 records / 20 cars: the port's report
    passes, and its deterministic fields equal JAX's (its verdicts too
    where JAX's run passes)."""
    t = t_drill.run_gateway_drill(seed=11, records=600, cars=20)
    j = j_drill.run_gateway_drill(seed=11, records=600, cars=20)
    assert t.ok, [i.detail for i in t.invariants if not i.ok]
    assert t.storm_wrong == t.storm_errors == 0 and t.storm_queries >= 200
    assert t.slos["promote_s"] < t_shards.GatewayCluster.PROMOTE_SLO_S
    for f in DETERMINISTIC:
        assert getattr(t, f) == getattr(j, f), f
    assert [i.name for i in t.invariants] == [i.name for i in j.invariants]
    if j.ok:
        assert [i.ok for i in t.invariants] == [i.ok for i in j.invariants]
    assert set(t.to_dict()) == set(j.to_dict())


def _slow_changelog(monkeypatch, broker_cls, log_cls, delay_s=1.0):
    """Delay every changelog produce: the gap a twin shard leaves between
    folding a pass into its table and producing the pass's changelog.
    Returns the changelog rolls made by another thread while such a
    produce was in flight."""
    real_produce, real_roll = broker_cls.produce_many, log_cls.roll
    inflight, raced = {}, []  # partition -> the thread producing into it

    def produce_many(self, topic, entries, partition=None, **kw):
        if topic != "CAR_TWIN":
            return real_produce(self, topic, entries, partition=partition,
                                **kw)
        inflight[partition] = threading.get_ident()
        try:
            time.sleep(delay_s)
            return real_produce(self, topic, entries, partition=partition,
                                **kw)
        finally:
            inflight.pop(partition, None)

    def roll(self):
        if os.path.basename(os.path.dirname(self.dir)) == "CAR_TWIN":
            owner = inflight.get(int(os.path.basename(self.dir)))
            if owner is not None and owner != threading.get_ident():
                raced.append(self.dir)
        return real_roll(self)

    monkeypatch.setattr(broker_cls, "produce_many", produce_many)
    monkeypatch.setattr(log_cls, "roll", roll)
    return raced


def test_drill_barrier_holds_under_a_fold_to_changelog_delay(monkeypatch):
    """With the changelog delayed after each fold, JAX's drill rolls the
    changelog while a shard's append is in flight and fails
    ``standby_byte_identical`` (its barriers pass between the fold and
    the changelog); the port's, which also waits for the primaries'
    source commits, rolls with no append in flight and passes every
    invariant."""
    from iotml.store import log as j_log
    from iotml_torch.store import log as t_log

    j_raced = _slow_changelog(monkeypatch, JBroker, j_log.SegmentedLog)
    t_raced = _slow_changelog(monkeypatch, Broker, t_log.SegmentedLog)
    j = j_drill.run_gateway_drill(seed=11, records=600, cars=20)
    t = t_drill.run_gateway_drill(seed=11, records=600, cars=20)
    verdicts = {i.name: i.ok for i in j.invariants}
    assert not verdicts["standby_byte_identical"]
    assert j_raced
    assert t.ok, [i.detail for i in t.invariants if not i.ok]
    assert t_raced == []


def test_cli_drill_prints_what_jax_prints():
    from iotml.gateway.__main__ import main as j_main

    argv = ["drill", "--seed", "11", "--records", "600", "--cars", "20",
            "--json"]
    outs = []
    for main in (t_main, j_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        outs.append((rc, json.loads(buf.getvalue())))
    (t_rc, t_doc), (j_rc, j_doc) = outs
    assert t_rc == 0 and t_doc["ok"] is True
    assert set(t_doc) == set(j_doc)
    for f in DETERMINISTIC:
        assert t_doc[f] == j_doc[f], f
    assert [i["name"] for i in t_doc["invariants"]] == \
        [i["name"] for i in j_doc["invariants"]]


def test_front_process_runs_the_port():
    """A front child runs ``python -m iotml_torch.gateway front``,
    announces its native front's port, and exits on EOF with its
    forwarded count."""
    from iotml_torch.stream.kafka_wire import KafkaWireServer

    b = Broker()
    b.create_topic(IN, partitions=2)
    wire = KafkaWireServer(b).start()
    try:
        proc = t_gateway.FrontProcess(f"127.0.0.1:{wire.port}",
                                      partitions=2)
        assert "iotml_torch.gateway" in proc.proc.args
        assert proc.native and proc.mqtt_port > 0
        assert proc.stop() == 0
        assert proc.proc.returncode == 0
    finally:
        wire.shutdown()
        wire.server_close()


# ---------------------------------------------- the scorer's sharded join
def _joined_params(seed=0):
    model = JDenseAutoencoder(input_dim=F + F + 2)
    trainer = JTrainer(model, rng=jax.random.PRNGKey(seed))
    trainer._ensure_state(np.zeros((100, F + F + 2), np.float32))
    tree = jax.tree.map(np.asarray, trainer.state.params)
    return model, tree, params_from_jax(tree)


def _parse(msg):
    parts = (msg if isinstance(msg, str) else msg.decode()).split("|")
    return np.array(parts[0].strip("[]").split(), np.float64), parts[1:]


@pytest.mark.parametrize("threshold", [None, 0.02])
def test_scorer_joins_through_the_gateway_as_jax(threshold):
    """Each package's StreamScorer joins through its own GatewayClient;
    the joined rows are bit-equal to a local TwinFeatureStore join, and
    the port's payloads and errors equal JAX's."""
    model, tree, params = _joined_params()
    runs = {}
    for kind, (gw, twin, broker_cls, sim, *_rest) in PKGS.items():
        b = broker_cls()
        b.create_topic(IN, partitions=4)
        published = _publish(sim, b, n_ticks=8)
        specs = [f"{IN}:{p}:0" for p in range(4)]
        mask = np.ones((F,), bool)
        with _cluster(gw, b) as (cluster, client):
            _await(lambda: client.aggregate()["records"] == published,
                   what="shards drained")
            # the reference pumps the source itself: it needs no barrier
            ref = twin.TwinService(b, group="gw-test-ref", changelog=False)
            while ref.pump_once():
                pass
            fs = twin.TwinFeatureStore(ref)
            if kind == "port":
                batches = SensorBatches(
                    StreamConsumer(b, specs, group="gw-scorer"),
                    batch_size=100, keep_keys=True)
                out = OutputSequence(b, "model-predictions", partition=0)
                scorer = t_scorer.StreamScorer(
                    AutoencoderSpec(input_dim=F + client.dim), params,
                    batches, out, feature_store=client, verdict_mask=mask,
                    threshold=threshold, device="cpu")
            else:
                batches = JSensorBatches(
                    JStreamConsumer(b, specs, group="gw-scorer"),
                    batch_size=100, keep_keys=True)
                out = JOutputSequence(b, "model-predictions", partition=0)
                scorer = JStreamScorer(model, tree, batches, out,
                                       feature_store=client,
                                       verdict_mask=mask,
                                       threshold=threshold)
            scored = scorer.score_available()
            replay = (SensorBatches if kind == "port" else JSensorBatches)(
                (StreamConsumer if kind == "port" else JStreamConsumer)(
                    b, specs, group="gw-replay"), batch_size=100,
                keep_keys=True)
            joined = []
            for x in replay:
                remote = client.matrix(x.keys, x.x.shape[0])
                np.testing.assert_array_equal(
                    remote, fs.matrix(x.keys, x.x.shape[0]))
                joined.append(remote[: x.n_valid])
        assert scored == published == b.end_offset("model-predictions", 0)
        rows = [m.value for m in b.fetch("model-predictions", 0, 0, 1 << 30)]
        runs[kind] = (rows, np.concatenate(joined), scorer.quality)
    t_rows, t_joined, t_quality = runs["port"]
    j_rows, j_joined, j_quality = runs["jax"]
    np.testing.assert_array_equal(t_joined, j_joined)
    assert t_joined.any()
    assert t_quality == j_quality
    assert len(t_rows) == len(j_rows) > 0
    for tm, jm in zip(t_rows, j_rows):
        t_vals, t_tail = _parse(tm)
        j_vals, j_tail = _parse(jm)
        assert t_vals.shape == j_vals.shape == (F + F + 2,)
        np.testing.assert_allclose(t_vals, j_vals, rtol=0, atol=1e-6)
        if threshold is None:
            assert t_tail == j_tail == []
        else:
            t_err, j_err = float(t_tail[1]), float(j_tail[1])
            if abs(j_err - threshold) > 1e-4:
                assert t_tail[0] == j_tail[0]
            np.testing.assert_allclose(t_err, j_err, rtol=1e-5, atol=1e-6)
