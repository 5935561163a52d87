"""The port's partition-parallel streaming trainer
(``iotml_torch.parallel.streaming``) and the mesh modes of the live
trainer, the online learner and the knobs, held against the JAX
package's on the CPU: the cases of ``tests/test_multichip.py`` on both
packages (but its ``bench.py`` table test), the port's CPU shards
standing where the JAX suite has virtual devices.

Both packages read the same records (generated once, copied into a JAX
broker) and start from the same params (the JAX init, converted).
Tolerances: step losses, per-device losses and params rtol 1e-4 /
atol 1e-6; the device-normalized step within JAX's own pins (first step
5e-6, whole run 5e-4, the map 4e-5); partitions, cursors, counts and
messages equal.
"""

import os

import jax
import numpy as np
import pytest
import torch

from iotml.core.normalize import CAR_NORMALIZER as J_CAR_NORMALIZER
from iotml.mlops import ModelRegistry as JModelRegistry
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml.online.detectors import DriftMonitor as JDriftMonitor
from iotml.online.learner import OnlineLearner as JOnlineLearner
from iotml.parallel import mesh as j_mesh
from iotml.parallel import streaming as j_streaming
from iotml.stream.broker import Broker as JBroker
from iotml.train.live import ContinuousTrainer as JContinuousTrainer
from iotml_torch.core.normalize import CAR_NORMALIZER, RAW_COLUMNS
from iotml_torch.data.dataset import Batch
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.mlops import ModelRegistry
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.models.convert import params_from_jax
from iotml_torch.online.detectors import ADAPTING, DriftMonitor
from iotml_torch.online.learner import OnlineLearner, _padded_shard_counts
from iotml_torch.parallel.distributed import assign_partitions
from iotml_torch.parallel.mesh import batch_sharding, make_mesh
from iotml_torch.parallel.streaming import (MeshFeeds, ShardedStreamTrainer,
                                            bench_leg, data_axis_devices,
                                            leg_record, shard_mean_losses)
from iotml_torch.stream.broker import Broker
from iotml_torch.train.live import ContinuousTrainer
from iotml_torch.train.loop import TrainState
from iotml_torch.train.optim import Adam

TOL = dict(rtol=1e-4, atol=1e-6)
CPU = torch.device("cpu")


def _fill(broker, topic="S", n_ticks=100, partitions=8, num_cars=50,
          failure_rate=0.01, jax_broker=None):
    """Publish a fleet into the port's broker (and the same records into
    ``jax_broker``); returns the count."""
    n = FleetGenerator(FleetScenario(
        num_cars=num_cars, failure_rate=failure_rate)).publish(
        broker, topic, n_ticks=n_ticks, partitions=partitions)
    if jax_broker is not None:
        jax_broker.create_topic(topic, partitions=partitions)
        for p in range(partitions):
            for m in broker.fetch(topic, p, 0, broker.end_offset(topic, p)):
                jax_broker.produce(topic, m.value, key=m.key, partition=p,
                                   timestamp_ms=m.timestamp_ms)
    return n


def _mesh(n):
    return make_mesh((n,), ("data",), devices=[CPU] * n)


def _j_mesh(n):
    return j_mesh.make_mesh((n,), ("data",), devices=jax.devices()[:n])


def _j_params():
    return J_AE.init(jax.random.PRNGKey(0),
                     np.zeros((1, 18), np.float32))["params"]


def _jax_init_state():
    params = params_from_jax(_j_params())
    return TrainState(step=0, params=params, opt_state=Adam().init(params))


def _assert_params(t_params, j_params):
    for k, v in params_from_jax(jax.device_get(j_params)).items():
        np.testing.assert_allclose(t_params[k].numpy(), v.numpy(), **TOL,
                                   err_msg=k)


# ------------------------------------------------- partition assignment
def test_assign_partitions_disjoint_exhaustive():
    for n_parts in (1, 3, 8, 10, 16):
        for n_dev in (1, 2, 4, 8):
            subsets = [assign_partitions(n_parts, n_dev, d)
                       for d in range(n_dev)]
            assert subsets == [j_streaming.assign_partitions(n_parts, n_dev,
                                                             d)
                               for d in range(n_dev)]
            flat = [p for s in subsets for p in s]
            assert sorted(flat) == list(range(n_parts))
            assert len(flat) == len(set(flat))


def test_mesh_feeds_static_ownership_and_coverage():
    """4 feeds over 8 partitions: JAX's ownership, and a full drain takes
    every record once."""
    broker, jb = Broker(), JBroker()
    n = _fill(broker, n_ticks=40, jax_broker=jb)
    feeds = MeshFeeds(broker, "S", 4, group="own", only_normal=False,
                      batch_size=50)
    j_feeds = j_streaming.MeshFeeds(jb, "S", 4, group="own",
                                    only_normal=False, batch_size=50)
    assert feeds.partitions == j_feeds.partitions
    assert set().union(*map(set, feeds.partitions)) == set(range(8))
    total = rows = 0
    for row in feeds.rounds():
        total += sum(b.n_valid for b in row if b is not None)
        rows += 1
    j_total = j_rows = 0
    for row in j_feeds.rounds():
        j_total += sum(b.n_valid for b in row if b is not None)
        j_rows += 1
    assert total == j_total == n and rows == j_rows
    assert feeds.positions() == j_feeds.positions()
    feeds.close()
    j_feeds.close()


def test_feed_rebalance_member_death_stays_disjoint_exhaustive():
    """Group mode under a member's death (never driven again, never
    leaving): after its session expires the survivors' subsets are
    disjoint and exhaustive, the dead feed's partitions move, records
    keep flowing, and the survivors' subset sizes are JAX's (member ids
    are random, so which survivor holds which range is not)."""
    from iotml.stream.group import GroupCoordinator as JGroupCoordinator
    from iotml_torch.stream.group import GroupCoordinator

    finals = []
    for pkg, B, Coord, Feeds in (
            ("port", Broker, GroupCoordinator, MeshFeeds),
            ("jax", JBroker, JGroupCoordinator, j_streaming.MeshFeeds)):
        clock = [0.0]
        broker = B()
        if pkg == "port":
            _fill(broker, n_ticks=40)
        else:
            _fill(Broker(), n_ticks=40, jax_broker=broker)
        coord = Coord(broker, "mesh-elastic", session_timeout_s=5.0,
                      clock=lambda: clock[0])
        feeds = Feeds(broker, "S", 4, group="mesh-elastic",
                      coordinator=coord, only_normal=False, batch_size=50)
        flat = [tp for a in feeds.assignments() for tp in a]
        assert len(flat) == 8 and len(set(flat)) == 8
        for c in feeds.consumers:
            c.poll(60)
        dead = 2
        dead_parts = set(feeds.consumers[dead].assignment)
        survivors = [c for i, c in enumerate(feeds.consumers) if i != dead]
        for _ in range(14):
            clock[0] += 0.5
            for c in survivors:
                c.poll(1)
        for c in survivors:
            c.poll(1)
        live = [sorted(c.assignment) for c in survivors]
        flat = [tp for a in live for tp in a]
        assert sorted(flat) == [("S", p) for p in range(8)], live
        assert len(flat) == len(set(flat))
        assert set(flat) & dead_parts == dead_parts
        drained = 0
        for _ in range(200):
            got = sum(len(c.poll(256)) for c in survivors)
            drained += got
            if not got:
                break
        assert drained > 0
        finals.append(sorted(len(a) for a in live))
    assert finals[0] == finals[1]  # the same range split of 8 over 3


# ---------------------------------------------- prefetcher placement
def test_prefetcher_whole_batch_follows_sharding():
    """x, y and the mask all land cut over the data axis, each shard on
    its device; padding rows carry mask 0."""
    from iotml_torch.data.prefetch import DevicePrefetcher

    sharding = batch_sharding(_mesh(4))
    bs = [Batch(x=np.full((10, 18), i, np.float32), n_valid=6,
                first_index=0, y=np.ones((10, 18), np.float32))
          for i in range(2)]
    seen = 0
    for (x, y, mask), b in DevicePrefetcher(iter(bs), sharding=sharding):
        for arr in (x, y, mask):
            assert arr.sharding is sharding and len(arr.shards) == 4
            assert arr.shape[0] == 12  # 10 rows padded to 4 x 3
            assert all(s.device == CPU for s in arr.shards)
        assert float(mask.numpy().sum()) == b.n_valid
        np.testing.assert_array_equal(x.numpy()[:10], b.x)
        assert not x.numpy()[10:].any()
        seen += 1
    assert seen == 2
    with pytest.raises(ValueError, match="not both"):
        DevicePrefetcher(iter(bs), to_device=lambda b: b, sharding=sharding)


def test_global_put_lands_shards_on_their_devices():
    broker = Broker()
    _fill(broker, n_ticks=20)
    mesh = _mesh(4)
    feeds = MeshFeeds(broker, "S", 4, group="placement", batch_size=10,
                      only_normal=False)
    tr = ShardedStreamTrainer(CAR_AUTOENCODER, mesh, feeds)
    shards = [np.full((10, 18), float(d), np.float32) for d in range(4)]
    arr = tr._global_put(shards)
    assert arr.shape == (40, 18)
    devs = data_axis_devices(mesh)
    for d, (piece, dev) in enumerate(zip(arr.shards, devs)):
        assert piece.device == dev
        assert bool((piece == float(d)).all())


# ------------------------------------------- device-side normalization
def _stream_losses(broker, mesh, device_normalize, group, rounds=4,
                   feeds_cls=MeshFeeds, trainer_cls=ShardedStreamTrainer,
                   model=CAR_AUTOENCODER, normalizer=CAR_NORMALIZER):
    feeds = feeds_cls(broker, "S", 4, group=group, batch_size=50,
                      take_batches=3, only_normal=True,
                      device_normalize=device_normalize)
    tr = trainer_cls(model, mesh, feeds,
                     normalizer=normalizer if device_normalize else None)
    if trainer_cls is ShardedStreamTrainer:
        tr.state = _jax_init_state()
    losses = []
    for _ in range(rounds):
        losses.extend(tr.fit_round()["step_loss"])
    return losses, tr


def test_device_normalize_bit_comparable_losses():
    """Device-side normalization against the host-normalized baseline,
    within JAX's own pins, and each mode against JAX's."""
    broker, jb = Broker(), JBroker()
    _fill(broker, n_ticks=60, failure_rate=0.0, jax_broker=jb)
    host, _ = _stream_losses(broker, _mesh(4), False, "norm-host")
    dev, _ = _stream_losses(broker, _mesh(4), True, "norm-dev")
    assert len(host) == len(dev) and len(host) >= 8
    diffs = np.abs(np.asarray(host) - np.asarray(dev))
    assert diffs[0] <= 5e-6, (host[0], dev[0])
    assert diffs.max() <= 5e-4, diffs
    j_dev, _ = _stream_losses(jb, _j_mesh(4), True, "norm-dev",
                              feeds_cls=j_streaming.MeshFeeds,
                              trainer_cls=j_streaming.ShardedStreamTrainer,
                              model=J_AE, normalizer=J_CAR_NORMALIZER)
    np.testing.assert_allclose(dev, j_dev, **TOL)
    raw = np.random.default_rng(0).uniform(-40, 260,
                                           (64, 18)).astype(np.float32)
    host_norm = CAR_NORMALIZER.np(raw)
    from iotml_torch.parallel.data_parallel import \
        make_device_normalized_step
    fold = make_device_normalized_step(lambda _s, x, _y, _m: x,
                                       CAR_NORMALIZER)
    t = torch.from_numpy(raw)
    dev_norm = fold(None, t, t, None).numpy()
    assert np.abs(host_norm - dev_norm).max() <= 4e-5


def test_device_normalized_step_matches_jax():
    """``make_device_normalized_step`` over the single-device step equals
    JAX's over its raw step, on raw columns, within the ~1-ulp pin."""
    from iotml.parallel.data_parallel import \
        make_device_normalized_step as j_make
    from iotml.train.loop import TrainState as JTrainState
    from iotml.train.loop import make_raw_train_step as j_raw
    from iotml_torch.parallel.data_parallel import \
        make_device_normalized_step
    from iotml_torch.train.loop import make_raw_train_step

    import optax

    raw = np.random.default_rng(2).uniform(-40, 260,
                                           (50, 18)).astype(np.float32)
    mask = np.ones((50,), np.float32)
    tx = optax.adam(1e-3)
    j_state = JTrainState.create(J_AE, jax.random.PRNGKey(0), raw, tx=tx)
    j_step = j_make(j_raw(J_AE, tx), J_CAR_NORMALIZER)
    _, jm = j_step(j_state, raw, raw, mask)
    model = CAR_AUTOENCODER.build("cpu")
    step = make_device_normalized_step(make_raw_train_step(model, Adam()),
                                       CAR_NORMALIZER)
    x = torch.from_numpy(raw)
    _, tm = step(_jax_init_state(), x, x, torch.from_numpy(mask))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=5e-6, atol=5e-6)


def test_raw_columns_normalizer_is_passthrough():
    x = np.random.default_rng(1).normal(size=(5, 18)).astype(np.float32)
    out = RAW_COLUMNS.np(x)
    assert out is x  # a cast-only view: no host work
    assert torch.equal(RAW_COLUMNS(x), torch.from_numpy(x))


# ----------------------------------------------------- sharded training
def test_sharded_stream_trainer_trains_and_tracks():
    """Step losses, per-device losses, cursors and params as JAX's from
    the same init and records."""
    broker, jb = Broker(), JBroker()
    n = _fill(broker, n_ticks=120, failure_rate=0.0, jax_broker=jb)
    runs = []
    for feeds_cls, trainer_cls, model, b, mesh, norm in (
            (MeshFeeds, ShardedStreamTrainer, CAR_AUTOENCODER, broker,
             _mesh(4), CAR_NORMALIZER),
            (j_streaming.MeshFeeds, j_streaming.ShardedStreamTrainer, J_AE,
             jb, _j_mesh(4), J_CAR_NORMALIZER)):
        feeds = feeds_cls(b, "S", 4, group="train", batch_size=50,
                          only_normal=True, device_normalize=True)
        tr = trainer_cls(model, mesh, feeds, normalizer=norm)
        if trainer_cls is ShardedStreamTrainer:
            tr.state = _jax_init_state()
        runs.append((tr.fit_round(), tr, feeds))
    (h, tr, feeds), (jh, jtr, j_feeds) = runs
    assert h["records"][0] == jh["records"][0] == n
    assert h["steps"] == jh["steps"]
    assert h["step_loss"][-1] < h["step_loss"][0]
    np.testing.assert_allclose(h["step_loss"], jh["step_loss"], **TOL)
    assert feeds.positions() == j_feeds.positions()
    assert all(off > 0 for _t, _p, off in feeds.positions())
    assert tr.last_shard_losses is not None and \
        len(tr.last_shard_losses) == 4
    np.testing.assert_allclose(tr.last_shard_losses, jtr.last_shard_losses,
                               **TOL)
    _assert_params(tr.state.params, jtr.state.params)
    assert tr.records_trained == jtr.records_trained == n


def test_dry_feed_zero_shard_matches_jax():
    """3 partitions over 2 feeds: feed 1 owns one partition and runs dry
    first, then contributes zero shards (mask 0; the activity penalty
    still counts their rows) — losses and params as JAX's."""
    broker, jb = Broker(), JBroker()
    _fill(broker, n_ticks=30, partitions=3, failure_rate=0.0,
          jax_broker=jb)
    runs = []
    for feeds_cls, trainer_cls, model, b, mesh in (
            (MeshFeeds, ShardedStreamTrainer, CAR_AUTOENCODER, broker,
             _mesh(2)),
            (j_streaming.MeshFeeds, j_streaming.ShardedStreamTrainer, J_AE,
             jb, _j_mesh(2))):
        probe = feeds_cls(b, "S", 2, group="dry-probe", batch_size=40,
                          only_normal=True)
        rows = [[x is None for x in row] for row in probe.rounds()]
        probe.close()
        feeds = feeds_cls(b, "S", 2, group="dry", batch_size=40,
                          only_normal=True)
        tr = trainer_cls(model, mesh, feeds)
        if trainer_cls is ShardedStreamTrainer:
            tr.state = _jax_init_state()
        runs.append((rows, tr.fit_round(), tr))
    (rows, h, tr), (j_rows, jh, jtr) = runs
    assert rows == j_rows and any(r[1] for r in rows)  # zero shards
    np.testing.assert_allclose(h["step_loss"], jh["step_loss"], **TOL)
    np.testing.assert_allclose(tr.last_shard_losses, jtr.last_shard_losses,
                               **TOL)
    _assert_params(tr.state.params, jtr.state.params)


def test_feeds_device_normalize_requires_step_normalizer():
    broker = Broker()
    _fill(broker, n_ticks=5)
    feeds = MeshFeeds(broker, "S", 2, group="guard", device_normalize=True)
    with pytest.raises(ValueError, match="raw columns"):
        ShardedStreamTrainer(CAR_AUTOENCODER, _mesh(2), feeds)
    with pytest.raises(ValueError, match="one feed per data-axis device"):
        ShardedStreamTrainer(CAR_AUTOENCODER, _mesh(4), feeds,
                             normalizer=CAR_NORMALIZER)


def test_streaming_mesh_refuses_model_axis():
    mesh = make_mesh((4, 2), ("data", "model"), devices=[CPU] * 8)
    with pytest.raises(ValueError, match="data-parallel") as t_err:
        data_axis_devices(mesh)
    with pytest.raises(ValueError) as j_err:
        j_streaming.data_axis_devices(j_mesh.make_mesh(
            (4, 2), ("data", "model"), devices=jax.devices()[:8]))
    assert str(t_err.value) == str(j_err.value)


# -------------------------------------- continuous trainer integration
def test_continuous_trainer_mesh_manifest_is_atomic(tmp_path):
    """One manifest stamps every feed's partition cursors, committed
    trails it, a second incarnation resumes from it — and the stamps are
    JAX's."""
    broker, jb = Broker(), JBroker()
    _fill(broker, n_ticks=200, jax_broker=jb)
    stamps = []
    for tag, CT, Reg, b, mesh in (
            ("port", ContinuousTrainer, ModelRegistry, broker, _mesh(4)),
            ("jax", JContinuousTrainer, JModelRegistry, jb, _j_mesh(4))):
        reg = Reg(str(tmp_path / tag))
        tr = CT(b, "S", None, registry=reg, mesh=mesh,
                device_normalize=True, take_batches=4, batch_size=50)
        assert tr.train_round()["records"] > 0
        v = tr.checkpointer.write_once()
        m = reg.manifest(v)
        assert {(t, p) for t, p, _ in m.offsets} == \
            {("S", p) for p in range(8)}
        for t, p, off in m.offsets:
            assert (b.committed(tr.group, t, p) or 0) <= off
        tr.close()
        tr2 = CT(b, "S", None, registry=reg, mesh=mesh,
                 device_normalize=True, take_batches=4, batch_size=50)
        assert tr2.restored_version == v
        pos = {(t, p): o for t, p, o in tr2.consumer.positions()}
        for t, p, off in m.offsets:
            assert pos[(t, p)] >= off
        tr2.close()
        stamps.append(sorted(m.offsets))
    assert [tuple(o) for o in stamps[0]] == [tuple(o) for o in stamps[1]]


def test_continuous_trainer_mesh_rounds_match_jax(tmp_path):
    """Three store-mode rounds over the mesh: the round losses, records,
    committed cursors and params are JAX's from the same init."""
    from iotml.train.artifacts import ArtifactStore as JArtifactStore
    from iotml_torch.train.artifacts import ArtifactStore

    broker, jb = Broker(), JBroker()
    _fill(broker, n_ticks=120, jax_broker=jb)
    tr = ContinuousTrainer(broker, "S", ArtifactStore(str(tmp_path / "t")),
                           mesh=_mesh(4), device_normalize=True,
                           take_batches=3, batch_size=50)
    tr.trainer.state = _jax_init_state()
    jtr = JContinuousTrainer(jb, "S", JArtifactStore(str(tmp_path / "j")),
                             mesh=_j_mesh(4), device_normalize=True,
                             take_batches=3, batch_size=50)
    assert tr.min_available == jtr.min_available == int(600 * 1.1) + 1
    for _ in range(3):
        t, j = tr.train_round(), jtr.train_round()
        assert t["records"] == j["records"] > 0
        np.testing.assert_allclose(t["loss"], j["loss"], **TOL)
        assert t["artifact"] == j["artifact"]
    for p in range(8):
        assert broker.committed(tr.group, "S", p) == \
            jb.committed(jtr.group, "S", p)
    _assert_params(tr.trainer.state.params, jtr.trainer.state.params)


def test_continuous_trainer_mesh_rejects_multi_epoch_rounds():
    broker = Broker()
    _fill(broker, n_ticks=5)
    with pytest.raises(ValueError, match="single-epoch"):
        ContinuousTrainer(broker, "S", None, registry=object(),
                          mesh=_mesh(2), epochs_per_round=2)
    with pytest.raises(ValueError, match="needs a mesh"):
        ContinuousTrainer(broker, "S", None, registry=object(),
                          device_normalize=True)
    with pytest.raises(ValueError, match="mesh or device"):
        ContinuousTrainer(broker, "S", None, registry=object(),
                          mesh=_mesh(2), device="cpu")


# ------------------------------------------------ online per-chip drift
def _chip_windows(seed=0):
    rng = np.random.default_rng(seed)

    def window(chip_spike=None):
        x = rng.normal(0, 0.1, (100, 18)).astype(np.float32)
        if chip_spike is not None:
            x[chip_spike * 25:(chip_spike + 1) * 25] += 60.0
        return x

    return [window() for _ in range(16)] + \
        [window(chip_spike=3) for _ in range(8)]


def test_online_mesh_per_chip_drift_coordinates_one_episode():
    """A shard-local drift trips that shard's monitor while the blind
    global monitor stays quiet: ONE episode, tagged with the shard,
    boosted, a forced publish staged — and the windows' losses, the
    per-device losses and the adaptations are JAX's."""
    from iotml.data.dataset import Batch as JBatch

    out = []
    for pkg in ("port", "jax"):
        if pkg == "port":
            broker = Broker()
            _fill(broker, n_ticks=10)
            lr = OnlineLearner(
                broker, "S", mesh=_mesh(4), device_normalize=True,
                window=100, monitor=DriftMonitor(detector="ph",
                                                 ph_threshold=1e9,
                                                 level_ratio=0),
                chip_monitors=[DriftMonitor(burn_in=4) for _ in range(4)])
            lr.trainer._ensure_state()
            init = _jax_init_state()
            lr.trainer.state = TrainState(
                step=0, params=init.params,
                opt_state=lr.trainer.state.opt_state)
            batch = Batch
        else:
            jb = JBroker()
            _fill(Broker(), n_ticks=10, jax_broker=jb)
            lr = JOnlineLearner(
                jb, "S", mesh=_j_mesh(4), device_normalize=True,
                window=100, monitor=JDriftMonitor(detector="ph",
                                                  ph_threshold=1e9,
                                                  level_ratio=0),
                chip_monitors=[JDriftMonitor(burn_in=4) for _ in range(4)])
            batch = JBatch
        losses, chips = [], []
        for i, x in enumerate(_chip_windows()):
            loss = lr._update(batch(x=x, n_valid=100, first_index=0))
            lr._after_update(loss)
            losses.append(loss)
            chips.append(np.asarray(lr.last_chip_losses))
            if i == 15:
                assert lr.adaptations == []
        out.append((lr, losses, chips))
    (lr, losses, chips), (jlr, j_losses, j_chips) = out
    assert len(lr.adaptations) == 1, lr.adaptations
    _idx, signal, _action = lr.adaptations[0]
    assert signal.startswith("chip3-"), signal
    assert lr.monitor.state == ADAPTING
    assert lr.current_lr > lr.base_lr
    assert lr._publish_pending and lr._publish_force
    assert [tuple(a) for a in lr.adaptations] == \
        [tuple(a) for a in jlr.adaptations]
    np.testing.assert_allclose(losses, j_losses, **TOL)
    np.testing.assert_allclose(np.stack(chips), np.stack(j_chips), **TOL)
    assert lr.current_lr == pytest.approx(jlr.current_lr)


def test_online_mesh_trains_from_stream():
    broker, jb = Broker(), JBroker()
    n = _fill(broker, n_ticks=60, failure_rate=0.0, jax_broker=jb)
    lr = OnlineLearner(broker, "S", mesh=_mesh(4), device_normalize=True,
                       window=100)
    got = lr.process_available()
    assert got > 0 and lr.records_trained == n
    assert lr.last_chip_losses is not None and len(lr.last_chip_losses) == 4
    d = lr.describe()
    assert len(d["chips"]) == 4
    jlr = JOnlineLearner(jb, "S", mesh=_j_mesh(4), device_normalize=True,
                         window=100)
    assert jlr.process_available() == got
    assert jlr.records_trained == n and set(jlr.describe()) == set(d)


def test_padded_shard_counts_match_jax():
    from iotml.online.learner import _padded_shard_counts as j_counts

    for b, valid, shards in ((100, 100, 8), (100, 61, 8), (10, 3, 4),
                             (7, 7, 2)):
        mask = np.zeros((b,), np.float32)
        mask[:valid] = 1.0
        assert _padded_shard_counts(mask, shards) == \
            j_counts(mask, shards)


def test_cardata_cli_honors_mesh_knob_env(tmp_path, monkeypatch, capsys):
    """The deploy manifests' contract: IOTML_MESH_DATA=N trains over an
    N-shard data axis, as JAX's CLI prints it."""
    from iotml_torch.cli import cardata

    monkeypatch.setenv("IOTML_MESH_DATA", "2")
    rc = cardata.main(["--train.epochs=1", "--train.take_batches=2",
                       "--train.batch_size=50", "emulator:500",
                       "SENSOR_DATA_S_AVRO", "0", "model-predictions",
                       "train", "mesh-knob-model", str(tmp_path / "arts")],
                      device="cpu", devices=[CPU] * 2)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "mesh: {'data': 2, 'model': 1} over 2 devices" in out, out


# --------------------------------------------------------------- knobs
def test_mesh_knobs_never_leak_into_config_tree():
    from iotml.config import load_config as j_load
    from iotml_torch.config import load_config

    for load in (load_config, j_load):
        cfg, _ = load(argv=[], env={"IOTML_MESH_DATA": "4",
                                    "IOTML_DEVICE_NORMALIZE": "1"})
        clean, _ = load(argv=[], env={})
        assert cfg.as_dict() == clean.as_dict()
        assert cfg.applied == set()


def test_mesh_knob_validation(monkeypatch):
    from iotml.data import pipeline as j_pl
    from iotml_torch.data import pipeline as pl

    for mod in (pl, j_pl):
        monkeypatch.setenv("IOTML_MESH_DATA", "4")
        monkeypatch.setenv("IOTML_DEVICE_NORMALIZE", "1")
        assert mod.mesh_data() == 4
        assert mod.device_normalize() is True
        monkeypatch.setenv("IOTML_MESH_DATA", "-1")
        with pytest.raises(ValueError):
            mod.mesh_data()
        monkeypatch.setenv("IOTML_DEVICE_NORMALIZE", "maybe")
        with pytest.raises(ValueError):
            mod.device_normalize()
        monkeypatch.delenv("IOTML_MESH_DATA")
        monkeypatch.delenv("IOTML_DEVICE_NORMALIZE")
        assert mod.mesh_data() == 0
        assert mod.device_normalize() is False
        with pytest.raises(ValueError):
            mod.set_knobs(mesh_data=-2)
        assert "IOTML_MESH_DATA" not in os.environ
        mod.set_knobs(mesh_data=2, device_normalize=True)
        try:
            assert mod.mesh_data() == 2 and mod.device_normalize() is True
        finally:
            os.environ.pop("IOTML_MESH_DATA", None)
            os.environ.pop("IOTML_DEVICE_NORMALIZE", None)


# --------------------------------------------------------- bench schema
def test_bench_leg_matches_shared_schema():
    leg = bench_leg(2, records=2000, warmup_records=1000, batch_size=50,
                    devices=[CPU] * 2)
    shared = {"leg", "devices", "records", "seconds", "records_per_sec",
              "loss_first", "loss_last"}
    assert shared <= set(leg)
    assert leg["devices"] == 2 and leg["records"] > 0
    assert leg["records_per_sec"] > 0
    assert leg["loss_last"] < leg["loss_first"]
    ref = leg_record("x", 1, 10, 1.0, None, None)
    assert ref == j_streaming.leg_record("x", 1, 10, 1.0, None, None)
    with pytest.raises(ValueError, match="need 3 devices, have 2"):
        bench_leg(3, devices=[CPU] * 2)


def test_shard_mean_losses_maps_chips_in_feed_order():
    from iotml_torch.parallel.data_parallel import put_global

    row = np.repeat(np.asarray([1.0, 2.0, 3.0, 4.0], np.float32), 8)
    arr = put_global(row, batch_sharding(_mesh(4)))
    out = shard_mean_losses(arr, [8, 8, 8, 8])
    j_arr = jax.device_put(row, j_mesh.batch_sharding(_j_mesh(4)))
    assert np.allclose(out, j_streaming.shard_mean_losses(j_arr,
                                                          [8, 8, 8, 8]))
    assert np.allclose(out, [1.0, 2.0, 3.0, 4.0])
    out2 = shard_mean_losses(arr, [4, 8, 8, 8])
    assert np.isclose(out2[0], 2.0)
    with pytest.raises(ValueError, match="row-loss shards"):
        shard_mean_losses(arr, [8, 8])
