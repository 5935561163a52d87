"""The port's model lifecycle (``iotml_torch.mlops``: the versioned
registry, the async checkpointer, the registry watcher, the A/B rollout
gate; ``train.live`` and ``serve.live`` in registry mode) held against
the JAX package's on the CPU: the scenarios of ``tests/test_mlops.py``
(all but the platform mount, which needs ``iotml.cli.up``), each run in
both packages on the same seeded records and the same (converted)
params, plus the cross-reads: a registry, ``model.h5`` and ``state.npz``
written by either package resume, serve and inspect in the other.

Tolerances:
- manifests field by field (``created_ts`` and the artifacts' checksums
  and sizes aside: the two h5 writers lay the same file out apart),
  history events (their wall-clock ``t`` aside), versions, channels,
  cursors, committed offsets, counts, verdicts and CLI output: equal;
- params, Adam moments, counts and steps that crossed a ``model.h5`` or
  a ``state.npz``: bit for bit;
- per-round losses at the fused-fit bounds (tests/test_fused_train.py):
  rtol 2e-4 / atol 1e-6; params after further rounds rtol 5e-3 /
  atol 2e-5;
- scorer confusion counts and scored rows of the two packages from the
  same params: equal.
"""

import io
import json
import os
import shutil
import sys
import time

import jax
import numpy as np
import pytest

from iotml import config as j_config
from iotml.mlops import ABRollout as JABRollout
from iotml.mlops import AsyncCheckpointer as JAsyncCheckpointer
from iotml.mlops import ModelRegistry as JModelRegistry
from iotml.mlops import RegistryWatcher as JRegistryWatcher
from iotml.mlops import RolloutGate as JRolloutGate
from iotml.mlops import restore_trainer as j_restore_trainer
from iotml.mlops.__main__ import main as j_mlops_main
from iotml.mlops.checkpoint import params_from_h5_bytes as j_from_h5
from iotml.mlops.checkpoint import params_to_h5_bytes as j_to_h5
from iotml.mlops.checkpoint import state_to_npz_bytes as j_state_to_npz
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml.serve.live import LiveScorer as JLiveScorer
from iotml.stream.broker import Broker as JBroker
from iotml.train.live import ContinuousTrainer as JContinuousTrainer
from iotml.train.loop import Trainer as JTrainer
from iotml.train.loop import adam_injectable_cached
from iotml_torch import config as t_config
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.mlops import (ABRollout, AsyncCheckpointer, Manifest,
                               ModelRegistry, RegistryWatcher, RolloutGate,
                               restore_trainer)
from iotml_torch.mlops.__main__ import main as t_mlops_main
from iotml_torch.mlops.checkpoint import (params_from_h5_bytes,
                                          params_to_h5_bytes,
                                          state_from_npz_bytes,
                                          state_to_npz_bytes)
from iotml_torch.models.autoencoder import CAR_AUTOENCODER, PARAM_NAMES
from iotml_torch.models.convert import (adam_from_optax, adam_to_optax,
                                        params_from_jax)
from iotml_torch.serve.live import LiveScorer
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.train.checkpoint import CheckpointManager
from iotml_torch.train.live import ContinuousTrainer
from iotml_torch.train.loop import Trainer, TrainState

TOPIC = "SENSOR_DATA_S_AVRO"
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=5e-3, atol=2e-5)


# ------------------------------------------------------------------ helpers
def _seed(n_records, failure_rate=0.02, partitions=2):
    """A port and a JAX broker holding the same generated records."""
    t, j = Broker(), JBroker()
    _publish(t, j, n_records, failure_rate, partitions)
    return t, j


def _publish(t, j, n_records, failure_rate=0.02, partitions=2, seed=0):
    before = {p: t.end_offset(TOPIC, p) if TOPIC in t.topics() else 0
              for p in range(partitions)}
    FleetGenerator(FleetScenario(num_cars=100, failure_rate=failure_rate,
                                 seed=seed)) \
        .publish(t, TOPIC, n_ticks=n_records // 100, partitions=partitions)
    if TOPIC not in j.topics():
        j.create_topic(TOPIC, partitions=partitions)
    for p in range(partitions):
        for m in t.fetch(TOPIC, p, before[p], t.end_offset(TOPIC, p)):
            j.produce(TOPIC, m.value, key=m.key, partition=p,
                      timestamp_ms=m.timestamp_ms)


def _j_params(seed=0):
    tr = JTrainer(J_AE, rng=jax.random.PRNGKey(seed))
    tr._ensure_state(np.zeros((4, 18), np.float32))
    return jax.device_get(tr.state.params)


def _j_state(seed=0, step=0):
    tr = JTrainer(J_AE, rng=jax.random.PRNGKey(seed))
    tr._ensure_state(np.zeros((4, 18), np.float32))
    return tr.state.replace(step=np.asarray(step, np.int32))


def _t_state(jstate):
    """The port's TrainState holding a JAX TrainState's numbers."""
    adam = jstate.opt_state[0]
    return TrainState(
        step=int(jstate.step),
        params=params_from_jax(jax.tree.map(np.asarray, jstate.params)),
        opt_state=adam_from_optax(adam.count,
                                  jax.tree.map(np.asarray, adam.mu),
                                  jax.tree.map(np.asarray, adam.nu)))


def _carry(jtrainer, ttrainer):
    """Start the port's trainer from the JAX trainer's initial state."""
    jtrainer._ensure_state(np.zeros((100, 18), np.float32))
    ttrainer.state = _t_state(jtrainer.state)


def _assert_state_equal(tstate, jstate, opt=True):
    """Bit-equal params (and Adam count/moments, step)."""
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for k in PARAM_NAMES:
        assert tstate.params[k].numpy().tobytes() == \
            want[k].numpy().tobytes(), k
    if opt:
        adam = jstate.opt_state[0]
        got = adam_to_optax(tstate.opt_state)
        assert int(got[0]) == int(adam.count)
        for g, w in ((got[1], adam.mu), (got[2], adam.nu)):
            for a, b in zip(jax.tree_util.tree_leaves(g),
                            jax.tree_util.tree_leaves(w)):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert tstate.step == int(jstate.step)


def _assert_params_close(tparams, jparams, tol=PARAM_TOL):
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for k in PARAM_NAMES:
        np.testing.assert_allclose(tparams[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


def _manifest_fields(m):
    d = m.to_dict()
    d.pop("created_ts")
    d["artifacts"] = sorted(d["artifacts"])
    return d


def _history(reg):
    return [{k: v for k, v in e.items() if k != "t"} for e in reg.history()]


def _registries(tmp_path):
    return ModelRegistry(str(tmp_path / "t")), \
        JModelRegistry(str(tmp_path / "j"))


def _blobs(seed):
    """The same params as each package's model.h5 blob."""
    jp = _j_params(seed)
    return params_to_h5_bytes(params_from_jax(jp)), j_to_h5(jp)


# ----------------------------------------------------------------- registry
def test_registry_publish_channels_history_checksum(tmp_path):
    regs = _registries(tmp_path)
    b0, b1 = _blobs(0), _blobs(1)
    for i, reg in enumerate(regs):
        assert reg.versions() == [] and reg.latest() is None
        m1 = reg.publish({"model.h5": b0[i]},
                         offsets=[(TOPIC, 0, 10), (TOPIC, 1, 12)],
                         metrics={"loss": 0.5}, step=7)
        assert m1.version == 1 and m1.parent is None and m1.step == 7
        assert reg.publish({"model.h5": b1[i]}).version == 2
        assert reg.manifest(1).offsets == [(TOPIC, 0, 10), (TOPIC, 1, 12)]
        assert reg.manifest(1).metrics == {"loss": 0.5}
        reg.promote(2)
        assert reg.channel("serving") == 2
        reg.rollback(1)
        assert reg.channel("serving") == 1
        with pytest.raises(ValueError):
            reg.channel("staging")
        with pytest.raises(KeyError):
            reg.set_channel("serving", 99)
        assert (reg.cell.leader, reg.cell.epoch) == ("v0000000001", 3)
    t, j = regs
    for v in (1, 2):
        assert _manifest_fields(t.manifest(v)) == \
            _manifest_fields(j.manifest(v))
    assert _history(t) == _history(j)
    assert [e["event"] for e in t.history()] == \
        ["publish", "publish", "promote", "rollback"]
    assert t.describe()["versions"] == j.describe()["versions"]
    # each package's reader decodes both blobs to the same params
    for reg in regs:
        got = params_from_h5_bytes(t.load_bytes(1, "model.h5"))
        want = j_from_h5(j.load_bytes(1, "model.h5"))
        assert all(got[k].numpy().tobytes() ==
                   params_from_jax(want)[k].numpy().tobytes()
                   for k in PARAM_NAMES)
    for reg in regs:
        with open(reg.artifact_path(2, "model.h5"), "r+b") as fh:
            fh.seek(0, os.SEEK_END)
            fh.truncate(fh.tell() - 1)
        with pytest.raises(ValueError, match="checksum"):
            reg.load_bytes(2, "model.h5")


def test_each_package_reads_the_others_registry(tmp_path):
    """The directory layout, file names and JSON are shared: each
    registry class opens the other's root and sees the same versions,
    manifests, channels and history."""
    regs = _registries(tmp_path)
    b = _blobs(2)
    for i, reg in enumerate(regs):
        reg.publish({"model.h5": b[i]}, offsets=[(TOPIC, 0, 5)], step=3)
        reg.publish({"model.h5": b[i]}, offsets=[(TOPIC, 0, 9)], step=6,
                    metrics={"loss": 0.25})
        reg.promote(2)
        reg.rollback(1)
        reg.set_channel("candidate", 2)
    for root, other in ((regs[0].root, JModelRegistry),
                        (regs[1].root, ModelRegistry)):
        theirs = other(root)
        mine = (regs[0] if root == regs[0].root else regs[1])
        assert theirs.describe() == mine.describe()
        assert theirs.history() == mine.history()
        for v in mine.versions():
            assert theirs.manifest(v).to_dict() == mine.manifest(v).to_dict()
            assert theirs.load_bytes(v, "model.h5") == \
                mine.load_bytes(v, "model.h5")
        assert (theirs.cell.leader, theirs.cell.epoch) == \
            ("v0000000001", 1)
    assert sorted(os.listdir(regs[0].root)) == \
        sorted(os.listdir(regs[1].root))
    assert sorted(os.listdir(regs[0].version_dir(1))) == \
        sorted(os.listdir(regs[1].version_dir(1)))


def test_registry_torn_publish_invisible_and_swept(tmp_path):
    for reg in _registries(tmp_path):
        reg.publish({"model.h5": b"x" * 10})
        torn = reg.version_dir(2)
        os.makedirs(torn)
        with open(os.path.join(torn, "model.h5"), "wb") as fh:
            fh.write(b"torn")
        stage = os.path.join(reg.root, ".stage-v0000000003-999")
        os.makedirs(stage)
        assert reg.versions() == [1] and reg.latest() == 1
        with pytest.raises(KeyError):
            reg.manifest(2)
        assert reg.recover() == 2
        assert not os.path.isdir(torn) and not os.path.isdir(stage)
        assert reg.publish({"model.h5": b"y" * 10}).version == 2
        assert reg.versions() == [1, 2]


def test_channel_pointer_to_missing_version_falls_back(tmp_path):
    for reg in _registries(tmp_path):
        reg.publish({"model.h5": b"a"})
        reg.publish({"model.h5": b"b"})
        reg.promote(2)
        shutil.rmtree(reg.version_dir(2))
        assert reg.channel("serving") == 1


def test_registry_prune_keeps_newest_and_channel_targets(tmp_path):
    regs = _registries(tmp_path)
    for reg in regs:
        for i in range(6):
            reg.publish({"model.h5": bytes([i]) * 8})
        reg.set_channel("serving", 2)
        assert reg.prune(keep=2) == 3
        assert reg.versions() == [2, 5, 6]
        assert reg.channel("serving") == 2
        assert reg.next_version() == 7
        assert reg.prune(keep=2) == 0
    assert _history(regs[0]) == _history(regs[1])


# ------------------------------------------------------ async checkpointer
def test_checkpointer_queue_coalesce_drop_oldest_and_timings(tmp_path):
    regs = _registries(tmp_path)
    jstate = _j_state(0)
    tstate = _t_state(jstate)
    cks = [AsyncCheckpointer(regs[0], queue_depth=2, min_interval_s=0.0),
           JAsyncCheckpointer(regs[1], queue_depth=2, min_interval_s=0.0)]
    for ck, state in zip(cks, (tstate, jstate)):
        for i in range(3):
            ck.snapshot(state, [(TOPIC, 0, 10 + i)])
        assert ck.pending() == 2 and ck.dropped == 1
        assert (ck.write_once(), ck.write_once(), ck.write_once()) == \
            (1, 2, None)
        ck.min_interval_s = 60.0
        ck._last_accept = time.monotonic()
        ck.snapshot(state, [(TOPIC, 0, 13)])
        assert ck.coalesced == 1 and ck.pending() == 0
        ck.snapshot(state, [(TOPIC, 0, 13)], force=True)
        assert ck.pending() == 1 and ck.write_once() == 3
    for v in (1, 2, 3):
        assert _manifest_fields(regs[0].manifest(v)) == \
            _manifest_fields(regs[1].manifest(v))
    assert regs[0].manifest(1).offsets == [(TOPIC, 0, 11)]
    assert regs[0].channel("serving") == regs[1].channel("serving") == 3
    assert _history(regs[0]) == _history(regs[1])
    assert all(s > 0 for s in cks[0].seconds.values())
    assert set(cks[0].seconds) == {"snapshot", "serialize", "fsync"}


def test_snapshot_is_a_copy_taken_at_snapshot_time(tmp_path):
    """The snapshot owns its numbers: changing the trainer's tensors
    afterwards does not reach the committed version."""
    reg = ModelRegistry(str(tmp_path))
    ck = AsyncCheckpointer(reg)
    state = _t_state(_j_state(0))
    want = {k: v.clone() for k, v in state.params.items()}
    ck.snapshot(state, [(TOPIC, 0, 1)])
    for v in list(state.params.values()) + list(state.opt_state.mu.values()):
        v.add_(1.0)
    ck.write_once()
    got = params_from_h5_bytes(reg.load_bytes(1, "model.h5"))
    assert all(got[k].numpy().tobytes() == want[k].numpy().tobytes()
               for k in PARAM_NAMES)


def test_commit_fn_runs_after_durability(tmp_path):
    regs = _registries(tmp_path)
    jstate = _j_state(0)
    seen = {}
    for name, reg, ck, state in (
            ("t", regs[0], AsyncCheckpointer(regs[0]), _t_state(jstate)),
            ("j", regs[1], JAsyncCheckpointer(regs[1]), jstate)):
        seen[name] = []
        ck.commit_fn = lambda m, r=reg, s=seen[name]: s.append(
            (m.version, r.versions()[-1]))
        ck.snapshot(state, [(TOPIC, 0, 5)])
        ck.write_once()
    assert seen["t"] == seen["j"] == [(1, 1)]


def test_state_npz_is_jax_leaf_order_bit_for_bit():
    """``state.npz`` of the same state from both packages: the same
    keys, dtypes, shapes and bytes (p_0..p_7, o_0..o_16, step)."""
    jstate = _j_state(4, step=41)
    tstate = _t_state(jstate)
    with np.load(io.BytesIO(state_to_npz_bytes(
            tstate.params, tstate.opt_state, 41))) as z:
        got = {k: z[k] for k in z.files}
    with np.load(io.BytesIO(j_state_to_npz(
            jax.device_get(jstate.params),
            jax.device_get(jstate.opt_state), 41))) as z:
        want = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.startswith("o_")]) == 17
    for k in want:
        assert (got[k].dtype, got[k].shape) == (want[k].dtype, want[k].shape)
        assert got[k].tobytes() == want[k].tobytes(), k
    back = state_from_npz_bytes(state_to_npz_bytes(
        tstate.params, tstate.opt_state, 41), _t_state(_j_state(9)))
    _assert_state_equal(back, jstate)


def test_restore_trainer_full_state_and_weights_only(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    assert restore_trainer(Trainer(CAR_AUTOENCODER, device="cpu"),
                           reg) is None
    jsrc = _j_state(3, step=41)
    src = _t_state(jsrc)
    ck = AsyncCheckpointer(reg)
    ck.snapshot(src, [(TOPIC, 0, 3)], metrics={"loss": 1.0})
    ck.write_once()
    dst = Trainer(CAR_AUTOENCODER, device="cpu")
    m = restore_trainer(dst, reg)
    assert m.version == 1 and dst.state.step == 41
    _assert_state_equal(dst.state, jsrc)
    # the JAX package restores the port's version the same
    jdst = JTrainer(J_AE)
    assert j_restore_trainer(jdst, JModelRegistry(reg.root)).version == 1
    assert int(jdst.state.step) == 41
    _assert_state_equal(src, jdst.state)
    ck2 = AsyncCheckpointer(reg, save_opt_state=False)
    ck2.snapshot(src, [(TOPIC, 0, 9)])
    ck2.write_once()
    assert "state.npz" not in reg.manifest(2).artifacts
    dst2 = Trainer(CAR_AUTOENCODER, device="cpu")
    assert restore_trainer(dst2, reg).version == 2
    _assert_state_equal(dst2.state, jsrc, opt=False)
    assert dst2.state.step == 41 and dst2.state.opt_state.count == 0


def test_restore_trainer_resumes_lineage_tip_not_serving(tmp_path):
    regs = _registries(tmp_path)
    jstate = _j_state(0)
    for reg, ck, state, tr in (
            (regs[0], AsyncCheckpointer(regs[0]), _t_state(jstate),
             lambda: Trainer(CAR_AUTOENCODER, device="cpu")),
            (regs[1], JAsyncCheckpointer(regs[1]), jstate,
             lambda: JTrainer(J_AE))):
        ck.snapshot(state, [(TOPIC, 0, 10)])
        ck.write_once()
        ck.snapshot(state, [(TOPIC, 0, 20)])
        ck.write_once()
        reg.rollback(1)
        m = (restore_trainer if reg is regs[0] else j_restore_trainer)(
            tr(), reg)
        assert m.version == 2 and m.offsets == [(TOPIC, 0, 20)]


def test_checkpointer_keep_versions_prunes_after_commit(tmp_path):
    regs = _registries(tmp_path)
    jstate = _j_state(0)
    for ck, state in ((AsyncCheckpointer(regs[0], keep_versions=2),
                       _t_state(jstate)),
                      (JAsyncCheckpointer(regs[1], keep_versions=2), jstate)):
        for i in range(4):
            ck.snapshot(state, [(TOPIC, 0, i)])
            ck.write_once()
    for reg in regs:
        assert reg.versions() == [3, 4] and reg.channel("serving") == 4
    assert _history(regs[0]) == _history(regs[1])


def test_writer_thread_under_snapshot_pressure(tmp_path):
    """The train thread snapshots while the writer thread drains (switch
    interval shortened): every snapshot is written or counted dropped,
    versions commit in snapshot order, and ``stop()`` drains what is
    pending first."""
    reg = ModelRegistry(str(tmp_path))
    ck = AsyncCheckpointer(reg, queue_depth=2).start()
    state = _t_state(_j_state(0))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for i in range(60):
            ck.snapshot(state, [(TOPIC, 0, i)])
        ck.stop(flush=True)
    finally:
        sys.setswitchinterval(interval)
    assert ck.pending() == 0 and ck._thread is None
    assert ck.written + ck.dropped == 60 and ck.last_error is None
    assert reg.versions() == list(range(1, ck.written + 1))
    offsets = [reg.manifest(v).offsets[0][2] for v in reg.versions()]
    assert offsets == sorted(offsets) and offsets[-1] == 59


# --------------------------------------------------- trainer crash / resume
def _trainer_pair(tb, jb, tmp_path, tag, **kw):
    tt = ContinuousTrainer(tb, TOPIC, None,
                           registry=ModelRegistry(str(tmp_path / tag / "t")),
                           device="cpu", **kw)
    jt = JContinuousTrainer(jb, TOPIC, None,
                            registry=JModelRegistry(str(tmp_path / tag
                                                        / "j")), **kw)
    return tt, jt


def test_trainer_crash_resumes_from_stamped_offsets(tmp_path):
    tb, jb = _seed(3000)
    kw = dict(group="crash-train", take_batches=5)
    tt, jt = _trainer_pair(tb, jb, tmp_path, "r", **kw)
    _carry(jt.trainer, tt.trainer)
    losses = {"t": [], "j": []}
    for name, tr in (("t", tt), ("j", jt)):
        for _ in range(2):
            losses[name].append(tr.train_round()["loss"])
            tr.checkpointer.write_once()
        losses[name].append(tr.train_round()["loss"])  # never lands
        assert tr.checkpointer.pending() == 1
    np.testing.assert_allclose(losses["t"], losses["j"], **LOSS_TOL)
    durable = {(t, p): o for t, p, o in tt.registry.manifest(2).offsets}
    assert durable == {(t, p): o for t, p, o in
                       jt.registry.manifest(2).offsets}
    advanced = {(t, p): o for t, p, o in tt.consumer.positions()}
    assert any(advanced[k] > durable[k] for k in durable)
    for (t, p), off in durable.items():
        assert tb.committed("crash-train", t, p) == off == \
            jb.committed("crash-train", t, p)
    # incarnation 2 of each mounts its registry root
    resumed = {}
    for name, tr, cls, reg_cls, kwargs in (
            ("t", tt, ContinuousTrainer, ModelRegistry, {"device": "cpu"}),
            ("j", jt, JContinuousTrainer, JModelRegistry, {})):
        reg = reg_cls(tr.registry.root)
        reg.recover()
        tr2 = cls(tb if name == "t" else jb, TOPIC, None, registry=reg,
                  **kw, **kwargs)
        assert tr2.restored_version == 2
        assert int(tr2.trainer.state.step) == reg.manifest(2).step == 10
        assert {(t, p): o for t, p, o in tr2.consumer.positions()} == \
            durable
        stats = tr2.train_round()
        assert tr2.checkpointer.write_once() == 3 and stats["records"] > 0
        resumed[name] = (tr2, stats["loss"])
    np.testing.assert_allclose(resumed["t"][1], resumed["j"][1], **LOSS_TOL)
    _assert_params_close(resumed["t"][0].trainer.state.params,
                         resumed["j"][0].trainer.state.params)
    assert resumed["t"][0].trainer.state.opt_state.count == \
        int(resumed["j"][0].trainer.state.opt_state[0].count) == 15


def test_committed_never_passes_the_newest_durable_manifest(tmp_path):
    """A threaded writer under rounds: at every round the group's
    committed offsets are at or below the newest durable manifest's."""
    tb, _ = _seed(4000)
    tt = ContinuousTrainer(tb, TOPIC, None,
                           registry=ModelRegistry(str(tmp_path)),
                           group="g", take_batches=5, device="cpu")
    tt.checkpointer.start()
    try:
        for _ in range(5):
            tt.train_round()
            latest = tt.registry.latest()
            newest = {} if latest is None else {
                (t, p): o for t, p, o in tt.registry.manifest(latest)
                .offsets}
            for p in range(2):
                c = tb.committed("g", TOPIC, p)
                assert c is None or c <= newest.get((TOPIC, p), 0)
    finally:
        tt.close()
    m = tt.registry.manifest(tt.registry.latest())
    assert [tb.committed("g", t, p) for t, p, _ in m.offsets] == \
        [o for _, _, o in m.offsets]


def test_manifest_cursors_beat_backfill_since_ms(tmp_path):
    tb, jb = Broker(), JBroker()
    for b in (tb, jb):
        b.create_topic("t", partitions=2)
        for i in range(50):
            b.produce("t", str(i).encode(), partition=i % 2,
                      timestamp_ms=1000 + i)
    pos = {}
    for name, b, reg, ck, cls, state, kwargs in (
            ("t", tb, ModelRegistry(str(tmp_path / "t")), AsyncCheckpointer,
             ContinuousTrainer, _t_state(_j_state(0)), {"device": "cpu"}),
            ("j", jb, JModelRegistry(str(tmp_path / "j")),
             JAsyncCheckpointer, JContinuousTrainer, _j_state(0), {})):
        c = ck(reg)
        c.snapshot(state, [("t", 0, 17)])
        c.write_once()
        ct = cls(b, "t", None, registry=reg, group="cold-mlops",
                 backfill_since_ms=1030, **kwargs)
        pos[name] = {p: off for _t, p, off in ct.consumer.positions()}
    assert pos["t"] == pos["j"]
    assert pos["t"][0] == 17
    assert pos["t"][1] == tb.offset_for_timestamp("t", 1, 1030) > 0


def test_manifest_cursor_never_rewinds_committed(tmp_path):
    pos = {}
    for name, b, reg, ck, cls, state, kwargs in (
            ("t", Broker(), ModelRegistry(str(tmp_path / "t")),
             AsyncCheckpointer, ContinuousTrainer, _t_state(_j_state(0)),
             {"device": "cpu"}),
            ("j", JBroker(), JModelRegistry(str(tmp_path / "j")),
             JAsyncCheckpointer, JContinuousTrainer, _j_state(0), {})):
        b.create_topic("t", partitions=1)
        for i in range(40):
            b.produce("t", str(i).encode(), partition=0)
        b.commit("fwd", "t", 0, 30)
        c = ck(reg)
        c.snapshot(state, [("t", 0, 12)])
        c.write_once()
        ct = cls(b, "t", None, registry=reg, group="fwd", **kwargs)
        pos[name] = {p: off for _t, p, off in ct.consumer.positions()}
    assert pos["t"] == pos["j"] == {0: 30}


@pytest.mark.parametrize("warm_start", [True, False])
def test_warm_start_choice_between_registry_tip_and_committed(tmp_path,
                                                             warm_start):
    """With ``warm_start`` the trainer takes the tip's state and manifest
    cursor; without it, fresh weights and the group's committed offset,
    the registry unread."""
    got = {}
    for name, b, reg, ck, cls, state, kwargs in (
            ("t", Broker(), ModelRegistry(str(tmp_path / "t")),
             AsyncCheckpointer, ContinuousTrainer, _t_state(_j_state(3, 7)),
             {"device": "cpu"}),
            ("j", JBroker(), JModelRegistry(str(tmp_path / "j")),
             JAsyncCheckpointer, JContinuousTrainer, _j_state(3, 7), {})):
        b.create_topic("t", partitions=1)
        for i in range(40):
            b.produce("t", str(i).encode(), partition=0)
        b.commit("ws", "t", 0, 5)
        c = ck(reg)
        c.snapshot(state, [("t", 0, 17)])
        c.write_once()
        ct = cls(b, "t", None, registry=reg, group="ws",
                 warm_start=warm_start, **kwargs)
        got[name] = ct
        assert ct.restored_version == (1 if warm_start else None)
        assert {p: off for _t, p, off in ct.consumer.positions()} == \
            {0: 17 if warm_start else 5}
    if warm_start:
        _assert_state_equal(got["t"].trainer.state, got["j"].trainer.state)
    else:
        assert got["t"].trainer.state is None
        assert got["j"].trainer.state is None


def test_checkpoint_interval_coalesces_rounds_and_run_archives_last(
        tmp_path):
    """A cadence longer than the run: the first round is archived, the
    next two coalesce, and ``run``'s exit force-archives the newest
    state, in both packages alike."""
    tb, jb = _seed(3000)
    tt, jt = _trainer_pair(tb, jb, tmp_path, "cad", group="cad",
                           take_batches=5, checkpoint_interval_s=3600.0)
    _carry(jt.trainer, tt.trainer)
    for tr in (tt, jt):
        assert tr.checkpointer.min_interval_s == 3600.0
        try:
            assert tr.run(max_rounds=3, poll_interval_s=0.01) == 3
        finally:
            tr.close()
        assert tr.registry.versions() == [1, 2]
        assert tr.checkpointer.coalesced == 2
        assert [tr.registry.manifest(v).step for v in (1, 2)] == [5, 15]
        assert tr.registry.manifest(2).offsets == \
            [tuple(c) for c in tr.consumer.positions()]
    for v in (1, 2):
        tm, jm = (_manifest_fields(tr.registry.manifest(v))
                  for tr in (tt, jt))
        tl, jl = tm.pop("metrics"), jm.pop("metrics")
        assert tm == jm and tl["records"] == jl["records"]
        np.testing.assert_allclose(tl["loss"], jl["loss"], **LOSS_TOL)
    _assert_params_close(tt.trainer.state.params, jt.trainer.state.params)


def test_ckptmanager_atomic_save_and_torn_restore(tmp_path):
    """The port's checkpoint directory: the JAX package's semantics (a
    torn newest step is skipped back to the newest intact one, counted;
    an explicitly named torn step raises)."""
    mgr = CheckpointManager(str(tmp_path))
    state = _t_state(_j_state(0, step=1))
    mgr.save(state, step=1, cursors=[(TOPIC, 0, 5)])
    state.step = 2
    mgr.save(state, step=2, cursors=[(TOPIC, 0, 9)])
    assert mgr.steps() == [1, 2]
    assert not [n for n in os.listdir(str(tmp_path))
                if n.startswith(".tmp_step_")]
    step2 = os.path.join(str(tmp_path), "step_0000000002")
    shutil.rmtree(step2)
    os.makedirs(step2)
    with open(os.path.join(step2, "manifest.json"), "wb") as fh:
        fh.write(b"garbage that is not a checkpoint")
    payload = mgr.restore()
    assert payload["step"] == 1 and payload["cursors"] == [(TOPIC, 0, 5)]
    assert mgr.skipped_torn == 1
    with pytest.raises(Exception):
        mgr.restore(step=2)


# ----------------------------------------------- cross-package resumption
def _rounds(tr, n):
    out = []
    for _ in range(n):
        out.append(tr.train_round()["loss"])
        tr.checkpointer.write_once()
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_registry_written_by_one_package_resumes_in_the_other(tmp_path,
                                                              writer):
    """Two rounds by one package's trainer; the other package's trainer
    resumes the tip (weights, Adam state, step and cursors bit for bit),
    and it and the writer's own resumed trainer train on alike."""
    tb, jb = _seed(4000)
    kw = dict(group="x", take_batches=5)
    root = str(tmp_path / "reg")
    if writer == "jax":
        first = JContinuousTrainer(jb, TOPIC, None,
                                   registry=JModelRegistry(root), **kw)
    else:
        first = ContinuousTrainer(tb, TOPIC, None,
                                  registry=ModelRegistry(root),
                                  device="cpu", **kw)
        jt0 = JTrainer(J_AE)
        _carry(jt0, first.trainer)
    _rounds(first, 2)
    # the other broker follows the writer's group commit
    src, dst = (jb, tb) if writer == "jax" else (tb, jb)
    for p in range(2):
        dst.commit("x", TOPIC, p, src.committed("x", TOPIC, p))
    tt = ContinuousTrainer(tb, TOPIC, None, registry=ModelRegistry(root),
                           device="cpu", **kw)
    jt = JContinuousTrainer(jb, TOPIC, None, registry=JModelRegistry(root),
                            **kw)
    assert tt.restored_version == jt.restored_version == 2
    _assert_state_equal(tt.trainer.state, jt.trainer.state)
    assert tt.consumer.positions() == jt.consumer.positions()
    np.testing.assert_allclose(_rounds(tt, 2), _rounds(jt, 2), **LOSS_TOL)
    _assert_params_close(tt.trainer.state.params, jt.trainer.state.params)


def test_a_23_leaf_blob_falls_back_to_weights_only_in_both(tmp_path):
    """``adam_injectable_cached`` state (23 leaves) does not fit the
    plain Adam layout: both packages restore the weights and the step
    and start Adam fresh; a JAX trainer on the injectable optimizer does
    the same with the port's 17-leaf blob."""
    jtr = JTrainer(J_AE, rng=jax.random.PRNGKey(2),
                   tx=adam_injectable_cached(1e-3))
    jtr._ensure_state(np.zeros((4, 18), np.float32))
    jtr.state = jtr.state.replace(step=np.asarray(12, np.int32))
    assert len(jax.tree_util.tree_leaves(jtr.state.opt_state)) == 23
    reg = JModelRegistry(str(tmp_path / "j"))
    ck = JAsyncCheckpointer(reg)
    ck.snapshot(jtr.state, [(TOPIC, 0, 4)])
    ck.write_once()
    t_dst, j_dst = Trainer(CAR_AUTOENCODER, device="cpu"), JTrainer(J_AE)
    assert restore_trainer(t_dst, ModelRegistry(reg.root)).version == 1
    assert j_restore_trainer(j_dst, reg).version == 1
    with pytest.raises(ValueError, match="leaf shape"):
        state_from_npz_bytes(reg.load_bytes(1, "state.npz"), t_dst.state)
    _assert_state_equal(t_dst.state, jtr.state, opt=False)
    assert t_dst.state.step == int(j_dst.state.step) == 12
    assert t_dst.state.opt_state.count == \
        int(j_dst.state.opt_state[0].count) == 0
    # the reverse: the port's 17-leaf blob into an injectable JAX trainer
    treg = ModelRegistry(str(tmp_path / "t"))
    tck = AsyncCheckpointer(treg)
    tck.snapshot(_t_state(_j_state(5, step=7)), [(TOPIC, 0, 4)])
    tck.write_once()
    jinj = JTrainer(J_AE, tx=adam_injectable_cached(1e-3))
    assert j_restore_trainer(jinj, JModelRegistry(treg.root)).version == 1
    assert int(jinj.state.step) == 7
    assert int(jinj.state.opt_state.inner_state[0].count) == 0
    _assert_state_equal(_t_state(_j_state(5, step=7)), jinj.state,
                        opt=False)


# ------------------------------------------------------- watcher + rollout
class _StubScorer:
    def __init__(self):
        self.params = None
        self.model_version = None

    def set_params(self, params, version=None):
        self.params = params
        self.model_version = version


def test_registry_watcher_swaps_and_late_attach(tmp_path):
    regs = _registries(tmp_path)
    b0, b1 = _blobs(0), _blobs(1)
    got = {}
    for i, (reg, cls) in enumerate(zip(regs, (RegistryWatcher,
                                              JRegistryWatcher))):
        v1 = reg.publish({"model.h5": b0[i]}).version
        reg.promote(v1)
        s1 = _StubScorer()
        w = cls(reg, scorers=[s1])
        assert w.poll_once() is True and s1.model_version == v1
        assert w.poll_once() is False
        v2 = reg.publish({"model.h5": b1[i]}).version
        reg.promote(v2)
        assert w.poll_once() is True and s1.model_version == v2
        s2 = _StubScorer()
        w.attach(s2)
        assert s2.model_version == v2 and w.swaps == 2
        got[i] = s2.params
    want = params_from_jax(jax.tree.map(np.asarray, got[1]))
    assert all(got[0][k].numpy().tobytes() == want[k].numpy().tobytes()
               for k in PARAM_NAMES)


def test_registry_watcher_thread_follows_promotions(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    b = _blobs(0)[0]
    reg.promote(reg.publish({"model.h5": b}).version)
    s = _StubScorer()
    w = RegistryWatcher(reg, scorers=[s], poll_interval_s=0.01).start()
    try:
        assert w.wait_for_model(5.0) == 1
        reg.promote(reg.publish({"model.h5": b}).version)
        deadline = time.monotonic() + 5.0
        while s.model_version != 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert s.model_version == 2
    finally:
        w.stop()
    assert w._thread is None


GATE_CASES = [
    ({"labeled": 10}, {}),
    ({}, {"labeled": 10}),
    ({"auc": None}, {}),
    ({}, {"f1": 0.79, "auc": 0.89}),
    ({}, {"f1": 0.7}),
    ({}, {"auc": 0.8}),
    ({"f1": None}, {"f1": None}),
    ({}, {"f1": 0.78, "auc": 0.88}),
]


@pytest.mark.parametrize("base_kw,cand_kw", GATE_CASES)
def test_rollout_gate_verdicts(base_kw, cand_kw):
    base = {"labeled": 500, "f1": 0.8, "auc": 0.9, "precision": 1,
            "recall": 1}
    b, c = dict(base, **base_kw), dict(base, **cand_kw)
    got = RolloutGate(min_records=100, epsilon=0.02).decide(b, c)
    assert got == JRolloutGate(min_records=100, epsilon=0.02).decide(b, c)
    assert got in (None, "promote", "rollback")


def test_ab_rollout_rolls_back_degraded_candidate(tmp_path):
    """The same baseline and degraded candidate (baseline + N(0, 1)
    noise) in both packages' registries: both roll back, serving returns
    to the baseline, both sides score the whole stream with the same
    confusion counts."""
    tb, jb = _seed(2000, failure_rate=0.05)
    regs = _registries(tmp_path)
    good = _j_params(0)
    noise = np.random.RandomState(7)
    bad = jax.tree_util.tree_map(
        lambda a: np.asarray(a)
        + noise.normal(0, 1.0, np.shape(a)).astype(np.float32), good)
    abs_ = []
    for reg, to_h5, broker, cls, gate, kw in (
            (regs[0], lambda p: params_to_h5_bytes(params_from_jax(p)), tb,
             ABRollout, RolloutGate, {"device": "cpu"}),
            (regs[1], j_to_h5, jb, JABRollout, JRolloutGate, {})):
        base = reg.publish({"model.h5": to_h5(good)}).version
        cand = reg.publish({"model.h5": to_h5(bad)}).version
        ab = cls(broker, TOPIC, reg, base, cand,
                 gate=gate(min_records=200, epsilon=0.02), threshold=5.0,
                 deploy_candidate=True, from_start=True,
                 group_prefix="ab-test", **kw)
        assert reg.channel("serving") == cand
        for _ in range(64):
            if ab.step(max_rows=5_000) == 0:
                break
        assert ab.decision == "rollback"
        assert reg.channel("serving") == base
        for v, side in ((base, "baseline"), (cand, "candidate")):
            assert broker.end_offset(f"model-predictions.v{v}", 0) == \
                ab.sides[side].scored == 2000
        abs_.append(ab)
    for side in ("baseline", "candidate"):
        assert abs_[0].sides[side].quality == abs_[1].sides[side].quality
        assert abs_[0].quality(side)["labeled"] == \
            abs_[1].quality(side)["labeled"]
    assert _history(regs[0]) == _history(regs[1])


def test_scorer_fleet_hot_swaps_every_member(tmp_path):
    """One watcher swaps a fleet of scorers (one a partition) between
    drains when serving moves; every member swaps and keeps scoring,
    nothing dropped — the port's scorers and JAX's alike."""
    tb, jb = _seed(400, partitions=2)
    regs = _registries(tmp_path)
    b0, b1 = _blobs(0), _blobs(1)
    from iotml.data.dataset import SensorBatches as JSensorBatches
    from iotml.serve.scorer import StreamScorer as JStreamScorer
    from iotml.stream.consumer import StreamConsumer as JStreamConsumer
    from iotml.stream.producer import OutputSequence as JOutputSequence

    fleets = {}
    for i, (reg, broker, wcls) in enumerate(
            ((regs[0], tb, RegistryWatcher), (regs[1], jb, JRegistryWatcher))):
        v1 = reg.publish({"model.h5": b0[i]}).version
        reg.promote(v1)
        w = wcls(reg)
        w.poll_once()
        members = []
        for p in range(2):
            broker.create_topic(f"preds{p}")
            if i == 0:
                c = StreamConsumer(broker, [f"{TOPIC}:{p}:0"], group="f")
                m = StreamScorer(CAR_AUTOENCODER, None,
                                 SensorBatches(c, batch_size=100),
                                 OutputSequence(broker, f"preds{p}"),
                                 device="cpu")
            else:
                c = JStreamConsumer(broker, [f"{TOPIC}:{p}:0"], group="f")
                m = JStreamScorer(J_AE, None,
                                  JSensorBatches(c, batch_size=100),
                                  JOutputSequence(broker, f"preds{p}"))
            w.attach(m)
            members.append(m)
        assert sum(m.score_available() for m in members) == 400
        assert all(m.model_version == v1 for m in members)
        reg.promote(reg.publish({"model.h5": b1[i]}).version)
        assert w.poll_once() and w.swaps == 2
        fleets[i] = members
    _publish(tb, jb, 400, seed=1)
    for members in fleets.values():
        assert sum(m.score_available() for m in members) == 400
        assert [m.model_version for m in members] == [2, 2]
        assert sum(m.scored for m in members) == 800
    for p in range(2):
        assert tb.end_offset(f"preds{p}", 0) == jb.end_offset(f"preds{p}", 0)


def test_live_scorer_follows_registry_serving_channel(tmp_path):
    tb, jb = _seed(1000)
    regs = _registries(tmp_path)
    b0, b1 = _blobs(0), _blobs(1)
    svcs = [LiveScorer(tb, TOPIC, "preds", None, registry=regs[0],
                       carhealth_topic=None, device="cpu"),
            JLiveScorer(jb, TOPIC, "preds", None, registry=regs[1],
                        carhealth_topic=None)]
    for i, (reg, svc) in enumerate(zip(regs, svcs)):
        reg.promote(reg.publish({"model.h5": b0[i]}).version)
        assert svc.wait_for_model(5.0) == "registry:v1"
        assert svc.scorer.score_available() == 1000
        reg.promote(reg.publish({"model.h5": b1[i]}).version)
        assert svc.maybe_swap() is True
        assert svc.scorer.model_version == 2
        assert svc.maybe_swap() is False
    assert svcs[0].stats()["model_updates"] == \
        svcs[1].stats()["model_updates"] == 2
    assert [m.value for m in tb.fetch("preds", 0, 0, 1000)][:1] != []
    with pytest.raises(ValueError):
        LiveScorer(tb, TOPIC, "p2", None, device="cpu")


def test_live_scorer_throttles_channel_polls(tmp_path):
    tb, _ = _seed(500)
    reg = ModelRegistry(str(tmp_path))
    b = _blobs(0)[0]
    reg.promote(reg.publish({"model.h5": b}).version)
    svc = LiveScorer(tb, TOPIC, "preds", None, registry=reg,
                     carhealth_topic=None, watch_poll_s=60.0, device="cpu")
    assert svc.maybe_swap() is True
    reg.promote(reg.publish({"model.h5": b}).version)
    assert svc.maybe_swap() is False  # inside the poll interval
    svc._last_watch -= 60.0
    assert svc.maybe_swap() is True and svc.scorer.model_version == 2


def test_cross_package_trainer_to_scorer(tmp_path):
    """A JAX trainer's registry served by the port's LiveScorer, and the
    port trainer's by JAX's: each scorer loads the other's model.h5 and
    scores every record."""
    tb, jb = _seed(3000)
    tt, jt = _trainer_pair(tb, jb, tmp_path, "x", group="g", take_batches=5)
    _carry(jt.trainer, tt.trainer)
    _rounds(tt, 1)
    _rounds(jt, 1)
    ts = LiveScorer(tb, TOPIC, "preds", None,
                    registry=ModelRegistry(jt.registry.root),
                    carhealth_topic=None, device="cpu")
    js = JLiveScorer(jb, TOPIC, "preds", None,
                     registry=JModelRegistry(tt.registry.root),
                     carhealth_topic=None)
    assert ts.wait_for_model(5.0) == js.wait_for_model(5.0) == "registry:v1"
    assert ts.scorer.score_available() == js.scorer.score_available() == 3000
    _assert_params_close(dict(ts.scorer.params),
                         jt.trainer.state.params, dict(rtol=0, atol=0))


# ---------------------------------------------------------- config and CLI
def test_mlops_config_section_resolves_from_env():
    env = {"IOTML_MLOPS_REGISTRY_DIR": "/tmp/r", "IOTML_MLOPS_QUEUE_DEPTH": "4",
           "IOTML_MLOPS_AUTO_PROMOTE": "false",
           "IOTML_MLOPS_WATCH_POLL_S": "0.5"}
    got = t_config.load_config([], env=env)[0].mlops
    want = j_config.load_config([], env=env)[0].mlops
    assert vars(got) == vars(want)
    assert (got.registry_dir, got.queue_depth, got.auto_promote) == \
        ("/tmp/r", 4, False)
    assert vars(t_config.MlopsConfig()) == vars(j_config.MlopsConfig())
    for mod in (t_config, j_config):
        with pytest.raises(ValueError):
            mod.load_config([], env={"IOTML_MLOPS_REGISTRY_DIRR": "/tmp/x"})


@pytest.mark.parametrize("as_json", [True, False])
def test_mlops_cli_registry_inspect(tmp_path, capsys, as_json):
    """Both CLIs print the same for the same registry root."""
    reg = ModelRegistry(str(tmp_path))
    v = reg.publish({"model.h5": b"m"}, offsets=[(TOPIC, 0, 4)],
                    metrics={"loss": 0.25}).version
    reg.promote(v)
    reg.publish({"model.h5": b"n"}, offsets=[(TOPIC, 0, 9)], step=3)
    reg.set_channel("candidate", 2)
    argv = ["registry", "--root", str(tmp_path)] + \
        (["--json"] if as_json else [])
    assert t_mlops_main(argv) == 0
    got = capsys.readouterr().out
    assert j_mlops_main(argv) == 0
    assert got == capsys.readouterr().out
    if as_json:
        doc = json.loads(got)
        assert doc["registry"]["versions"] == [1, 2]
        assert doc["registry"]["serving"] == 1
        assert [e["event"] for e in doc["history"]] == \
            ["publish", "promote", "publish", "set"]


def test_mlops_cli_drills_name_roadmap_a14(capsys):
    """The drills, once left out, are listed and run: ``drill`` exits
    with the verdict."""
    assert t_mlops_main(["list"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == ["rollback", "rollout"]
    assert not any("ROADMAP" in line for line in out)
    assert t_mlops_main(["drill", "--drill", "rollback", "--records",
                         "500"], device="cpu") == 0
    assert capsys.readouterr().out.rstrip().endswith(
        "DRILL PASS (rollback)")
    assert t_mlops_main([]) == 2


def test_manifest_from_dict_round_trip():
    m = Manifest(version=3, parent=2, created_ts=1.5,
                 offsets=[(TOPIC, 1, 7)], metrics={"loss": 0.1},
                 artifacts={"model.h5": {"sha256": "x", "bytes": 1}}, step=9)
    back = Manifest.from_dict(json.loads(json.dumps(m.to_dict())))
    assert back.to_dict() == m.to_dict()
