"""The port's device mesh and data-parallel trainer
(``iotml_torch.parallel``: ``mesh``, ``distributed``, ``data_parallel``)
held against the JAX package's on the CPU: the cases of
``tests/test_parallel.py`` on both packages, the port's eight CPU
shards standing where the JAX suite has eight virtual devices.

The same numpy-seeded batches and the JAX init converted by
``models/convert.py`` go through both ``ShardedTrainer``s.  Tolerances:
losses and params rtol 1e-4 / atol 1e-6 (``tests/test_parallel.py``'s
bound); the per-row pre-update losses rtol 1e-5 / atol 1e-7; shapes,
specs, partition splits and error messages equal.
"""

import jax
import numpy as np
import pytest
import torch

from iotml.data.dataset import Batch as JBatch
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml.parallel import data_parallel as j_dp
from iotml.parallel import distributed as j_dist
from iotml.parallel import mesh as j_mesh
from iotml_torch.data.dataset import Batch, SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.models.convert import params_from_jax
from iotml_torch.parallel import distributed
from iotml_torch.parallel.data_parallel import (ShardedTrainer,
                                                make_sharded_eval_step,
                                                param_specs, put_global,
                                                shard_params)
from iotml_torch.parallel.mesh import (P, ShardedTensor, auto_mesh,
                                       batch_sharding, make_mesh, replicated)
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.train.loop import Trainer, TrainState
from iotml_torch.train.optim import Adam

CPU8 = [torch.device("cpu")] * 8


def _distinct_devices(devices):
    return list(dict.fromkeys(devices))
TOL = dict(rtol=1e-4, atol=1e-6)


def _j_params(seed=0):
    return J_AE.init(jax.random.PRNGKey(seed),
                     np.zeros((1, 18), np.float32))["params"]


def _t_state(j_params):
    params = params_from_jax(j_params)
    return TrainState(step=0, params=params, opt_state=Adam().init(params))


def _batches(n, rows, seed=0, valid=None):
    """``n`` seeded batches of ``rows`` rows (the last ``valid`` valid)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.uniform(-1, 1, (rows, 18)).astype(np.float32)
        nv = rows if valid is None or i < n - 1 else valid
        x[nv:] = 0.0
        out.append((x, nv))
    return out


def _fit_both(batches, epochs, mesh_t, mesh_j, **kw):
    """The same batches and init through both packages' ShardedTrainer."""
    jp = _j_params()
    jt = j_dp.ShardedTrainer(J_AE, mesh_j, **kw)
    jt.init(batches[0][0])  # PRNGKey(0): the params _j_params() makes
    j_hist = jt.fit([JBatch(x=x, n_valid=nv, first_index=0)
                     for x, nv in batches], epochs=epochs)
    tt = ShardedTrainer(CAR_AUTOENCODER, mesh_t, **kw)
    tt.init(from_state=_t_state(jp))
    t_hist = tt.fit([Batch(x=x, n_valid=nv, first_index=0)
                     for x, nv in batches], epochs=epochs)
    return t_hist, j_hist, tt, jt


def _assert_params(t_state, j_state):
    want = params_from_jax(jax.device_get(j_state.params))
    for k, v in want.items():
        np.testing.assert_allclose(t_state.params[k].numpy(), v.numpy(),
                                   **TOL, err_msg=k)


# ------------------------------------------------------------------ mesh
def test_virtual_devices_present():
    """Eight CPU shards on the port's side, eight virtual devices on
    JAX's."""
    assert len(jax.devices()) == 8
    mesh = auto_mesh(devices=CPU8)
    assert mesh.size == 8 and all(d == torch.device("cpu")
                                  for d in mesh.devices.flat)


def test_auto_mesh_shapes():
    for mp in (1, 2, 4):
        t = auto_mesh(model_parallel=mp, devices=CPU8)
        j = j_mesh.auto_mesh(model_parallel=mp)
        assert dict(t.shape) == dict(j.shape)
        assert t.axis_names == tuple(j.axis_names) == ("data", "model")
    with pytest.raises(ValueError) as t_err:
        make_mesh((3, 2), ("a", "b"), devices=CPU8)
    with pytest.raises(ValueError) as j_err:
        j_mesh.make_mesh((3, 2), ("a", "b"))
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError) as t_err:
        auto_mesh(8, model_parallel=3, devices=CPU8)
    with pytest.raises(ValueError) as j_err:
        j_mesh.auto_mesh(8, model_parallel=3)
    assert str(t_err.value) == str(j_err.value)


def test_default_devices_are_the_visible_cards(monkeypatch):
    """No ``devices=``: every visible CUDA device, so a mesh on a machine
    without enough cards raises JAX's message."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    mesh = make_mesh((1,), ("data",))
    assert list(mesh.devices.flat) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match=r"needs 2 devices, have 1"):
        make_mesh((2, 1), ("data", "model"))


def test_batch_sharding_splits_rows():
    mesh = auto_mesh(devices=CPU8)
    x = np.arange(64 * 18, dtype=np.float32).reshape(64, 18)
    xd = put_global(x, batch_sharding(mesh))
    jd = jax.device_put(x, j_mesh.batch_sharding(j_mesh.auto_mesh()))
    assert len(xd.shards) == len(jd.addressable_shards) == 8
    assert [tuple(s.shape) for s in xd.shards] == \
        [s.data.shape for s in sorted(jd.addressable_shards,
                                      key=lambda s: s.index[0].start)]
    assert xd.shape == jd.shape == (64, 18)
    np.testing.assert_array_equal(xd.numpy(), np.asarray(jd))
    rep = put_global(x, replicated(mesh))
    assert len(rep.shards) == 1 and rep.shape == (64, 18)  # one device
    with pytest.raises(ValueError, match="do not split"):
        put_global(x[:63], batch_sharding(mesh))


def test_param_specs_tensor_parallel_hook():
    mesh = auto_mesh(model_parallel=2, devices=CPU8)
    jp = _j_params()
    params = params_from_jax(jp)
    specs = param_specs(params, mesh)
    j_specs = j_dp.param_specs(jp, j_mesh.auto_mesh(model_parallel=2))
    for layer, leaves in j_specs.items():
        for leaf, spec in leaves.items():
            name = f"{layer}.{'weight' if leaf == 'kernel' else 'bias'}"
            # [out, in] weights: JAX's kernel spec transposed
            want = P(*reversed(tuple(spec))) if leaf == "kernel" and spec \
                else P(*spec)
            assert specs[name] == want, name
    # encoder0 [14 out]: cut; encoder1 [7 out]: whole
    assert specs["encoder0.weight"] == P("model", None)
    assert specs["encoder1.weight"] == P()
    sharded = shard_params(params, mesh)
    w = sharded["encoder0.weight"]
    assert w.sharding.spec == specs["encoder0.weight"]
    assert [tuple(s.shape) for s in w.shards] == [(7, 18), (7, 18)]
    assert torch.equal(torch.cat(w.shards), params["encoder0.weight"])
    assert param_specs(params, auto_mesh(devices=CPU8)) == \
        {k: P() for k in params}


# ------------------------------------------------------------- training
def _stream_batches(num_cars=64, ticks=10, batch_size=64):
    broker = Broker()
    gen = FleetGenerator(FleetScenario(num_cars=num_cars, failure_rate=0.0))
    gen.publish(broker, "s", n_ticks=ticks)
    consumer = StreamConsumer(broker, ["s:0:0"])
    return SensorBatches(consumer, batch_size=batch_size, only_normal=True)


def test_sharded_trainer_dp_matches_single_chip():
    """Data parallelism over 8 shards equals the single-device fit."""
    st = ShardedTrainer(CAR_AUTOENCODER, auto_mesh(devices=CPU8))
    hist_dp = st.fit(_stream_batches(), epochs=2)
    tr = Trainer(CAR_AUTOENCODER, device="cpu")
    hist_ref = tr.fit(_stream_batches(), epochs=2, verbose=False)
    np.testing.assert_allclose(hist_dp["loss"], hist_ref["loss"], **TOL)
    for k, v in tr.state.params.items():
        np.testing.assert_allclose(st.state.params[k].numpy(), v.numpy(),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("rows,valid", [(100, 100), (100, 61), (64, 64)])
def test_sharded_trainer_matches_jax(rows, valid):
    """Batch 100 on 8 shards pads to 104 (the global loss divides by the
    valid count and the activity penalty by 104 rows, never a mean of
    shard means); a ragged last batch too."""
    batches = _batches(4, rows, seed=rows + valid, valid=valid)
    t_hist, j_hist, tt, jt = _fit_both(
        batches, 2, auto_mesh(devices=CPU8), j_mesh.auto_mesh())
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], **TOL)
    assert t_hist["records"] == j_hist["records"]
    assert tt.state.step == int(jt.state.step) == 8
    _assert_params(tt.state, jt.state)


def test_sharded_trainer_model_axis_matches_jax():
    """('data' 4, 'model' 2): the model axis is the layout's metadata,
    the data-axis devices hold whole replicas, and the fit is JAX's."""
    batches = _batches(3, 100, seed=5, valid=77)
    t_hist, j_hist, tt, jt = _fit_both(
        batches, 2, auto_mesh(model_parallel=2, devices=CPU8),
        j_mesh.auto_mesh(model_parallel=2))
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], **TOL)
    _assert_params(tt.state, jt.state)
    assert tuple(tt.state.params["encoder0.weight"].shape) == (14, 18)
    assert list(tt._states) == [torch.device("cpu")]  # one replica


def test_replicas_on_distinct_devices_stay_bit_identical():
    """Two data-axis devices, two replicas: one Adam update on each keeps
    them equal bit for bit (the CPU stands in for a second device)."""
    devices = [torch.device("cpu")] * 4 + [torch.device("cpu", 0)] * 4
    tt = ShardedTrainer(CAR_AUTOENCODER, auto_mesh(devices=devices))
    tt.init()
    assert list(tt._states) == _distinct_devices(devices)
    (x, _nv), = _batches(1, 64, seed=11)
    tt.step(x, x, np.ones((64,), np.float32))
    a, b = tt._states.values()
    assert a.step == b.step == 1
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k


def test_sharded_trainer_with_model_axis_runs():
    st = ShardedTrainer(CAR_AUTOENCODER,
                        auto_mesh(model_parallel=2, devices=CPU8))
    hist = st.fit(_stream_batches(ticks=4), epochs=1)
    assert np.isfinite(hist["loss"]).all()


def test_row_loss_and_step_metrics_match_jax():
    """``row_loss=True``: each row's masked pre-update MSE, row-sharded
    and padding rows 0; loss and accuracy are the batch's."""
    (x, nv), = _batches(1, 100, seed=3, valid=90)
    mask = np.zeros((100,), np.float32)
    mask[:nv] = 1.0
    jt = j_dp.ShardedTrainer(J_AE, j_mesh.auto_mesh(), row_loss=True)
    jm = jt.step(x, x, mask)
    tt = ShardedTrainer(CAR_AUTOENCODER, auto_mesh(devices=CPU8),
                        row_loss=True)
    tt.init(from_state=_t_state(_j_params()))
    tm = tt.step(x, x, mask)
    rl = tm["row_loss"]
    assert isinstance(rl, ShardedTensor) and len(rl.shards) == 8
    assert rl.shape == (104,)
    np.testing.assert_allclose(rl.numpy(), np.asarray(jm["row_loss"]),
                               rtol=1e-5, atol=1e-7)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL)


def test_state_round_trips_through_the_model_axis_blocks():
    """On a mesh with a model axis the setter lays the state on the
    devices and the getter returns it bit for bit, Adam moments
    included."""
    tt = ShardedTrainer(CAR_AUTOENCODER,
                        auto_mesh(model_parallel=2, devices=CPU8))
    tt.init()
    (x, nv), = _batches(1, 48, seed=9)
    tt.step(x, x, np.ones((48,), np.float32))
    st = tt.state
    tt.state = st
    again = tt.state
    assert again.step == st.step == 1
    for tree in ("params",):
        for k, v in getattr(st, tree).items():
            assert torch.equal(getattr(again, tree)[k], v)
    for k, v in st.opt_state.mu.items():
        assert torch.equal(again.opt_state.mu[k], v)
        assert torch.equal(again.opt_state.nu[k], st.opt_state.nu[k])


def test_sharded_eval_step_matches_jax():
    jp = _j_params()
    params = params_from_jax(jp)
    x = np.random.default_rng(4).uniform(-1, 1, (100, 18)).astype(
        np.float32)
    ev = make_sharded_eval_step(CAR_AUTOENCODER.build("cpu"),
                                auto_mesh(devices=CPU8))
    out = ev(params, x)
    j_ev = j_dp.make_sharded_eval_step(J_AE, j_mesh.auto_mesh())
    want = np.asarray(j_ev(jp, np.concatenate(
        [x, np.zeros((4, 18), np.float32)])))
    assert out.shape == (104, 18) and len(out.shards) == 8
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)


def test_multi_process_shape_agreement_is_skipped_alone():
    """One process: no collective, any shape; the agreed shape stays
    unset."""
    assert distributed.process_count() == 1
    tt = ShardedTrainer(CAR_AUTOENCODER, auto_mesh(2, devices=CPU8))
    for rows in (10, 12):
        x = np.zeros((rows, 18), np.float32)
        tt.step(x, x, np.ones((rows,), np.float32))
    assert tt._agreed_shape is None


# ------------------------------------------------------------- placement
def test_partition_assignment():
    seen = []
    for h in range(4):
        ps = distributed.assign_partitions(10, 4, h)
        assert ps == j_dist.assign_partitions(10, 4, h)
        seen.extend(ps)
        assert ps == sorted(ps)
    assert sorted(seen) == list(range(10))
    assert distributed.consumer_specs("sensor-data", [0, 4], offset=7) == \
        j_dist.consumer_specs("sensor-data", [0, 4], offset=7) == \
        ["sensor-data:0:7", "sensor-data:4:7"]
    for mod in (distributed, j_dist):
        with pytest.raises(ValueError, match="out of range"):
            mod.assign_partitions(4, 2, 2)


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    for k in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert distributed.initialize(num_processes=1, device="cpu") is False
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(device="cpu")


@pytest.mark.parametrize("local_rank,given,want", [
    (None, "cuda", 3),        # no launcher: the current CUDA device
    ("5", "cuda", 1),         # LOCAL_RANK % device_count
    ("5", None, 1),           # the default device is cuda too
    (None, "cuda:2", 2),      # an index given stays
])
def test_initialize_under_nccl_sets_an_indexed_cuda_device(
        monkeypatch, local_rank, given, want):
    """A CUDA device given without an index (or none at all) reaches
    ``torch.cuda.set_device`` with an integer index, so the default join
    of the multi-host manifest does not die on ``cuda``."""
    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.setdefault("device", d))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.setdefault("group", kw))
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert distributed.initialize("127.0.0.1:1", 2, 1, device=given) is True
    dev = calls["device"]
    assert dev == torch.device("cuda", want) and dev.index == want
    assert calls["group"]["backend"] == "nccl"
    assert (calls["group"]["world_size"], calls["group"]["rank"]) == (2, 1)
    assert distributed.rank_device(given) == torch.device("cuda", want)
