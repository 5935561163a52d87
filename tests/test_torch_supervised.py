"""The supervised platform of the port (``iotml_torch.cli.up``): the units
of ``Platform.supervised()`` against the JAX package's (a platform built
without Connect has no ``connect-driver``), a dead KSQL pump
respawned as JAX's test does (``tests/test_supervise.py``), a crashed
``ckpt-writer`` restarted with the snapshot still queued published bit for
bit, ``--supervise`` / ``IOTML_SUPERVISE`` on the command line, and the
``unit_loop`` bodies of ``AsyncCheckpointer`` and ``RegistryWatcher``
under a ``Supervisor``.  Everything runs on the CPU."""

import time
import types

import numpy as np
import pytest
import torch

from iotml.cli.up import Platform as JPlatform
from iotml.mlops import AsyncCheckpointer as JAsyncCheckpointer
from iotml_torch.chaos import faults
from iotml_torch.chaos.faults import ChaosEngine, FaultEvent
from iotml_torch.cli import up
from iotml_torch.cli.up import Platform
from iotml_torch.mlops import (AsyncCheckpointer, ModelRegistry,
                               RegistryWatcher)
from iotml_torch.mlops.checkpoint import (params_from_h5_bytes,
                                          params_to_h5_bytes)
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.supervise.supervisor import RUNNING, Supervisor
from iotml_torch.train.loop import Trainer


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    yield
    faults.disarm()


def _wait_for(cond, timeout_s: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _state(seed: int):
    tr = Trainer(CAR_AUTOENCODER, seed=seed, device="cpu")
    tr._ensure_state()
    return tr.state


def test_supervised_units_equal_jax_less_connect_driver(tmp_path):
    names = {}
    for kind, make, ck in (
            ("jax", lambda d: JPlatform(partitions=2, registry_dir=d),
             JAsyncCheckpointer),
            ("port", lambda d: Platform(partitions=2, registry_dir=d,
                                        cc_port=0, device="cpu"),
             AsyncCheckpointer)):
        plat = make(str(tmp_path / kind)).start()
        try:
            plat.start_fleet(2, rate_hz=5.0)
            writer = plat.attach_checkpointer(ck(plat.model_registry))
            sup = plat.supervised()
            names[kind] = [u.name for u in sup.units()]
            assert writer._external  # the supervisor owns the writer loop
            assert writer.start() is writer and writer._thread is None
        finally:
            plat.stop()
    assert "connect-driver" in names["jax"]
    assert names["port"] == [n for n in names["jax"]
                             if n != "connect-driver"]
    assert names["port"] == [
        "kafka-wire", "mqtt-front", "ksql-tasks", "schema-registry",
        "control-center", "fleet", "registry-watcher", "ckpt-writer"]


def test_supervised_poll_interval_from_the_environment(monkeypatch):
    plat = Platform(partitions=1, device="cpu").start()
    try:
        monkeypatch.setenv("IOTML_SUPERVISE_POLL_S", "0.125")
        assert plat.supervised().poll_interval_s == 0.125
        monkeypatch.delenv("IOTML_SUPERVISE_POLL_S")
        assert plat.supervised().poll_interval_s == 0.25
        assert plat.supervised(poll_interval_s=0.02).poll_interval_s == 0.02
    finally:
        plat.stop()


def test_platform_supervised_restarts_dead_pump():
    plat = Platform(partitions=2, device="cpu")
    plat.start()
    sup = plat.supervised(poll_interval_s=0.02).start()
    try:
        names = {u.name for u in sup.units()}
        assert {"kafka-wire", "mqtt-front", "ksql-tasks",
                "schema-registry"} <= names
        assert "connect-driver" not in names
        assert _wait_for(lambda: sup.unit("ksql-tasks").state == RUNNING)
        rest_thread = plat.ksql._thread
        # kill the continuous-query pump thread the way a bug would: stop
        # flag set, the thread exits, nobody restarts it by hand
        plat.ksql._stop.set()
        assert _wait_for(lambda: sup.unit("ksql-tasks").restarts >= 1)
        plat.ksql._stop.clear()
        assert _wait_for(
            lambda: plat.ksql._pump_thread.is_alive()
            and sup.unit("ksql-tasks").state == RUNNING)
        # the pump alone: the REST serving thread is the one it was
        assert plat.ksql._thread is rest_thread
    finally:
        sup.stop()
        plat.stop()


def test_crashed_ckpt_writer_restarts_with_its_queue(tmp_path):
    """The writer dies at ``ckpt.write`` on the first snapshot; the
    supervisor restarts it and the snapshot still queued is published,
    its weights and cursors those it was taken with."""
    plat = Platform(partitions=1, registry_dir=str(tmp_path),
                    device="cpu").start()
    writer = plat.attach_checkpointer(
        AsyncCheckpointer(plat.model_registry, queue_depth=2))
    sup = plat.supervised(poll_interval_s=0.02)
    first, second = _state(1), _state(2)
    writer.snapshot(first, [("t", 0, 5)])
    writer.snapshot(second, [("t", 0, 9)])
    faults.arm(ChaosEngine([FaultEvent(1, "ckpt.write", "error",
                                       (("exc", "RuntimeError"),))]))
    sup.start()
    try:
        # published, then promoted by the writer (auto_promote)
        assert _wait_for(lambda: plat.model_registry.versions() == [1]
                         and plat.model_registry.channel("serving") == 1)
        unit = sup.unit("ckpt-writer")
        assert unit.restarts == 1 and writer.pending() == 0
        assert "RuntimeError" in writer.last_error
        m = plat.model_registry.manifest(1)
        assert [tuple(o) for o in m.offsets] == [("t", 0, 9)]
        got = params_from_h5_bytes(
            plat.model_registry.load_bytes(1, "model.h5"))
        for k, v in second.params.items():
            assert torch.equal(got[k], v), k
    finally:
        sup.stop()
        plat.stop()


@pytest.mark.parametrize("how", ["flag", "env"])
def test_cli_supervise_prints_its_units(how, capsys, monkeypatch):
    seen = {}

    def sleep(_seconds):
        """main's wait: returns control as Ctrl-C would, once the
        supervisor has seen every unit run."""
        sup = seen["sup"]
        assert _wait_for(lambda: all(u.state == RUNNING
                                     for u in sup.units()))
        raise KeyboardInterrupt

    real = up.Platform

    def platform(*a, **kw):
        plat = real(*a, **kw)
        supervised = plat.supervised

        def spy(*sa, **skw):
            seen["sup"] = supervised(*sa, **skw)
            return seen["sup"]

        plat.supervised = spy
        seen["plat"] = plat
        return plat

    monkeypatch.setattr(up, "Platform", platform)
    monkeypatch.setattr(up, "time", types.SimpleNamespace(sleep=sleep))
    argv = ["--metrics-port", "0"]
    if how == "flag":
        argv.append("--supervise")
    else:
        monkeypatch.setenv("IOTML_SUPERVISE", "1")
    assert up.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    n = len(seen["sup"].units())
    # kafka-wire, mqtt-front, ksql-tasks, connect-driver, registry, cc
    assert n == 6
    assert f"  supervisor       {n} units (self-healing; states on " \
           f"/healthz)" in out
    assert out.rstrip().endswith("stopped.")
    assert not seen["plat"].started
    assert not any(u.alive() for u in seen["sup"].units()
                   if u.loop is not None)


def test_checkpointer_unit_loop_under_a_supervisor(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    ck = AsyncCheckpointer(reg)
    sup = Supervisor(poll_interval_s=0.02)
    sup.add_loop("ckpt-writer", ck.unit_loop(), heartbeat_timeout_s=30.0)
    assert ck._external and ck.start() is ck and ck._thread is None
    sup.start()
    try:
        state = _state(3)
        ck.snapshot(state, [("t", 1, 4)])
        assert _wait_for(lambda: reg.versions() == [1])
        assert sup.unit("ckpt-writer").state == RUNNING
        got = params_from_h5_bytes(reg.load_bytes(1, "model.h5"))
        assert all(torch.equal(got[k], v) for k, v in state.params.items())
    finally:
        sup.stop()


def test_watcher_unit_loop_swaps_under_a_supervisor(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    swaps = []
    scorer = types.SimpleNamespace(
        set_params=lambda params, version=None: swaps.append(version))
    watcher = RegistryWatcher(reg, scorers=[scorer], poll_interval_s=0.01)
    sup = Supervisor(poll_interval_s=0.02)
    sup.add_loop("registry-watcher", watcher.unit_loop(),
                 heartbeat_timeout_s=30.0)
    sup.start()
    try:
        for seed in (1, 2):
            v = reg.publish({"model.h5": params_to_h5_bytes(
                _state(seed).params)}).version
            reg.promote(v)
            assert _wait_for(lambda: watcher.current_version == v)
        assert swaps == [1, 2] and watcher.swaps == 2
        assert sup.unit("registry-watcher").restarts == 0
    finally:
        sup.stop()
        watcher.stop()
    assert not np.isnan(watcher.last_swap_s)
