"""The port's one-command demo (``iotml_torch.cli.demo``) on the CPU:
fleet over MQTT TCP → bridge → KSQL → the fit (B1's plain version on the
CPU) → checkpoint → artifact store → scorer → report, held to the JAX
demo test's invariants (tests/test_platform_up.py) and to the JAX CLI's
flags and summary keys.

Tolerance: none; the invariants are counts, and the summary's keys and
the flags' defaults are equal.
"""

import json
import time

import pytest
import torch

from iotml.cli import demo as j_demo
from iotml_torch.cli import demo

ARGV = ["--cars", "6", "--seconds", "2", "--rate", "20", "--epochs", "2"]


def _summary(capsys, mod, argv, **kw):
    assert mod.main(argv, **kw) == 0
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


def test_demo_meets_the_jax_tests_invariants(capsys):
    s = _summary(capsys, demo, ARGV, device="cpu")
    assert s["mqtt_messages_bridged"] > 0
    assert s["ksql_avro_records"] == s["mqtt_messages_bridged"]
    assert s["scored"] == s["ksql_avro_records"]
    assert s["loss_first_to_last"][1] <= s["loss_first_to_last"][0]
    assert s["epochs"] == 2 and s["cars"] == 6
    assert 0 < s["trained_records_per_epoch"] <= s["ksql_avro_records"]
    assert s["eval_report"].endswith("demo-model-eval.zip")


def test_summary_keys_and_flags_equal_jax(capsys):
    got = _summary(capsys, demo, ARGV + ["--threshold", "0.5"],
                   device="cpu")
    want = _summary(capsys, j_demo, ARGV + ["--threshold", "0.5"])
    assert list(got) == list(want)
    assert got["anomaly_threshold"] == want["anomaly_threshold"] == 0.5
    assert got["epochs"] == want["epochs"]
    assert got["scored"] == got["ksql_avro_records"] > 0


def test_defaults_equal_jax():
    import argparse

    seen = {}

    def grab(mod):
        real = argparse.ArgumentParser.parse_args

        def parse(self, argv=None, ns=None):
            seen[mod] = vars(real(self, argv, ns))
            raise SystemExit(0)
        return parse

    for name, mod in (("torch", demo), ("jax", j_demo)):
        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = grab(name)
        try:
            with pytest.raises(SystemExit):
                mod.main([])
        finally:
            argparse.ArgumentParser.parse_args = orig
    assert seen["torch"] == seen["jax"] == {
        "cars": 50, "seconds": 8.0, "rate": 10.0, "epochs": 5,
        "failure_rate": 0.02, "threshold": None}


def test_no_device_and_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(ARGV)


def test_without_matplotlib_the_report_is_json_alone(capsys, monkeypatch):
    """A card's machine has no matplotlib: the demo says so on a line of
    its own, uploads report.json alone and meets the invariants."""
    import importlib.util
    import zipfile

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a:
                        None if name == "matplotlib" else real(name, *a))
    assert demo.main(ARGV, device="cpu") == 0
    out = capsys.readouterr().out
    assert "report: matplotlib is not installed" in out
    s = json.loads(out[out.index("{"):])
    assert s["scored"] == s["ksql_avro_records"] > 0
    with zipfile.ZipFile(s["eval_report"]) as z:
        assert z.namelist() == ["report.json"]


def _avro_records(plat) -> int:
    return sum(plat.broker.end_offset("SENSOR_DATA_S_AVRO", p)
               for p in range(plat.broker.topic("SENSOR_DATA_S_AVRO")
                              .partitions))


def _slow_front(seconds: float):
    """Every MQTT delivery (the front's hand-off to the bridge) delayed."""
    from iotml_torch.chaos import faults

    return faults.arm(faults.ChaosEngine([faults.FaultEvent(
        1, "mqtt.deliver", "delay", (("seconds", seconds),),
        repeat=1_000_000)]))


def test_a_slow_front_is_drained_before_the_stream_is_read():
    """The MQTT front 20 ms a delivery behind a 6-car fleet at 20 Hz: after
    the publisher's join and one pump (the old path) the KSQL output is
    still short of what was published; ``drain_ingest`` waits until the
    bridge has every published message and the KSQL output stops
    moving."""
    from iotml_torch.chaos import faults
    from iotml_torch.cli.up import Platform

    plat = Platform(partitions=4, device="cpu").start()
    try:
        _slow_front(0.02)
        plat.start_fleet(6, rate_hz=20)
        time.sleep(1.5)
        plat.stop_fleet()
        plat.pump()
        published = plat.fleet_published()
        assert published > 0
        assert _avro_records(plat) < published  # the race: a short stream
        assert plat.drain_ingest(deadline_s=60) == published
        assert plat.bridge.forwarded() == published == _avro_records(plat)
        plat.pump()
        assert _avro_records(plat) == published  # nothing left to move
    finally:
        faults.disarm()
        plat.stop()


def test_drain_ingest_raises_naming_what_is_missing():
    from iotml_torch.cli.up import Platform

    plat = Platform(partitions=4, device="cpu").start()
    try:
        plat._fleet_published = 7  # sent, and never reaching the front
        with pytest.raises(TimeoutError, match="7 of 7 published"):
            plat.drain_ingest(deadline_s=0.2)
    finally:
        plat.stop()


def test_the_demo_scores_every_record_behind_a_slow_front(capsys):
    """The demo with its front 15 ms a delivery behind (a backlog past the
    fleet's 2 s): the summary still reads scored == ksql_avro_records ==
    mqtt_messages_bridged, because training and scoring start only after
    ``drain_ingest``."""
    from iotml_torch.chaos import faults

    _slow_front(0.015)
    try:
        s = _summary(capsys, demo, ARGV, device="cpu")
    finally:
        faults.disarm()
    assert s["mqtt_messages_bridged"] > 0
    assert s["scored"] == s["ksql_avro_records"] == \
        s["mqtt_messages_bridged"]
