"""The port's record tracing (``iotml_torch.obs.tracing``) held against
the JAX package's (``iotml.obs.tracing``) on the CPU: the header wire
format both ways, the collector and its exporters, the pipeline's stages
from the fleet publish through the batcher to the train step and the
scorer, the forks of two pipelines over one topic, the wire server's
hop, ``/healthz`` liveness, the environment toggles and ``python -m
iotml_torch.obs trace`` on a span log the JAX package wrote.

Tolerances: the encoded header is byte-identical in both directions
under one monotonic clock; both packages trace the same stages with the
same number of spans a stage and the same e2e closes; span-log lines
have the same keys (durations and ids aside); the trace CLI's JSON
summary of one span log is equal in both packages.
"""

import contextlib
import io
import json
import os
import time
import urllib.request

import jax
import numpy as np
import pytest

from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.gen.simulator import FleetGenerator as JFleetGenerator
from iotml.gen.simulator import FleetScenario as JFleetScenario
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml.obs import tracing as j_tracing
from iotml.obs.__main__ import main as j_obs_main
from iotml.serve.scorer import StreamScorer as JStreamScorer
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.producer import OutputSequence as JOutputSequence
from iotml.train.loop import Trainer as JTrainer
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.models.convert import params_from_jax
from iotml_torch.obs import metrics as t_metrics
from iotml_torch.obs import tracing
from iotml_torch.obs.__main__ import main as obs_main
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.kafka_wire import KafkaWireBroker, KafkaWireServer
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.train.loop import Trainer

TOPIC = "SENSOR_DATA_S_AVRO"


def _off(tr):
    tr.configure(enabled=False, sample=1.0)
    tr.reset()
    tr._PATH = None


@pytest.fixture
def traced(tmp_path):
    """Tracing on in both packages, full sampling, one span log each;
    both restored after."""
    paths = (str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl"))
    for tr, path in ((tracing, paths[0]), (j_tracing, paths[1])):
        tr.reset()
        tr.configure(enabled=True, sample=1.0, path=path)
    try:
        yield paths
    finally:
        _off(tracing)
        _off(j_tracing)


@pytest.fixture(autouse=True)
def _tracing_restored():
    yield
    _off(tracing)
    _off(j_tracing)


def _rows(path):
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(line) for line in fh]


# ------------------------------------------------------------ wire format
def test_header_bytes_identical_both_ways(monkeypatch):
    monkeypatch.setattr(time, "monotonic", lambda: 5000.25)
    t = tracing.TraceContext(trace_id=0x0123456789ABCDEF, t0=4999.75,
                             wall0_ns=1_700_000_000_123_456_789)
    j = j_tracing.TraceContext(trace_id=0x0123456789ABCDEF, t0=4999.75,
                               wall0_ns=1_700_000_000_123_456_789)
    raw = t.encode()
    assert raw == j.encode() == \
        b"iotml1;0123456789abcdef;1700000000123456789;500000000"
    for decode, other in ((tracing.TraceContext.decode, j.encode()),
                          (j_tracing.TraceContext.decode, raw)):
        back = decode(other)
        assert (back.trace_id, back.wall0_ns, back.t0) == \
            (0x0123456789ABCDEF, 1_700_000_000_123_456_789, 4999.75)
    for junk in (b"junk", b"other1;00;1;2", b"iotml1;zz;1;2", b"\xff"):
        assert tracing.TraceContext.decode(junk) is None
        assert j_tracing.TraceContext.decode(junk) is None
    assert tracing.from_headers(((tracing.HEADER_KEY, raw),)).trace_id == \
        0x0123456789ABCDEF
    assert tracing.from_headers(None) is None
    assert tracing.HEADER_KEY == j_tracing.HEADER_KEY


def test_context_marks_and_closes_spans(traced):
    ctx = tracing.start("devsim_publish")
    ctx.mark("consume")
    ctx.close("score")
    ctx.close("score")  # idempotent
    ctx.mark("late")  # a closed context records nothing more
    assert tracing.flush() == {"spans": 3, "e2e": 1}
    rows = _rows(traced[0])
    assert [r["stage"] for r in rows if r["kind"] == "span"] == \
        ["devsim_publish", "consume", "score"]
    assert len({r["trace"] for r in rows}) == 1


def test_disabled_records_nothing_and_attaches_no_headers():
    tracing.reset()
    assert tracing.ENABLED is False
    assert tracing.start("devsim_publish") is None
    assert tracing.headers_for(None) is None
    broker = Broker()
    FleetGenerator(FleetScenario(num_cars=5)).publish(broker, TOPIC)
    assert all(m.headers is None for m in broker.fetch(TOPIC, 0, 0))
    assert tracing.flush() == {"spans": 0, "e2e": 0}


def test_sampling_zero_traces_nothing(traced):
    tracing.configure(sample=0.0)
    assert tracing.start("devsim_publish") is None


def test_broker_carries_headers_through_produce_and_fetch():
    broker = Broker()
    broker.create_topic("t", partitions=2)
    hdr = (("iotml_trace", "x"),)
    broker.produce("t", b"v1", key=b"k", headers=hdr)
    broker.produce_many("t", [(b"k", b"v2", 0, hdr), (b"k", b"v3", 0)])
    by_val = {m.value: m.headers for p in range(2)
              for m in broker.fetch("t", p, 0)}
    assert by_val == {b"v1": hdr, b"v2": hdr, b"v3": None}


def test_headers_move_no_offset_or_payload_byte(traced):
    """The same records traced and untraced: equal offsets, keys, values
    and timestamps; only the headers differ."""
    def publish():
        b = Broker()
        FleetGenerator(FleetScenario(num_cars=30, seed=4)).publish(
            b, TOPIC, n_ticks=3, partitions=2)
        return [m for p in range(2) for m in b.fetch(TOPIC, p, 0)]

    on = publish()
    _off(tracing)
    off = publish()
    assert [m[:6] for m in on] == [m[:6] for m in off]
    assert all(m.headers for m in on) and not any(m.headers for m in off)


# -------------------------------------------------------- pipeline level
def _brokers(n_ticks=4, cars=50):
    t, j = Broker(), JBroker()
    FleetGenerator(FleetScenario(num_cars=cars, seed=3)).publish(
        t, TOPIC, n_ticks=n_ticks, partitions=1)
    JFleetGenerator(JFleetScenario(num_cars=cars, seed=3)).publish(
        j, TOPIC, n_ticks=n_ticks, partitions=1)
    return t, j


def _stage_counts(rows):
    out = {}
    for r in rows:
        key = (r["kind"], r.get("stage") or r.get("closer"))
        out[key] = out.get(key, 0) + 1
    return out


def _keys(rows):
    return {r["kind"]: sorted(r) for r in rows}


def test_train_and_score_trace_the_same_stages_as_jax(traced):
    tb, jb = _brokers()
    jp = jax.device_get(J_AE.init(jax.random.PRNGKey(0),
                                  np.zeros((1, 18), np.float32))["params"])
    spec = [f"{TOPIC}:0:0"]
    # train: fit_compiled over the slice, 2 epochs
    Trainer(CAR_AUTOENCODER, device="cpu").fit_compiled(
        SensorBatches(StreamConsumer(tb, spec, group="train"),
                      batch_size=25), epochs=2)
    JTrainer(J_AE).fit_compiled(
        JSensorBatches(JStreamConsumer(jb, spec, group="train"),
                       batch_size=25), epochs=2)
    # score: another group over the same topic
    for b in (tb, jb):
        b.create_topic("preds")
    ts = StreamScorer(CAR_AUTOENCODER, params_from_jax(jp),
                      SensorBatches(StreamConsumer(tb, spec, group="serve"),
                                    batch_size=25),
                      OutputSequence(tb, "preds", partition=0), device="cpu")
    js = JStreamScorer(J_AE, jp,
                       JSensorBatches(JStreamConsumer(jb, spec,
                                                      group="serve"),
                                      batch_size=25),
                       JOutputSequence(jb, "preds", partition=0))
    assert ts.score_available() == js.score_available() == 200
    assert tracing.flush()["e2e"] == j_tracing.flush()["e2e"] == 400
    t_rows, j_rows = _rows(traced[0]), _rows(traced[1])
    assert _stage_counts(t_rows) == _stage_counts(j_rows) == {
        ("span", "devsim_publish"): 200, ("span", "consume"): 400,
        ("span", "train"): 200, ("span", "score"): 200,
        ("e2e", "train"): 200, ("e2e", "score"): 200}
    assert _keys(t_rows) == _keys(j_rows)
    # one trace id, two closers: each pipeline closed its own fork
    closers = {}
    for r in t_rows:
        if r["kind"] == "e2e":
            closers.setdefault(r["trace"], set()).add(r["closer"])
    assert len(closers) == 200
    assert all(v == {"train", "score"} for v in closers.values())


def test_step_loop_fit_closes_once_over_epoch_rereads(traced):
    tb, _ = _brokers(n_ticks=2, cars=30)
    batches = SensorBatches(StreamConsumer(tb, [f"{TOPIC}:0:0"],
                                           group="train"), batch_size=10)
    Trainer(CAR_AUTOENCODER, device="cpu").fit(batches, epochs=3)
    tracing.flush()
    closers = [r["closer"] for r in _rows(traced[0]) if r["kind"] == "e2e"]
    assert closers == ["train"] * 60


def test_truncated_drain_defers_close_until_complete(traced):
    tb, _ = _brokers(n_ticks=3, cars=10)
    tb.create_topic("preds")
    scorer = StreamScorer(
        CAR_AUTOENCODER, None,
        SensorBatches(StreamConsumer(tb, [f"{TOPIC}:0:0"], group="s"),
                      batch_size=10),
        OutputSequence(tb, "preds", partition=0), device="cpu")
    scorer.set_params({k: v for k, v in scorer.params.items()})
    scorer.max_super_batches = 1
    assert scorer.score_available(max_rows=10) == 10
    tracing.flush()
    assert not any(r["kind"] == "e2e" for r in _rows(traced[0]))
    assert scorer.score_available() == 20
    tracing.flush()
    assert sum(r["kind"] == "e2e" for r in _rows(traced[0])) == 30


def test_large_drain_holds_every_pending_fork(traced):
    tb, _ = _brokers(n_ticks=50, cars=100)
    batches = SensorBatches(StreamConsumer(tb, [f"{TOPIC}:0:0"], group="b"),
                            batch_size=100)
    assert sum(b.n_valid for b in batches) == 5000
    forks = batches.take_traces()
    assert len(forks) == 5000 and batches.take_traces() == []
    for ctx in forks:
        ctx.close("score")
    assert tracing.flush()["e2e"] == 5000


def test_wire_server_marks_its_hop_and_the_client_drops_headers(traced):
    tb, _ = _brokers(n_ticks=2, cars=20)
    births = [m.headers[0][1] for m in tb.fetch(TOPIC, 0, 0)]
    t_last = [c.t_last for c in births]
    with KafkaWireServer(tb) as srv:
        client = KafkaWireBroker(f"127.0.0.1:{srv.port}")
        try:
            msgs = client.fetch(TOPIC, 0, 0, 100)
        finally:
            client.close()
    assert len(msgs) == 40 and all(m.headers is None for m in msgs)
    tracing.flush()
    rows = _rows(traced[0])
    batch = [r for r in rows if r["kind"] == "batch"]
    assert len(batch) == 1 and batch[0]["stage"] == "wire_fetch"
    assert (batch[0]["first_offset"], batch[0]["last_offset"],
            batch[0]["n"]) == (0, 39, 40)
    # the broker's own contexts stay unmarked for in-process readers
    assert [c.t_last for c in births] == t_last
    assert sum(r["kind"] == "span" and r["stage"] == "wire_fetch"
               for r in rows) == 1


# -------------------------------------------------- liveness and exporters
def test_liveness_and_healthz_serve_stage_ages(traced):
    ctx = tracing.start("devsim_publish")
    ctx.close("score")
    ages = tracing.liveness()
    assert set(ages) >= {"devsim_publish", "score"}
    assert all(a >= 0 for a in ages.values())
    tracing.touch("consume")
    srv = t_metrics.start_http_server(0)
    try:
        port = srv.server_address[1]
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10).read())
        assert doc["tracing"] is True
        assert {"devsim_publish", "score", "consume"} <= set(doc["stages"])
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert 'iotml_stage_seconds_count{stage="devsim_publish"}' in body
    finally:
        srv.shutdown()
        srv.server_close()


def test_unwritable_span_log_counts_instead_of_raising(tmp_path):
    tracing.configure(enabled=True, path=str(tmp_path / "no" / "dir.jsonl"))
    before = tracing.log_write_errors.value()
    tracing.start("devsim_publish").close("score")
    assert tracing.flush() == {"spans": 2, "e2e": 1}
    assert tracing.log_write_errors.value() - before == 3


def test_env_configuration_equals_jax(tmp_path):
    for tr in (tracing, j_tracing):
        tr.configure_from_env({"IOTML_TRACE": "1",
                               "IOTML_TRACE_SAMPLE": "0.25",
                               "IOTML_TRACE_PATH": str(tmp_path / "s")})
        assert (tr.ENABLED, tr._SAMPLE, tr._PATH) == \
            (True, 0.25, str(tmp_path / "s"))
        tr.configure_from_env({"IOTML_TRACE": "off",
                               "IOTML_TRACE_SAMPLE": "7"})
        assert (tr.ENABLED, tr._SAMPLE) == (False, 1.0)


# ------------------------------------------------------------ trace CLI
def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_obs_trace_cli_summarizes_a_jax_span_log(traced):
    jb = JBroker()
    JFleetGenerator(JFleetScenario(num_cars=20, seed=3)).publish(
        jb, TOPIC, n_ticks=2)
    batches = JSensorBatches(JStreamConsumer(jb, [f"{TOPIC}:0:0"],
                                             group="cli"), batch_size=10)
    JTrainer(J_AE).fit_compiled(batches, epochs=1)
    j_tracing.flush()
    path = traced[1]
    assert _run(obs_main, [])[0] == 2  # no subcommand
    rc, text = _run(obs_main, ["trace", path, "--json"])
    jrc, jtext = _run(j_obs_main, ["trace", path, "--json"])
    assert rc == jrc == 0
    got, want = json.loads(text), json.loads(jtext)
    assert got == want and got["bottleneck"] in {
        "devsim_publish", "consume", "train"}
    assert got["e2e"]["train"]["count"] == 40
    rc, text = _run(obs_main, ["trace", path, "--show-trace"])
    assert rc == 0 and "bottleneck:" in text and "trace " in text
    rc, text = _run(obs_main, ["trace", path, "--min-stages", "9",
                               "--require-cross-process", "2"])
    assert rc == 1 and text.count("TRACE CHECK FAILED") == 2
    assert _run(obs_main, ["trace", path + ".missing"])[0] == 2


@pytest.mark.parametrize("cmd,item", [("fleet", "A13"), ("tsdb", "A13")])
def test_obs_cli_unported_subcommands_name_their_item(cmd, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        obs_main([cmd, "--once"])


def test_collector_loses_no_span_under_concurrent_drains(traced):
    """Eight recording threads against two draining ones, with a short
    switch interval: every span recorded is drained exactly once."""
    import sys
    import threading

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    got = {"spans": 0, "e2e": 0}
    lock = threading.Lock()
    done = threading.Event()

    def record():
        for _ in range(500):
            tracing.start("devsim_publish").close("score")

    def drain():
        while not done.is_set():
            n = tracing.flush()
            with lock:
                for k in got:
                    got[k] += n[k]

    try:
        drainers = [threading.Thread(target=drain) for _ in range(2)]
        writers = [threading.Thread(target=record) for _ in range(8)]
        for t in drainers + writers:
            t.start()
        for t in writers:
            t.join(timeout=60)
        done.set()
        for t in drainers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in drainers + writers)
    finally:
        sys.setswitchinterval(interval)
    n = tracing.flush()
    assert got["spans"] + n["spans"] == 8 * 500 * 2
    assert got["e2e"] + n["e2e"] == 8 * 500
