"""The port's MQTT layer (``iotml_torch.mqtt``: topic tree, broker core,
wire codec and protocol state machine, the threaded and epoll fronts,
the Kafka-extension bridge, the device-simulator scenarios) held against
the JAX package's on the same inputs.

Tolerance: none.  Matching, receivers, packet bytes, parsed frames, the
protocol's answers to a packet script, deliveries, queues, records
(keys, values, partitions, offsets) and scenario counts are equal;
exceptions match by type and message.  Every socket has a timeout and
every wait a deadline; servers and clients stop in ``finally`` blocks;
every port is 0.
"""

import dataclasses
import json
import socket
import struct
import threading
import time
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import iotml.mqtt.bridge as j_bridge
import iotml.mqtt.broker as j_broker
import iotml.mqtt.eventserver as j_es
import iotml.mqtt.scenario as j_scenario
import iotml.mqtt.topic_tree as j_tt
import iotml.mqtt.wire as j_wire
from iotml.chaos import faults as j_faults
from iotml.chaos.scenarios import FaultEvent as JFaultEvent
from iotml.obs import tracing as j_tracing
from iotml.stream.broker import Broker as JBroker
import iotml_torch.mqtt.bridge as t_bridge
import iotml_torch.mqtt.broker as t_broker
import iotml_torch.mqtt.eventserver as t_es
import iotml_torch.mqtt.scenario as t_scenario
import iotml_torch.mqtt.topic_tree as t_tt
import iotml_torch.mqtt.wire as t_wire
from iotml_torch.chaos import faults as t_faults
from iotml_torch.obs import tracing as t_tracing
from iotml_torch.stream.broker import Broker as TBroker

PKG = {
    "torch": types.SimpleNamespace(
        tt=t_tt, broker=t_broker, wire=t_wire, es=t_es, bridge=t_bridge,
        scenario=t_scenario, Broker=TBroker, faults=t_faults,
        FaultEvent=t_faults.FaultEvent, tracing=t_tracing),
    "jax": types.SimpleNamespace(
        tt=j_tt, broker=j_broker, wire=j_wire, es=j_es, bridge=j_bridge,
        scenario=j_scenario, Broker=JBroker, faults=j_faults,
        FaultEvent=JFaultEvent, tracing=j_tracing),
}
T, J = PKG["torch"], PKG["jax"]
W = t_wire  # packet builders for scripts (byte-identical to JAX's)


def _outcome(fn, *args, **kw):
    """fn's value, or its exception as (type name, message)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the exception IS the outcome
        return ("raise", type(e).__name__, str(e))


def _wait_for(fn, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.01)
    return fn()


# ------------------------------------------------------------ topic tree
MATCH_TABLE = [
    ("vehicles/sensor/data/#", "vehicles/sensor/data/car-1", True),
    ("vehicles/sensor/data/#", "vehicles/sensor/data/a/b/c", True),
    ("vehicles/sensor/data/#", "vehicles/sensor/data", True),
    ("vehicles/sensor/data/#", "vehicles/sensor/other/car-1", False),
    ("vehicles/+/data/+", "vehicles/sensor/data/car-1", True),
    ("vehicles/+/data/+", "vehicles/sensor/data/a/b", False),
    ("+", "vehicles", True),
    ("+", "vehicles/sensor", False),
    ("#", "anything/at/all", True),
    ("#", "$SYS/broker/load", False),
    ("+/monitor", "$SYS/monitor", False),
    ("$SYS/#", "$SYS/broker/load", True),
    ("sport/tennis/player1/#", "sport/tennis/player1/ranking", True),
    ("a/b", "a/b/c", False),
    ("a/b/c", "a/b", False),
    ("+/+", "/x", True),
    ("/#", "/", True),
    ("a//b", "a//b", True),
]


@pytest.mark.parametrize("filt,topic,expect", MATCH_TABLE)
def test_topic_matches_equal_jax(filt, topic, expect):
    assert t_tt.topic_matches(filt, topic) is expect
    assert j_tt.topic_matches(filt, topic) is expect


@pytest.mark.parametrize("filt", [
    "$share/consumers/vehicles/#", "vehicles/#", "$share/nogroup",
    "$share//x", "$share/g/", "", "a/#/b", "a/b#", "a/+b", "+/+/#",
    "$share/g/a/+/#", "#", "a/#"])
def test_split_share_and_validate_equal_jax(filt):
    assert _outcome(t_tt.split_share, filt) == \
        _outcome(j_tt.split_share, filt)
    assert _outcome(t_tt.validate_filter, filt) == \
        _outcome(j_tt.validate_filter, filt)


def _tree_script(m, steps):
    tree = m.tt.TopicTree()
    out = []
    for op, *a in steps:
        if op == "sub":
            out.append(_outcome(tree.subscribe, *a))
        elif op == "unsub":
            out.append(_outcome(tree.unsubscribe, *a))
        elif op == "unsub_all":
            out.append(_outcome(tree.unsubscribe_all, *a))
        elif op == "recv":
            topic, live = a
            is_live = None if live is None else (lambda cid: cid in live)
            out.append(tree.receivers(topic, is_live=is_live))
        elif op == "filters":
            out.append(tree.filters_of(*a))
    return out


TREE_SCRIPTS = {
    "overlap": [("sub", "a", "vehicles/sensor/data/#", 1),
                ("sub", "b", "vehicles/+/data/car-1", 0),
                ("sub", "c", "vehicles/sensor/data/car-1", 2),
                ("recv", "vehicles/sensor/data/car-1", None),
                ("sub", "a", "vehicles/#", 0),
                ("recv", "vehicles/sensor/data/car-2", None),
                ("filters", "a"), ("unsub", "a", "vehicles/#"),
                ("unsub", "a", "nope/x"), ("recv", "vehicles", None)],
    "shares": [("sub", f"consumer-{i}", "$share/consumers/vehicles/#", 1)
               for i in range(3)]
              + [("sub", "x", "$share/other/vehicles/+/data/#", 0)]
              + [("recv", "vehicles/sensor/data/car-7", None)] * 7
              + [("recv", "vehicles/sensor/data/car-7",
                  {"consumer-2", "x"})] * 4
              + [("recv", "vehicles/sensor/data/car-7", set())] * 2
              + [("unsub_all", "consumer-1"), ("filters", "consumer-1"),
                 ("recv", "vehicles/a", None), ("filters", "x")],
    "dollar": [("sub", "a", "#", 0), ("sub", "b", "+/monitor", 0),
               ("sub", "c", "$SYS/#", 1),
               ("recv", "$SYS/monitor", None), ("recv", "x/monitor", None),
               ("sub", "d", "bad/#/x", 0), ("sub", "e", "$share/g", 0)],
}


@pytest.mark.parametrize("name", sorted(TREE_SCRIPTS))
def test_tree_receivers_equal_jax(name):
    got = _tree_script(T, TREE_SCRIPTS[name])
    assert got == _tree_script(J, TREE_SCRIPTS[name])
    assert got  # the script did something


_LEVELS = st.sampled_from(["a", "b", "c", "+", "#", "$s", ""])
_TLEVELS = st.sampled_from(["a", "b", "c", "$s", ""])


@settings(max_examples=150, deadline=None)
@given(subs=st.lists(st.tuples(
           st.sampled_from(["c0", "c1", "c2", "c3"]),
           st.sampled_from([None, "g1", "g2"]),
           st.lists(_LEVELS, min_size=1, max_size=4),
           st.integers(0, 2)), max_size=10),
       topics=st.lists(st.lists(_TLEVELS, min_size=1, max_size=4),
                       min_size=1, max_size=6))
def test_tree_hypothesis_equal_jax(subs, topics):
    steps = []
    for cid, group, levels, qos in subs:
        f = "/".join(levels)
        steps.append(("sub", cid, f"$share/{group}/{f}" if group else f,
                      qos))
    for levels in topics:
        steps.append(("recv", "/".join(levels), None))
        steps.append(("recv", "/".join(levels), {"c1", "c3"}))
    assert _tree_script(T, steps) == _tree_script(J, steps)
    for _, _, levels, _ in subs:
        for tl in topics:
            f, t = "/".join(levels), "/".join(tl)
            assert _outcome(t_tt.topic_matches, f, t) == \
                _outcome(j_tt.topic_matches, f, t)


# -------------------------------------------------------------- packets
@pytest.mark.parametrize("n", [0, 1, 127, 128, 16383, 16384, 2097151,
                               2097152, 268435455])
def test_varlen_equal_jax(n):
    enc = t_wire.encode_varlen(n)
    assert enc == j_wire.encode_varlen(n)
    for mod in (t_wire, j_wire):
        buf = iter(enc)
        assert mod.decode_varlen(lambda k: bytes([next(buf)])) == n


def test_varlen_malformed_equal_jax():
    for mod in (t_wire, j_wire):
        with pytest.raises(ValueError, match="malformed remaining-length"):
            mod.decode_varlen(lambda k: b"\xff")
    frame = b"\x30\xff\xff\xff\xff\x01"
    assert _outcome(t_wire.parse_frame, frame, 0) == \
        _outcome(j_wire.parse_frame, frame, 0)


def _props(pairs: bytes) -> bytes:
    return t_wire.encode_varlen(len(pairs)) + pairs


PACKETS = {
    "connect-v4": lambda m: m.connect_packet("car-1"),
    "connect-v4-persistent-ka0": lambda m: m.connect_packet(
        "car-1", keepalive=0, clean=False),
    "connect-v5": lambda m: m.connect_packet("car-1", protocol_level=5),
    "connect-will-v4": lambda m: m.connect_packet(
        "car-2", will=("vehicles/status/car-2", b"dead", 1, True)),
    "connect-will-v5-delay": lambda m: m.connect_packet(
        "car-2", protocol_level=5, clean=False, will_delay_s=30,
        will=("vehicles/status/car-2", b"x" * 300, 2, False)),
    "connect-will-v5-nodelay": lambda m: m.connect_packet(
        "car-2", protocol_level=5, will=("w", b"", 0, False)),
    "publish-q0": lambda m: m.publish_packet("vehicles/sensor/data/car-1",
                                             b'{"a": 1}'),
    "publish-q1-retain-dup": lambda m: m.publish_packet(
        "t", b"p" * 200, qos=1, retain=True, packet_id=513, dup=True),
    "publish-q2-v5": lambda m: m.publish_packet(
        "t/x", b"\x00\x01", qos=2, packet_id=65535, protocol_level=5),
    "publish-large": lambda m: m.publish_packet("big", b"z" * 20000),
    "subscribe-v4": lambda m: m.subscribe_packet(
        7, [("vehicles/#", 1), ("$share/g/a/+", 2)]),
    "subscribe-v5": lambda m: m.subscribe_packet(9, [("a", 0)],
                                                 protocol_level=5),
    "raw": lambda m: m.packet(m.PUBREL, 0x02, struct.pack(">H", 3)),
}


@pytest.mark.parametrize("name", sorted(PACKETS))
def test_packets_byte_identical_and_parse_equal(name):
    got, want = PACKETS[name](t_wire), PACKETS[name](j_wire)
    assert got == want
    # every prefix: incomplete (None) until the whole frame, then equal
    for cut in sorted({0, 1, 2, 3, len(got) // 2, len(got) - 1,
                       len(got)}):
        buf = bytearray(b"\x00" * 3 + got[:cut])
        assert t_wire.parse_frame(buf, 3) == j_wire.parse_frame(buf, 3)
    ptype, flags, body, pos = t_wire.parse_frame(got, 0)
    assert pos == len(got) and (ptype << 4 | flags) == got[0]


@pytest.mark.parametrize("block", [
    _props(b""),
    _props(b"\x18\x00\x00\x00\x05"),
    _props(b"\x01\x01\x02\x00\x00\x00\x0a\x18\x00\x00\x01\x00"),
    _props(b"\x03\x00\x04text\x08\x00\x01r\x09\x00\x02ab"),
    _props(b"\x26\x00\x03key\x00" + bytes([150]) + b"v" * 150),  # > 127
    _props(b"\x26\x00\x01k\x00\x01v" * 40),  # a 2-byte length varint
    _props(b"\x2a\x00"),  # an id the will block does not allow
    b"\x05\x18\x00\x00",  # overrun
])
def test_property_blocks_equal_jax(block):
    buf = b"\x00\x00" + block + b"tail"
    assert _outcome(t_wire._skip_props, buf, 2) == \
        _outcome(j_wire._skip_props, buf, 2)
    assert _outcome(t_wire._parse_will_props, buf, 2) == \
        _outcome(j_wire._parse_will_props, buf, 2)


# ------------------------------------------------------- protocol script
def _run_script(m, steps, **broker_kw):
    """Drive m's MqttProtocol objects with the same frames a transport
    would feed them; teardown as the transports do (on False, on a
    violation, on a drop).  Returns every byte sent per connection, the
    per-step log and the broker's state."""
    broker = m.broker.MqttBroker(**broker_kw)
    sent, log, conns = [], [], {}

    def proto(name):
        if name not in conns:
            conns[name] = m.wire.MqttProtocol(
                broker, lambda data, n=name: sent.append((n, data)))
        return conns[name]

    for kind, name, *rest in steps:
        if kind == "pkt":
            ptype, flags, body, _ = m.wire.parse_frame(rest[0], 0)
            try:
                keep = proto(name).handle_packet(ptype, flags, body)
            except (ValueError, struct.error, IndexError) as e:
                log.append((name, "violation", type(e).__name__, str(e)))
                conns.pop(name).teardown()
                continue
            log.append((name, keep))
            if not keep:
                conns.pop(name).teardown()
        elif kind == "drop":
            conns.pop(name).teardown()
    state = (sorted(broker.session_ids()), broker.retained(),
             sorted(broker._offline),
             {c: broker._tree.filters_of(c) for c in
              ("sub", "sub2", "car", "car-1", "car-2")},
             broker.saturated())
    for p in conns.values():
        p.teardown()
    return sent, log, state


def _pid(pid):
    return struct.pack(">H", pid)


def _conn(cid, **kw):
    return W.connect_packet(cid, **kw)


SCRIPTS = {
    "v4-qos012": [
        ("pkt", "sub", _conn("sub")),
        ("pkt", "sub", W.subscribe_packet(1, [("vehicles/#", 2),
                                             ("x/+", 1), ("bad/#/x", 0)])),
        ("pkt", "pub", _conn("pub")),
        ("pkt", "pub", W.publish_packet("vehicles/a", b"q0")),
        ("pkt", "pub", W.publish_packet("vehicles/b", b"q1", qos=1,
                                        packet_id=10)),
        ("pkt", "pub", W.publish_packet("vehicles/c", b"q2", qos=2,
                                        packet_id=11)),
        ("pkt", "pub", W.publish_packet("vehicles/c", b"q2", qos=2,
                                        packet_id=11, dup=True)),
        ("pkt", "pub", W.packet(W.PUBREL, 0x02, _pid(11))),
        ("pkt", "pub", W.publish_packet("vehicles/c", b"again", qos=2,
                                        packet_id=11)),
        ("pkt", "sub", W.packet(W.PUBREC, 0, _pid(3))),
        ("pkt", "sub", W.packet(W.PUBCOMP, 0, _pid(3))),
        ("pkt", "sub", W.packet(W.PUBACK, 0, _pid(2))),
        ("pkt", "pub", W.publish_packet("x/y", b"r", qos=1, retain=True,
                                        packet_id=12)),
        ("pkt", "sub", W.packet(W.PINGREQ, 0, b"")),
        ("pkt", "sub", W.packet(W.UNSUBSCRIBE, 0x02,
                                _pid(4) + b"\x00\x0avehicles/#")),
        ("pkt", "pub", W.publish_packet("vehicles/a", b"gone")),
        ("pkt", "sub2", _conn("sub2")),
        ("pkt", "sub2", W.subscribe_packet(2, [("x/#", 1)])),
        ("pkt", "pub", W.packet(W.DISCONNECT, 0, b"")),
    ],
    "v5": [
        ("pkt", "sub", _conn("sub", protocol_level=5)),
        ("pkt", "sub", W.subscribe_packet(1, [("t/#", 1)],
                                          protocol_level=5)),
        ("pkt", "pub", _conn("pub", protocol_level=5)),
        ("pkt", "pub", W.publish_packet("t/1", b"v5", qos=1, packet_id=4,
                                        protocol_level=5)),
        ("pkt", "pub", W.packet(W.PUBLISH, 0, b"\x00\x03t/2"
                                + _props(b"\x26\x00\x01k\x00\x01v" * 30)
                                + b"props")),
        ("pkt", "pub", W.packet(W.UNSUBSCRIBE, 0x02,
                                _pid(5) + b"\x00\x00\x03t/#")),
        ("pkt", "sub", W.packet(W.DISCONNECT, 0, b"\x00")),
    ],
    "wills": [
        ("pkt", "sub", _conn("sub")),
        ("pkt", "sub", W.subscribe_packet(1, [("status/#", 1)])),
        ("pkt", "car-1", _conn("car-1", will=("status/car-1", b"dead",
                                              1, True))),
        ("drop", "car-1"),  # abnormal: the will is published
        ("pkt", "car-2", _conn("car-2", will=("status/car-2", b"bye",
                                              0, False))),
        ("pkt", "car-2", W.packet(W.DISCONNECT, 0, b"")),  # discarded
        ("pkt", "v5", _conn("car", protocol_level=5,
                            will=("status/car", b"kept", 0, False))),
        ("pkt", "v5", W.packet(W.DISCONNECT, 0, b"\x04")),  # 0x04 keeps
        # a v5 will delay on a persistent session: deferred, then the
        # reconnect cancels it
        ("pkt", "d1", _conn("car-2", protocol_level=5, clean=False,
                            will_delay_s=3600,
                            will=("status/car-2", b"late", 1, False))),
        ("drop", "d1"),
        ("pkt", "d2", _conn("car-2", protocol_level=5, clean=False)),
        ("drop", "d2"),
        # a delayed will whose session a clean start ends: fires now
        ("pkt", "d3", _conn("car-1", protocol_level=5, clean=False,
                            will_delay_s=3600,
                            will=("status/car-1", b"ended", 1, False))),
        ("drop", "d3"),
        ("pkt", "d4", _conn("car-1")),
    ],
    "takeover-session-present": [
        ("pkt", "a", _conn("car", clean=False,
                           will=("status/car", b"took", 0, False))),
        ("pkt", "a", W.subscribe_packet(1, [("cmd/#", 1)])),
        ("pkt", "b", _conn("car", clean=False)),  # takeover, present=1
        ("drop", "a"),  # the stale teardown must not end b's session
        ("pkt", "pub", _conn("pub")),
        ("pkt", "pub", W.publish_packet("cmd/1", b"live", qos=1,
                                        packet_id=1)),
        ("drop", "b"),  # offline: QoS 1 queues
        ("pkt", "pub", W.publish_packet("cmd/2", b"queued", qos=1,
                                        packet_id=2)),
        ("pkt", "pub", W.publish_packet("cmd/3", b"q0-dropped")),
        ("pkt", "c", _conn("car", clean=False)),  # resumes, drains
        ("pkt", "d", _conn("car")),  # clean start: present=0, subs gone
        ("pkt", "pub", W.publish_packet("cmd/4", b"nobody", qos=1,
                                        packet_id=3)),
    ],
    "violations": [
        ("pkt", "early", W.subscribe_packet(1, [("a/#", 0)])),
        ("pkt", "twice", _conn("twice")),
        ("pkt", "twice", _conn("twice")),
        ("pkt", "wild", _conn("wild")),
        ("pkt", "wild", W.publish_packet("a/#", b"x")),
        ("pkt", "short", _conn("short")),
        ("pkt", "short", W.packet(W.PUBLISH, 2, b"\x00\x09ab")),
        ("pkt", "anon", _conn("", clean=False)),
        ("pkt", "anon5", _conn("", clean=False, protocol_level=5)),
        ("pkt", "trunc", W.packet(W.CONNECT, 0, b"\x00\x04MQTT")),
        ("pkt", "badwill", W.packet(
            W.CONNECT, 0, b"\x00\x04MQTT\x05\x06\x00\x3c\x00\x00\x01w"
            + _props(b"\x2a\x00") + b"\x00\x01t\x00\x00")),
        ("pkt", "shortwill", W.packet(
            W.CONNECT, 0, b"\x00\x04MQTT\x04\x06\x00\x3c\x00\x01w"
            b"\x00\x01t\x00\x09ab")),
    ],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_protocol_answers_byte_identical_to_jax(name):
    got = _run_script(T, SCRIPTS[name])
    want = _run_script(J, SCRIPTS[name])
    assert got == want
    assert got[0] and got[1]


def test_protocol_offline_queue_limits_equal_jax():
    steps = [("pkt", "a", _conn("car", clean=False)),
             ("pkt", "a", W.subscribe_packet(1, [("t/#", 1)])),
             ("drop", "a"), ("pkt", "pub", _conn("pub"))]
    steps += [("pkt", "pub", W.publish_packet("t/x", b"%d" % i, qos=1,
                                              packet_id=i + 1))
              for i in range(12)]
    steps += [("pkt", "b", _conn("car", clean=False))]
    kw = dict(offline_queue_limit=5, backpressure_hwm=3)
    got, want = _run_script(T, steps, **kw), _run_script(J, steps, **kw)
    assert got == want
    delivered = [d for n, d in got[0] if n == "b" and d[0] >> 4 == 3]
    assert [d.rsplit(b"x", 1)[1][2:] for d in delivered] == \
        [b"%d" % i for i in range(7, 12)]


# ---------------------------------------------------------------- broker
def _counter(m, name):
    reg = m.broker.default_registry
    metric = reg._metrics.get(name)
    return 0.0 if metric is None else metric.value()


_COUNTERS = ("mqtt_messages_incoming_publish_count",
             "mqtt_messages_outgoing_publish_count",
             "mqtt_messages_dropped_count", "mqtt_messages_queued_count",
             "iotml_mqtt_backpressure_total")


def _case_retained(m):
    b = m.broker.MqttBroker()
    c1 = m.broker.QueueClient(b, "sub-1")
    c1.subscribe("tele/+/status")
    b.publish("tele/dev1/status", b"up", retain=True)
    c2 = m.broker.QueueClient(b, "sub-2")
    c2.subscribe("tele/#")
    b.publish("tele/dev1/status", b"", retain=True)
    c3 = m.broker.QueueClient(b, "sub-3")
    c3.subscribe("tele/#")
    c4 = m.broker.QueueClient(b, "sub-4")
    b.publish("tele/dev2/status", b"q2", qos=2, retain=True)
    c4.subscribe("tele/dev2/status", qos=1)
    c4.subscribe("$share/g/tele/#")  # no retained to shared subs
    return (c1.messages, c2.messages, c3.messages, c4.messages,
            b.retained(), _outcome(b.publish, "a/+", b"x"))


def _case_takeover(m):
    b = m.broker.MqttBroker()
    c1 = m.broker.QueueClient(b, "dev")
    c1.subscribe("t/#")
    b.publish("t/x", b"1")
    c2 = m.broker.QueueClient(b, "dev")
    b.publish("t/x", b"2")
    c1.disconnect()  # stale: must not end c2's session
    alive = b.session_ids()
    b.disconnect("dev")
    return c1.messages, c2.messages, alive, b.session_count()


def _case_offline_queue(m):
    b = m.broker.MqttBroker(offline_queue_limit=3)
    c = m.broker.QueueClient(b, "car", clean_start=False)
    c.subscribe("cmd/#", qos=1)
    c.disconnect()
    for i in range(5):
        b.publish("cmd/x", b"%d" % i, qos=1)
    b.publish("cmd/x", b"q0", qos=0)  # QoS 0 is not queued
    sat = b.saturated()
    c2 = m.broker.QueueClient(b, "car", clean_start=False)
    return c2.messages, sat, b.saturated(), c2._session.resumed


def _case_expiry(m):
    b = m.broker.MqttBroker(offline_session_expiry_s=0.0)
    c = m.broker.QueueClient(b, "car", clean_start=False)
    c.subscribe("cmd/#", qos=1)
    c.disconnect()
    time.sleep(0.01)
    b._next_offline_sweep = 0.0
    b.publish("cmd/x", b"late", qos=1)  # sweeps: queue and subs gone
    c2 = m.broker.QueueClient(b, "car", clean_start=False)
    return (c2.messages, c2._session.resumed, b._tree.filters_of("car"),
            sorted(b._offline))


def _case_counters(m):
    before = {n: _counter(m, n) for n in _COUNTERS}
    b = m.broker.MqttBroker(offline_queue_limit=4, backpressure_hwm=2)
    c = m.broker.QueueClient(b, "car", clean_start=False)
    c.subscribe("t/#", qos=1)
    b.publish("t/a", b"1", qos=1)
    c.disconnect()
    for i in range(3):
        b.publish("t/a", b"%d" % i, qos=1)
    b.publish("nobody/here", b"x")
    return {n: _counter(m, n) - before[n] for n in _COUNTERS}


def _case_mid_handshake_takeover(m):
    b = m.broker.MqttBroker()
    got1, got2 = [], []
    s = b.connect("car", lambda *a: got1.append(a), clean_start=False)
    b.deliver_pending(s)
    b.subscribe("car", "t/#", qos=1)
    b.disconnect("car", s)
    b.publish("t/1", b"a", qos=1)
    s1 = b.connect("car", lambda *a: got1.append(a), clean_start=False)
    b.publish("t/2", b"b", qos=1)  # appends behind the backlog
    s2 = b.connect("car", lambda *a: got2.append(a), clean_start=False)
    n1 = b.deliver_pending(s1)  # superseded: delivers nothing
    n2 = b.deliver_pending(s2)
    return got1, got2, n1, n2, s2.resumed


def _case_shared_offline(m):
    b = m.broker.MqttBroker()
    live = m.broker.QueueClient(b, "live")
    off = m.broker.QueueClient(b, "off", clean_start=False)
    for c in (live, off):
        c.subscribe("$share/g/t/#", qos=1)
    off.disconnect()
    for i in range(6):
        b.publish("t/x", b"%d" % i, qos=1)
    live.disconnect()
    for i in range(2):
        b.publish("t/x", b"n%d" % i, qos=1)
    back = m.broker.QueueClient(b, "off", clean_start=False)
    return live.messages, back.messages


def _case_qos2_state(m):
    b = m.broker.MqttBroker()
    s = b.connect("car", lambda *a: None, clean_start=False)
    out = [b.qos2_begin(s, 5), b.qos2_begin(s, 5), b.qos2_begin(s, 6)]
    b.disconnect("car", s)
    s2 = b.connect("car", lambda *a: None, clean_start=False)
    out += [b.qos2_begin(s2, 5), sorted(s2.qos2_inbound)]
    b.qos2_release(s2, 5)
    out += [b.qos2_begin(s2, 5), b.subscribe("car", "x", qos=2)]
    s3 = b.connect("car", lambda *a: None, clean_start=True)
    return out + [sorted(s3.qos2_inbound)]


def _case_wills(m):
    b = m.broker.MqttBroker()
    sub = m.broker.QueueClient(b, "sub")
    sub.subscribe("status/#", qos=1)
    w = ("status/a", b"dead", 1, True)
    s = b.connect("a", lambda *x: None, will=w)
    b.disconnect("a", s)  # abnormal → will
    s = b.connect("b", lambda *x: None, will=("status/b", b"x", 0, False))
    b.discard_will(s)
    b.disconnect("b", s)  # clean → none
    s = b.connect("c", lambda *x: None, will=("status/c", b"t", 0, False))
    b.connect("c", lambda *x: None)  # takeover → the old will
    return sub.messages, b.retained()


def _case_chaos_deliver(m):
    b = m.broker.MqttBroker()
    c = m.broker.QueueClient(b, "sub")
    c.subscribe("t/#")
    ev = m.FaultEvent
    eng = m.faults.arm(m.faults.ChaosEngine([
        ev(at=2, point="mqtt.deliver", action="drop"),
        ev(at=4, point="mqtt.deliver", action="dup", repeat=2),
        ev(at=7, point="mqtt.deliver", action="delay",
           params=(("seconds", 0.001),))]))
    try:
        counts = [b.publish("t/x", b"%d" % i) for i in range(8)]
    finally:
        m.faults.disarm()
    return (counts, c.messages, eng.hits, eng.injected,
            eng.dropped_count)


BROKER_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_retained, _case_takeover, _case_offline_queue, _case_expiry,
    _case_counters, _case_mid_handshake_takeover, _case_shared_offline,
    _case_qos2_state, _case_wills, _case_chaos_deliver)}


@pytest.mark.parametrize("name", sorted(BROKER_CASES))
def test_broker_case_equal_jax(name):
    got = BROKER_CASES[name](T)
    assert got == BROKER_CASES[name](J)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_will_delay_fires_on_a_quiet_broker(pkg):
    """The consolidated will timer publishes a delayed will with no other
    broker traffic; a reconnect within the delay cancels another."""
    m = PKG[pkg]
    b = m.broker.MqttBroker()
    sub = m.broker.QueueClient(b, "sub")
    sub.subscribe("status/#")
    t0 = time.monotonic()
    s = b.connect("a", lambda *x: None, clean_start=False,
                  will=("status/a", b"gone", 0, False), will_delay_s=0.3)
    s2 = b.connect("b", lambda *x: None, clean_start=False,
                   will=("status/b", b"back", 0, False), will_delay_s=0.3)
    b.disconnect("a", s)
    b.disconnect("b", s2)
    assert sub.messages == []
    b.connect("b", lambda *x: None, clean_start=False)  # cancels b's
    assert _wait_for(lambda: sub.messages, timeout=10)
    assert time.monotonic() - t0 >= 0.3
    time.sleep(0.4)
    assert sub.messages == [("status/a", b"gone", 0, False)]


def _traced_bridge(m, path):
    m.tracing.reset()
    m.tracing.configure(enabled=True, sample=1.0, path=str(path))
    try:
        mqtt, stream = m.broker.MqttBroker(), m.Broker()
        m.bridge.KafkaBridge(mqtt, stream, partitions=1)
        for i in range(3):
            mqtt.publish(f"vehicles/sensor/data/car-{i}", b"{}")
        msgs = stream.fetch("sensor-data", 0, 0, 10)
        ids = [f"{m.tracing.from_headers(x.headers).trace_id:016x}"
               for x in msgs]
        m.tracing.flush()
    finally:
        m.tracing.configure(enabled=False, sample=1.0, path="")
        m.tracing.reset()
    spans = [json.loads(ln) for ln in open(path)]
    return [[s["stage"] for s in spans if s["trace"] == t] for t in ids], \
        [x.value for x in msgs]


def test_bridge_carries_the_same_trace_marks_as_jax(tmp_path):
    """Under tracing a publish is born in MqttBroker.publish and the
    bridge marks mqtt_deliver and bridge_produce before produce(); the
    produced value stays the payload."""
    got = _traced_bridge(T, tmp_path / "t.jsonl")
    assert got == _traced_bridge(J, tmp_path / "j.jsonl")
    assert got[0] == [["mqtt_publish", "mqtt_deliver", "bridge_produce"]] \
        * 3


# --------------------------------------------------------------- bridges
def _bridge_records(m, mapping, publishes):
    mqtt, stream = m.broker.MqttBroker(), m.Broker()
    bridge = m.bridge.KafkaBridge(mqtt, stream, mappings=mapping(m),
                                  partitions=3)
    for topic, payload, qos in publishes:
        mqtt.publish(topic, payload, qos=qos)
    out = {}
    for t in stream.topics():
        for p in range(stream.topic(t).partitions):
            out[(t, p)] = [(r.offset, r.key, r.value)
                           for r in stream.fetch(t, p, 0, 10_000)]
    return out, bridge.forwarded()


_PUBLISHES = [(f"vehicles/sensor/data/car-{i % 7}",
               json.dumps({"i": i}).encode(), i % 2) for i in range(60)] + \
    [("other/topic", b"skip", 0), ("vehicles/sensor/data", b"parent", 0),
     ("vehicles/sensor/data/a/b", b"deep", 1)]


@pytest.mark.parametrize("mapping", [
    lambda m: None,
    lambda m: [m.bridge.TopicMapping.sensor_data_keyed("KEYED")],
    lambda m: [m.bridge.TopicMapping(("vehicles/+/data/#", "other/#"),
                                     "both", id="two"),
               m.bridge.TopicMapping.sensor_data()],
], ids=["reference", "car-keyed", "two-mappings"])
def test_kafka_bridge_records_equal_jax(mapping):
    got = _bridge_records(T, mapping, _PUBLISHES)
    assert got == _bridge_records(J, mapping, _PUBLISHES)
    assert got[1] >= 60


def test_topic_mapping_equal_jax():
    for mod in (t_bridge, j_bridge):
        with pytest.raises(ValueError, match="stream_key"):
            mod.TopicMapping(("a",), "b", stream_key="nope")
    assert dataclasses.asdict(t_bridge.TopicMapping.sensor_data()) == \
        dataclasses.asdict(j_bridge.TopicMapping.sensor_data())
    assert dataclasses.asdict(t_bridge.TopicMapping.sensor_data_keyed()) \
        == dataclasses.asdict(j_bridge.TopicMapping.sensor_data_keyed())


# ------------------------------------------------------ cross-package TCP
def _server(m, kind, broker, **kw):
    if kind == "threaded":
        return m.wire.MqttServer(broker, **kw).start()
    return m.es.MqttEventServer(broker, **kw).start()


def _stop(srv):
    if isinstance(srv, (t_es.MqttEventServer, j_es.MqttEventServer)):
        srv.stop()
    else:
        srv.shutdown()
        srv.server_close()


def _tcp_session(server_m, kind, client_m, level):
    broker = server_m.broker.MqttBroker()
    srv = _server(server_m, kind, broker)
    clients = []
    try:
        got, lock = [], threading.Lock()

        def on_msg(topic, payload):
            with lock:
                got.append((topic, payload))

        sub = client_m.wire.MqttClient("127.0.0.1", srv.port, "sub",
                                       protocol_level=level,
                                       on_message=on_msg)
        clients.append(sub)
        sub.subscribe("vehicles/#", qos=2)
        sub.subscribe("status/#", qos=1)
        pub = client_m.wire.MqttClient(
            "127.0.0.1", srv.port, "pub", protocol_level=level,
            will=("status/pub", b"dead", 1, False))
        clients.append(pub)
        for q in (0, 1, 2):
            pub.publish(f"vehicles/q{q}", b"p%d" % q, qos=q)
        n = pub.publish_many([(f"vehicles/many/{i}", b"m%d" % i)
                              for i in range(20)])
        pub.ping()
        rejected = _outcome(pub.subscribe, "bad/#/x")
        pub.drop()  # abnormal: the will is published
        assert _wait_for(lambda: len(got) >= 24)
        sub.ping()
        sub.disconnect()
        return sorted(got), n, rejected[0]
    finally:
        for c in clients:
            c.drop()
        _stop(srv)


@pytest.mark.parametrize("kind", ["threaded", "epoll"])
@pytest.mark.parametrize("server,client", [("torch", "jax"),
                                           ("jax", "torch"),
                                           ("torch", "torch")])
@pytest.mark.parametrize("level", [4, 5])
def test_tcp_both_ways_equal_jax(kind, server, client, level):
    got = _tcp_session(PKG[server], kind, PKG[client], level)
    want = _tcp_session(J, kind, J, level)
    assert got == want
    assert ("vehicles/q2", b"p2") in got[0]
    assert ("status/pub", b"dead") in got[0]


def _raw(port, data, n_read=4):
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        s.sendall(data)
        buf = b""
        while len(buf) < n_read:
            chunk = s.recv(n_read - len(buf))
            if not chunk:
                break
            buf += chunk
        return buf
    finally:
        s.close()


@pytest.mark.parametrize("kind", ["threaded", "epoll"])
def test_raw_answers_on_the_wire_equal_jax(kind):
    """The bytes each front answers a raw script with: CONNACK (v4, v5,
    the 0x02 / 0x85 rejections), SUBACK with a failure code, PINGRESP."""
    scripts = [
        (W.connect_packet("r1") + W.subscribe_packet(1, [("a", 1),
                                                        ("a/#/b", 0)])
         + W.packet(W.PINGREQ, 0, b""), 4 + 6 + 2),
        (W.connect_packet("r2", protocol_level=5), 5),
        (W.connect_packet("", clean=False), 4),
        (W.connect_packet("", clean=False, protocol_level=5), 5),
    ]
    out = {}
    for name, m in PKG.items():
        srv = _server(m, kind, m.broker.MqttBroker())
        try:
            out[name] = [_raw(srv.port, data, n) for data, n in scripts]
        finally:
            _stop(srv)
    assert out["torch"] == out["jax"]
    assert out["torch"][2] == b"\x20\x02\x00\x02"


# --------------------------------------------------- the epoll front alone
def _connected_raw(port, cid, rcvbuf=None):
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    if rcvbuf:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
    s.settimeout(10)
    s.connect(("127.0.0.1", port))
    s.sendall(W.connect_packet(cid))
    buf = b""
    while len(buf) < 4:
        buf += s.recv(4 - len(buf))
    return s


def test_epoll_slow_consumer_evicted():
    broker = t_broker.MqttBroker()
    srv = t_es.MqttEventServer(broker, max_outbuf=64 * 1024).start()
    s = pub = None
    try:
        s = _connected_raw(srv.port, "sleepy")
        s.sendall(W.subscribe_packet(1, [("flood/#", 0)]))
        assert _wait_for(lambda: broker._tree.filters_of("sleepy"))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        pub = j_wire.MqttClient("127.0.0.1", srv.port, "firehose")
        for _ in range(200):
            pub.publish("flood/x", b"z" * 8192, qos=0)
        assert _wait_for(lambda: "sleepy" not in broker.session_ids())
        pub.ping()
    finally:
        for c in (pub,):
            if c is not None:
                c.drop()
        if s is not None:
            s.close()
        srv.stop()


def test_epoll_malformed_and_pre_connect_close_only_that_connection():
    broker = t_broker.MqttBroker()
    srv = t_es.MqttEventServer(broker).start()
    c = None
    try:
        for data in (W.packet(1, 0, b"\x00\x04MQTT"),
                     W.subscribe_packet(1, [("a/#", 0)]),
                     b"\x30\xff\xff\xff\xff\x01"):
            bad = socket.create_connection(("127.0.0.1", srv.port),
                                           timeout=10)
            try:
                bad.sendall(data)
                assert bad.recv(16) == b""
            finally:
                bad.close()
        assert broker._tree.filters_of(None) == []
        c = j_wire.MqttClient("127.0.0.1", srv.port, "healthy")
        c.publish("t/x", b"ok", qos=1)
        c.ping()
    finally:
        if c is not None:
            c.drop()
        srv.stop()


def test_epoll_handshake_and_keepalive_timeouts():
    broker = t_broker.MqttBroker()
    srv = t_es.MqttEventServer(broker, handshake_timeout_s=0.3).start()
    silent = ka = None
    try:
        silent = socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=10)
        assert _wait_for(lambda: srv.connection_count == 1)
        t0 = time.monotonic()
        assert silent.recv(16) == b""  # dropped: never spoke MQTT
        assert time.monotonic() - t0 < 5
        sub = t_broker.QueueClient(broker, "watch")
        sub.subscribe("status/#")
        # keepalive 1 s, then silence: closed after 1.5 s, will published
        ka = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        ka.sendall(W.connect_packet("quiet", keepalive=1,
                                    will=("status/quiet", b"gone", 0,
                                          False)))
        assert ka.recv(4)[0] >> 4 == W.CONNACK
        assert _wait_for(lambda: sub.messages)
        assert sub.messages == [("status/quiet", b"gone", 0, False)]
    finally:
        for s in (silent, ka):
            if s is not None:
                s.close()
        srv.stop()


def _flood(pub, n, payload):
    def run():
        try:
            for _ in range(n):
                pub.publish("flood/x", payload, qos=0)
        except OSError:
            pass
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_epoll_backpressure_pause_resume():
    broker = t_broker.MqttBroker()
    srv = t_es.MqttEventServer(broker, max_outbuf=256 << 20,
                               high_watermark=2 << 20,
                               low_watermark=512 * 1024).start()
    sub = pub = None
    try:
        sub = _connected_raw(srv.port, "stalled-sub", rcvbuf=4096)
        sub.sendall(W.subscribe_packet(1, [("flood/#", 0)]))
        assert _wait_for(lambda: broker._tree.filters_of("stalled-sub"))
        pub = j_wire.MqttClient("127.0.0.1", srv.port, "firehose")
        t = _flood(pub, 1500, b"z" * 16384)
        assert _wait_for(lambda: srv.paused_count > 0, timeout=30), \
            "backpressure never engaged"
        sub.settimeout(30)
        while t.is_alive() or srv.paused_count:
            try:
                chunk = sub.recv(1 << 16)
            except socket.timeout:
                break
            if not chunk:
                break
        t.join(timeout=30)
        assert not t.is_alive()
        sub.close()
        sub = None
        assert _wait_for(lambda: srv.paused_count == 0, timeout=30)
        pub.publish("flood/x", b"after-resume", qos=1, timeout=30)
    finally:
        if pub is not None:
            pub.drop()
        if sub is not None:
            sub.close()
        srv.stop()


def test_epoll_stalled_backpressure_evicts_slowest_consumer():
    broker = t_broker.MqttBroker()
    srv = t_es.MqttEventServer(broker, max_outbuf=64 << 20,
                               high_watermark=1 << 20,
                               low_watermark=256 * 1024,
                               stall_timeout_s=1.0).start()
    sub = pub = None
    try:
        sub = _connected_raw(srv.port, "stalled", rcvbuf=4096)
        sub.sendall(W.subscribe_packet(1, [("flood/#", 0)]))
        assert _wait_for(lambda: broker._tree.filters_of("stalled"))
        pub = j_wire.MqttClient("127.0.0.1", srv.port, "pub")
        t = _flood(pub, 1200, b"z" * 16384)
        assert _wait_for(lambda: srv.paused_count > 0, timeout=30)
        t.join(timeout=60)
        assert not t.is_alive(), "publisher stayed wedged"
        assert _wait_for(lambda: "stalled" not in broker.session_ids())
        pub.publish("flood/x", b"alive", qos=1)
    finally:
        if pub is not None:
            pub.drop()
        if sub is not None:
            sub.close()
        srv.stop()


def test_in_process_publisher_wakes_the_loop():
    """Fan-out from a foreign thread appends to the connection's buffer
    and wakes the loop through the socketpair; only the loop touches the
    selector."""
    broker = t_broker.MqttBroker()
    srv = t_es.MqttEventServer(broker).start()
    got, sub = [], None
    try:
        sub = j_wire.MqttClient("127.0.0.1", srv.port, "sub",
                                on_message=lambda t, p: got.append(p))
        sub.subscribe("t/#")
        done = []
        th = threading.Thread(target=lambda: done.append(
            [broker.publish("t/x", b"%d" % i) for i in range(50)]))
        th.start()
        th.join(timeout=10)
        assert not th.is_alive() and done[0] == [1] * 50
        assert _wait_for(lambda: len(got) == 50)
        assert got == [b"%d" % i for i in range(50)]
    finally:
        if sub is not None:
            sub.drop()
        srv.stop()


# ------------------------------------------------------------- scenarios
def test_scenario_parse_helpers_equal_jax():
    for fn in ("parse_rate", "parse_duration_s"):
        for arg in ("1/10s", "5/s", "3 / 2s", "10", "250ms", "2m", "bad",
                    "1/0.5s"):
            assert _outcome(getattr(t_scenario, fn), arg) == \
                _outcome(getattr(j_scenario, fn), arg)
    for pat, i in (("electric-vehicle-[0-9]{5}", 7), ("a-[0-9]{2}/b", 123),
                   ("plain", 3)):
        assert t_scenario.expand_pattern(pat, i) == \
            j_scenario.expand_pattern(pat, i)


@pytest.mark.parametrize("name", ["scenario.xml",
                                  "scenario_evaluation.xml"])
def test_parse_scenario_equal_jax(name):
    import os

    import iotml_torch.gen as tgen

    path = os.path.join(os.path.dirname(tgen.__file__), "scenarios", name)
    with open(path) as fh:
        xml = fh.read()
    got = dataclasses.asdict(t_scenario.parse_scenario(xml))
    assert got == dataclasses.asdict(j_scenario.parse_scenario(xml))
    assert dataclasses.asdict(t_scenario.EVALUATION_SCENARIO) == \
        dataclasses.asdict(j_scenario.EVALUATION_SCENARIO)


def _capped(m, cap):
    sc = m.scenario.parse_scenario(open(
        __import__("os").path.join(
            __import__("os").path.dirname(__file__), "..", "iotml_torch",
            "gen", "scenarios", "scenario.xml")).read())
    for g in list(sc.client_groups.values()) + \
            list(sc.topic_groups.values()):
        g.count = min(g.count, cap)
    for stage in sc.stages:
        for lc in stage.lifecycles:
            if lc.publish is not None:
                lc.publish.count = min(lc.publish.count, 20)
    return sc


@pytest.mark.parametrize("which", ["evaluation", "capped-full"])
def test_scenario_runner_inproc_counts_equal_jax(which):
    out = {}
    for name, m in PKG.items():
        sc = m.scenario.EVALUATION_SCENARIO if which == "evaluation" \
            else _capped(m, 4)
        runner = m.scenario.ScenarioRunner(sc, m.broker.MqttBroker())
        out[name] = (runner.run(), runner.consumer_counts)
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["published"] > 0


def test_scenario_runner_tcp_over_the_ports_epoll_front_equal_jax():
    out = {}
    for name, m in PKG.items():
        broker = m.broker.MqttBroker()
        srv = t_es.MqttEventServer(broker).start() if name == "torch" \
            else j_es.MqttEventServer(broker).start()
        try:
            sc = _capped(m, 3)
            runner = m.scenario.ScenarioRunner(sc, broker, transport="tcp",
                                               port=srv.port)
            out[name] = runner.run()
        finally:
            srv.stop()
    assert out["torch"] == out["jax"]
    assert sum(v for k, v in out["torch"].items() if k != "published") \
        == out["torch"]["published"]
