"""The port's native MQTT ingest front (``iotml_torch/cpp/mqtt_ingest.cc``
bound in ``iotml_torch.mqtt.native_ingest``) held against the JAX
package's engine and bridge on the same byte scripts and publishes.

Tolerance: none.  Each engine's answers to a raw script (CONNACK,
PUBACK, SUBACK, UNSUBACK, PINGRESP bytes, or the connection dropped),
the drained (topic, payload) pairs, and the bridged records (keys,
values, partitions, offsets) are equal.  Every socket has a timeout,
every wait a deadline; every port is 0.
"""

import shutil
import socket
import threading
import time

import pytest

import iotml.mqtt.native_ingest as j_ni
from iotml.mqtt.bridge import KafkaBridge as JKafkaBridge
from iotml.mqtt.broker import MqttBroker as JMqttBroker
from iotml.mqtt.wire import MqttClient as JMqttClient
from iotml.stream.broker import Broker as JBroker
import iotml_torch.mqtt.native_ingest as t_ni
from iotml_torch.mqtt import wire as W
from iotml_torch.mqtt.bridge import TopicMapping
from iotml_torch.mqtt.wire import MqttClient as TMqttClient
from iotml_torch.stream import native
from iotml_torch.stream.broker import Broker as TBroker

ENGINES = {"torch": t_ni, "jax": j_ni}


def _wait_for(fn, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.01)
    return fn()


def _props(pairs: bytes) -> bytes:
    return W.encode_varlen(len(pairs)) + pairs


def _drive(mod, data: bytes, n_answer: int):
    """Send ``data`` on one raw connection to ``mod``'s engine, polling
    it, and read ``n_answer`` bytes or to EOF; returns (answer, closed,
    drained pairs)."""
    with mod.NativeMqttIngest() as ing:
        s = socket.create_connection(("127.0.0.1", ing.port), timeout=10)
        s.setblocking(False)
        drained, answer, closed = [], b"", False
        try:
            s.sendall(data)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not closed \
                    and len(answer) < n_answer:
                drained += ing.poll(timeout_ms=10)
                try:
                    chunk = s.recv(4096)
                except BlockingIOError:
                    continue
                except ConnectionResetError:
                    chunk = b""
                if not chunk:
                    closed = True
                answer += chunk
            if not closed:  # a drop must have happened by now if it will
                for _ in range(5):
                    drained += ing.poll(timeout_ms=10)
                try:
                    closed = s.recv(4096) == b""
                except BlockingIOError:
                    pass
                except ConnectionResetError:
                    closed = True
        finally:
            s.close()
        for _ in range(3):
            drained += ing.poll(timeout_ms=0)
    return answer, closed, drained


_MANY = [(f"f/{i}", 1) for i in range(130)]  # SUBACK's length: 2 bytes
SCRIPTS = {
    "v4-publish-q0-q1-ping": (
        W.connect_packet("c1") + W.publish_packet("vehicles/a", b"q0")
        + W.publish_packet("vehicles/b", b"q1", qos=1, packet_id=258)
        + W.packet(W.PINGREQ, 0, b""), 4 + 4 + 2),
    "v5-publish-props": (
        W.connect_packet("c5", protocol_level=5)
        + W.packet(W.PUBLISH, 2, b"\x00\x01t\x00\x07"
                   + _props(b"\x26\x00\x01k\x00\x01v" * 30) + b"payload")
        + W.publish_packet("u", b"v5", protocol_level=5), 5 + 4),
    "subscribe-refused": (
        W.connect_packet("s") + W.subscribe_packet(3, [("a/#", 1),
                                                       ("b", 0)])
        + W.packet(W.UNSUBSCRIBE, 0x02, b"\x00\x04\x00\x01a"), 4 + 6 + 4),
    "subscribe-refused-v5-many": (
        W.connect_packet("s5", protocol_level=5)
        + W.subscribe_packet(4, _MANY, protocol_level=5), 5 + 3 + 3 + 130),
    "qos2-drops": (W.connect_packet("q2")
                   + W.publish_packet("t", b"x", qos=2, packet_id=1), 99),
    "malformed-drops": (b"\x30\xff\xff\xff\xff\xff", 99),
    "publish-before-connect-drops": (W.publish_packet("t", b"x"), 99),
    "disconnect": (W.connect_packet("d") + W.publish_packet("t", b"last")
                   + W.packet(W.DISCONNECT, 0, b""), 99),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_engine_answers_equal_jax(name):
    data, n = SCRIPTS[name]
    got = _drive(t_ni, data, n)
    assert got == _drive(j_ni, data, n)
    assert got[0] or got[1]


def test_engine_is_built_from_the_ports_source(tmp_path):
    assert "mqtt_ingest.cc" in native.SOURCES
    for name in native.SOURCES + native.HEADERS:
        shutil.copy(native.CPP / name, tmp_path / name)
    good = native.library_path(tmp_path)
    src = tmp_path / "mqtt_ingest.cc"
    src.write_text(src.read_text() + "\nnot C++ at all;\n")
    assert native.library_path(tmp_path) != good
    with pytest.raises(RuntimeError, match="build failed") as ei:
        native.build(tmp_path)
    assert "mqtt_ingest.cc" in str(ei.value)
    assert native.load().iotml_mqtt_ingest_drain.argtypes is not None


def test_poll_copies_the_arena_out_before_clearing():
    with t_ni.NativeMqttIngest() as ing:
        c = None
        got = []
        stop = threading.Event()

        def pump():
            while not stop.is_set():
                got.append(ing.poll(timeout_ms=10))

        th = threading.Thread(target=pump, daemon=True)
        th.start()
        try:
            c = TMqttClient("127.0.0.1", ing.port, "car")
            c.publish("t/1", b"first", qos=1)
            assert _wait_for(lambda: any(got))
            first = [b for b in got if b][0]
            for i in range(50):
                c.publish("t/2", b"later-%d" % i, qos=1)
            assert first == [(b"t/1", b"first")]
            assert ing.connection_count == 1
        finally:
            if c is not None:
                c.disconnect()
            stop.set()
            th.join(timeout=10)
        assert not th.is_alive()
    assert [p for b in got for _, p in b] == \
        [b"first"] + [b"later-%d" % i for i in range(50)]


def _records(stream, topics, parts):
    return {(t, p): [(m.offset, m.key, m.value)
                     for m in stream.fetch(t, p, 0, 100_000)]
            for t in topics for p in range(parts)}


def _publish_fleet(client_cls, port, cars=6, ticks=5):
    for i in range(cars):  # one connection at a time: a defined order
        c = client_cls("127.0.0.1", port, f"car-{i}")
        try:
            for k in range(ticks):
                c.publish(f"vehicles/sensor/data/car-{i}", b'{"k": %d}' % k,
                          qos=k % 2)
            c.publish("other/topic", b"skip", qos=1)
            c.ping()
        finally:
            c.disconnect()


def _native_bridge(mod, stream_cls, client_cls, mapping):
    stream = stream_cls()
    kw = {} if mapping is None else {"mapping": mapping(mod)}
    bridge = mod.NativeIngestBridge(stream, partitions=3, **kw).start()
    try:
        _publish_fleet(client_cls, bridge.port)
        assert _wait_for(lambda: bridge.forwarded() >= 30)
    finally:
        bridge.stop()
    topic = bridge.mapping.stream_topic
    return _records(stream, [topic], 3), bridge.forwarded()


def _j_mapping(kind):
    from iotml.mqtt.bridge import TopicMapping as JTopicMapping

    return {"torch": TopicMapping, "jax": JTopicMapping}[kind]


@pytest.mark.parametrize("keyed", [False, True], ids=["topic", "car"])
@pytest.mark.parametrize("client", ["torch", "jax"])
def test_native_bridge_records_equal_jax(keyed, client):
    client_cls = {"torch": TMqttClient, "jax": JMqttClient}[client]

    def mapping(mod):
        cls = _j_mapping("torch" if mod is t_ni else "jax")
        return cls.sensor_data_keyed("KEYED") if keyed else \
            cls.sensor_data()

    got = _native_bridge(t_ni, TBroker, client_cls, mapping)
    want = _native_bridge(j_ni, JBroker, client_cls, mapping)
    assert got == want
    assert got[1] == 30


def test_native_bridge_records_equal_the_python_front():
    """The same publishes through the JAX package's KafkaBridge behind a
    Python front give the records the port's native bridge gives."""
    got = _native_bridge(t_ni, TBroker, TMqttClient, None)
    mqtt, stream = JMqttBroker(), JBroker()
    JKafkaBridge(mqtt, stream, partitions=3)
    from iotml.mqtt.wire import MqttServer as JMqttServer

    srv = JMqttServer(mqtt).start()
    try:
        _publish_fleet(JMqttClient, srv.port)
    finally:
        srv.shutdown()
        srv.server_close()
    assert got[0] == _records(stream, ["sensor-data"], 3)


def test_native_fan_in_many_connections():
    n_conns, per_conn = 100, 20
    stream = TBroker()
    bridge = t_ni.NativeIngestBridge(stream, partitions=4).start()
    errors = []
    try:
        def run(i):
            try:
                s = socket.create_connection(("127.0.0.1", bridge.port),
                                             timeout=10)
                try:
                    s.sendall(W.connect_packet(f"car-{i:05d}"))
                    buf = b""
                    while len(buf) < 4:
                        chunk = s.recv(4 - len(buf))
                        if not chunk:
                            raise ConnectionError("EOF before CONNACK")
                        buf += chunk
                    pkt = W.publish_packet(
                        f"vehicles/sensor/data/car-{i:05d}", b"{}")
                    s.sendall(pkt * per_conn)
                finally:
                    s.close()
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_conns)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert _wait_for(lambda: bridge.forwarded() == n_conns * per_conn,
                         timeout=30)
    finally:
        bridge.stop()
    per_key = {}
    for p in range(4):
        for m in stream.fetch("sensor-data", p, 0, 10_000):
            per_key.setdefault(m.key, set()).add(p)
    assert len(per_key) == n_conns
    assert all(len(ps) == 1 for ps in per_key.values())
