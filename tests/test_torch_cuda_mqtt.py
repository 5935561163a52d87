"""Card-only checks of the ingest front: the native MQTT ingest engine
built from the checkout on the card's host and drained in bulk, and the
one-command demo on the card (one launch of the fused fit kernel, B1,
through its "rows" design).  Every test is marked ``cuda`` and skips
without a card.

The machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_mqtt.py

Tolerance: none; drained pairs, records and launch counts are exact.
"""

import json
import socket
import threading
import time

import pytest
import torch

from iotml_torch.cli import demo
from iotml_torch.mqtt import wire as W
from iotml_torch.mqtt.native_ingest import NativeIngestBridge, NativeMqttIngest
from iotml_torch.ops import fused_train
from iotml_torch.stream import native
from iotml_torch.stream.broker import Broker


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_native_ingest_builds_and_drains(cuda_device):
    assert "mqtt_ingest.cc" in native.SOURCES
    native.load()  # builds the engine from the checkout or raises
    frames = W.connect_packet("car") + b"".join(
        W.publish_packet(f"vehicles/sensor/data/car-{i % 7}",
                         b'{"i": %d}' % i) for i in range(5000))
    with NativeMqttIngest() as ing:
        s = socket.create_connection(("127.0.0.1", ing.port), timeout=10)
        sender = threading.Thread(target=s.sendall, args=(frames,),
                                  daemon=True)
        sender.start()
        try:
            got = []
            deadline = time.monotonic() + 30
            while len(got) < 5000 and time.monotonic() < deadline:
                got += ing.poll(timeout_ms=20)
            sender.join(timeout=30)
            assert not sender.is_alive()
        finally:
            s.close()
    assert got == [(f"vehicles/sensor/data/car-{i % 7}".encode(),
                    b'{"i": %d}' % i) for i in range(5000)]


@pytest.mark.cuda
def test_native_bridge_forwards_every_record(cuda_device):
    stream = Broker()
    bridge = NativeIngestBridge(stream, partitions=4).start()
    try:
        s = socket.create_connection(("127.0.0.1", bridge.port), timeout=10)
        try:
            s.sendall(W.connect_packet("car") + b"".join(
                W.publish_packet(f"vehicles/sensor/data/car-{i % 50}", b"{}")
                for i in range(20_000)))
            assert s.recv(4)[0] >> 4 == W.CONNACK
        finally:
            s.close()
        deadline = time.monotonic() + 60
        while bridge.forwarded() < 20_000 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        bridge.stop()
    assert bridge.forwarded() == 20_000
    assert sum(stream.end_offset("sensor-data", p) for p in range(4)) == \
        20_000


@pytest.mark.cuda
def test_demo_on_the_card_launches_b1_once(cuda_device, capsys):
    fused_train.fused_fit.launches = 0
    fused_train.fused_fit.launches_by_design = dict.fromkeys(
        fused_train.DESIGNS, 0)
    assert demo.main(["--cars", "10", "--seconds", "2", "--rate", "20",
                      "--epochs", "3"]) == 0
    out = capsys.readouterr().out
    s = json.loads(out[out.index("{"):])
    assert s["mqtt_messages_bridged"] > 0
    assert s["ksql_avro_records"] == s["mqtt_messages_bridged"]
    assert s["scored"] == s["ksql_avro_records"]
    assert s["loss_first_to_last"][1] <= s["loss_first_to_last"][0]
    assert fused_train.fused_fit.launches == 1
    assert fused_train.fused_fit.launches_by_design["rows"] == 1
