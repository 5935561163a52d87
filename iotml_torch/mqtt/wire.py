"""MQTT wire protocol: packet codec, TCP server, and a small client
(``iotml.mqtt.wire``'s copy: its frames are byte-identical).

The reference's device fleet speaks real MQTT over TCP to HiveMQ on :1883
(reference `infrastructure/hivemq/hivemq-mqtt.yaml:12-14`, scenario clients
`mqttVersion 5`).  This module gives the framework the same boundary: an
MQTT 3.1.1 server (protocol level 4; level-5 CONNECT/SUBSCRIBE/PUBLISH
packets are accepted by parsing and skipping their properties block) in
front of `MqttBroker`, plus a blocking client used by the load-generator
agents.  QoS 0, 1, and 2 are implemented end to end (PUBLISH→PUBACK;
PUBLISH→PUBREC→PUBREL→PUBCOMP with broker-side dedup surviving reconnect)
— the reference broker advertises maxQos 2 (hivemq-crd.yaml:13); its
scenarios use qos 0 (full) and qos 1 (evaluation).
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .broker import MqttBroker

# packet types
CONNECT, CONNACK, PUBLISH, PUBACK = 1, 2, 3, 4
PUBREC, PUBREL, PUBCOMP = 5, 6, 7
SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK = 8, 9, 10, 11
PINGREQ, PINGRESP, DISCONNECT = 12, 13, 14


# ------------------------------------------------------------------ codec
def encode_varlen(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n % 128
        n //= 128
        out.append(b | 0x80 if n else b)
        if not n:
            return bytes(out)


def decode_varlen(read: Callable[[int], bytes]) -> int:
    mult, val = 1, 0
    for _ in range(4):
        (b,) = read(1)
        val += (b & 0x7F) * mult
        if not b & 0x80:
            return val
        mult *= 128
    raise ValueError("malformed remaining-length")


def _mqtt_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def _read_str(buf: bytes, pos: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from(">H", buf, pos)
    return buf[pos + 2:pos + 2 + n].decode(), pos + 2 + n


def _skip_props(buf: bytes, pos: int) -> int:
    """Skip an MQTT 5 properties block: variable-byte-integer length, then
    that many bytes (spec §2.2.2 — NOT a single length byte)."""
    cur = [pos]

    def read(n: int) -> bytes:
        chunk = buf[cur[0]:cur[0] + n]
        cur[0] += n
        return chunk

    length = decode_varlen(read)  # advances cur past the varint itself
    return cur[0] + length


def _parse_will_props(buf: bytes, pos: int) -> Tuple[int, int]:
    """Parse an MQTT 5 will-properties block; returns (will_delay_s,
    next_pos).  Table-driven over the property ids the spec allows in a
    will block (§3.1.3.2): the Will Delay Interval (0x18) is extracted,
    the rest are validated-and-skipped."""
    cur = [pos]

    def read(n: int) -> bytes:
        chunk = buf[cur[0]:cur[0] + n]
        cur[0] += n
        return chunk

    length = decode_varlen(read)
    p, end = cur[0], cur[0] + length
    delay = 0
    while p < end:
        pid = buf[p]
        p += 1
        if pid == 0x18:    # will delay interval: 4-byte int
            (delay,) = struct.unpack_from(">I", buf, p)
            p += 4
        elif pid == 0x01:  # payload format indicator: 1 byte
            p += 1
        elif pid == 0x02:  # message expiry interval: 4-byte int
            p += 4
        elif pid in (0x03, 0x08):   # content type / response topic: utf8
            _, p = _read_str(buf, p)
        elif pid == 0x09:  # correlation data: binary (u16 length)
            (n,) = struct.unpack_from(">H", buf, p)
            p += 2 + n
        elif pid == 0x26:  # user property: utf8 pair
            _, p = _read_str(buf, p)
            _, p = _read_str(buf, p)
        else:
            raise ValueError(f"bad will property id 0x{pid:02x}")
    if p != end:
        raise ValueError("will properties overrun")
    return delay, end


def packet(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + encode_varlen(len(body)) + body


def connect_packet(client_id: str, protocol_level: int = 4,
                   keepalive: int = 60, clean: bool = True,
                   will: Optional[Tuple[str, bytes, int, bool]] = None,
                   will_delay_s: int = 0) -> bytes:
    """CONNECT.  `will` is (topic, payload, qos, retain) — the Last Will
    registered with the broker, published on abnormal disconnect (spec
    §3.1.2-8).  `will_delay_s` emits the v5 Will Delay Interval property
    (0x18) inside the will-properties block."""
    name = "MQTT"
    flags = 0x02 if clean else 0x00
    if will is not None:
        wtopic, wpayload, wqos, wretain = will
        flags |= 0x04 | ((wqos & 0x03) << 3) | (0x20 if wretain else 0x00)
    body = _mqtt_str(name) + bytes([protocol_level, flags]) + \
        struct.pack(">H", keepalive)
    if protocol_level == 5:
        body += b"\x00"  # empty properties
    body += _mqtt_str(client_id)
    if will is not None:
        if protocol_level == 5:
            if will_delay_s:
                props = b"\x18" + struct.pack(">I", will_delay_s)
                body += encode_varlen(len(props)) + props
            else:
                body += b"\x00"  # empty will properties
        body += _mqtt_str(wtopic) + struct.pack(">H", len(wpayload)) + wpayload
    return packet(CONNECT, 0, body)


def publish_packet(topic: str, payload: bytes, qos: int = 0,
                   retain: bool = False, packet_id: int = 0,
                   protocol_level: int = 4, dup: bool = False) -> bytes:
    flags = (qos << 1) | (1 if retain else 0) | (0x08 if dup else 0)
    body = _mqtt_str(topic)
    if qos > 0:
        body += struct.pack(">H", packet_id)
    if protocol_level == 5:
        body += b"\x00"
    body += payload
    return packet(PUBLISH, flags, body)


def subscribe_packet(packet_id: int, filters: List[Tuple[str, int]],
                     protocol_level: int = 4) -> bytes:
    body = struct.pack(">H", packet_id)
    if protocol_level == 5:
        body += b"\x00"
    for f, q in filters:
        body += _mqtt_str(f) + bytes([q])
    return packet(SUBSCRIBE, 0x02, body)


from ..utils.net import recv_exact as _recv_exact


def parse_frame(buf, pos: int):
    """Parse one MQTT frame out of buf[pos:].

    Returns (ptype, flags, body, next_pos), or None while the frame is
    still incomplete.  Raises ValueError on a malformed remaining-length.
    This is the zero-copy-ish framing step both transports share: the
    blocking server reads exact counts, the event server feeds recv()
    chunks through this."""
    n = len(buf)
    if n - pos < 2:
        return None
    h = buf[pos]
    mult, length, i = 1, 0, pos + 1
    for _ in range(4):
        if i >= n:
            return None
        b = buf[i]
        i += 1
        length += (b & 0x7F) * mult
        if not b & 0x80:
            break
        mult *= 128
    else:
        raise ValueError("malformed remaining-length")
    if n - i < length:
        return None
    return h >> 4, h & 0x0F, bytes(buf[i:i + length]), i + length


class MqttProtocol:
    """Transport-independent per-connection MQTT state machine.

    Both TCP fronts (`MqttServer`, thread-per-connection, and
    `MqttEventServer`, epoll loop) drive this one class: they feed it
    decoded frames via `handle_packet` and give it a `send(bytes)` to
    answer on.  Broker fan-out arrives through `deliver` (registered as
    the session's delivery callback), which may run on any thread — the
    supplied `send` must be thread-safe."""

    def __init__(self, broker: MqttBroker, send: Callable[[bytes], None]):
        self.broker = broker
        self._send = send
        self.level = 4
        self.client_id: Optional[str] = None
        self.session = None
        #: keepalive seconds from CONNECT (0 = disabled).  The transport
        #: enforces the spec's 1.5× rule: no packet for keepalive*1.5 →
        #: abnormal close (which publishes the will, §3.1.2-10).
        self.keepalive = 0
        self._next_pid = 0
        self._pid_lock = threading.Lock()
        # outbound QoS 2 sender state: pid → "rec" (awaiting PUBREC) or
        # "comp" (PUBREL sent, awaiting PUBCOMP).  Spec §4.3.3 sender flow.
        self._out_qos2: Dict[int, str] = {}

    # ------------------------------------------------------ broker fan-out
    def deliver(self, topic: str, payload: bytes, qos: int, retain: bool):
        pid = 0
        if qos > 0:
            with self._pid_lock:
                self._next_pid = self._next_pid % 65535 + 1
                pid = self._next_pid
                if qos == 2:
                    self._out_qos2[pid] = "rec"
        try:
            self._send(publish_packet(topic, payload, qos, retain, pid,
                                      protocol_level=self.level))
        except OSError:
            pass  # connection torn down mid-fanout; session cleanup follows

    # ------------------------------------------------------ inbound frames
    def handle_packet(self, ptype: int, flags: int, body: bytes) -> bool:
        """Process one frame; returns False when the connection must close.

        Raises ValueError/struct.error on protocol violations (wildcard
        PUBLISH topic, short body) — MQTT says drop the connection."""
        broker = self.broker
        if ptype != CONNECT and self.session is None:
            # spec §3.1: the first packet MUST be CONNECT.  Without this a
            # pre-CONNECT SUBSCRIBE would register topic-tree state under a
            # None client id that no teardown ever removes.
            raise ValueError(f"packet type {ptype} before CONNECT")
        if ptype == CONNECT:
            if self.session is not None:
                raise ValueError("second CONNECT on one connection")
            _name, pos = _read_str(body, 0)
            self.level = body[pos]
            cflags = body[pos + 1]
            clean = bool(cflags & 0x02)
            (self.keepalive,) = struct.unpack_from(">H", body, pos + 2)
            pos += 4  # level + flags + keepalive
            if self.level >= 5:
                pos = _skip_props(body, pos)
            client_id, pos = _read_str(body, pos)
            # Last Will (§3.1.2-8): will flag → will topic + message follow
            # the client id (after will properties on v5): the failure-
            # detection primitive a predictive-maintenance fleet leans on
            # (a dead car's will tells the platform the car is gone).
            will = None
            will_delay_s = 0
            if cflags & 0x04:
                if self.level >= 5:
                    will_delay_s, pos = _parse_will_props(body, pos)
                wtopic, pos = _read_str(body, pos)
                (wlen,) = struct.unpack_from(">H", body, pos)
                wpayload = bytes(body[pos + 2:pos + 2 + wlen])
                if len(wpayload) != wlen:
                    raise ValueError("truncated will payload")
                pos += 2 + wlen
                will = (wtopic, wpayload, (cflags >> 3) & 0x03,
                        bool(cflags & 0x20))
            if not client_id and not clean:
                # §3.1.3-8: a zero-byte client id REQUIRES a clean
                # session — a synthesized persistent id could never
                # be resumed, only leak offline queue state.
                # v5: reason 0x85 (client id not valid) + empty
                # properties; v4: return code 0x02
                reject = (b"\x00\x85\x00" if self.level >= 5
                          else b"\x00\x02")
                self._send(packet(CONNACK, 0, reject))
                return False
            self.client_id = client_id or f"anon-{id(self):x}"
            self.session = broker.connect(self.client_id, self.deliver, clean,
                                          will=will,
                                          will_delay_s=will_delay_s)
            # byte 1 bit 0 = session-present (MQTT 3.1.1 §3.2.2.2):
            # a resumed persistent session must say so, or spec
            # clients discard their subscription state
            sp = b"\x01" if self.session.resumed else b"\x00"
            ack = sp + (b"\x00\x00" if self.level >= 5 else b"\x00")
            self._send(packet(CONNACK, 0, ack))
            # only after CONNACK is on the wire may queued offline
            # PUBLISHes flow (a pre-CONNACK PUBLISH breaks clients)
            broker.deliver_pending(self.session)
        elif ptype == PUBLISH:
            qos = (flags >> 1) & 0x03
            retain = bool(flags & 0x01)
            topic, pos = _read_str(body, 0)
            pid = 0
            if qos > 0:
                (pid,) = struct.unpack_from(">H", body, pos)
                pos += 2
            if self.level >= 5:
                pos = _skip_props(body, pos)
            if qos == 2:
                # exactly-once inbound: forward only the FIRST arrival of
                # this packet id; a DUP retry (PUBREC lost / reconnect
                # before PUBREL) re-acknowledges without re-forwarding
                if self.broker.qos2_begin(self.session, pid):
                    broker.publish(topic, body[pos:], qos, retain)
                self._send(packet(PUBREC, 0, struct.pack(">H", pid)))
            else:
                broker.publish(topic, body[pos:], qos, retain)
                if qos == 1:
                    self._send(packet(PUBACK, 0, struct.pack(">H", pid)))
        elif ptype == PUBREL:
            # sender released the id: complete the handshake and forget it
            (pid,) = struct.unpack_from(">H", body, 0)
            self.broker.qos2_release(self.session, pid)
            self._send(packet(PUBCOMP, 0, struct.pack(">H", pid)))
        elif ptype == PUBREC:
            # receiver acked our QoS 2 delivery: release
            (pid,) = struct.unpack_from(">H", body, 0)
            if self._out_qos2.get(pid) == "rec":
                self._out_qos2[pid] = "comp"
            self._send(packet(PUBREL, 0x02, struct.pack(">H", pid)))
        elif ptype == PUBCOMP:
            (pid,) = struct.unpack_from(">H", body, 0)
            self._out_qos2.pop(pid, None)
        elif ptype == SUBSCRIBE:
            (pid,) = struct.unpack_from(">H", body, 0)
            pos = 2
            if self.level >= 5:
                pos = _skip_props(body, pos)
            codes = bytearray()
            while pos < len(body):
                f, pos = _read_str(body, pos)
                qos = body[pos] & 0x03
                pos += 1
                try:
                    codes.append(broker.subscribe(self.client_id, f, qos))
                except ValueError:
                    codes.append(0x80)  # per-filter failure code
            self._send(packet(SUBACK, 0,
                              struct.pack(">H", pid) +
                              (b"\x00" if self.level >= 5 else b"") +
                              bytes(codes)))
        elif ptype == UNSUBSCRIBE:
            (pid,) = struct.unpack_from(">H", body, 0)
            pos = 2
            if self.level >= 5:
                pos = _skip_props(body, pos)
            while pos < len(body):
                f, pos = _read_str(body, pos)
                broker.unsubscribe(self.client_id, f)
            self._send(packet(UNSUBACK, 0, struct.pack(">H", pid)))
        elif ptype == PINGREQ:
            self._send(packet(PINGRESP, 0, b""))
        elif ptype == PUBACK:
            pass  # client acks for our qos1 deliveries
        elif ptype == DISCONNECT:
            # clean disconnect discards the will (§3.1.2-10) — EXCEPT the
            # v5 "disconnect with will message" reason 0x04 (§3.14.2.1),
            # which closes the network connection normally but still asks
            # for the will to be published
            keep_will = (self.level >= 5 and len(body) >= 1
                         and body[0] == 0x04)
            if not keep_will and self.session is not None:
                self.broker.discard_will(self.session)
            return False
        return True

    def teardown(self):
        if self.client_id is not None:
            # identity-checked: a session taken over by a newer
            # connection with this client id survives our teardown.
            # Any will still registered on the session is published by the
            # broker here — reaching teardown without a clean DISCONNECT
            # (socket error, EOF, keepalive timeout, protocol violation)
            # is exactly the spec's "abnormal disconnection".
            self.broker.disconnect(self.client_id, self.session)


# ------------------------------------------------------------------ server
class _Conn(socketserver.BaseRequestHandler):
    """One MQTT connection on the thread-per-connection front.  The handler
    loop reads packets and drives the shared MqttProtocol; outbound
    publishes are serialized by a per-connection write lock (broker fan-out
    may run on other publishers' threads)."""

    def _read_exact(self, n: int) -> bytes:
        return _recv_exact(self.request, n)

    def _send(self, data: bytes) -> None:
        with self._wlock:
            self.request.sendall(data)

    def handle(self):
        broker: MqttBroker = self.server.broker  # type: ignore[attr-defined]
        self._wlock = threading.Lock()
        proto = MqttProtocol(broker, self._send)
        try:
            # until CONNECT announces a keepalive, bound the handshake wait
            self.request.settimeout(30.0)
            ka_armed = 0
            while True:
                (h,) = self._read_exact(1)
                ptype, flags = h >> 4, h & 0x0F
                length = decode_varlen(self._read_exact)
                body = self._read_exact(length) if length else b""
                if not proto.handle_packet(ptype, flags, body):
                    break
                if not ka_armed and proto.session is not None:
                    # §3.1.2-24: 1.5× the keepalive with no packet →
                    # abnormal close (the timeout surfaces as OSError, so
                    # teardown publishes the will); keepalive 0 disables
                    ka_armed = 1
                    self.request.settimeout(
                        proto.keepalive * 1.5 if proto.keepalive else None)
        except (ConnectionError, OSError):
            pass
        except (ValueError, struct.error, IndexError):
            # protocol violation (wildcard PUBLISH topic, malformed
            # varint/short body — truncated bodies surface as IndexError):
            # MQTT says drop the connection — without letting socketserver
            # dump a traceback per bad client
            pass
        finally:
            proto.teardown()


class MqttServer(socketserver.ThreadingTCPServer):
    """TCP front for MqttBroker.  `with MqttServer(broker) as s:` serves on
    an ephemeral localhost port (`s.port`) until the block exits."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, broker: MqttBroker, host: str = "127.0.0.1",
                 port: int = 0):
        super().__init__((host, port), _Conn)
        self.broker = broker
        self.port = self.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MqttServer":
        from ..supervise.registry import register_thread

        self._thread = register_thread(threading.Thread(
            target=self.serve_forever, daemon=True,
            name=f"iotml-mqtt-wire-{self.port}"))
        self._thread.start()
        return self

    def __enter__(self) -> "MqttServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()
        self.server_close()


# ------------------------------------------------------------------ client
class MqttClient:
    """Small blocking MQTT client (the simulator agents' network path)."""

    def __init__(self, host: str, port: int, client_id: str,
                 protocol_level: int = 4, clean: bool = True,
                 on_message: Optional[Callable[[str, bytes], None]] = None,
                 keepalive: int = 60,
                 will: Optional[Tuple[str, bytes, int, bool]] = None,
                 will_delay_s: int = 0):
        self.client_id = client_id
        self._level = protocol_level
        self._sock = socket.create_connection((host, port), timeout=10)
        self._on_message = on_message
        self._acks: Dict[int, threading.Event] = {}
        # QoS 2 sender: pid → (PUBREC event, PUBCOMP event)
        self._qos2_acks: Dict[int, Tuple[threading.Event, threading.Event]] = {}
        # QoS 2 receiver dedup: inbound pids seen but not yet PUBREL'd
        self._qos2_inbound: set = set()
        self._suback = threading.Event()
        self._suback_codes: List[int] = []
        # ping pairing: PINGRESPs are FIFO per connection, so response N
        # answers request N — counting both sides lets ping() wait for THE
        # response to ITS request, immune to late responses of abandoned
        # (timed-out keepalive) requests satisfying a later barrier early
        self._ping_sent = 0
        self._ping_rcvd = 0
        self._ping_cv = threading.Condition()
        self._next_pid = 0
        self._wlock = threading.Lock()
        self._sock.sendall(connect_packet(client_id, protocol_level,
                                          keepalive=keepalive, clean=clean,
                                          will=will,
                                          will_delay_s=will_delay_s))
        h, body = self._read_packet()
        if h >> 4 != CONNACK:
            raise ConnectionError(f"expected CONNACK, got {h >> 4}")
        # the connect timeout must not survive into the reader thread: an
        # idle subscriber would hit recv timeout after 10s and die silently
        self._sock.settimeout(None)
        from ..supervise.registry import register_thread

        self._reader = register_thread(threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"iotml-mqtt-reader-{client_id}"))
        self._reader.start()
        # honor our announced keepalive: the server evicts at 1.5× with no
        # inbound packet, so an idle client must ping on its own — one
        # PINGREQ every keepalive/2 (clients may send early, §3.1.2-23)
        self._closed = threading.Event()
        # serializes ping round-trips: with the keepalive thread also
        # pinging, an unpaired PINGREQ's late PINGRESP could otherwise
        # satisfy a user ping()'s wait early and break its quiesce-barrier
        # guarantee (at most ONE outstanding PINGREQ at a time)
        self._ping_lock = threading.Lock()
        if keepalive:
            self._keeper = register_thread(threading.Thread(
                target=self._keepalive_loop, args=(keepalive / 2,),
                daemon=True, name=f"iotml-mqtt-keepalive-{client_id}"))
            self._keeper.start()

    def _keepalive_loop(self, interval_s: float) -> None:
        while not self._closed.wait(interval_s):
            try:
                self.ping(timeout=interval_s)
            except TimeoutError:
                continue  # one slow PINGRESP (GC pause, loaded box) must
                #           not permanently disable keepalive
            except OSError:
                return  # connection gone: the reader owns errors

    def _read_exact(self, n: int) -> bytes:
        return _recv_exact(self._sock, n)

    def _read_packet(self) -> Tuple[int, bytes]:
        (h,) = self._read_exact(1)
        length = decode_varlen(self._read_exact)
        return h, self._read_exact(length) if length else b""

    def _read_loop(self):
        try:
            while True:
                h, body = self._read_packet()
                ptype, flags = h >> 4, h & 0x0F
                if ptype == PUBLISH:
                    qos = (flags >> 1) & 0x03
                    topic, pos = _read_str(body, 0)
                    duplicate = False
                    if qos > 0:
                        (pid,) = struct.unpack_from(">H", body, pos)
                        pos += 2
                        if qos == 1:
                            ack = packet(PUBACK, 0, struct.pack(">H", pid))
                        else:  # exactly-once receiver: dedup until PUBREL
                            duplicate = pid in self._qos2_inbound
                            self._qos2_inbound.add(pid)
                            ack = packet(PUBREC, 0, struct.pack(">H", pid))
                        with self._wlock:
                            self._sock.sendall(ack)
                    if self._level >= 5:
                        pos = _skip_props(body, pos)
                    if self._on_message and not duplicate:
                        self._on_message(topic, body[pos:])
                elif ptype == PUBACK:
                    (pid,) = struct.unpack_from(">H", body, 0)
                    ev = self._acks.pop(pid, None)
                    if ev:
                        ev.set()
                elif ptype == PUBREC:
                    (pid,) = struct.unpack_from(">H", body, 0)
                    pair = self._qos2_acks.get(pid)
                    if pair:
                        pair[0].set()
                    with self._wlock:
                        self._sock.sendall(
                            packet(PUBREL, 0x02, struct.pack(">H", pid)))
                elif ptype == PUBREL:
                    (pid,) = struct.unpack_from(">H", body, 0)
                    self._qos2_inbound.discard(pid)
                    with self._wlock:
                        self._sock.sendall(
                            packet(PUBCOMP, 0, struct.pack(">H", pid)))
                elif ptype == PUBCOMP:
                    (pid,) = struct.unpack_from(">H", body, 0)
                    pair = self._qos2_acks.pop(pid, None)
                    if pair:
                        pair[1].set()
                elif ptype == SUBACK:
                    pos = 2  # packet id
                    if self._level >= 5:
                        pos = _skip_props(body, pos)
                    self._suback_codes = list(body[pos:])
                    self._suback.set()
                elif ptype == PINGRESP:
                    with self._ping_cv:
                        self._ping_rcvd += 1
                        self._ping_cv.notify_all()
        except (ConnectionError, OSError):
            pass

    def publish(self, topic: str, payload: bytes, qos: int = 0,
                retain: bool = False, timeout: float = 10.0) -> None:
        """QoS 0: fire and forget.  QoS 1: blocks until PUBACK.  QoS 2:
        blocks through the full PUBREC→PUBREL→PUBCOMP handshake (the
        reader thread sends the PUBREL on PUBREC arrival)."""
        pid, ev, pair = 0, None, None
        if qos > 0:
            with self._wlock:
                self._next_pid = self._next_pid % 65535 + 1
                pid = self._next_pid
            if qos == 1:
                ev = threading.Event()
                self._acks[pid] = ev
            else:
                pair = (threading.Event(), threading.Event())
                self._qos2_acks[pid] = pair
        with self._wlock:
            self._sock.sendall(publish_packet(topic, payload, qos, retain,
                                              pid, self._level))
        if ev is not None and not ev.wait(timeout):
            raise TimeoutError(f"no PUBACK for packet {pid}")
        if pair is not None:
            if not pair[0].wait(timeout):
                raise TimeoutError(f"no PUBREC for packet {pid}")
            if not pair[1].wait(timeout):
                raise TimeoutError(f"no PUBCOMP for packet {pid}")

    def publish_many(self, items, qos: int = 0) -> int:
        """Pipeline a batch of QoS-0 publishes in ONE socket write.

        A fleet driver pushes a tick's worth of per-car publishes per
        connection; a sendall per message would syscall 100k times per
        tick.  QoS 0 only: higher QoS
        needs per-packet ids and ack tracking, which defeats the
        point of the batch."""
        if qos != 0:
            raise ValueError("publish_many is QoS 0 only")
        buf = b"".join(publish_packet(topic, payload, 0, False, 0,
                                      self._level)
                       for topic, payload in items)
        with self._wlock:
            self._sock.sendall(buf)
        return len(items)

    def subscribe(self, filter_: str, qos: int = 0,
                  timeout: float = 10.0) -> None:
        with self._wlock:
            self._next_pid = self._next_pid % 65535 + 1
            pid = self._next_pid
        self._suback.clear()
        with self._wlock:
            self._sock.sendall(subscribe_packet(pid, [(filter_, qos)],
                                                self._level))
        if not self._suback.wait(timeout):
            raise TimeoutError("no SUBACK")
        codes = getattr(self, "_suback_codes", [])
        if any(c >= 0x80 for c in codes):
            raise ValueError(
                f"server rejected subscription {filter_!r} (SUBACK {codes})")

    def ping(self, timeout: float = 10.0) -> None:
        """PINGREQ/PINGRESP round-trip.  Because the server processes each
        connection's packets in order, a returned ping guarantees every
        prior qos-0 publish on this connection has been fully fanned out —
        the deterministic quiesce barrier the scenario runner uses.

        Sequence-paired: this waits for the response to ITS OWN request
        (PINGRESP N answers PINGREQ N on an ordered connection), so a late
        response to an earlier abandoned request — e.g. a keepalive ping
        that timed out on a loaded box — can never satisfy the barrier
        early."""
        with self._ping_lock:
            with self._ping_cv:
                self._ping_sent += 1
                target = self._ping_sent
            with self._wlock:
                self._sock.sendall(packet(PINGREQ, 0, b""))
            deadline = time.monotonic() + timeout
            with self._ping_cv:
                while self._ping_rcvd < target:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._ping_cv.wait(remaining):
                        if self._ping_rcvd >= target:
                            break
                        raise TimeoutError("no PINGRESP")

    def disconnect(self) -> None:
        self._closed.set()
        try:
            with self._wlock:
                self._sock.sendall(packet(DISCONNECT, 0, b""))
            self._sock.close()
        except OSError:
            pass

    def drop(self) -> None:
        """Abort the network connection WITHOUT a DISCONNECT packet — the
        abnormal-disconnect path (the broker publishes our will).
        shutdown() first: close() alone would not send the FIN while the
        reader thread is blocked in recv (the blocked syscall holds the
        file description open)."""
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
