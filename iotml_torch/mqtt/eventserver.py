"""Fleet-scale MQTT listener: one epoll loop, thousands of connections
(``iotml.mqtt.eventserver``'s copy).

The reference fronts its 100,000-car fleet with a 5-node HiveMQ cluster
(reference `infrastructure/hivemq/hivemq-crd.yaml:10-18`: 5 nodes × 4 CPU ×
10G heap; reference `infrastructure/test-generator/scenario.xml:13-14`:
100k clients at ~10k msgs/s fleet-wide).  A thread-per-connection front
(`wire.MqttServer`) cannot hold that many sockets in Python; this listener
is the scale path: non-blocking sockets multiplexed by one
`selectors.DefaultSelector` (epoll on Linux) event loop, per-connection
input/output buffers, and the same `MqttProtocol` state machine the
threaded front drives — so both transports stay protocol-identical by
construction.

Flow-control stance (HiveMQ's "overload protection" analogue, charted by
its Grafana credit-system panels): a consumer connection whose output
buffer exceeds `max_outbuf` is disconnected (slow-consumer eviction —
the broker must never buffer unboundedly for one stalled socket), and
publishers are throttled by aggregate output pressure: when the total
bytes buffered for delivery exceed `high_watermark`, the listener stops
READING from the connections that are feeding it, pushing backpressure
into the publishers' TCP windows — the same stop-reading mechanism
HiveMQ's credit system uses — and resumes them once the backlog drains
below `low_watermark`.

Delivery threading: broker fan-out calls `MqttProtocol.deliver` on the
*publisher's* thread.  For wire-to-wire traffic that is the event-loop
thread itself; for in-process publishers (e.g. platform components) it is
a foreign thread.  `_send_to` is therefore thread-safe: it appends to the
connection's locked output buffer, marks the connection write-pending, and
wakes the loop through a socketpair.  Only the loop thread touches the
selector, so no cross-thread selector mutation ever happens.
"""

from __future__ import annotations

import selectors
import socket
import struct
import threading
import time
from typing import Dict, Optional

from ..obs.metrics import default_registry
from .broker import MqttBroker
from .wire import MqttProtocol, parse_frame

# Overload-protection metric families — the rebuilt twins of the credit-
# system panels in the reference's HiveMQ dashboard (hivemq.json charts
# overload-protection credits and backpressure); the generated Grafana
# dashboards pick these up from the registry automatically.
_m_paused = default_registry.gauge(
    "mqtt_overload_publishers_paused_current",
    "publisher connections currently read-suspended by backpressure")
_m_backlog = default_registry.gauge(
    "mqtt_overload_delivery_backlog_bytes",
    "bytes buffered for delivery across all connections (the watermark "
    "quantity)")
_m_evicted = default_registry.counter(
    "mqtt_overload_slow_consumers_evicted_total",
    "consumer connections dropped for not draining their delivery buffer")


class _EConn:
    """Per-socket state owned by the event loop."""

    __slots__ = ("sock", "proto", "inbuf", "outbuf", "lock", "closing",
                 "paused", "registered", "last_recv")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.proto: Optional[MqttProtocol] = None
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.lock = threading.Lock()
        self.closing = False
        self.paused = False  # reads suspended (publisher backpressure)
        self.registered = True  # currently in the selector (loop thread)
        self.last_recv = time.monotonic()  # keepalive clock (loop thread)


class MqttEventServer:
    """Selector-based TCP front for MqttBroker (the 10k-connection path).

    Same context-manager surface as `wire.MqttServer`:
    `with MqttEventServer(broker) as s:` serves on `s.port` until exit.

    Args:
      max_outbuf: slow-consumer eviction threshold (bytes buffered for one
        connection before it is dropped).
      high_watermark / low_watermark: aggregate delivery-backlog bounds for
        publisher backpressure (reads suspended above high, resumed below
        low).
      stall_timeout_s: overload-protection escape.  If the backlog has not
        drained below the low watermark after this long with publishers
        paused, the slowest consumer (largest output buffer) is evicted —
        repeatedly, one per loop pass — until the backlog sinks and the
        publishers resume.  Without this, enough stalled consumers each
        sitting under max_outbuf could hold every publisher paused (and
        their closed sockets unobserved) forever.
      handshake_timeout_s: a connection that has not completed CONNECT
        within this bound is dropped (same 30s stance as the threaded
        front) — otherwise half-open sockets that never speak MQTT would
        hold fds and selector slots forever.
    """

    def __init__(self, broker: MqttBroker, host: str = "127.0.0.1",
                 port: int = 0, max_outbuf: int = 4 << 20,
                 high_watermark: int = 16 << 20,
                 low_watermark: int = 4 << 20,
                 stall_timeout_s: float = 10.0,
                 handshake_timeout_s: float = 30.0):
        self.broker = broker
        self.max_outbuf = max_outbuf
        self.high_watermark = high_watermark
        self.low_watermark = low_watermark
        self.stall_timeout_s = stall_timeout_s
        self.handshake_timeout_s = handshake_timeout_s
        self._pause_started: Optional[float] = None  # loop-thread only
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # generous receive buffers, set on the LISTENER so accepted sockets
        # inherit them with the right window scale (post-connect shrinking
        # wedges TCP).  Under a fleet-scale burst, per-conn buffer overflow
        # on loopback manifests as packet loss → RTO exponential backoff →
        # sockets stuck for tens of seconds with cwnd 1 (observed at
        # backoff 7 / rto 29s in the 9k-conn drain phase) — a deep buffer
        # absorbs a pass's worth of backlog instead.
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
        self._lsock.bind((host, port))
        self._lsock.listen(1024)
        self._lsock.setblocking(False)
        self.host, self.port = self._lsock.getsockname()[:2]
        self._sel = selectors.DefaultSelector()
        self._conns: Dict[socket.socket, _EConn] = {}
        # cross-thread write wake-up: foreign threads add to _pending and
        # poke the socketpair; the loop drains both
        self._pending: set = set()
        self._pending_lock = threading.Lock()
        # aggregate bytes queued for delivery across all connections — the
        # quantity the publisher-backpressure watermarks act on
        self._total_out = 0
        self._out_lock = threading.Lock()
        self._paused_conns: set = set()  # loop-thread only
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._next_ka_sweep = 0.0  # loop-thread only

    # --------------------------------------------------------- lifecycle
    def start(self) -> "MqttEventServer":
        from ..supervise.registry import register_thread

        self._running = True
        self._thread = register_thread(threading.Thread(
            target=self._loop, daemon=True,
            name=f"mqtt-evloop-{self.port}"))
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        self._wake()
        if self._thread is not None:
            self._thread.join(timeout=5)
        for conn in list(self._conns.values()):
            self._close(conn)
        try:
            self._lsock.close()
        finally:
            self._sel.close()
            self._wake_r.close()
            self._wake_w.close()

    def __enter__(self) -> "MqttEventServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def connection_count(self) -> int:
        return len(self._conns)

    @property
    def paused_count(self) -> int:
        """Connections currently read-suspended by backpressure."""
        return len(self._paused_conns)

    # --------------------------------------------------------- internals
    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass

    def _send_to(self, conn: _EConn, data: bytes) -> None:
        """Thread-safe outbound enqueue (MqttProtocol's send).

        The watermark counter is updated INSIDE conn.lock so it cannot race
        _close's leftover accounting: either the bytes are appended+counted
        before close snapshots them (close subtracts them), or close has
        already marked the connection and this raises without counting.
        Lock order conn.lock → _out_lock everywhere."""
        with conn.lock:
            if conn.closing:
                raise OSError("connection closing")
            conn.outbuf += data
            over = len(conn.outbuf) > self.max_outbuf
            with self._out_lock:
                self._total_out += len(data)
        with self._pending_lock:
            self._pending.add(conn)
        if over:
            # slow-consumer eviction: mark and let the loop tear it down
            conn.closing = True
            _m_evicted.inc()
        if threading.current_thread() is not self._thread:
            self._wake()

    def _loop(self) -> None:
        self._sel.register(self._lsock, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        while self._running:
            events = self._sel.select(timeout=0.1)
            for key, mask in events:
                tag = key.data
                if tag == "accept":
                    self._accept()
                elif tag == "wake":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                else:
                    conn = tag
                    if mask & selectors.EVENT_READ:
                        self._readable(conn)
                    if mask & selectors.EVENT_WRITE:
                        self._flush(conn)
            # drain cross-thread sends
            with self._pending_lock:
                pending, self._pending = self._pending, set()
            for conn in pending:
                if conn.sock in self._conns:
                    self._flush(conn)
            # overload gauges refresh once per loop pass, not per message
            # (the registry lock must not ride the enqueue hot path); with
            # one listener per process — the deployment shape — the gauges
            # read as this listener's state
            with self._out_lock:
                _m_backlog.set(self._total_out)
            _m_paused.set(len(self._paused_conns))
            # keepalive enforcement (§3.1.2-24): every second, close any
            # connection silent for over 1.5× its announced keepalive —
            # abnormal close, so teardown publishes its will.  Paused
            # connections are exempt: WE stopped reading them, so their
            # pings may be sitting unread in the kernel buffer.
            now = time.monotonic()
            if now >= self._next_ka_sweep:
                self._next_ka_sweep = now + 1.0
                for conn in list(self._conns.values()):
                    if conn.paused:
                        continue
                    proto = conn.proto
                    if proto is None or proto.session is None:
                        # pre-CONNECT: bound the handshake wait
                        if now - conn.last_recv > self.handshake_timeout_s:
                            self._close(conn)
                    elif proto.keepalive and \
                            now - conn.last_recv > 1.5 * proto.keepalive:
                        self._close(conn)
            # backpressure release: resume paused publishers once the
            # aggregate delivery backlog has drained below the low mark
            if self._paused_conns:
                with self._out_lock:
                    below = self._total_out < self.low_watermark
                if below:
                    for conn in list(self._paused_conns):
                        conn.paused = False
                        if conn.sock in self._conns:
                            self._rearm(conn)
                    self._paused_conns.clear()
                    self._pause_started = None
                elif self._pause_started is not None and \
                        time.monotonic() - self._pause_started > \
                        self.stall_timeout_s:
                    # the backlog is not draining: evict the slowest
                    # consumer so the system unwedges instead of holding
                    # every publisher paused indefinitely.  The clock is
                    # NOT reset — once stalled, one eviction per loop pass
                    # until the backlog sinks below the low mark (the
                    # resume branch above then clears the clock).
                    victim = max(self._conns.values(),
                                 key=lambda c: len(c.outbuf), default=None)
                    if victim is not None and victim.outbuf \
                            and not victim.closing:
                        # not victim.closing: an outbuf-cap eviction may
                        # have marked (and counted) it already this pass
                        victim.closing = True  # eviction, not courtesy close
                        _m_evicted.inc()
                        self._close(victim)

    def _accept(self) -> None:
        while True:
            try:
                sock, _addr = self._lsock.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _EConn(sock)
            conn.proto = MqttProtocol(
                self.broker, lambda data, c=conn: self._send_to(c, data))
            self._conns[sock] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _events_for(self, conn: _EConn) -> int:
        ev = 0
        if not conn.paused:
            ev |= selectors.EVENT_READ
        with conn.lock:
            if conn.outbuf:
                ev |= selectors.EVENT_WRITE
        return ev

    def _rearm(self, conn: _EConn) -> None:
        """Loop-thread only: sync the selector with the connection state.
        A paused connection with nothing to write is UNREGISTERED — keeping
        it readable would defeat the pause (the selector would keep firing
        and the loop keep ingesting).  A remote close is then observed on
        resume, when reads re-arm."""
        ev = self._events_for(conn)
        try:
            if ev:
                if conn.registered:
                    self._sel.modify(conn.sock, ev, conn)
                else:
                    self._sel.register(conn.sock, ev, conn)
                    conn.registered = True
            elif conn.registered:
                self._sel.unregister(conn.sock)
                conn.registered = False
        except (KeyError, ValueError, OSError):
            pass

    def _readable(self, conn: _EConn) -> None:
        # drain up to 4 chunks per event: one 64KB recv per pass left the
        # kernel buffer refilling faster than the loop could circle back
        # under burst load, overflowing it (→ loopback drops → RTO
        # exponential backoff: stuck senders observed at rto ~29s, cwnd 1);
        # bounded so one firehose connection cannot starve the rest of the
        # pass.  Frames read together with an EOF are parsed BEFORE the
        # close — the FIN does not void the data in front of it.
        eof = False
        got_any = False
        for _ in range(4):
            try:
                data = conn.sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                # error-close (e.g. RST after a burst): frames already
                # received THIS pass still parse below — same invariant as
                # the FIN case, the close does not void the data before it
                eof = True
                break
            if not data:
                eof = True
                break
            conn.inbuf += data
            got_any = True
            if len(data) < (1 << 16):
                break
        if not got_any:
            if eof:
                self._close(conn)
            return
        conn.last_recv = time.monotonic()
        pos = 0
        try:
            while True:
                frame = parse_frame(conn.inbuf, pos)
                if frame is None:
                    break
                ptype, flags, body, pos = frame
                if not conn.proto.handle_packet(ptype, flags, body):
                    self._close(conn)
                    return
        except (ValueError, struct.error, IndexError, OSError):
            # protocol violation (malformed varint, truncated body →
            # IndexError from short reads) → drop the connection (MQTT
            # semantics, same stance as the threaded front).  Only THIS
            # connection dies; the loop serves everyone else on.
            self._close(conn)
            return
        if pos:
            del conn.inbuf[:pos]
        if conn.closing or eof:
            self._close(conn)
            return
        # publisher backpressure: this connection just fed us input; if the
        # aggregate delivery backlog is over the high mark, stop reading it
        # (its TCP window fills → the client blocks) until the drain below
        # the low mark resumes it
        with self._out_lock:
            over = self._total_out > self.high_watermark
        if over:
            conn.paused = True
            self._paused_conns.add(conn)
            if self._pause_started is None:
                self._pause_started = time.monotonic()
        self._rearm(conn)

    def _flush(self, conn: _EConn) -> None:
        if conn.closing:
            # eviction (outbuf cap exceeded): the peer is not draining, so
            # waiting for the buffer to empty would keep it alive forever —
            # drop the connection and its buffered output now
            self._close(conn)
            return
        try:
            with conn.lock:
                if conn.outbuf:
                    n = conn.sock.send(conn.outbuf)
                    del conn.outbuf[:n]
                else:
                    n = 0
            if n:
                with self._out_lock:
                    self._total_out -= n
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._close(conn)
            return
        self._rearm(conn)

    def _close(self, conn: _EConn) -> None:
        self._paused_conns.discard(conn)
        if not self._paused_conns:
            # last paused conn gone: clear the stall clock, or a LATER
            # pause would inherit this one's start time and evict a
            # healthy consumer instantly
            self._pause_started = None
        with conn.lock:
            # eviction (_send_to's outbuf-cap mark) arrives with closing
            # already True; a graceful close (protocol reject/DISCONNECT)
            # sets it here — under conn.lock, so no _send_to can slip bytes
            # in after our leftover accounting
            closing_was = conn.closing
            conn.closing = True
            leftover = bytes(conn.outbuf)
            conn.outbuf.clear()
            if leftover:
                with self._out_lock:
                    self._total_out -= len(leftover)
        if leftover and not closing_was:
            # graceful close: give the final packets — e.g. the
            # spec-mandated CONNACK rejection code — one best-effort
            # non-blocking send before the FIN, matching the threaded
            # front's synchronous send.  (An evicted stalled reader gets
            # no such courtesy: its buffer is the problem.)
            try:
                conn.sock.send(leftover)
            except OSError:
                pass
        if conn.registered:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            conn.registered = False
        self._conns.pop(conn.sock, None)
        try:
            conn.sock.close()
        except OSError:
            pass
        if conn.proto is not None:
            conn.proto.teardown()
