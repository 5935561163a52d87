"""In-process MQTT broker core — the HiveMQ-cluster equivalent
(``iotml.mqtt.broker``'s copy).

The reference fronts its pipeline with a 5-node HiveMQ cluster (reference
`infrastructure/hivemq/hivemq-crd.yaml:10-26`): MQTT sessions, wildcard and
shared subscriptions, QoS 0/1/2, and extension hooks (the Kafka extension
registers for a topic filter and forwards publishes).  This core implements
those broker semantics in-process; `mqtt.wire` and `mqtt.eventserver`
put real TCP/MQTT protocol fronts on it, and `mqtt.bridge.KafkaBridge` is
the extension equivalent.  Metrics use the same family names the reference's Grafana
dashboards chart (`com_hivemq_messages_*`, SURVEY §5).  Fan-out runs
through the ``mqtt.deliver`` fault point, and a publish with no trace
context in flight starts one (stage ``mqtt_publish``) that rides a
thread-local slot to every subscriber callback.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..chaos import faults as chaos
from ..obs import tracing
from ..obs.metrics import default_registry
from .topic_tree import TopicTree, validate_filter

# callback(topic, payload, qos, retain) — delivery to one session
DeliveryFn = Callable[[str, bytes, int, bool], None]


class Session:
    __slots__ = ("client_id", "deliver", "clean_start", "connected_at",
                 "pending", "resumed", "qos2_inbound", "will",
                 "will_delay_s")

    def __init__(self, client_id: str, deliver: DeliveryFn,
                 clean_start: bool = True):
        self.client_id = client_id
        self.deliver = deliver
        self.clean_start = clean_start
        self.connected_at = time.time()  # wallclock-ok: display stat (when the session connected), not a timeout
        # Last Will from CONNECT: (topic, payload, qos, retain) published on
        # abnormal disconnect (socket drop, keepalive timeout, protocol
        # violation, session takeover), DISCARDED on clean DISCONNECT.
        # will_delay_s is the v5 Will Delay Interval: a persistent session
        # that reconnects within the delay cancels the will.
        self.will: Optional[Tuple[str, bytes, int, bool]] = None
        self.will_delay_s: float = 0.0
        # (topic, payload, qos, retain) queued while this persistent
        # session was offline, held until the transport is ready (CONNACK
        # sent); live publishes append here until drained so ordering is
        # preserved
        self.pending: Optional[List[Tuple[str, bytes, int, bool]]] = None
        # True when server-side state (subscriptions/backlog) carried over —
        # what CONNACK's session-present flag must report
        self.resumed: bool = False
        # QoS 2 exactly-once receiver state: packet ids of inbound PUBLISHes
        # whose payload was already forwarded but whose PUBREL has not yet
        # arrived.  A retried PUBLISH with one of these ids is a duplicate
        # and must NOT be forwarded again (spec §4.3.3).  Carried across
        # reconnects for persistent sessions — the dedup guarantee is the
        # whole point of the handshake surviving a dropped connection.
        self.qos2_inbound: set = set()


class MqttBroker:
    """Session + subscription + retained-message state with synchronous
    fan-out delivery.  Thread-safe: routing decisions and queue mutations
    happen under the broker lock, but delivery callbacks run on the
    publisher's thread AFTER the lock is released — a stalled subscriber
    socket can slow its publisher, never the whole broker.  Ordering is
    per-publisher (as before); the wire server hands each connection its
    own writer lock, so concurrent fan-out to one socket is safe."""

    def __init__(self, name: str = "iotml-mqtt",
                 offline_queue_limit: int = 1000,
                 offline_session_expiry_s: float = 3600.0,
                 backpressure_hwm: Optional[int] = None):
        self.name = name
        self._sessions: Dict[str, Session] = {}
        self._tree = TopicTree()
        self._retained: Dict[str, Tuple[bytes, int]] = {}
        # disconnected persistent sessions: cid → [queue, expires_at,
        # qos2_inbound, delayed_will] where delayed_will is None or
        # ((topic, payload, qos, retain), due_time) — a v5 will-delay will
        # pending publication unless the session reconnects first.
        # QoS≥1 deliveries queue (oldest dropped past the limit, HiveMQ's
        # offline buffering); a session that never reconnects expires after
        # offline_session_expiry_s (HiveMQ's session expiry) so rotating
        # client ids cannot grow state without bound.
        self._offline: Dict[str, list] = {}
        self.offline_queue_limit = offline_queue_limit
        self.offline_session_expiry_s = offline_session_expiry_s
        self._next_offline_sweep = 0.0
        # Backpressure: once any receiver queue (a reconnecting
        # session's pending backlog or an offline session's queue)
        # crosses the high-water mark, the broker raises a "slow down"
        # signal cooperative publishers poll via `saturated()` —
        # deferral at the SOURCE instead of drop-oldest at the limit.
        # A publish that lands on a saturated queue counts into
        # iotml_mqtt_backpressure_total either way, so non-cooperative
        # fleets still show up on the dashboard before data is lost.
        self.backpressure_hwm = backpressure_hwm if backpressure_hwm \
            is not None else max(1, (offline_queue_limit * 4) // 5)
        self._bp_sessions: set = set()
        # ONE consolidated timer for all pending delayed wills, armed for
        # the earliest due time (a timer thread per will would mean
        # thousands of stacks during a fleet-scale disconnect wave —
        # exactly the silent-fleet event wills exist for)
        self._will_timer: Optional[threading.Timer] = None
        self._will_timer_due = float("inf")
        # RLock: delivery callbacks may legally re-enter (a subscriber that
        # publishes from its handler, e.g. a bridge)
        self._lock = threading.RLock()
        reg = default_registry
        self._m_in = reg.counter(
            "mqtt_messages_incoming_publish_count",
            "PUBLISH packets received (reference family "
            "com_hivemq_messages_incoming_publish_count)")
        self._m_out = reg.counter(
            "mqtt_messages_outgoing_publish_count",
            "PUBLISH packets delivered to subscribers")
        self._m_dropped = reg.counter(
            "mqtt_messages_dropped_count",
            "publishes that matched no subscription")
        self._m_queued = reg.counter(
            "mqtt_messages_queued_count",
            "QoS>=1 publishes buffered for offline persistent sessions")
        self._g_sessions = reg.gauge(
            "mqtt_sessions_overall_current", "live MQTT sessions")
        self._m_backpressure = reg.counter(
            "iotml_mqtt_backpressure_total",
            "publishes that landed on a receiver queue at/over the "
            "backpressure high-water mark (cooperative publishers "
            "poll saturated() and defer instead)")

    # ------------------------------------------------------ backpressure
    def _note_queue_depth(self, cid: str, depth: int,
                          count: bool = True) -> None:
        """Track a receiver queue against the high-water mark (caller
        holds _lock).  Crossing raises the saturation signal; draining
        below it clears the signal.  ``count`` marks publish-path
        updates (the ones the backpressure counter measures) —
        connect/disconnect bookkeeping only moves the signal."""
        if depth >= self.backpressure_hwm:
            self._bp_sessions.add(cid)
            if count:
                self._m_backpressure.inc()
        else:
            self._bp_sessions.discard(cid)

    def saturated(self) -> bool:
        """The bounded-queue "slow down" signal: True while any
        receiver queue sits at/over the backpressure high-water mark.
        Cooperative publishers (`gen.scenarios` fleet agents, the
        rush-hour burst drill) poll this between publishes and defer
        into their own bounded buffer instead of pushing the broker's
        queues into drop-oldest — deferral at the source is recoverable,
        a dropped-oldest message is not."""
        return bool(self._bp_sessions)

    # ---------------------------------------------------------- sessions
    def connect(self, client_id: str, deliver: DeliveryFn,
                clean_start: bool = True,
                will: Optional[Tuple[str, bytes, int, bool]] = None,
                will_delay_s: float = 0.0) -> Session:
        """Register a session.  A reconnect with the same client id takes
        over (the old delivery path is dropped — MQTT session takeover).

        A persistent session (clean_start=False) that reconnects has the
        QoS≥1 messages queued while it was offline staged on
        `session.pending`; the transport calls `deliver_pending(session)`
        once it is ready (AFTER sending CONNACK — a PUBLISH before CONNACK
        breaks the handshake).  Until that drain, live publishes for the
        session append behind the queued ones, preserving order.

        `will`/`will_delay_s` register the connection's Last Will
        (published on abnormal disconnect — see `disconnect`).  Takeover
        counts as abnormal FOR THE OLD CONNECTION: its will is published
        here, unless a will delay applies (the new connection to the same
        session cancels a delayed will, MQTT 5 §3.1.3.2.2)."""
        takeover_will = None
        with self._lock:
            due_wills = self._expire_offline()
            pending: List[Tuple[str, bytes, int, bool]] = []
            qos2_inbound: set = set()
            old = self._sessions.get(client_id)
            if old is not None:
                if old.pending:
                    # session takeover mid-handshake: the superseded
                    # connection must not drain the backlog to its (likely
                    # dead) socket — the new session inherits it
                    pending = old.pending
                    old.pending = []
                qos2_inbound = old.qos2_inbound
                if old.will is not None and (old.will_delay_s <= 0
                                             or clean_start):
                    # a delayed will survives a non-clean takeover (the new
                    # connection resumes the session and cancels it,
                    # §3.1.3.2.2) — but a clean-start connect ENDS the old
                    # session, and §3.1.2.5 publishes the will at the
                    # earlier of delay expiry and session end
                    takeover_will = old.will
                # either way the old connection's will is settled now —
                # its late teardown must not publish it again
                old.will = None
            resumed = False
            entry = self._offline.pop(client_id, None)
            if clean_start:
                self._tree.unsubscribe_all(client_id)
                if entry is not None and entry[3] is not None:
                    # the offline session carried a pending delayed will;
                    # clean-start ends that session rather than resuming
                    # it, so the will fires NOW (§3.1.2.5: earlier of
                    # delay expiry and session end) — a crashed device
                    # re-provisioned clean must still report as dead
                    due_wills.append(entry[3][0])
                pending = []
                qos2_inbound = set()
            else:
                if entry is not None:
                    # reconnect before the will delay fired: cancel it
                    pending = list(entry[0]) + pending
                    qos2_inbound |= entry[2]
                # session-present: any server-side state carried over
                resumed = (entry is not None or old is not None
                           or bool(self._tree.filters_of(client_id)))
            s = Session(client_id, deliver, clean_start)
            s.resumed = resumed
            s.qos2_inbound = qos2_inbound
            s.will = will
            s.will_delay_s = will_delay_s
            # deliveries are held on `pending` until the transport declares
            # ready via deliver_pending() — this covers both the offline
            # backlog AND live publishes racing the CONNECT handshake (a
            # PUBLISH before CONNACK is a protocol violation)
            s.pending = pending
            self._note_queue_depth(client_id, len(pending), count=False)
            self._sessions[client_id] = s
            self._g_sessions.set(len(self._sessions))
        # outside the lock: will fan-out must not stall the broker
        for w in due_wills:
            self.publish(*w)
        if takeover_will is not None:
            self.publish(*takeover_will)
        return s

    def deliver_pending(self, session: Session) -> int:
        """Drain a freshly-connected session's queued messages and switch
        it to live delivery.  Call after the transport is ready (CONNACK on
        the wire path; immediately for in-process clients).

        Chunked: queue entries are COPIED under the lock, delivered outside
        it (a slow socket must not wedge the broker), and only removed from
        the backlog after delivery — so a takeover mid-chunk inherits the
        in-flight messages (possible duplicates, never loss: QoS 1's
        at-least-once).  Publishes arriving mid-drain append behind the
        backlog, preserving order."""
        n = 0
        while True:
            with self._lock:
                if self._sessions.get(session.client_id) is not session:
                    return n  # superseded: the new session owns the backlog
                chunk = list(session.pending or [])
                if not chunk:
                    session.pending = None  # live from here on
                    self._bp_sessions.discard(session.client_id)
                    return n
            for topic, payload, qos, retain in chunk:
                session.deliver(topic, payload, qos, retain)
                self._m_out.inc()
                n += 1
            with self._lock:
                if self._sessions.get(session.client_id) is not session:
                    return n  # delivered chunk may be redelivered by heir
                # drop the delivered messages BY IDENTITY: a concurrent
                # overflow drop-oldest may already have removed a prefix of
                # the chunk, and positional deletion would then take an
                # undelivered mid-drain arrival with it (silent loss)
                ci = 0
                while session.pending and ci < len(chunk):
                    if session.pending[0] is chunk[ci]:
                        session.pending.pop(0)
                    ci += 1
                # draining below the high-water mark releases the
                # backpressure signal (deferred publishers resume)
                self._note_queue_depth(session.client_id,
                                       len(session.pending or ()),
                                       count=False)

    def discard_will(self, session: Session) -> None:
        """Clean DISCONNECT received: the will must never be published
        (§3.1.2-10).  Called by the transport BEFORE teardown."""
        with self._lock:
            session.will = None

    def disconnect(self, client_id: str,
                   session: Optional[Session] = None) -> None:
        """End a session.  Pass the Session returned by connect() so a
        stale connection's teardown cannot destroy a session that was
        taken over by a newer connection with the same client id.

        Any will still registered on the session is published here — the
        transport discards it first on a clean DISCONNECT, so reaching
        this point with a will set means the disconnect was abnormal.  A
        v5 will delay on a persistent session defers publication: the will
        rides the offline entry and fires in the expiry sweep unless the
        session reconnects first (which cancels it)."""
        will = None
        delayed = None
        with self._lock:
            due_wills = self._expire_offline()
            cur = self._sessions.get(client_id)
            if cur is not None and \
                    (session is None or cur is session):
                del self._sessions[client_id]
                will, cur.will = cur.will, None
                if will is not None and not cur.clean_start \
                        and cur.will_delay_s > 0:
                    # spec: publish at the earlier of will-delay expiry and
                    # session expiry — both bounds land in the sweep, and a
                    # timer guarantees the sweep happens even on an
                    # otherwise-quiet broker
                    delay = min(cur.will_delay_s,
                                self.offline_session_expiry_s)
                    # monotonic domain: will/session deadlines must not
                    # stretch or collapse on a wall-clock step (NTP)
                    delayed = (will, time.monotonic() + delay)
                    will = None
                if cur.clean_start:
                    self._tree.unsubscribe_all(client_id)
                    # the session's queue dies with it: a saturated
                    # clean-start client must not wedge the broker-wide
                    # backpressure signal forever after leaving
                    self._bp_sessions.discard(client_id)
                else:
                    # persistent session goes offline: queue QoS≥1
                    # deliveries until it reconnects (bounded, drop-oldest)
                    # or expires
                    q = deque(cur.pending or (),
                              maxlen=self.offline_queue_limit)
                    self._offline[client_id] = [
                        q, time.monotonic() + self.offline_session_expiry_s,
                        cur.qos2_inbound, delayed]
                    # the deque bound may have clipped the carried-over
                    # backlog; re-judge the signal on the real depth
                    self._note_queue_depth(client_id, len(q), count=False)
                    if delayed is not None:
                        self._arm_will_timer(delayed[1])
                self._g_sessions.set(len(self._sessions))
        # outside the lock: will fan-out must not stall the broker
        for w in due_wills:
            self.publish(*w)
        if will is not None:
            self.publish(*will)

    def _expire_offline(self) -> list:
        """Drop offline persistent sessions past their expiry (HiveMQ's
        session-expiry): queue AND subscriptions go.  Returns due delayed
        wills (v5 will-delay-interval) for the CALLER to publish after
        releasing _lock — fan-out under the broker lock would let one slow
        subscriber socket stall every connect/disconnect/publish."""
        now = time.monotonic()
        due_wills = []
        dead = []
        for cid, entry in self._offline.items():
            if entry[3] is not None and entry[3][1] <= now:
                due_wills.append(entry[3][0])
                entry[3] = None
            if entry[1] < now:
                dead.append(cid)
        for cid in dead:
            del self._offline[cid]
            self._tree.unsubscribe_all(cid)
            self._bp_sessions.discard(cid)
        return due_wills

    def _arm_will_timer(self, due_time: float) -> None:
        """Ensure the consolidated will timer fires by `due_time`.
        Caller holds _lock."""
        if due_time >= self._will_timer_due:
            return  # an earlier firing is already scheduled
        if self._will_timer is not None:
            self._will_timer.cancel()
        self._will_timer_due = due_time
        t = threading.Timer(max(due_time - time.monotonic(), 0.0),
                            self._sweep_due_wills)
        t.daemon = True
        t.start()
        self._will_timer = t

    def _sweep_due_wills(self) -> None:
        """Timer target: publish any delayed wills that have come due and
        re-arm for the next pending one.  Without this, a will on a quiet
        broker (no connects/publishes to trigger the lazy sweep) would
        never fire — and a silent fleet is exactly the condition a will
        exists to report."""
        with self._lock:
            self._will_timer = None
            self._will_timer_due = float("inf")
            due = self._expire_offline()
            nxt = min((e[3][1] for e in self._offline.values()
                       if e[3] is not None), default=None)
            if nxt is not None:
                self._arm_will_timer(nxt)
        for w in due:
            self.publish(*w)

    def session_count(self) -> int:
        return len(self._sessions)

    def session_ids(self) -> List[str]:
        with self._lock:
            return list(self._sessions)

    # ------------------------------------------------------------- qos 2
    def qos2_begin(self, session: Session, packet_id: int) -> bool:
        """Exactly-once receiver step 1: returns True when this packet id
        is NEW for the session (caller must forward the publish), False
        when it is a retry of an unreleased id (caller must NOT forward —
        just re-acknowledge with PUBREC).  Spec §4.3.3 receiver flow."""
        with self._lock:
            if packet_id in session.qos2_inbound:
                return False
            session.qos2_inbound.add(packet_id)
            return True

    def qos2_release(self, session: Session, packet_id: int) -> None:
        """Exactly-once receiver step 2 (PUBREL): the sender has seen our
        PUBREC, so the id can never be retried — forget it."""
        with self._lock:
            session.qos2_inbound.discard(packet_id)

    # ----------------------------------------------------- subscriptions
    def subscribe(self, client_id: str, filter_: str, qos: int = 0) -> int:
        """Returns granted qos (0/1/2 — the reference broker advertises
        maxQos 2, hivemq-crd.yaml:13)."""
        validate_filter(filter_)
        granted = min(qos, 2)
        self._tree.subscribe(client_id, filter_, granted)
        # retained delivery on subscribe (spec §3.8.4) — through the same
        # gate as publish(): routing under the lock, a not-yet-ready
        # session's messages join its pending backlog (never a PUBLISH
        # before CONNACK / ahead of the queued backlog), sockets written
        # only after the lock is released
        from .topic_tree import split_share, topic_matches
        group, real = split_share(filter_)
        live: List[Tuple[str, bytes, int]] = []
        if group is None:  # retained messages are not sent to shared subs
            with self._lock:
                sess = self._sessions.get(client_id)
                if sess is not None:
                    for topic, (payload, rqos) in list(self._retained.items()):
                        if not topic_matches(real, topic):
                            continue
                        eff = min(granted, rqos)
                        # retain=True rides along: spec 3.3.1.3 requires the
                        # flag on messages sent due to a new subscription
                        if sess.pending is not None:
                            sess.pending.append((topic, payload, eff, True))
                        else:
                            live.append((topic, payload, eff))
            for topic, payload, eff in live:
                sess.deliver(topic, payload, eff, True)
        return granted

    def unsubscribe(self, client_id: str, filter_: str) -> bool:
        return self._tree.unsubscribe(client_id, filter_)

    # ------------------------------------------------------------ publish
    def publish(self, topic: str, payload: bytes, qos: int = 0,
                retain: bool = False) -> int:
        """Fan a publish out to every matching session; returns the number
        of deliveries."""
        if "+" in topic or "#" in topic:
            raise ValueError(f"wildcards not allowed in publish topic: {topic!r}")
        self._m_in.inc()
        # Trace injection: a record is born here.  Delivery is synchronous
        # on THIS thread (fan-out after the lock is released), so the
        # context rides a thread-local slot to every subscriber callback —
        # the bridge reads it and forwards it as a stream-record header.
        # MQTT 3 has no per-message metadata slot, so no wire change.
        # Re-entrant publishes (a will fired mid-publish, a subscriber
        # republishing) inherit the outer record's context rather than
        # starting their own.
        _tctx = _tprev = None
        if tracing.ENABLED and tracing.current() is None:
            _tctx = tracing.start("mqtt_publish")
            if _tctx is not None:
                _tprev = tracing.set_current(_tctx)
        try:
            return self._publish_locked_fanout(topic, payload, qos, retain)
        finally:
            if _tctx is not None:
                tracing.set_current(_tprev)

    def _publish_locked_fanout(self, topic: str, payload: bytes, qos: int,
                               retain: bool) -> int:
        delivered = queued = 0
        live: List[Tuple[Session, int]] = []
        due_wills: list = []
        with self._lock:  # routing + queue mutation atomic; delivery after
            now = time.monotonic()
            if now >= self._next_offline_sweep:
                due_wills = self._expire_offline()
                self._next_offline_sweep = now + 5.0
            if retain:
                if payload:
                    self._retained[topic] = (payload, qos)
                else:
                    self._retained.pop(topic, None)  # empty retained = clear
            def is_live(cid: str) -> bool:
                s = self._sessions.get(cid)
                return s is not None and s.pending is None

            for cid, granted in self._tree.receivers(topic, is_live=is_live):
                eff = min(qos, granted)
                sess = self._sessions.get(cid)
                if sess is None:
                    entry = self._offline.get(cid)
                    if entry is not None and eff >= 1:
                        entry[0].append((topic, payload, eff, False))
                        self._note_queue_depth(cid, len(entry[0]))
                        queued += 1
                    continue
                if sess.pending is not None:
                    # reconnect in progress: keep order behind the queued
                    # backlog instead of jumping ahead of it (same bound as
                    # the offline queue: drop-oldest)
                    sess.pending.append((topic, payload, eff, False))
                    self._note_queue_depth(cid, len(sess.pending))
                    if len(sess.pending) > self.offline_queue_limit:
                        del sess.pending[0]
                    else:
                        queued += 1
                    continue
                live.append((sess, eff))
        for sess, eff in live:  # outside the lock: a slow socket blocks
            # chaos faultpoint: a "drop" models the flapping device link
            # (the publish happened, the delivery is lost — ledgered as
            # intentional loss), a "dup" the QoS-1 retry duplicate the
            # at-least-once contract must absorb; delays apply inline
            act = chaos.point("mqtt.deliver")
            if act is not None and act.kind == "drop":
                continue
            sess.deliver(topic, payload, eff, False)  # only its publisher
            delivered += 1
            if act is not None and act.kind == "dup":
                sess.deliver(topic, payload, eff, False)
                delivered += 1
        for w in due_wills:  # due delayed wills, also outside the lock
            self.publish(*w)
        if delivered:
            self._m_out.inc(delivered)
        if queued:
            self._m_queued.inc(queued)
        if not delivered and not queued:
            self._m_dropped.inc()
        return delivered

    def retained(self) -> Dict[str, bytes]:
        return {t: p for t, (p, _q) in self._retained.items()}


class QueueClient:
    """In-process client: collects deliveries into a list (tests, sinks)."""

    def __init__(self, broker: MqttBroker, client_id: str,
                 clean_start: bool = True):
        self.broker = broker
        self.client_id = client_id
        self.messages: List[Tuple[str, bytes, int, bool]] = []
        self._lock = threading.Lock()
        self._session = broker.connect(client_id, self._deliver, clean_start)
        broker.deliver_pending(self._session)  # in-process: ready at once

    def _deliver(self, topic: str, payload: bytes, qos: int, retain: bool):
        with self._lock:
            self.messages.append((topic, payload, qos, retain))

    def subscribe(self, filter_: str, qos: int = 0) -> int:
        return self.broker.subscribe(self.client_id, filter_, qos)

    def publish(self, topic: str, payload: bytes, qos: int = 0,
                retain: bool = False) -> int:
        return self.broker.publish(topic, payload, qos, retain)

    def disconnect(self):
        self.broker.disconnect(self.client_id, self._session)
