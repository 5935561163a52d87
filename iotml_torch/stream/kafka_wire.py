"""Kafka wire protocol: TCP client and server (``iotml.stream.kafka_wire``'s
classic subset).

The reference's data plane is the Kafka protocol: its jobs consume
``kafka:9071`` with SASL/PLAIN (reference cardata-v3.py:7-15,46-47) and
produce predictions back to it, and the deploy manifests start the CLIs
with ``<servers>`` = ``host:port``.  This module speaks the subset those
paths need:

- ``KafkaWireBroker``: a client with the port's ``Broker`` duck-type
  (produce / fetch / end_offset / commit / ...), so ``StreamConsumer``,
  ``GroupConsumer``, ``SensorBatches``, ``OutputSequence`` and both CLIs
  run unchanged against a server; ``RemoteGroupCoordinator`` gives
  ``GroupConsumer`` a group whose membership lives server-side.
- ``KafkaWireServer``: a threaded TCP front for the port's in-memory
  ``Broker`` speaking the same protocol, so the client (and any classic
  Kafka client) runs end to end without a cluster.

Protocol (big-endian, classic encoding, no flexible fields): request
header v1 (api_key, api_version, correlation_id, client_id); MessageSet
v1 entries (magic 1, CRC-32 over magic..value) in Produce v2 / Fetch v2;
Metadata v1; ListOffsets v1; OffsetCommit v2 / OffsetFetch v1;
FindCoordinator, JoinGroup, SyncGroup, Heartbeat and LeaveGroup v0;
CreateTopics v0; ApiVersions v0; SaslHandshake v0 + the raw PLAIN token
frame (the pre-KIP-152 exchange the reference's SASL_PLAIN config uses).

Message sets are encoded and decoded by the native engine
(``native.msgset_encode`` / ``msgset_decode``); ``_encode_message_set_py``
and ``_decode_message_set_py`` are their plain versions, run only by name,
except that sets under 26 bytes (no whole v1 entry fits) go to the pure
decoder.  There is no fallback: a set the engine refuses raises the pure
decoder's own error, and raises all the same when the pure decoder would
have accepted it.

The JAX package's raw columnar extensions are ported: RAW_FETCH (API key
64) answers one partition's store frames as they are (a durable broker's
segment bytes, ``Broker.fetch_raw``) for the consumer's columnar decoder,
and RAW_PRODUCE (65) lands a pre-framed batch (``Broker.produce_raw``;
a corrupt batch answers CORRUPT_MESSAGE with nothing appended).  The
client's ``fetch_raw`` / ``produce_raw`` raise NotImplementedError
against a server without them, which answers UNSUPPORTED_VERSION; the
consumer and ``RawBatchProducer`` then pin back to FETCH and PRODUCE.
RAW_PRODUCE is not idempotent (never auto-retried), RAW_FETCH is.

Leader-epoch fencing: a client built with
``epoch=`` or ``topology=`` stamps its epoch on the header's client id
(``@e<N>``), and the server answers a produce or commit whose stamped
epoch differs from its own with FENCED_LEADER_EPOCH (74) before the
broker is touched (unstamped clients pass unfenced); the client then
re-resolves its topology and raises ``FencedEpochError``.  The replica
leg: FETCH and RAW_FETCH carry a replica id, and a fetch with one >= 0
reaches ``broker.replication.observe_fetch`` and is served past the
quorum high-water mark, which bounds every consumer's fetch.  Quorum
acks: ``acks=-1`` on PRODUCE and RAW_PRODUCE against a broker with
replication waits in ``wait_replicated`` until the batch is below the
quorum HWM; an ISR below ``min_isr`` answers NOT_ENOUGH_REPLICAS (19)
with nothing appended, a quorum that does not catch up in time
REQUEST_TIMED_OUT (7) with the batch appended but unacked, a quorum HWM
that reaches the batch only after the ISR fell below ``min_isr``
NOT_ENOUGH_REPLICAS_AFTER_APPEND (20), appended but unacked (a deviation:
``iotml.stream.kafka_wire``'s server acks that batch, held by fewer than
``min_isr`` replicas), and invalid acks INVALID_REQUIRED_ACKS (21).

The cluster half (``iotml_torch.cluster``): a server given a ``cluster``
view answers METADATA with the whole cluster's brokers and each
partition's owning node, FIND_COORDINATOR with the pinned coordinator,
and every group and offset API with NOT_COORDINATOR (16) unless it is
that coordinator; a sharded broker's unowned partition answers
NOT_LEADER_FOR_PARTITION (6) on every produce, fetch and list-offsets
path, and a ``retiring`` server (leadership moved off it) answers 6 to
every PRODUCE and RAW_PRODUCE.  CLUSTER_ADMIN (66) carries the
``add-broker`` / ``drain-broker`` / ``status`` verbs to the server's
``admin`` hook (the controller); a server without one answers
UNSUPPORTED_VERSION.  The client raises ``NotLeaderForPartitionError``
and ``CoordinatorMovedError`` typed, and offers ``cluster_metadata``,
``find_coordinator`` and ``cluster_admin``.

The client passes the chaos points ``kafka_wire.send``
(``error``, ``delay``, ``short_write``: half a frame, then OSError) and
``kafka_wire.recv`` on every frame.  Records carry no headers on the
wire; under tracing the server marks the trace that a fetched batch's
first traced record carries in the in-process broker (a fork of it,
stage ``wire_fetch``, with the batch's offset range), the hop through
this server on the span log.
"""

from __future__ import annotations

import re
import socket
import socketserver
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from ..chaos import faults as chaos
from ..obs import tracing
from ..utils.net import parse_bootstrap, recv_exact
from . import native
from .broker import (Broker, CorruptMessageError, Message,
                     OffsetOutOfRangeError, TopicSpec)

# api keys
PRODUCE, FETCH, LIST_OFFSETS, METADATA = 0, 1, 2, 3
OFFSET_COMMIT, OFFSET_FETCH = 8, 9
FIND_COORDINATOR, JOIN_GROUP, HEARTBEAT, LEAVE_GROUP, SYNC_GROUP = \
    10, 11, 12, 13, 14
SASL_HANDSHAKE, API_VERSIONS, CREATE_TOPICS = 17, 18, 19
#: the JAX package's extensions, keys far outside Kafka's range: a fetch
#: answered with the broker's raw store frames (one buffer for the
#: consumer's columnar decoder), and its write-path mirror, a produce of
#: pre-framed frames the broker appends as they are.  Kafka's servers
#: answer UNSUPPORTED_VERSION and the clients pin back to FETCH/PRODUCE.
RAW_FETCH = 64
RAW_PRODUCE = 65
#: the cluster's admin extension: the elastic reassignment verbs
#: (``python -m iotml_torch.cluster add-broker / drain-broker / status``)
#: reach the controller through any broker's wire port; a server with no
#: ``admin`` hook answers UNSUPPORTED_VERSION
CLUSTER_ADMIN = 66

# error codes
ERR_NONE = 0
ERR_OFFSET_OUT_OF_RANGE = 1
ERR_CORRUPT_MESSAGE = 2
ERR_UNKNOWN_TOPIC = 3
ERR_NOT_LEADER_FOR_PARTITION = 6
ERR_REQUEST_TIMED_OUT = 7
ERR_NOT_COORDINATOR = 16
ERR_NOT_ENOUGH_REPLICAS = 19
ERR_NOT_ENOUGH_REPLICAS_AFTER_APPEND = 20
ERR_INVALID_REQUIRED_ACKS = 21
ERR_ILLEGAL_GENERATION = 22
ERR_UNKNOWN_MEMBER_ID = 25
ERR_REBALANCE_IN_PROGRESS = 27
ERR_TOPIC_AUTHORIZATION_FAILED = 29
ERR_UNSUPPORTED_VERSION = 35
ERR_TOPIC_EXISTS = 36
ERR_INVALID_CONFIG = 40
ERR_SASL_AUTH_FAILED = 58
ERR_FENCED_LEADER_EPOCH = 74  # Kafka's own fencing error code
#: Kafka's UNKNOWN_SERVER_ERROR: a CLUSTER_ADMIN verb that raised in the
#: controller (the response body carries its error text)
ERR_UNKNOWN_SERVER = -1

_SUPPORTED = {PRODUCE: (2, 2), FETCH: (2, 2), LIST_OFFSETS: (1, 1),
              METADATA: (1, 1), OFFSET_COMMIT: (2, 2), OFFSET_FETCH: (1, 1),
              FIND_COORDINATOR: (0, 0), JOIN_GROUP: (0, 0),
              HEARTBEAT: (0, 0), LEAVE_GROUP: (0, 0), SYNC_GROUP: (0, 0),
              SASL_HANDSHAKE: (0, 0), API_VERSIONS: (0, 0),
              CREATE_TOPICS: (0, 0), RAW_FETCH: (0, 0),
              RAW_PRODUCE: (0, 0), CLUSTER_ADMIN: (0, 0)}

# APIs the client may retry after a reconnect (see _request): a duplicate
# of any of these is invisible (a read) or a no-op (a liveness signal).
# Everything else (produce, offset commit, topic creation, membership
# changes) may have been APPLIED by the dead server before it died, so a
# blind retry would apply it twice; those raise ConnectionError and the
# caller owns redelivery.
IDEMPOTENT_APIS = frozenset({FETCH, RAW_FETCH, METADATA, LIST_OFFSETS,
                             OFFSET_FETCH, API_VERSIONS, SASL_HANDSHAKE,
                             HEARTBEAT, FIND_COORDINATOR})

#: a fetch answers at most this many records a partition, then cuts the
#: set at the request's max_bytes (possibly mid-entry)
FETCH_MAX_RECORDS = 4096
#: the client's max_bytes a partition in each fetch
FETCH_MAX_BYTES = 4 << 20


class SaslAuthError(ConnectionError):
    """The server explicitly REJECTED the credentials (handshake error or
    a non-empty auth response), as opposed to dying mid-handshake.
    Failover does not retry rejected credentials against the other
    bootstrap servers; connectivity errors it does."""


class NotLeaderForPartitionError(ConnectionError):
    """Kafka error 6: the addressed broker does not lead this (topic,
    partition): the cluster's partition map moved (a shard failover,
    stale client metadata) or the broker is a shard that never owned it.
    Nothing was applied there; ``cluster.ClusterClient`` refreshes its
    metadata and re-routes.  A ConnectionError, so a non-routing
    caller's redelivery loop treats it as the failover signal it is."""

    def __init__(self, topic: str, partition: int):
        super().__init__(
            f"broker is not the leader for {topic}:{partition}; refresh "
            f"metadata and route to the owning broker (Kafka error 6)")
        self.topic = topic
        self.partition = partition


class CoordinatorMovedError(ConnectionError):
    """Kafka error 16 (NOT_COORDINATOR): a group or offset request
    reached a broker that is not the group coordinator.  Nothing was
    applied; the caller re-discovers the coordinator (FIND_COORDINATOR)
    and retries: a cluster pins group state to exactly one broker."""


class NotEnoughReplicasError(ConnectionError):
    """An ``acks=all`` produce was refused because the in-sync-replica
    set is below ``min_isr``, or the topic has no ISR configured on a
    broker that opted into quorum (Kafka error 19).  Nothing was
    appended, so redelivery is safe; a ConnectionError because the
    condition passes (an evicted follower re-admits)."""


class ProduceTimedOutError(ConnectionError):
    """An ``acks=all`` produce was appended on the leader but the quorum
    high-water mark did not reach it within the request timeout (Kafka
    error 7).  The record is on the leader yet unacked: the caller
    redelivers (at-least-once); consumers cannot have read it, it sits
    above the quorum HWM."""


class NotEnoughReplicasAfterAppendError(ProduceTimedOutError):
    """An ``acks=all`` produce was appended and the quorum high-water
    mark reached it, but only after the ISR had shrunk below
    ``min_isr`` (Kafka error 20): fewer replicas than the guarantee
    names hold it, so it is unacked and the caller redelivers
    (at-least-once), as after a timeout."""


class FencedEpochError(ConnectionError):
    """A produce or commit was refused because the leadership epochs
    disagree: this client slept through a failover (its epoch is stale)
    or it reached a resurrected old leader (the server's is).  Either
    way the log must not split.  The client has re-resolved its topology
    before raising, so the caller's redelivery reaches the real leader."""


# The fencing epoch rides the request header's client id as a trailing
# `@e<N>` tag: the one header field the classic encoding lets us extend
# without a new wire type, so standard clients (no tag: unfenced) stay
# byte-compatible with the server.
_EPOCH_TAG_RE = re.compile(r"^(.*)@e(\d+)$")


def tag_client_id(client_id: str, epoch: Optional[int]) -> str:
    return client_id if epoch is None else f"{client_id}@e{int(epoch)}"


def parse_client_epoch(client_id: Optional[str]) -> Tuple[str, Optional[int]]:
    """(bare client id, stamped epoch or None) from a header client_id."""
    if not client_id:
        return client_id or "", None
    m = _EPOCH_TAG_RE.match(client_id)
    if m is None:
        return client_id, None
    return m.group(1), int(m.group(2))


# ------------------------------------------------------------- primitives
class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def i8(self, v):  self.buf += struct.pack(">b", v); return self
    def i16(self, v): self.buf += struct.pack(">h", v); return self
    def i32(self, v): self.buf += struct.pack(">i", v); return self
    def i64(self, v): self.buf += struct.pack(">q", v); return self
    def u32(self, v): self.buf += struct.pack(">I", v); return self

    def string(self, s: Optional[str]):
        if s is None:
            return self.i16(-1)
        b = s.encode()
        self.i16(len(b))
        self.buf += b
        return self

    def bytes_(self, b: Optional[bytes]):
        if b is None:
            return self.i32(-1)
        self.i32(len(b))
        self.buf += b
        return self

    def array(self, items, fn):
        self.i32(len(items))
        for it in items:
            fn(self, it)
        return self


class _Reader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _unpack(self, fmt, size):
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return v

    def i8(self):  return self._unpack(">b", 1)
    def i16(self): return self._unpack(">h", 2)
    def i32(self): return self._unpack(">i", 4)
    def i64(self): return self._unpack(">q", 8)
    def u32(self): return self._unpack(">I", 4)

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        s = self.buf[self.pos:self.pos + n].decode()
        self.pos += n
        return s

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def array(self, fn) -> list:
        n = self.i32()
        return [fn(self) for _ in range(max(n, 0))]


# ---------------------------------------------------------- message sets
Entry = Tuple[int, Optional[bytes], Optional[bytes], int]
#: crc, magic, attributes and the key and value lengths (a v0 entry)
_MIN_ENTRY_BODY = 14


def _encode_message_set_py(entries: List[Entry]) -> bytes:
    """The plain version of ``encode_message_set``."""
    out = _Writer()
    for offset, key, value, ts in entries:
        body = _Writer()
        body.i8(1).i8(0).i64(ts)          # magic 1, attributes 0, timestamp
        body.bytes_(key).bytes_(value)
        msg = struct.pack(">I", zlib.crc32(bytes(body.buf))) + bytes(body.buf)
        out.i64(offset).i32(len(msg))
        out.buf += msg
    return bytes(out.buf)


def _decode_message_set_py(buf: bytes) -> List[Entry]:
    """The plain version of ``decode_message_set``."""
    out = []
    r = _Reader(buf)
    while r.pos + 12 <= len(buf):
        offset = r.i64()
        size = r.i32()
        if size < _MIN_ENTRY_BODY:
            # the reads below would run past the entry's end
            raise ValueError(f"message size {size} under the smallest "
                             f"entry body at offset {offset}")
        if r.pos + size > len(buf):
            break  # partial trailing message
        end = r.pos + size
        crc = r.u32()
        if zlib.crc32(buf[r.pos:end]) != crc:
            raise ValueError(f"message CRC mismatch at offset {offset}")
        magic = r.i8()
        r.i8()  # attributes (no compression support needed)
        ts = r.i64() if magic >= 1 else 0
        key = r.bytes_()
        value = r.bytes_()
        r.pos = end
        out.append((offset, key, value, ts))
    return out


def encode_message_set(entries: List[Entry]) -> bytes:
    """[(offset, key, value, timestamp_ms)] → MessageSet v1 bytes, by the
    native engine."""
    return native.msgset_encode(entries)


def decode_message_set(buf: bytes) -> List[Entry]:
    """MessageSet v1 bytes → [(offset, key, value, timestamp_ms)], by the
    native engine.  A truncated trailing entry (Kafka allows partial
    final messages in fetch responses) is dropped; a CRC mismatch raises
    ``ValueError("message CRC mismatch at offset N")``, and an entry whose
    size field is under the 14-byte smallest body raises ValueError."""
    if len(buf) < 26:  # no whole v1 entry fits: the plain decoder's job
        return _decode_message_set_py(buf)
    try:
        return native.msgset_decode(buf)
    except ValueError as refused:
        # the engine gives a code, the plain decoder the error text the
        # wire contract pins: raise that one
        _decode_message_set_py(buf)
        raise ValueError("the native and pure message-set decoders "
                         "disagree: the engine refused a set the pure "
                         "decoder accepts") from refused


def _req_header(api_key: int, api_version: int, corr: int,
                client_id: str) -> bytes:
    w = _Writer()
    w.i16(api_key).i16(api_version).i32(corr).string(client_id)
    return bytes(w.buf)


# ------------------------------------------------------------------ client
class ProducePartitionMixin:
    """Client-side keyed partitioner + produce conveniences.  Keyed
    records land on ``crc32(key) % n`` and unkeyed ones round-robin, as
    the JAX package's clients land them (per-key ordering is a
    cross-client invariant).  Subclasses provide
    `_partition_count_or_default(topic)` and `produce_many`, plus the
    `_rr` round-robin state dict.
    """

    def _partition_for(self, topic: str, key: Optional[bytes]) -> int:
        n = self._partition_count_or_default(topic)
        if key is None:
            self._rr[topic] = (self._rr.get(topic, -1) + 1) % n
            return self._rr[topic]
        return zlib.crc32(key) % n

    def produce(self, topic: str, value: bytes, key: Optional[bytes] = None,
                partition: Optional[int] = None, timestamp_ms: int = 0,
                headers: Optional[tuple] = None) -> int:
        # headers accepted for Broker duck-type parity and dropped: the
        # wire protocol (MessageSet v1) has no header slot
        return self.produce_many(topic, [(key, value, timestamp_ms)],
                                 partition=partition)

    def produce_batch(self, topic: str, values, key=None,
                      partition=None) -> int:
        return self.produce_many(topic, [(key, v, 0) for v in values],
                                 partition=partition)


class KafkaWireBroker(ProducePartitionMixin):
    """Kafka-protocol client with the port's ``Broker`` duck-type.

    One socket, one lock: requests are serialized.  Partition counts are
    cached for the client-side partitioner and refreshed on topic misses.
    ``servers`` is a bootstrap list, tried in order; the first that
    answers (and accepts the SASL/PLAIN credentials, when given) wins,
    and a request that finds its socket dead reconnects down the list
    (see ``_request``).

    ``topology`` (a ``supervise.Topology``): every (re)connect resolves
    the active leader and epoch from it instead of the static list, and
    the epoch is stamped on each request (``epoch`` stamps a fixed one).
    ``acks`` is the default required acks of the produce paths (-1:
    the quorum where the topic is replicated, the leader append
    otherwise).  ``replica_id`` >= 0 makes this client a follower's
    mirror leg: FETCH and RAW_FETCH carry the id, the leader tracks the
    fetch position in its ISR and serves past the quorum HWM.
    """

    def __init__(self, servers: str, client_id: str = "iotml",
                 sasl_username: Optional[str] = None,
                 sasl_password: Optional[str] = None,
                 timeout_s: float = 30.0, topology=None,
                 epoch: Optional[int] = None,
                 acks: Optional[int] = None,
                 replica_id: int = -1):
        self.client_id = client_id
        self._acks = -1 if acks is None else int(acks)
        self._replica_id = int(replica_id)
        self._lock = threading.Lock()
        self._corr = 0
        self._servers = parse_bootstrap(servers)
        self._servers_repr = servers
        self._timeout_s = timeout_s
        self._sasl_creds = ((sasl_username, sasl_password or "")
                            if sasl_username is not None else None)
        self._topology = topology
        self._epoch = epoch
        self._sock: Optional[socket.socket] = None
        self._connect_any()  # resolves the topology first
        self._meta: Dict[str, int] = {}  # topic → partition count
        self._rr: Dict[str, int] = {}
        # high-water marks off every fetch response: consumer lag at no
        # extra round trip (last_hwm)
        self._hwm: Dict[tuple, int] = {}

    # ------------------------------------------------------ epoch fencing
    @property
    def epoch(self) -> Optional[int]:
        return self._epoch

    def set_epoch(self, epoch: Optional[int]) -> None:
        """Stamp ``epoch`` on later requests (None: unfenced)."""
        self._epoch = epoch

    def set_replica_id(self, replica_id: int) -> None:
        """Make this client a replica's mirror leg: later FETCH and
        RAW_FETCH requests carry ``replica_id``."""
        self._replica_id = int(replica_id)

    def _refresh_topology(self) -> None:
        """Re-resolve (servers, epoch) from the published topology.
        Caller holds the lock (or is __init__)."""
        if self._topology is None:
            return
        servers, epoch = self._topology.resolve()
        self._servers_repr = ",".join(servers)
        self._servers = parse_bootstrap(self._servers_repr)
        self._epoch = epoch

    def _fenced(self, what: str) -> FencedEpochError:
        """The fence error, built AFTER re-resolving the topology and
        reconnecting, so the caller's redelivery talks to the real
        leader at the current epoch instead of failing the same way
        forever."""
        stale = self._epoch
        with self._lock:
            try:
                self._connect_any()  # re-resolves the topology first
            except OSError:
                pass  # nobody reachable now: the next request retries
        return FencedEpochError(
            f"{what} fenced: leadership epoch mismatch (client was at "
            f"epoch {stale}, now {self._epoch}); topology re-resolved — "
            f"the caller owns redelivery")

    # ---------------------------------------------------------- transport
    def _connect_any(self) -> None:
        """Connect to the first reachable bootstrap server (+ SASL).
        Caller holds the lock (or is __init__).  A client with a
        topology re-reads it first, so after a promotion the first
        server tried is the new leader.

        An explicit SASL rejection raises at once (the credentials are
        wrong everywhere); a server dying mid-handshake is connectivity
        and falls through to the next server.  Either way the socket is
        closed, never leaked."""
        self._refresh_topology()
        last_err: Optional[Exception] = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        for host, port in self._servers:
            try:
                sock = socket.create_connection((host, port),
                                                timeout=self._timeout_s)
            except OSError as e:
                last_err = e
                continue
            try:
                self._sock = sock
                if self._sasl_creds is not None:
                    self._sasl_plain_raw(*self._sasl_creds)
                return
            except SaslAuthError:
                self._sock = None
                sock.close()
                raise
            except OSError as e:
                last_err = e
                self._sock = None
                sock.close()
        raise last_err or \
            OSError(f"no reachable broker in {self._servers_repr!r}")

    def _send_frame(self, payload: bytes) -> None:
        act = chaos.point("kafka_wire.send")
        data = struct.pack(">i", len(payload)) + payload
        if act is not None and act.kind == "short_write":
            # a torn frame: the server drops the connection, this
            # client fails over
            self._sock.sendall(data[: len(data) // 2])
            raise OSError("chaos[kafka_wire.send]: short write")
        self._sock.sendall(data)

    def _recv_frame(self) -> bytes:
        chaos.point("kafka_wire.recv")
        (size,) = struct.unpack(
            ">i", recv_exact(self._sock, 4, "broker closed connection"))
        return recv_exact(self._sock, size, "broker closed connection")

    def _exchange(self, api_key: int, api_version: int,
                  body: bytes) -> tuple:
        """One request/response on the current socket; caller holds the
        lock.  Returns (corr, resp bytes)."""
        self._corr += 1
        corr = self._corr
        self._send_frame(_req_header(
            api_key, api_version, corr,
            tag_client_id(self.client_id, self._epoch)) + body)
        return corr, self._recv_frame()

    def _request(self, api_key: int, api_version: int, body: bytes) -> _Reader:
        # every socket op is bounded by timeout_s, so a stalled broker
        # parks callers for at most that
        with self._lock:
            try:
                if self._sock is None:
                    # an earlier reconnect found nobody: try again now
                    self._connect_any()
                corr, resp = self._exchange(api_key, api_version, body)
            except OSError as e:
                # dead server: fail over down the bootstrap list, then
                # retry ONCE, and only IDEMPOTENT_APIS: the dead server
                # may have applied anything else before dying
                self._connect_any()
                if api_key not in IDEMPOTENT_APIS:
                    raise ConnectionError(
                        f"connection lost during non-idempotent request "
                        f"(api_key={api_key}); not auto-retried — the dead "
                        f"server may have applied it.  Reconnected; the "
                        f"caller decides whether to redeliver.") from e
                corr, resp = self._exchange(api_key, api_version, body)
        r = _Reader(resp)
        got = r.i32()
        if got != corr:
            raise ConnectionError(f"correlation id mismatch: {got} != {corr}")
        return r

    def _sasl_plain_raw(self, username: str, password: str) -> None:
        """SASL PLAIN on the current socket, no locking (``_connect_any``
        runs under the lock or from __init__)."""
        w = _Writer()
        w.string("PLAIN")
        corr, resp = self._exchange(SASL_HANDSHAKE, 0, bytes(w.buf))
        r = _Reader(resp)
        if r.i32() != corr:
            raise ConnectionError("correlation id mismatch in handshake")
        err = r.i16()
        mechanisms = r.array(lambda rd: rd.string())
        if err != ERR_NONE:
            raise SaslAuthError(
                f"SASL handshake failed ({err}); server offers {mechanisms}")
        token = b"\x00" + username.encode() + b"\x00" + password.encode()
        self._send_frame(token)   # raw token frame (pre-KIP-152)
        if self._recv_frame() != b"":
            raise SaslAuthError("SASL PLAIN authentication failed")

    # ------------------------------------------------------------ metadata
    def _metadata(self, topics: Optional[List[str]] = None) -> Dict[str, int]:
        """{topic: partitions} of the known topics among ``topics`` (all
        topics when None); unknown topics are simply absent."""
        return self.cluster_metadata(topics)["topics"]

    def cluster_metadata(self, topics: Optional[List[str]] = None) -> dict:
        """The raw Metadata answer: {"brokers": [(node, host, port,
        rack)], "topics": {name: partitions}, "leaders": {(topic,
        partition): node}}, what ``cluster.ClusterClient`` caches and
        refreshes on NOT_LEADER_FOR_PARTITION (a single-broker server
        names node 0 everywhere)."""
        w = _Writer()
        if topics is None:
            w.i32(-1)
        else:
            w.array(topics, lambda wr, t: wr.string(t))
        r = self._request(METADATA, 1, bytes(w.buf))

        def partition(rd):
            err, pid, leader = rd.i16(), rd.i32(), rd.i32()
            rd.array(lambda x: x.i32())  # replicas
            rd.array(lambda x: x.i32())  # isr
            return (err, pid, leader)

        def topic(rd):
            err = rd.i16()
            name = rd.string()
            rd.i8()  # is_internal
            return (err, name, rd.array(partition))

        brokers = r.array(lambda rd: (rd.i32(), rd.string(), rd.i32(),
                                      rd.string()))
        r.i32()  # controller id
        meta = {"brokers": brokers, "topics": {}, "leaders": {}}
        for err, name, parts in r.array(topic):
            if err == ERR_NONE:
                meta["topics"][name] = len(parts)
                self._meta[name] = len(parts)
                for perr, pid, leader in parts:
                    if perr == ERR_NONE:
                        meta["leaders"][(name, pid)] = leader
        return meta

    def find_coordinator(self, group: str) -> Tuple[int, str, int]:
        """(node_id, host, port) of the group coordinator: in a cluster
        the one broker holding every group's membership and offsets."""
        w = _Writer()
        w.string(group)
        r = self._request(FIND_COORDINATOR, 0, bytes(w.buf))
        err = r.i16()
        node, host, port = r.i32(), r.string(), r.i32()
        if err != ERR_NONE:
            raise RuntimeError(f"find_coordinator({group}): error {err}")
        return node, host or "", port

    def topics(self) -> List[str]:
        return sorted(self._metadata())

    def topic(self, name: str) -> TopicSpec:
        """The topic's partition count (cached after the first lookup);
        KeyError if the server does not know it."""
        n = self._meta.get(name) or self._metadata([name]).get(name)
        if n is None:
            raise KeyError(name)
        return TopicSpec(name, n)

    def create_topic(self, name: str, partitions: int = 1,
                     retention_messages: Optional[int] = None,
                     retention_bytes: Optional[int] = None,
                     retention_ms: Optional[int] = None,
                     cleanup_policy: Optional[str] = None) -> TopicSpec:
        """CreateTopics; an existing topic is returned as the server has
        it.  Retention and cleanup.policy ride CreateTopics v0's config
        entries (retention.messages is the emulator family's own)."""
        w = _Writer()
        cfgs = [(k, str(v)) for k, v in
                (("retention.messages", retention_messages),
                 ("retention.bytes", retention_bytes),
                 ("retention.ms", retention_ms),
                 ("cleanup.policy", cleanup_policy)) if v is not None]

        def one(wr, _):
            wr.string(name).i32(partitions).i16(1)
            wr.i32(0)  # replica assignment: none
            wr.array(cfgs, lambda cw, kv: cw.string(kv[0]).string(kv[1]))

        w.array([None], one)
        w.i32(10_000)  # timeout ms
        # not retried: a lost CreateTopics raises ConnectionError, and
        # re-issuing it is safe (TOPIC_EXISTS is handled below)
        r = self._request(CREATE_TOPICS, 0, bytes(w.buf))
        existed = False
        for _, err in r.array(lambda rd: (rd.string(), rd.i16())):
            if err == ERR_TOPIC_EXISTS:
                existed = True
            elif err == ERR_INVALID_CONFIG:
                raise ValueError(
                    f"create_topic({name}): broker rejected the config "
                    f"(negative retention?)")
            elif err != ERR_NONE:
                raise RuntimeError(f"create_topic({name}) failed: error {err}")
        if existed:
            # the real partition count may differ from the request
            self._meta.pop(name, None)
            return self.topic(name)
        self._meta[name] = partitions
        return TopicSpec(name, partitions)

    # ------------------------------------------------------------- produce
    def _partition_count_or_default(self, topic: str) -> int:
        n = self._meta.get(topic)
        if n is None:
            n = self._metadata([topic]).get(topic, 1)
        return n

    def produce_many(self, topic: str, entries,
                     partition: Optional[int] = None,
                     acks: Optional[int] = None,
                     timeout_ms: int = 10_000) -> int:
        """entries: [(key, value, timestamp_ms[, headers])] → offset of the
        last one, in ONE Produce request.  Record headers are dropped:
        MessageSet v1 has no header slot.

        ``acks`` (default: the client's, -1): -1 acks at the quorum
        high-water mark on replicated topics (the leader append
        otherwise), 1 at the leader append, 0 answers at once with no
        delivery guarantee.  A quorum that cannot form raises
        ``NotEnoughReplicasError`` (nothing appended); one that does not
        catch up within ``timeout_ms`` raises ``ProduceTimedOutError``
        (appended, unacked: redeliver), and one reached only after the
        ISR fell below ``min_isr`` its subclass
        ``NotEnoughReplicasAfterAppendError``."""
        by_part: Dict[int, list] = {}
        for key, value, ts, *_hdrs in entries:
            p = self._partition_for(topic, key) if partition is None \
                else partition
            by_part.setdefault(p, []).append((0, key, value, ts))
        w = _Writer()
        w.i16(self._acks if acks is None else int(acks))
        w.i32(int(timeout_ms))

        def part_entry(wr, item):
            p, ents = item
            wr.i32(p).bytes_(encode_message_set(ents))

        w.array([None], lambda wr, _: wr.string(topic).array(
            sorted(by_part.items()), part_entry))
        # not retried (a double append); ConnectionError reaches the
        # producer, which owns redelivery
        r = self._request(PRODUCE, 2, bytes(w.buf))

        def part_resp(rd):
            p, err, base = rd.i32(), rd.i16(), rd.i64()
            rd.i64()  # log append time
            return (p, err, base)

        last = -1
        for _, parts in r.array(lambda rd: (rd.string(),
                                            rd.array(part_resp))):
            for p, err, base in parts:
                if err == ERR_FENCED_LEADER_EPOCH:
                    # a stale party (this client or a resurrected old
                    # leader): nothing appended; re-resolve, hand the
                    # redelivery back
                    raise self._fenced(f"produce to {topic}:{p}")
                if err == ERR_NOT_LEADER_FOR_PARTITION:
                    raise NotLeaderForPartitionError(topic, p)
                if err == ERR_NOT_ENOUGH_REPLICAS:
                    raise NotEnoughReplicasError(
                        f"produce to {topic}:{p} refused: ISR below "
                        f"min_isr (or no ISR configured for acks=all); "
                        f"nothing appended — redeliver when the quorum "
                        f"re-forms")
                if err == ERR_REQUEST_TIMED_OUT:
                    raise ProduceTimedOutError(
                        f"produce to {topic}:{p} appended but the "
                        f"quorum HWM did not reach it in time; unacked "
                        f"— the caller redelivers (at-least-once)")
                if err == ERR_NOT_ENOUGH_REPLICAS_AFTER_APPEND:
                    raise NotEnoughReplicasAfterAppendError(
                        f"produce to {topic}:{p} appended but the ISR "
                        f"fell below min_isr before the quorum HWM "
                        f"reached it; unacked — the caller redelivers")
                if err == ERR_INVALID_REQUIRED_ACKS:
                    raise ValueError(
                        f"produce to {topic}:{p} refused: required_acks "
                        f"must be -1, 0 or 1; nothing appended")
                if err == ERR_UNKNOWN_TOPIC:
                    raise KeyError(topic)
                if err == ERR_TOPIC_AUTHORIZATION_FAILED:
                    raise PermissionError(
                        f"produce to {topic}:{p} refused: the topic is "
                        f"restricted to its owning engine "
                        f"(Broker.restrict_topic); nothing appended")
                if err != ERR_NONE:
                    raise RuntimeError(f"produce to {topic}:{p} failed: {err}")
                last = max(last, base + len(by_part[p]) - 1)
        return last

    def produce_raw(self, topic: str, partition: int, frames: bytes,
                    acks: Optional[int] = None,
                    timeout_ms: int = 10_000) -> int:
        """RAW_PRODUCE: ship a pre-framed batch the broker validates whole,
        stamps and appends as it is; returns the batch's base offset.
        Raises NotImplementedError against a server without the
        extension (pin back to PRODUCE), ``CorruptMessageError`` when the
        server rejected the batch (nothing appended), the quorum errors
        of ``produce_many`` under ``acks`` -1, and ConnectionError on a
        lost connection: never auto-retried, the caller owns
        redelivery, as with ``produce_many``."""
        w = _Writer()
        w.string(topic).i32(partition).bytes_(frames)
        # the trailing acks and timeout (a server without them stops at
        # the frames, and absent ones mean -1)
        w.i16(self._acks if acks is None else int(acks))
        w.i32(int(timeout_ms))
        r = self._request(RAW_PRODUCE, 0, bytes(w.buf))
        err = r.i16()
        if err == ERR_UNSUPPORTED_VERSION:
            raise NotImplementedError(
                "server lacks the RAW_PRODUCE extension")
        base = r.i64()
        r.i32()  # frames appended
        if err == ERR_CORRUPT_MESSAGE:
            raise CorruptMessageError(topic, partition, int(base))
        if err == ERR_FENCED_LEADER_EPOCH:
            raise self._fenced(f"raw produce to {topic}:{partition}")
        if err == ERR_NOT_LEADER_FOR_PARTITION:
            raise NotLeaderForPartitionError(topic, partition)
        if err == ERR_NOT_ENOUGH_REPLICAS:
            raise NotEnoughReplicasError(
                f"raw produce to {topic}:{partition} refused: ISR "
                f"below min_isr; nothing appended — redeliver when the "
                f"quorum re-forms")
        if err == ERR_REQUEST_TIMED_OUT:
            raise ProduceTimedOutError(
                f"raw produce to {topic}:{partition} appended but "
                f"unacked within the timeout — the caller redelivers")
        if err == ERR_NOT_ENOUGH_REPLICAS_AFTER_APPEND:
            raise NotEnoughReplicasAfterAppendError(
                f"raw produce to {topic}:{partition} appended but the "
                f"ISR fell below min_isr before the quorum HWM reached "
                f"it — the caller redelivers")
        if err == ERR_INVALID_REQUIRED_ACKS:
            raise ValueError(f"raw produce to {topic}:{partition} refused: "
                             f"required_acks must be -1, 0 or 1; nothing "
                             f"appended")
        if err == ERR_UNKNOWN_TOPIC:
            raise KeyError(topic)
        if err == ERR_TOPIC_AUTHORIZATION_FAILED:
            raise PermissionError(
                f"raw produce to {topic}:{partition} refused: the topic is "
                f"restricted to its owning engine (Broker.restrict_topic); "
                f"nothing appended")
        if err != ERR_NONE:
            raise RuntimeError(
                f"raw produce to {topic}:{partition} failed: {err}")
        return base

    # --------------------------------------------------------------- fetch
    def fetch(self, topic: str, partition: int, offset: int,
              max_messages: int = 1024) -> List[Message]:
        """Up to ``max_messages`` records from ``offset``.  The server
        answers up to ``FETCH_MAX_RECORDS``; the rest are decoded and
        dropped, as in the JAX client.  A fetch below the retained base
        raises OffsetOutOfRangeError with the earliest retained offset."""
        w = _Writer()
        # replica id (-1: a consumer; >= 0: a follower's mirror fetch),
        # max wait 0 ms, min bytes 1
        w.i32(self._replica_id).i32(0).i32(1)

        def part(wr, _):
            wr.i32(partition).i64(offset).i32(FETCH_MAX_BYTES)

        w.array([None], lambda wr, _: (wr.string(topic),
                                       wr.array([None], part)))
        r = self._request(FETCH, 2, bytes(w.buf))
        r.i32()  # throttle
        out: List[Message] = []
        tops = r.array(lambda rd: (rd.string(), rd.array(
            lambda p: (p.i32(), p.i16(), p.i64(), p.bytes_()))))
        for tname, parts in tops:
            for pid, err, hwm, record_set in parts:
                if err == ERR_OFFSET_OUT_OF_RANGE:
                    # the hwm slot carries the earliest retained offset
                    raise OffsetOutOfRangeError(tname or topic, pid,
                                                offset, max(hwm, 0))
                if err == ERR_UNKNOWN_TOPIC:
                    raise KeyError(topic)
                if err == ERR_NOT_LEADER_FOR_PARTITION:
                    raise NotLeaderForPartitionError(tname or topic, pid)
                if err != ERR_NONE:
                    raise RuntimeError(f"fetch {topic}:{pid} failed: {err}")
                self._hwm[(tname or topic, pid)] = int(hwm)
                entries = decode_message_set(record_set or b"")
                for off, key, value, ts in entries:
                    if off >= offset and len(out) < max_messages:
                        # a null value is a tombstone: kept as None
                        out.append(Message(tname, pid, off, value, key, ts))
        return out

    def fetch_raw(self, topic: str, partition: int, offset: int,
                  max_bytes: int = 1 << 20):
        """RAW_FETCH: the broker's store frames from ``offset``, as they
        are, in one ``RawFrameBatch`` (the consumer's columnar decoder
        does all record work on the one buffer).  None at the log end;
        NotImplementedError against a server without the extension (the
        consumer then pins back to FETCH for good); OffsetOutOfRangeError
        below the retained base, with the earliest retained offset."""
        from ..ops.framing import RawFrameBatch

        w = _Writer()
        # the trailing replica id (a server without it stops at
        # max_bytes): a follower's mirror fetch is observed into the
        # leader's ISR and served past the quorum HWM
        w.string(topic).i32(partition).i64(offset).i32(max_bytes)
        w.i32(self._replica_id)
        r = self._request(RAW_FETCH, 0, bytes(w.buf))
        err = r.i16()
        if err == ERR_UNSUPPORTED_VERSION:
            # raised, not None: the consumer must switch the columnar path
            # off, not take it for the log end
            raise NotImplementedError("server lacks the RAW_FETCH extension")
        aux = r.i64()  # the batch's start offset; the earliest for error 1
        blob = r.bytes_()
        if err == ERR_NONE and r.pos + 8 <= len(r.buf):
            hwm = r.i64()  # trailing high-water mark (-1: not answered)
            if hwm >= 0:
                self._hwm[(topic, partition)] = hwm
        if err == ERR_OFFSET_OUT_OF_RANGE:
            raise OffsetOutOfRangeError(topic, partition, offset,
                                        max(aux, 0))
        if err == ERR_UNKNOWN_TOPIC:
            raise KeyError(topic)
        if err == ERR_NOT_LEADER_FOR_PARTITION:
            raise NotLeaderForPartitionError(topic, partition)
        if err != ERR_NONE:
            raise RuntimeError(f"raw fetch {topic}:{partition}: {err}")
        if not blob:
            return None  # the log end
        return RawFrameBatch(topic, partition, int(aux), blob)

    def last_hwm(self, topic: str, partition: int) -> Optional[int]:
        """The newest high-water mark seen for (topic, partition) in a
        fetch response; None before the first fetch."""
        return self._hwm.get((topic, partition))

    # ------------------------------------------------------------- offsets
    def _list_offset(self, topic: str, partition: int, timestamp: int) -> int:
        w = _Writer()
        w.i32(-1)

        def part(wr, _):
            wr.i32(partition).i64(timestamp)

        w.array([None], lambda wr, _: (wr.string(topic),
                                       wr.array([None], part)))
        r = self._request(LIST_OFFSETS, 1, bytes(w.buf))
        tops = r.array(lambda rd: (rd.string(), rd.array(
            lambda p: (p.i32(), p.i16(), p.i64(), p.i64()))))
        for _, parts in tops:
            for pid, err, _ts, off in parts:
                if err == ERR_NOT_LEADER_FOR_PARTITION:
                    raise NotLeaderForPartitionError(topic, pid)
                if err == ERR_UNKNOWN_TOPIC:
                    raise KeyError(topic)
                if err != ERR_NONE:
                    raise RuntimeError(f"list_offsets {topic}:{pid}: {err}")
                return off
        raise RuntimeError("empty ListOffsets response")

    def end_offset(self, topic: str, partition: int = 0) -> int:
        return self._list_offset(topic, partition, -1)

    def begin_offset(self, topic: str, partition: int = 0) -> int:
        return self._list_offset(topic, partition, -2)

    def offset_for_timestamp(self, topic: str, partition: int,
                             timestamp_ms: int) -> int:
        """Earliest offset with record timestamp >= ``timestamp_ms``
        (ListOffsets by timestamp)."""
        return self._list_offset(topic, partition, max(int(timestamp_ms), 0))

    # ------------------------------------------------- consumer-group API
    def commit(self, group: str, topic: str, partition: int, next_offset: int):
        """Simple-consumer commit: ``commit_fenced`` at generation -1."""
        if not self.commit_fenced(group, -1, "",
                                  [(topic, partition, next_offset)]):
            raise RuntimeError(f"offset commit {topic}:{partition} fenced")

    def commit_many(self, group: str, topic: str, entries) -> None:
        """Commit [(partition, next_offset), ...] of one topic in ONE
        OffsetCommit request (``StreamConsumer.commit``'s path)."""
        if not self.commit_fenced(group, -1, "",
                                  [(topic, p, off) for p, off in entries]):
            raise RuntimeError(f"batched offset commit {topic} fenced")

    def _offset_fetch(self, group: str, by_topic: Dict[str, List[int]]
                      ) -> Dict[Tuple[str, int], int]:
        w = _Writer()
        w.string(group)
        w.array(sorted(by_topic.items()), lambda wr, tp: (
            wr.string(tp[0]),
            wr.array(sorted(tp[1]), lambda pw, p: pw.i32(p))))
        r = self._request(OFFSET_FETCH, 1, bytes(w.buf))
        tops = r.array(lambda rd: (rd.string(), rd.array(
            lambda p: (p.i32(), p.i64(), p.string(), p.i16()))))
        out: Dict[Tuple[str, int], int] = {}
        for tname, parts in tops:
            for pid, off, _meta, err in parts:
                if err == ERR_NOT_COORDINATOR:
                    raise CoordinatorMovedError(
                        f"offset fetch {tname}:{pid}: broker is not the "
                        f"coordinator")
                if err != ERR_NONE:
                    raise RuntimeError(f"offset fetch {tname}:{pid}: {err}")
                if off >= 0:
                    out[(tname, pid)] = off
        return out

    def committed(self, group: str, topic: str,
                  partition: int) -> Optional[int]:
        return self._offset_fetch(group, {topic: [partition]}).get(
            (topic, partition))

    def committed_many(self, group: str, pairs
                       ) -> Dict[Tuple[str, int], int]:
        """Committed offsets of [(topic, partition), ...] in ONE
        OffsetFetch request; pairs with nothing committed are left out."""
        by_topic: Dict[str, List[int]] = {}
        for t, p in pairs:
            by_topic.setdefault(t, []).append(p)
        return self._offset_fetch(group, by_topic)

    def commit_fenced(self, group: str, generation: int, member_id: str,
                      positions) -> bool:
        """Generation-fenced OffsetCommit (v2 carries generation and
        member).  Every partition refused with ILLEGAL_GENERATION: the
        member is fenced, nothing written, False.  All accepted: True.  A
        mix (the member named partitions outside its assignment; the rest
        ARE committed) raises RuntimeError naming them."""
        by_topic: dict = {}
        for t, p, off in positions:
            by_topic.setdefault(t, []).append((p, off))
        w = _Writer()
        w.string(group).i32(generation).string(member_id).i64(-1)
        w.array(sorted(by_topic.items()), lambda wr, tp: (
            wr.string(tp[0]),
            wr.array(tp[1], lambda pw, p: pw.i32(p[0]).i64(p[1])
                     .string(None))))
        # not retried: a stale commit replayed after a rebalance could
        # bypass the fence; callers re-commit from their own cursors
        r = self._request(OFFSET_COMMIT, 2, bytes(w.buf))
        tops = r.array(lambda rd: (rd.string(), rd.array(
            lambda p: (p.i32(), p.i16()))))
        results = [(t, pid, err) for t, parts in tops for pid, err in parts]
        errs = {err for _, _, err in results}
        if errs == {ERR_NONE}:
            return True
        if errs == {ERR_ILLEGAL_GENERATION}:
            return False  # fenced: nothing was written
        if errs == {ERR_NOT_COORDINATOR}:
            # the group's coordinator moved (a cluster failover): nothing
            # written here; re-find the coordinator and re-commit
            raise CoordinatorMovedError(
                f"offset commit {sorted(by_topic)}: broker is not the "
                f"coordinator")
        if errs == {ERR_FENCED_LEADER_EPOCH}:
            # the leadership epoch fence (the whole server relationship
            # is stale, not one member): nothing written, the caller
            # re-commits from its cursors against the re-resolved leader
            raise self._fenced(f"offset commit {sorted(by_topic)}")
        bad = [(t, pid) for t, pid, err in results if err != ERR_NONE]
        raise RuntimeError(
            f"partial offset commit: partitions {bad} refused (outside this "
            f"member's assignment?); the rest were committed")

    # ------------------------------------------- group membership (wire)
    def join_group(self, group: str, topics, member_id: str = "",
                   session_timeout_ms: int = 10_000):
        """JoinGroup v0 with the standard consumer subscription metadata.
        Returns (generation, member_id, leader_id, members): ``members``
        is [(member_id, [topics])], non-empty only for the elected leader
        (which computes the assignment client-side)."""
        meta = _Writer()
        meta.i16(0)
        meta.array(list(topics), lambda wr, t: wr.string(t))
        meta.bytes_(b"")
        w = _Writer()
        w.string(group).i32(session_timeout_ms).string(member_id)
        w.string("consumer")
        w.array([("range", bytes(meta.buf))],
                lambda wr, p: (wr.string(p[0]), wr.bytes_(p[1])))
        # not retried: join mutates membership; RemoteGroupCoordinator's
        # join loop retries with its member id
        r = self._request(JOIN_GROUP, 0, bytes(w.buf))
        err = r.i16()
        if err == ERR_NOT_COORDINATOR:
            raise CoordinatorMovedError(
                f"join group {group}: broker is not the coordinator")
        if err != ERR_NONE:
            raise RuntimeError(f"join group {group}: error {err}")
        generation = r.i32()
        r.string()  # protocol
        leader = r.string()
        mid = r.string()
        members = []
        for other_id, blob in r.array(lambda rd: (rd.string(), rd.bytes_())):
            sub = []
            if blob:
                mr = _Reader(blob)
                try:
                    mr.i16()
                    sub = mr.array(lambda rd: rd.string())
                except struct.error:
                    sub = []
            members.append((other_id, sub))
        return generation, mid, leader, members

    def sync_group(self, group: str, generation: int, member_id: str,
                   assignments: Optional[dict] = None):
        """SyncGroup v0 → [(topic, partition), ...] assignment.

        ``assignments`` (leader only): {member_id: [(topic, [partitions])]}
        in the standard ConsumerProtocolAssignment format; a real broker
        forwards it to each member, the servers here compute the same
        assignment themselves."""
        w = _Writer()
        w.string(group).i32(generation).string(member_id)

        def one(wr, item):
            other_id, tps = item
            aw = _Writer()
            aw.i16(0)
            aw.array(sorted(tps), lambda xw, tp: (
                xw.string(tp[0]),
                xw.array(sorted(tp[1]), lambda pw, p: pw.i32(p))))
            aw.bytes_(b"")
            wr.string(other_id).bytes_(bytes(aw.buf))

        w.array(sorted((assignments or {}).items()), one)
        # not retried: sync is generation-fenced; callers rejoin
        r = self._request(SYNC_GROUP, 0, bytes(w.buf))
        err = r.i16()
        blob = r.bytes_() or b""
        if err == ERR_NOT_COORDINATOR:
            raise CoordinatorMovedError(
                f"sync group {group}: broker is not the coordinator")
        if err == ERR_UNKNOWN_MEMBER_ID:
            raise RuntimeError(
                f"sync group {group}: member {member_id!r} unknown to "
                f"the coordinator — rejoin the group")
        if err == ERR_ILLEGAL_GENERATION:
            raise RuntimeError(
                f"sync group {group}: generation {generation} fenced by "
                f"a newer rebalance — rejoin the group")
        if err != ERR_NONE:
            raise RuntimeError(f"sync group {group}: error {err}")
        if not blob:
            return []  # the coordinator has nothing for us (yet)
        ar = _Reader(blob)
        ar.i16()  # version
        pairs = []
        for topic, parts in ar.array(lambda rd: (rd.string(),
                                                 rd.array(lambda p: p.i32()))):
            pairs.extend((topic, p) for p in parts)
        return pairs

    def heartbeat_group(self, group: str, generation: int,
                        member_id: str) -> bool:
        """True while the member is current; False demands a rejoin."""
        w = _Writer()
        w.string(group).i32(generation).string(member_id)
        err = self._request(HEARTBEAT, 0, bytes(w.buf)).i16()
        if err == ERR_NOT_COORDINATOR:
            raise CoordinatorMovedError(
                f"heartbeat {group}: broker is not the coordinator")
        # UNKNOWN_MEMBER_ID and REBALANCE_IN_PROGRESS both mean "this
        # generation is over": the caller rejoins either way
        return err == ERR_NONE

    def leave_group(self, group: str, member_id: str) -> None:
        w = _Writer()
        w.string(group).string(member_id)
        # not retried: a lost leave heals by session timeout
        err = self._request(LEAVE_GROUP, 0, bytes(w.buf)).i16()
        if err == ERR_NOT_COORDINATOR:
            # typed, so the cluster client re-finds the coordinator rather
            # than leaving the member to expire by timeout
            raise CoordinatorMovedError(
                f"leave group {group}: broker is not the coordinator")

    # ------------------------------------------------------ cluster admin
    def cluster_admin(self, command: str,
                      args: Optional[dict] = None) -> dict:
        """CLUSTER_ADMIN: run a live controller's ``add-broker`` /
        ``drain-broker`` / ``status`` verb from another process and
        return its JSON report.  NotImplementedError against a server
        with no controller attached; RuntimeError with the controller's
        error text when the verb raised there."""
        import json

        w = _Writer()
        w.string(command)
        w.bytes_(json.dumps(args or {}).encode())
        # not retried: the verbs change the cluster (a replayed
        # add-broker boots a second node); the operator checks `status`
        r = self._request(CLUSTER_ADMIN, 0, bytes(w.buf))
        err = r.i16()
        if err == ERR_UNSUPPORTED_VERSION:
            raise NotImplementedError(
                "broker has no cluster controller attached "
                "(CLUSTER_ADMIN unsupported)")
        doc = json.loads((r.bytes_() or b"{}").decode() or "{}")
        if err != ERR_NONE:
            default = "unknown server error" if err == ERR_UNKNOWN_SERVER \
                else f"error {err}"
            raise RuntimeError(f"cluster admin {command!r} failed: "
                               f"{doc.get('error', default)}")
        return doc

    # --------------------------------------------------- api versions
    def api_versions(self) -> Dict[int, Tuple[int, int]]:
        """ApiVersions v0 → {api_key: (min_version, max_version)}."""
        r = self._request(API_VERSIONS, 0, b"")
        err = r.i16()
        ranges = r.array(lambda rd: (rd.i16(), rd.i16(), rd.i16()))
        if err != ERR_NONE:
            raise RuntimeError(f"api_versions failed: error {err}")
        return {k: (lo, hi) for k, lo, hi in ranges}

    def close(self) -> None:
        # no socket when the last reconnect found no reachable server
        if self._sock is not None:
            self._sock.close()


class RemoteGroupCoordinator:
    """``GroupCoordinator``-shaped adapter over the wire protocol.

    Gives ``stream.group.GroupConsumer`` elastic membership against a
    broker in ANOTHER process: join / heartbeat / leave / fenced_commit
    ride JoinGroup / SyncGroup / Heartbeat / LeaveGroup / OffsetCommit,
    with membership state living server-side, as Kafka's own coordinator
    keeps it."""

    def __init__(self, client: KafkaWireBroker, group_id: str,
                 session_timeout_ms: int = 10_000):
        self.broker = client
        self.group_id = group_id
        self.session_timeout_ms = session_timeout_ms

    def join(self, topics, member_id=None):
        mid = member_id or ""
        last_err = None
        # a peer joining between Join and Sync bumps the generation:
        # rejoin
        for _ in range(5):
            generation, mid, leader, members = self.broker.join_group(
                self.group_id, topics, mid,
                session_timeout_ms=self.session_timeout_ms)
            assignments = None
            if mid == leader and members:
                # the elected leader computes the range assignment and
                # submits it in SyncGroup, the flow a real broker needs
                assignments = self._leader_assign(members)
            try:
                assignment = self.broker.sync_group(
                    self.group_id, generation, mid, assignments)
                return mid, generation, assignment
            except RuntimeError as e:
                last_err = e
        raise last_err

    def _leader_assign(self, members):
        """RangeAssignor over the members' subscriptions, as
        {member_id: [(topic, [partitions])]}."""
        from .group import range_assign

        topic_parts: dict = {}
        for _mid, topics in members:
            for t in topics:
                if t not in topic_parts:
                    try:
                        topic_parts[t] = self.broker.topic(t).partitions
                    except KeyError:
                        continue  # subscribed before created: nothing yet
        flat = range_assign([m for m, _ in members], topic_parts)
        subscribed = {m: set(ts) for m, ts in members}
        out = {}
        for m, tps in flat.items():
            by_topic: dict = {}
            for t, p in tps:
                if t in subscribed.get(m, ()):
                    by_topic.setdefault(t, []).append(p)
            out[m] = sorted(by_topic.items())
        return out

    def heartbeat(self, member_id: str, generation: int) -> bool:
        return self.broker.heartbeat_group(self.group_id, generation,
                                           member_id)

    def fenced_commit(self, member_id: str, generation: int,
                      positions) -> bool:
        if not positions:
            # nothing to write, but the fencing answer must still be
            # real: a heartbeat checks membership at this generation
            return self.heartbeat(member_id, generation)
        return self.broker.commit_fenced(self.group_id, generation,
                                         member_id, positions)

    def leave(self, member_id: str) -> None:
        self.broker.leave_group(self.group_id, member_id)


# ------------------------------------------------------------------ server
class _KafkaConn(socketserver.BaseRequestHandler):
    """One client connection to the wire server."""

    def setup(self):
        with self.server._conn_lock:      # type: ignore[attr-defined]
            self.server._live_conns.add(self.request)

    def finish(self):
        with self.server._conn_lock:      # type: ignore[attr-defined]
            self.server._live_conns.discard(self.request)

    def handle(self):
        broker: Broker = self.server.broker  # type: ignore[attr-defined]
        creds = self.server.credentials      # type: ignore[attr-defined]
        authed = creds is None
        sasl_pending = False
        try:
            while True:
                (size,) = struct.unpack(">i", recv_exact(self.request, 4))
                frame = recv_exact(self.request, size)
                if sasl_pending:
                    # raw PLAIN token: [authzid] \0 user \0 password
                    parts = frame.split(b"\x00")
                    if len(parts) != 3 or (parts[1], parts[2]) != \
                            (creds[0].encode(), creds[1].encode()):
                        return  # auth failure: drop the connection
                    authed, sasl_pending = True, False
                    self.request.sendall(struct.pack(">i", 0))
                    continue
                r = _Reader(frame)
                api_key, api_version, corr = r.i16(), r.i16(), r.i32()
                # the client id's trailing @e<N> tag carries the
                # client's leadership epoch (absent for standard clients)
                _cid, client_epoch = parse_client_epoch(r.string())
                w = _Writer()
                w.i32(corr)
                lo_hi = _SUPPORTED.get(api_key)
                if lo_hi is None or not lo_hi[0] <= api_version <= lo_hi[1]:
                    w.i16(ERR_UNSUPPORTED_VERSION)
                elif api_key == SASL_HANDSHAKE:
                    mech = r.string()
                    if mech == "PLAIN":
                        w.i16(ERR_NONE)
                        sasl_pending = not authed
                    else:
                        w.i16(ERR_SASL_AUTH_FAILED)
                    w.array(["PLAIN"], lambda wr, m: wr.string(m))
                elif not authed:
                    return  # protocol requests before auth: drop
                elif api_key == API_VERSIONS:
                    w.i16(ERR_NONE)
                    w.array(sorted(_SUPPORTED.items()),
                            lambda wr, kv: wr.i16(kv[0]).i16(kv[1][0])
                            .i16(kv[1][1]))
                else:
                    # the log-mutating handlers fence on it
                    self._client_epoch = client_epoch
                    self._dispatch(broker, api_key, r, w)
                resp = bytes(w.buf)
                self.request.sendall(struct.pack(">i", len(resp)) + resp)
        except (ConnectionError, OSError, struct.error, UnicodeDecodeError):
            pass  # a dead or garbled peer: drop the connection

    @staticmethod
    def _valid_part(broker: Broker, topic: str, pid: int) -> bool:
        """An out-of-range partition answers Kafka error 3, not an
        IndexError that kills the connection."""
        return topic in broker.topics() and \
            0 <= pid < broker.topic(topic).partitions

    #: the epoch stamped on the request in hand (None: unstamped)
    _client_epoch: Optional[int] = None

    def _epoch_mismatch(self) -> bool:
        """True when the request's stamped epoch differs from the
        server's: below it, the client slept through a failover; above
        it, this server is a resurrected old leader.  Either way a
        log-mutating request is refused, or the log splits.  Unstamped
        (standard) clients pass unfenced."""
        return self._client_epoch is not None and \
            self._client_epoch != self.server.epoch  # type: ignore

    # ------------------------------------------------------------ handlers
    def _dispatch(self, broker: Broker, api_key: int, r: _Reader, w: _Writer):
        {METADATA: self._metadata, PRODUCE: self._produce,
         FETCH: self._fetch, LIST_OFFSETS: self._list_offsets,
         OFFSET_COMMIT: self._offset_commit,
         OFFSET_FETCH: self._offset_fetch,
         FIND_COORDINATOR: self._find_coordinator,
         JOIN_GROUP: self._join_group, SYNC_GROUP: self._sync_group,
         HEARTBEAT: self._heartbeat, LEAVE_GROUP: self._leave_group,
         CREATE_TOPICS: self._create_topics, RAW_FETCH: self._raw_fetch,
         RAW_PRODUCE: self._raw_produce,
         CLUSTER_ADMIN: self._cluster_admin}[api_key](broker, r, w)

    def _not_coordinator(self) -> bool:
        """True on a cluster broker that is not the pinned group
        coordinator: group membership and offsets live in exactly one
        place, so every other broker answers NOT_COORDINATOR (16)."""
        cluster = self.server.cluster        # type: ignore[attr-defined]
        return cluster is not None and \
            cluster.coordinator()[0] != cluster.node_id

    def _metadata(self, broker, r, w):
        n = r.i32()
        names = [r.string() for _ in range(max(n, 0))]
        if n <= 0:
            names = broker.topics()
        cluster = self.server.cluster        # type: ignore[attr-defined]
        if cluster is not None:
            # the whole cluster's brokers, and each partition's owning
            # node: the map routing clients cache
            rows = list(cluster.brokers())
            controller = rows[0][0]
        else:
            host, port = self.server.server_address[:2]  # type: ignore
            rows = [(0, host, port)]
            controller = 0
        w.array(rows, lambda wr, b: wr.i32(b[0]).string(b[1])
                .i32(b[2]).string(None))
        w.i32(controller)

        def topic_entry(wr, name):
            known = name in broker.topics()
            wr.i16(ERR_NONE if known else ERR_UNKNOWN_TOPIC)
            wr.string(name).i8(0)

            def part_entry(pw, p):
                leader = 0 if cluster is None else \
                    cluster.leader_node(name, p)
                pw.i16(ERR_NONE).i32(p).i32(-1 if leader is None
                                            else leader)
                node = 0 if leader is None else leader
                pw.array([node], lambda x, v: x.i32(v))  # replicas
                pw.array([node], lambda x, v: x.i32(v))  # isr

            wr.array(list(range(broker.topic(name).partitions)
                          if known else []), part_entry)

        w.array(names, topic_entry)

    @staticmethod
    def _produce_error_resp(w: _Writer, tops, err: int) -> None:
        """A PRODUCE response answering ``err`` for every partition (the
        invalid-acks and epoch-fence early returns)."""
        resp = [(tname, [(pid, err, -1) for pid, _ in parts])
                for tname, parts in tops]
        w.array(resp, lambda wr, t: (wr.string(t[0]), wr.array(
            t[1], lambda pw, p: pw.i32(p[0]).i16(p[1]).i64(p[2]).i64(-1))))
        w.i32(0)  # throttle

    @staticmethod
    def _quorum_short(repl, topic: str, pid: int) -> bool:
        """The acks=all refusal before any append: a topic with no ISR
        configured on a broker that opted into quorum, or an ISR below
        ``min_isr``.  A broker without replication state keeps Kafka's
        RF-1 shape (acks=all is acks=1) and never gets here."""
        return not repl.covers(topic) or \
            repl.isr_size(topic, pid) < repl.min_isr

    @staticmethod
    def _quorum_ack(repl, topic: str, pid: int, next_offset: int,
                    timeout_ms: int) -> int:
        """The acks=all verdict on an appended batch ending at
        ``next_offset - 1``: NONE once the quorum HWM covers it with the
        ISR at ``min_isr`` or more, REQUEST_TIMED_OUT when the HWM does
        not reach it in time, NOT_ENOUGH_REPLICAS_AFTER_APPEND when it
        does only because the ISR shrank below ``min_isr`` (Kafka's
        check at the ack point; ``iotml.stream.kafka_wire`` acks here)."""
        if not repl.wait_replicated(
                topic, pid, next_offset,
                timeout_s=min(max(timeout_ms, 0) / 1000.0, 30.0)):
            return ERR_REQUEST_TIMED_OUT
        if repl.isr_size(topic, pid) < repl.min_isr:
            return ERR_NOT_ENOUGH_REPLICAS_AFTER_APPEND
        return ERR_NONE

    def _produce(self, broker, r, w):
        # 1 acks at the leader append, -1 (acks=all) once the batch is
        # below the quorum high-water mark, 0 answers with no delivery
        # guarantee (errors masked: fire-and-forget)
        acks = r.i16()
        timeout_ms = r.i32()

        def part(rd):
            return (rd.i32(), rd.bytes_())

        tops = r.array(lambda rd: (rd.string(), rd.array(part)))
        if self.server.retiring:             # type: ignore[attr-defined]
            # the reassignment step-down: leadership moved, so every
            # producer (epoch-stamped or not) is told to re-route and
            # nothing lands in the retired log
            self._produce_error_resp(w, tops, ERR_NOT_LEADER_FOR_PARTITION)
            return
        if acks not in (-1, 0, 1):
            self._produce_error_resp(w, tops, ERR_INVALID_REQUIRED_ACKS)
            return
        if self._epoch_mismatch():
            # fence BEFORE the broker is touched: a stale-epoch produce
            # appends nothing anywhere
            self._produce_error_resp(w, tops, ERR_FENCED_LEADER_EPOCH)
            return
        repl = getattr(broker, "replication", None)
        quorum = acks == -1 and repl is not None
        cluster = self.server.cluster        # type: ignore[attr-defined]
        resp = []
        for tname, parts in tops:
            presp = []
            for pid, record_set in parts:
                entries = decode_message_set(record_set or b"")
                if tname not in broker.topics() and cluster is None:
                    # a cluster provisions its topics cluster-wide; one
                    # broker creating it here would fork the topic spec
                    broker.create_topic(tname, partitions=max(pid + 1, 1))
                if not self._valid_part(broker, tname, pid):
                    presp.append((pid, ERR_UNKNOWN_TOPIC, -1))
                    continue
                if quorum and self._quorum_short(repl, tname, pid):
                    # nothing appended: redelivery is safe
                    presp.append((pid, ERR_NOT_ENOUGH_REPLICAS, -1))
                    continue
                if not self.server.begin_write():  # type: ignore[attr-defined]
                    # stepped down since the request came in
                    presp.append((pid, ERR_NOT_LEADER_FOR_PARTITION, -1))
                    continue
                # one bulk append under one broker lock; the returned
                # LAST offset anchors the response base and the quorum
                # target (an end_offset re-read could include a
                # concurrent producer's batch)
                try:
                    last = broker.produce_many(
                        tname,
                        [(key, value, ts) for _, key, value, ts in entries],
                        partition=pid)
                except NotLeaderForPartitionError:
                    # a shard's unowned partition: the client refreshes
                    # its metadata and re-routes
                    presp.append((pid, ERR_NOT_LEADER_FOR_PARTITION, -1))
                    continue
                except PermissionError:
                    # engine-owned topic (Broker.restrict_topic): an
                    # external client may not write the AVRO leg
                    presp.append((pid, ERR_TOPIC_AUTHORIZATION_FAILED, -1))
                    continue
                finally:
                    self.server.end_write()  # type: ignore[attr-defined]
                base = last - len(entries) + 1 if entries \
                    else broker.end_offset(tname, pid)
                # an error here: appended, unacked, and the caller
                # redelivers (followers fetch on their own connections,
                # so this handler's wait starves nobody)
                err = self._quorum_ack(repl, tname, pid, last + 1,
                                       timeout_ms) \
                    if quorum and entries else ERR_NONE
                presp.append((pid, err, base))
            if acks == 0:
                # fire-and-forget: the appends ran, the answer carries no
                # delivery information (errors masked, as in JAX's server)
                presp = [(pid, ERR_NONE, -1) for pid, _, _ in presp]
            resp.append((tname, presp))
        w.array(resp, lambda wr, t: (wr.string(t[0]), wr.array(
            t[1], lambda pw, p: pw.i32(p[0]).i16(p[1]).i64(p[2]).i64(-1))))
        w.i32(0)  # throttle

    @staticmethod
    def _mark_fetch_batch(msgs, topic: str, pid: int) -> None:
        """The server's hop of a traced batch: a fork of the first
        header-carried context (the broker's object stays unmarked for
        its in-process readers), marked once for the whole batch."""
        for m in msgs:
            ctx = tracing.from_headers(m.headers)
            if ctx is not None:
                tracing.mark_batch(ctx.fork(), "wire_fetch", topic, pid,
                                   msgs[0].offset, msgs[-1].offset,
                                   len(msgs))
                return

    def _fetch(self, broker, r, w):
        # a replica id >= 0 marks a follower's mirror fetch: the leader
        # observes its position into the ISR and serves past the quorum
        # HWM (a follower exists to read that tail); consumers (-1) are
        # bounded by it
        rid = r.i32()
        r.i32()  # max wait
        r.i32()  # min bytes

        def part(rd):
            return (rd.i32(), rd.i64(), rd.i32())

        tops = r.array(lambda rd: (rd.string(), rd.array(part)))
        repl = getattr(broker, "replication", None)
        resp = []
        for tname, parts in tops:
            presp = []
            for pid, offset, max_bytes in parts:
                if not self._valid_part(broker, tname, pid):
                    presp.append((pid, ERR_UNKNOWN_TOPIC, -1, b""))
                    continue
                try:
                    if rid >= 0:
                        if repl is not None:
                            repl.observe_fetch(rid, tname, pid, offset)
                        # a relay broker has no fetch_tail and no
                        # replication state: its fetch is unbounded
                        msgs = getattr(broker, "fetch_tail", broker.fetch)(
                            tname, pid, offset, FETCH_MAX_RECORDS)
                    else:
                        msgs = broker.fetch(tname, pid, offset,
                                            FETCH_MAX_RECORDS)
                except NotLeaderForPartitionError:
                    presp.append((pid, ERR_NOT_LEADER_FOR_PARTITION, -1,
                                  b""))
                    continue
                except OffsetOutOfRangeError as e:
                    # Kafka error 1; the hwm slot carries the earliest
                    # retained offset, so the client resets without a
                    # second round trip
                    presp.append((pid, ERR_OFFSET_OUT_OF_RANGE,
                                  e.earliest, b""))
                    continue
                if tracing.ENABLED and msgs:
                    self._mark_fetch_batch(msgs, tname, pid)
                hwm = broker.end_offset(tname, pid)
                if rid < 0 and repl is not None:
                    # a consumer's hwm is its readable frontier, the
                    # quorum HWM, not the leader's log end
                    ceil = repl.fetch_ceiling(tname, pid)
                    if ceil is not None:
                        hwm = ceil
                # cut at max_bytes, possibly mid-entry: the client drops
                # a partial trailing entry
                ms = encode_message_set(
                    [(m.offset, m.key, m.value, m.timestamp_ms)
                     for m in msgs])[:max(max_bytes, 0) or None]
                presp.append((pid, ERR_NONE, hwm, ms))
            resp.append((tname, presp))
        w.i32(0)  # throttle
        w.array(resp, lambda wr, t: (wr.string(t[0]), wr.array(
            t[1], lambda pw, p: pw.i32(p[0]).i16(p[1]).i64(p[2])
            .bytes_(p[3]))))

    @staticmethod
    def _mark_raw_batch(frames: bytes, stage: str, topic: str, pid: int,
                        at_or_after: Optional[int] = None) -> None:
        """The server's hop of a traced raw batch: the context its first
        frame's headers carry, marked once for the whole batch (one
        frame parsed; bytes that hold no trace are simply not one)."""
        from ..ops.framing import first_frame_headers

        try:
            hdrs = first_frame_headers(frames, at_or_after=at_or_after)
        except (ValueError, struct.error):
            return
        ctx = tracing.from_headers(hdrs)
        if ctx is not None:
            tracing.mark_batch(ctx, stage, topic, pid)

    def _raw_fetch(self, broker, r, w):
        """One partition's store frames as the broker holds them: no
        message-set re-encode, no per-record work for a durable broker
        (the in-memory one re-frames its slice).  A trailing replica id
        >= 0 is a follower's mirror fetch: observed into the ISR (for a
        valid partition only) and served past the quorum HWM."""
        tname, pid = r.string(), r.i32()
        offset, max_bytes = r.i64(), r.i32()
        rid = r.i32() if r.pos + 4 <= len(r.buf) else -1
        repl = getattr(broker, "replication", None)
        fetch_raw = getattr(broker, "fetch_raw", None)
        valid = self._valid_part(broker, tname, pid)
        if valid and rid >= 0 and fetch_raw is not None:
            if repl is not None:
                repl.observe_fetch(rid, tname, pid, offset)
            fetch_raw = getattr(broker, "fetch_raw_tail", fetch_raw)
        if not valid:
            w.i16(ERR_UNKNOWN_TOPIC).i64(-1).bytes_(None)
            return
        if fetch_raw is None:  # a relay broker without raw reads
            w.i16(ERR_UNSUPPORTED_VERSION)
            return
        try:
            raw = fetch_raw(tname, pid, offset, max_bytes=max(max_bytes,
                                                              4096))
        except NotImplementedError:
            # a relay whose upstream lacks the extension: the same answer
            # as a server without it, so the client pins back to FETCH
            w.i16(ERR_UNSUPPORTED_VERSION)
            return
        except NotLeaderForPartitionError:
            w.i16(ERR_NOT_LEADER_FOR_PARTITION).i64(-1).bytes_(None)
            return
        except OffsetOutOfRangeError as e:
            w.i16(ERR_OFFSET_OUT_OF_RANGE).i64(e.earliest).bytes_(None)
            return
        if hasattr(broker, "_request"):
            # a relay answers from the hwm its own fetch just cached, not
            # with an upstream round trip a fetch
            hwm = broker.last_hwm(tname, pid)
            hwm = -1 if hwm is None else hwm
        elif rid < 0 and repl is not None and \
                repl.fetch_ceiling(tname, pid) is not None:
            # a consumer's columnar lag is against the quorum HWM
            hwm = repl.fetch_ceiling(tname, pid)
        else:
            hwm = broker.end_offset(tname, pid)
        if raw is None:
            w.i16(ERR_NONE).i64(offset).bytes_(b"")
        else:
            if tracing.ENABLED:
                self._mark_raw_batch(raw.data, "wire_raw_fetch", tname, pid,
                                     at_or_after=offset)
            w.i16(ERR_NONE).i64(raw.start_offset).bytes_(raw.data)
        w.i64(hwm)  # trailing: the columnar consumer's lag, no extra trip

    def _raw_produce(self, broker, r, w):
        """A pre-framed batch appended as it is after the broker validated
        it whole and stamped its offsets; a corrupt one answers
        CORRUPT_MESSAGE with nothing appended.  The trailing acks and
        timeout (absent: -1) follow PRODUCE's: acks=all waits for the
        quorum HWM, a short ISR refuses before the append."""
        tname, pid = r.string(), r.i32()
        frames = r.bytes_() or b""
        acks = r.i16() if r.pos + 2 <= len(r.buf) else -1
        timeout_ms = r.i32() if r.pos + 4 <= len(r.buf) else 10_000
        repl = getattr(broker, "replication", None)
        quorum = acks == -1 and repl is not None
        produce_raw = getattr(broker, "produce_raw", None)
        if self.server.retiring:             # type: ignore[attr-defined]
            # the reassignment step-down, PRODUCE's answer
            w.i16(ERR_NOT_LEADER_FOR_PARTITION).i64(-1).i32(0)
            return
        if self._epoch_mismatch():
            # fence before the broker is touched, as PRODUCE does
            w.i16(ERR_FENCED_LEADER_EPOCH).i64(-1).i32(0)
            return
        if produce_raw is None:  # a relay without raw appends
            w.i16(ERR_UNSUPPORTED_VERSION)
            return
        if acks not in (-1, 0, 1):
            w.i16(ERR_INVALID_REQUIRED_ACKS).i64(-1).i32(0)
            return
        if tname not in broker.topics() and \
                self.server.cluster is None:  # type: ignore[attr-defined]
            broker.create_topic(tname, partitions=max(pid + 1, 1))
        if not self._valid_part(broker, tname, pid):
            w.i16(ERR_UNKNOWN_TOPIC).i64(-1).i32(0)
            return
        if quorum and self._quorum_short(repl, tname, pid):
            w.i16(ERR_NOT_ENOUGH_REPLICAS).i64(-1).i32(0)
            return
        if tracing.ENABLED:
            self._mark_raw_batch(frames, "wire_raw_produce", tname, pid)
        nframes = None
        if quorum:
            # the quorum wait targets THIS batch's last offset, not an
            # end_offset re-read a concurrent producer may have moved:
            # count the frames before the append (a corrupt batch falls
            # through to produce_raw's own rejection)
            from ..ops import framing

            try:
                nframes = framing.validate_frame_batch(frames)["count"]
            except framing.CorruptFrameError:
                nframes = None
        if not self.server.begin_write():    # type: ignore[attr-defined]
            # stepped down since the request came in
            w.i16(ERR_NOT_LEADER_FOR_PARTITION).i64(-1).i32(0)
            return
        try:
            base = produce_raw(tname, pid, frames)
        except NotImplementedError:
            w.i16(ERR_UNSUPPORTED_VERSION)
            return
        except CorruptMessageError as e:
            w.i16(ERR_CORRUPT_MESSAGE).i64(e.index).i32(0)
            return
        except NotLeaderForPartitionError:
            w.i16(ERR_NOT_LEADER_FOR_PARTITION).i64(-1).i32(0)
            return
        except PermissionError:
            # engine-owned topic without the owner's grant
            w.i16(ERR_TOPIC_AUTHORIZATION_FAILED).i64(-1).i32(0)
            return
        finally:
            self.server.end_write()          # type: ignore[attr-defined]
        count = nframes if nframes is not None else \
            broker.end_offset(tname, pid) - base
        # an error here: appended, unacked; the producer redelivers
        err = self._quorum_ack(repl, tname, pid, base + count, timeout_ms) \
            if quorum and count else ERR_NONE
        w.i16(err).i64(base).i32(count)

    def _list_offsets(self, broker, r, w):
        r.i32()  # replica

        def part(rd):
            return (rd.i32(), rd.i64())

        tops = r.array(lambda rd: (rd.string(), rd.array(part)))
        resp = []
        for tname, parts in tops:
            presp = []
            for pid, ts in parts:
                if not self._valid_part(broker, tname, pid):
                    presp.append((pid, ERR_UNKNOWN_TOPIC, -1, -1))
                    continue
                try:
                    if ts == -2:
                        off = broker.begin_offset(tname, pid)
                    elif ts >= 0:
                        # by timestamp: earliest offset with record ts >= ts
                        off = broker.offset_for_timestamp(tname, pid, ts)
                    else:
                        off = broker.end_offset(tname, pid)
                except NotLeaderForPartitionError:
                    presp.append((pid, ERR_NOT_LEADER_FOR_PARTITION, -1, -1))
                    continue
                presp.append((pid, ERR_NONE, -1, off))
            resp.append((tname, presp))
        w.array(resp, lambda wr, t: (wr.string(t[0]), wr.array(
            t[1], lambda pw, p: pw.i32(p[0]).i16(p[1]).i64(p[2])
            .i64(p[3]))))

    def _offset_commit(self, broker, r, w):
        group = r.string()
        generation = r.i32()
        member = r.string()
        r.i64()  # retention

        def part(rd):
            return (rd.i32(), rd.i64(), rd.string())

        tops = r.array(lambda rd: (rd.string(), rd.array(part)))
        if self._not_coordinator():
            # a cluster pins offsets to ONE broker: a commit accepted
            # here would fork the offset table
            resp = [(tname, [(pid, ERR_NOT_COORDINATOR)
                             for pid, _, _ in parts])
                    for tname, parts in tops]
        elif self._epoch_mismatch():
            # a stale-epoch commit: writing it would let a zombie bypass
            # the promoted log's offset streams
            resp = [(tname, [(pid, ERR_FENCED_LEADER_EPOCH)
                             for pid, _, _ in parts])
                    for tname, parts in tops]
        elif generation >= 0:
            # a real generation goes through the group coordinator, so a
            # member fenced by a rebalance cannot clobber offsets
            coord = self.server.group_coordinator(group)  # type: ignore
            done = coord.fenced_commit_detailed(
                member, generation,
                [(t, pid, off) for t, parts in tops for pid, off, _ in parts])
            # fenced (None): nothing written; else unowned partitions
            # error out loudly
            resp = [(t, [(pid, ERR_NONE if done is not None and (t, pid)
                          in done else ERR_ILLEGAL_GENERATION)
                         for pid, _, _ in parts]) for t, parts in tops]
        else:
            # generation -1: the simple consumer, unfenced; one batched
            # commit per topic
            for tname, parts in tops:
                broker.commit_many(group, tname,
                                   [(pid, off) for pid, off, _ in parts])
            resp = [(tname, [(pid, ERR_NONE) for pid, _, _ in parts])
                    for tname, parts in tops]
        w.array(resp, lambda wr, t: (wr.string(t[0]), wr.array(
            t[1], lambda pw, p: pw.i32(p[0]).i16(p[1]))))

    def _offset_fetch(self, broker, r, w):
        group = r.string()
        tops = r.array(lambda rd: (rd.string(),
                                   rd.array(lambda p: p.i32())))
        err = ERR_NOT_COORDINATOR if self._not_coordinator() else ERR_NONE
        resp = [(tname, [(pid, None if err else
                          broker.committed(group, tname, pid))
                         for pid in parts]) for tname, parts in tops]
        w.array(resp, lambda wr, t: (wr.string(t[0]), wr.array(
            t[1], lambda pw, p: pw.i32(p[0]).i64(-1 if p[1] is None
                                                 else p[1])
            .string(None).i16(err))))

    def _find_coordinator(self, broker, r, w):
        r.string()  # group id: one coordinator serves every group
        cluster = self.server.cluster        # type: ignore[attr-defined]
        if cluster is not None:
            node, host, port = cluster.coordinator()
            w.i16(ERR_NONE).i32(node).string(host).i32(port)
            return
        # advertise the address the client connected to, not the bind
        # address (0.0.0.0 would be unconnectable)
        host = self.request.getsockname()[0]
        port = self.server.port  # type: ignore[attr-defined]
        w.i16(ERR_NONE).i32(0).string(host).i32(port)

    def _join_group(self, broker, r, w):
        if self._not_coordinator():
            w.i16(ERR_NOT_COORDINATOR).i32(-1).string("").string("")
            w.string("")
            w.array([], lambda wr, x: None)
            return
        group = r.string()
        session_timeout_ms = r.i32()
        member = r.string()
        r.string()  # protocol type ("consumer")
        protocols = r.array(lambda rd: (rd.string(), rd.bytes_()))
        # subscribed topics from the standard consumer protocol metadata:
        # version i16, topics array<str>, userdata bytes
        topics = []
        if protocols:
            meta = _Reader(protocols[0][1] or b"")
            try:
                meta.i16()
                topics = meta.array(lambda rd: rd.string())
            except struct.error:
                topics = []
        coord = self.server.group_coordinator(  # type: ignore
            group, session_timeout_ms / 1000.0)
        mid, gen, _assigned = coord.join(topics, member or None)
        members = coord.members()
        leader = members[0] if members else mid
        # echo a protocol the client offered (a client errors out if told
        # one it never proposed)
        proto = protocols[0][0] if protocols else "range"
        w.i16(ERR_NONE).i32(gen).string(proto).string(leader).string(mid)
        # the elected leader receives every member's subscription so it
        # can compute the assignment client-side (SyncGroup computes it
        # server-side regardless: the same answer)
        rows = []
        if mid == leader:
            for other_id, subs in sorted(coord.subscriptions().items()):
                mw = _Writer()
                mw.i16(0)
                mw.array(list(subs), lambda wr2, t: wr2.string(t))
                mw.bytes_(b"")
                rows.append((other_id, bytes(mw.buf)))
        w.array(rows, lambda wr, x: (wr.string(x[0]), wr.bytes_(x[1])))

    def _sync_group(self, broker, r, w):
        if self._not_coordinator():
            w.i16(ERR_NOT_COORDINATOR).bytes_(b"")
            return
        group = r.string()
        generation = r.i32()
        member = r.string()
        r.array(lambda rd: (rd.string(), rd.bytes_()))  # the leader's
        coord = self.server.group_coordinator(group)  # type: ignore
        # membership check + assignment under one coordinator lock
        verdict, assigned = coord.sync(member, generation)
        if verdict == "unknown_member":
            w.i16(ERR_UNKNOWN_MEMBER_ID).bytes_(b"")
        elif verdict == "illegal_generation":
            w.i16(ERR_ILLEGAL_GENERATION).bytes_(b"")
        else:
            by_topic: dict = {}
            for t, p in assigned:
                by_topic.setdefault(t, []).append(p)
            aw = _Writer()
            aw.i16(0)  # ConsumerProtocolAssignment version
            aw.array(sorted(by_topic.items()), lambda wr, tp: (
                wr.string(tp[0]),
                wr.array(sorted(tp[1]), lambda pw, p: pw.i32(p))))
            aw.bytes_(b"")  # userdata
            w.i16(ERR_NONE).bytes_(bytes(aw.buf))

    def _heartbeat(self, broker, r, w):
        if self._not_coordinator():
            w.i16(ERR_NOT_COORDINATOR)
            return
        group = r.string()
        generation = r.i32()
        member = r.string()
        coord = self.server.group_coordinator(group)  # type: ignore
        w.i16({"ok": ERR_NONE,
               "unknown_member": ERR_UNKNOWN_MEMBER_ID,
               "rebalance_in_progress": ERR_REBALANCE_IN_PROGRESS}
              [coord.heartbeat_verdict(member, generation)])

    def _leave_group(self, broker, r, w):
        if self._not_coordinator():
            w.i16(ERR_NOT_COORDINATOR)
            return
        group = r.string()
        member = r.string()
        self.server.group_coordinator(group).leave(member)  # type: ignore
        w.i16(ERR_NONE)

    def _cluster_admin(self, broker, r, w):
        """The elastic reassignment verbs, run in this handler thread
        by the server's ``admin`` hook (the controller): the CLI waits for
        the report while other connections keep being served."""
        import json

        command = r.string()
        blob = r.bytes_() or b"{}"
        admin = self.server.admin            # type: ignore[attr-defined]
        if admin is None:
            w.i16(ERR_UNSUPPORTED_VERSION)
            return
        try:
            doc = admin.admin_command(command or "",
                                      json.loads(blob.decode() or "{}"))
        except Exception as e:  # noqa: BLE001 - the operator gets the
            # error text and the connection stays up
            w.i16(ERR_UNKNOWN_SERVER)
            w.bytes_(json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode())
            return
        w.i16(ERR_NONE)
        w.bytes_(json.dumps(doc, default=str).encode())

    def _create_topics(self, broker, r, w):
        def topic(rd):
            name = rd.string()
            parts = rd.i32()
            rd.i16()  # replication factor
            rd.array(lambda x: (x.i32(), x.array(lambda y: y.i32())))
            cfgs = rd.array(lambda x: (x.string(), x.string()))
            return (name, parts, cfgs)

        tops = r.array(topic)
        r.i32()  # timeout
        resp = []
        for name, parts, cfgs in tops:
            if name in broker.topics():
                resp.append((name, ERR_TOPIC_EXISTS))
                continue
            try:
                broker.create_topic(name, partitions=max(parts, 1),
                                    **_retention_configs(cfgs))
            except ValueError:
                # unparseable or negative retention, or a cleanup policy
                # other than delete / compact
                resp.append((name, ERR_INVALID_CONFIG))
                continue
            resp.append((name, ERR_NONE))
        w.array(resp, lambda wr, t: wr.string(t[0]).i16(t[1]))


def _retention_configs(cfgs) -> dict:
    """CreateTopics config entries → ``Broker.create_topic`` retention
    and cleanup keywords.  Kafka's own names (retention.bytes,
    retention.ms, cleanup.policy) and the emulator family's
    retention.messages; retention -1 is Kafka's "unlimited", mapped to an
    explicit 0 (which on a durable broker overrides the store-wide
    default, where None would inherit it).  Unknown keys are ignored, as
    a permissive broker's defaults path does; ``create_topic`` validates
    the cleanup policy.  A bad value raises ValueError."""
    fields = {"retention.messages": "retention_messages",
              "retention.bytes": "retention_bytes",
              "retention.ms": "retention_ms"}
    out = {}
    for k, v in cfgs:
        if v is None:
            continue
        if k == "cleanup.policy":
            out["cleanup_policy"] = v
        elif k in fields:
            value = int(v)
            out[fields[k]] = 0 if value == -1 else value
    return out


class KafkaWireServer(socketserver.ThreadingTCPServer):
    """TCP Kafka-protocol front for the port's ``Broker`` (memory or disk).

    ``with KafkaWireServer(broker) as s:`` serves on an ephemeral
    localhost port (``s.port``) from a daemon thread.  Pass
    ``credentials=(user, password)`` to require the SASL/PLAIN exchange
    the reference's cluster config mandates (gcp.yaml:29-32).
    """

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, broker: Broker, host: str = "127.0.0.1",
                 port: int = 0,
                 credentials: Optional[Tuple[str, str]] = None,
                 epoch: int = 0, cluster=None):
        super().__init__((host, port), _KafkaConn)
        self.broker = broker
        self.credentials = credentials
        self.port = self.server_address[1]
        #: the cluster view (``cluster.ShardView``: node_id, brokers(),
        #: leader_node(topic, partition), coordinator()); None is the
        #: single-broker server
        self.cluster = cluster
        #: the CLUSTER_ADMIN hook (``admin_command(command, args) ->
        #: dict``, the controller); None answers UNSUPPORTED_VERSION
        self.admin = None
        #: the reassignment step-down: once leadership has moved off this
        #: server, every PRODUCE and RAW_PRODUCE answers NOT_LEADER (so
        #: unstamped producers re-route too) while reads keep being
        #: served until the server is retired (``step_down``)
        self.retiring = False
        # appends admitted and not yet landed (``begin_write``)
        self._writes = 0
        self._writes_cond = threading.Condition()
        #: the leadership epoch this server serves at: a promotion bumps
        #: it (``FollowerReplica.promote``), and a restarted old leader
        #: comes back at its stale one and fences itself against
        #: epoch-stamped produce and commit traffic
        self.epoch = int(epoch)
        self._thread: Optional[threading.Thread] = None
        self._coordinators: dict = {}
        self._coord_lock = threading.Lock()
        self._live_conns: set = set()
        self._conn_lock = threading.Lock()

    def begin_write(self) -> bool:
        """Admit one PRODUCE or RAW_PRODUCE append (``end_write`` once it
        has landed); False once the server has stepped down."""
        with self._writes_cond:
            if self.retiring:
                return False
            self._writes += 1
            return True

    def end_write(self) -> None:
        with self._writes_cond:
            self._writes -= 1
            self._writes_cond.notify_all()

    def step_down(self, timeout_s: float = 10.0) -> bool:
        """Refuse every later PRODUCE and RAW_PRODUCE with NOT_LEADER and
        wait for the appends already admitted to land, so the log ends
        where its last write left it and a successor that mirrors it to
        that end holds every record this server took (the quorum waits
        of those appends need not be over).  False when they did not
        land in time.  Not in ``iotml``: its controller sets
        ``retiring`` and promotes at once, so an append racing the flag
        can be acked and be missing on the new leader."""
        with self._writes_cond:
            self.retiring = True
            return self._writes_cond.wait_for(lambda: self._writes == 0,
                                              timeout_s)

    def set_epoch(self, epoch: int) -> None:
        if epoch < self.epoch:
            raise ValueError(f"epoch must be monotonic: have {self.epoch}, "
                             f"got {epoch}")
        self.epoch = int(epoch)

    def group_coordinator(self, group_id: str,
                          session_timeout_s: Optional[float] = None):
        """The server-side ``GroupCoordinator`` of a group, created on
        first use; the first member that names a session timeout fixes
        it."""
        from .group import GroupCoordinator

        with self._coord_lock:
            coord = self._coordinators.get(group_id)
            if coord is None:
                coord = GroupCoordinator(
                    self.broker, group_id,
                    session_timeout_s=session_timeout_s or 10.0)
                self._coordinators[group_id] = coord
            return coord

    def start(self) -> "KafkaWireServer":
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True,
            name=f"iotml-torch-kafka-wire-{self.port}")
        self._thread.start()
        return self

    def __enter__(self) -> "KafkaWireServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()
        self.server_close()

    def kill(self) -> None:
        """Abrupt broker death (failover tests): ``shutdown()`` only stops
        the accept loop, and established handler threads keep serving
        their sockets, which a dead process would not; this severs every
        live client connection too."""
        self.shutdown()
        with self._conn_lock:
            conns = list(self._live_conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self.server_close()
