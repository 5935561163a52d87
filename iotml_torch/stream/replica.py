"""Follower replication and leader failover for the wire broker
(``iotml.stream.replica``'s copy).

The reference provisions replicated infrastructure: RF-3 Kafka topics on
a 3-broker cluster (reference 01_installConfluentPlatform.sh:180-183,
gcp.yaml:46-54); its pipeline survives a broker death.  The stream
plane's equivalent:

- ``FollowerReplica``: a wire server of its own that pulls a leader's
  topics (messages at the same offsets, the consumer groups' committed
  offsets too) into a local log, durable when given ``store_dir``.  The
  mirror rides RAW_FETCH (the leader's frames appended as they are) and
  pins back to FETCH against a leader without it.  With a
  ``replica_id`` its fetches feed the leader's ISR
  (``replication.ReplicationState``), which acks ``acks=all`` produces
  only below the quorum high-water mark; without one it is the plain
  asynchronous mirror, whose loss window is ``lag()``.
- Failover: ``promote(epoch)`` stops the mirror and serves the log at a
  new fencing epoch; clients re-resolve the published ``Topology`` (or
  walk their bootstrap list) and resume at the same offsets.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..chaos import faults as chaos
from ..obs import metrics as obs_metrics
from ..utils.backoff import ExpBackoff
from .broker import Broker, OffsetOutOfRangeError
from .kafka_wire import KafkaWireBroker, KafkaWireServer

#: wire-server epoch of an UNPROMOTED follower: no stamped epoch equals
#: it, so every fenced client is refused until promote() installs one
FOLLOWER_EPOCH = -1


class FollowerReplica:
    """Pull-replicate a leader's topics into a local wire-served log.

    Args:
      leader: bootstrap string of the leader (host:port).
      topics: topic names to mirror (None = every topic the leader
        lists, re-read each round so late topics join).
      groups: consumer groups whose committed offsets are mirrored.
      host/port: where this follower's own wire server listens.
      poll_interval_s: sleep between rounds once caught up.
      fetch_batch: records a classic fetch asks for.
      retention_messages: the local bound per mirrored topic (the wire
        does not carry the leader's retention).
      sasl: optional (user, password) for the leader connection.
      commit_interval_s: idle cadence of the commit mirror in the
        background loop (a round that copied records always mirrors).
      store_dir / store_policy: mount the local log durably; a restarted
        follower resumes from its retained end.  ``local`` injects a
        broker instead.
      partition_filter(topic, partition) -> bool: mirror only these.
      compacted_topics: topics mirrored with compacted semantics (their
        batches carry offset holes, replayed at their offsets).
      replica_id: >= 0 stamps this follower's id on its fetches, so a
        quorum leader's ISR tracks it; None is the anonymous mirror.
      topology: the leader connection re-resolves the current leader
        through it on every reconnect.
    """

    def __init__(self, leader: str, topics: Optional[List[str]] = None,
                 groups: Tuple[str, ...] = (), host: str = "127.0.0.1",
                 port: int = 0, poll_interval_s: float = 0.05,
                 fetch_batch: int = 2000,
                 retention_messages: Optional[int] = None,
                 sasl: Optional[tuple] = None,
                 commit_interval_s: float = 1.0,
                 store_dir: Optional[str] = None, store_policy=None,
                 partition_filter=None, local: Optional[Broker] = None,
                 compacted_topics: Tuple[str, ...] = (),
                 replica_id: Optional[int] = None, topology=None):
        self._retention = retention_messages
        self._owns = partition_filter or (lambda _t, _p: True)
        if local is not None and store_dir is not None:
            raise ValueError("pass either local= or store_dir=, not both")
        self.local = local if local is not None else \
            Broker(store_dir=store_dir, store_policy=store_policy)
        # epoch -1: not a leader.  An epoch-stamped produce or commit
        # reaching this follower before promotion is fenced (a failed-
        # over client must not write to a log replication still owns);
        # unstamped clients keep the open fixture semantics
        self.server = KafkaWireServer(self.local, host=host, port=port,
                                      epoch=FOLLOWER_EPOCH)
        user, pw = sasl if sasl is not None else (None, None)
        self.replica_id = replica_id
        self._leader = KafkaWireBroker(
            leader, client_id="iotml-replica", topology=topology,
            sasl_username=user, sasl_password=pw,
            replica_id=-1 if replica_id is None else int(replica_id))
        self._topics = topics
        #: the wire Metadata carries no topic config, so a wire follower
        #: is told which topics mirror with compacted semantics
        self._compacted = set(compacted_topics)
        self._groups = list(groups)
        self._interval = poll_interval_s
        self._commit_interval = commit_interval_s
        self._last_commit_sync = float("-inf")  # monotonic domain
        self._last_lag_probe = float("-inf")    # lag-gauge cadence
        self._batch = fetch_batch
        self._stop = threading.Event()
        # pause()/resume(): the background loop parks BETWEEN rounds (and
        # says so through _paused), so a test or promote() drives
        # sync_once() or kills the leader with no round in flight
        self._pause = threading.Event()
        self._paused = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._parts: Dict[str, int] = {}
        self.sync_errors: list = []
        self.rounds = 0
        self.promoted = False
        #: the RAW_FETCH mirror: None undecided, True in use, False
        #: pinned to the per-record leg (a leader without the extension,
        #: or IOTML_RAW_PRODUCE=off)
        self._raw_mirror: Optional[bool] = None
        try:
            from ..data.pipeline import raw_produce_mode

            if raw_produce_mode() == "off":
                self._raw_mirror = False
        except ValueError:
            self._raw_mirror = False
        self.raw_mirrored = 0  # records copied over the raw leg

    # -------------------------------------------------------- lifecycle
    @property
    def port(self) -> int:
        return self.server.port

    def start(self) -> "FollowerReplica":
        from ..supervise.registry import register_thread

        self.server.start()
        self._thread = register_thread(threading.Thread(
            target=self._run, daemon=True,
            name=f"iotml-replica-sync-{self.port}"))
        self._thread.start()
        return self

    def pause(self, timeout_s: float = 10.0) -> bool:
        """Park the background loop at the round barrier; returns once
        the round in flight (if any) has finished.  True at once when no
        loop runs."""
        self._pause.set()
        if self._thread is None or not self._thread.is_alive():
            return True
        return self._paused.wait(timeout=timeout_s)

    def resume(self) -> None:
        self._pause.clear()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.server.shutdown()
        self.server.server_close()
        try:
            self._leader.close()
        except OSError:
            pass
        self.local.close()  # a durable log releases its files

    def __enter__(self) -> "FollowerReplica":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------ replication
    def _run(self) -> None:
        # jittered backoff against a dead or dying leader: a fixed retry
        # busy-spins through a long outage, and unjittered retries from
        # a fleet of followers stampede the leader when it returns
        base = max(self._interval * 2, 0.01)
        backoff = ExpBackoff(base_s=base, cap_s=max(2.0, base))
        while not self._stop.is_set():
            if self._pause.is_set():
                self._paused.set()
                while self._pause.is_set() and not self._stop.is_set():
                    time.sleep(0.005)
                self._paused.clear()
                continue
            try:
                moved = self.sync_once(mirror_commits=None)
            except Exception as e:  # noqa: BLE001 - the leader may be
                # dying; the follower keeps serving what it has
                self.sync_errors.append(f"{type(e).__name__}: {e}")
                obs_metrics.replica_sync_errors.inc()
                time.sleep(backoff.next_delay())
                continue
            backoff.reset()
            self.rounds += 1
            obs_metrics.replica_sync_rounds.inc()
            # the loss-window gauge at the commit-mirror cadence: lag()
            # costs a ListOffsets a partition, too much for every round
            now = time.monotonic()
            if now - self._last_lag_probe >= self._commit_interval:
                self._last_lag_probe = now
                try:
                    self.lag()
                except (OSError, RuntimeError, KeyError):
                    pass  # leader dying: the sync error path owns this
            if not moved:
                time.sleep(self._interval)

    def sync_once(self, mirror_commits: Optional[bool] = True) -> int:
        """One replication round; returns the records copied.  A direct
        call mirrors the commit tables unconditionally; the background
        loop passes None (mirror after a round that copied, or once per
        ``commit_interval_s``)."""
        act = chaos.point("replica.sync")
        if act is not None and act.kind == "skip":
            return 0  # an injected pause: this round copies nothing
        names = self._topics if self._topics is not None \
            else self._leader.topics()
        copied = 0
        for t in names:
            spec = self._leader.topic(t)
            compacted = t in self._compacted or \
                getattr(spec, "cleanup_policy", "delete") == "compact"
            if t not in self._parts:
                if t not in self.local.topics():
                    self.local.create_topic(
                        t, partitions=spec.partitions,
                        retention_messages=self._retention,
                        cleanup_policy="compact" if compacted
                        else "delete")
                    # a late start: each empty partition begins at the
                    # leader's earliest retained offset, so copies land
                    # at IDENTICAL offsets
                    for p in range(spec.partitions):
                        if not self._owns(t, p):
                            continue
                        begin = self._leader.begin_offset(t, p)
                        if begin > 0:
                            self.local.align_base_offset(t, p, begin)
                self._parts[t] = spec.partitions
            for p in range(self._parts[t]):
                if self._owns(t, p):
                    copied += self._sync_partition(t, p, compacted)
        if copied:
            obs_metrics.replica_copied.inc(copied)
        if mirror_commits is None:
            mirror_commits = bool(copied) or (
                time.monotonic() - self._last_commit_sync
                >= self._commit_interval)
        if mirror_commits and self._groups:
            # ONE OffsetFetch a group over every mirrored partition (not
            # partition-filtered: a promoted follower inherits the whole
            # offsets table)
            pairs = [(t, p) for t in list(self._parts)
                     for p in range(self._parts[t])]
            for g in self._groups:
                for (t, p), off in self._leader.committed_many(
                        g, pairs).items():
                    self.local.commit(g, t, p, off)
            self._last_commit_sync = time.monotonic()
        return copied

    def _sync_partition(self, t: str, p: int, compacted: bool) -> int:
        """Mirror one partition up to the leader's end; records copied."""
        copied = 0
        while not self._stop.is_set():
            local_end = self.local.end_offset(t, p)
            if self._raw_mirror is not False:
                n, verdict = self._sync_raw(t, p, local_end, compacted)
                copied += n
                if verdict == "continue":
                    continue
                if verdict == "break":
                    break
                # "classic": the per-record leg takes this batch
            try:
                msgs = self._leader.fetch(t, p, local_end,
                                          max_messages=self._batch)
            except OffsetOutOfRangeError as e:
                # the leader's retention outran replication: realign at
                # its earliest retained offset
                begin = max(e.earliest, self._leader.begin_offset(t, p))
                if begin <= local_end:
                    break  # raced a concurrent trim; next round
                self._realign(t, p, local_end, begin)
                continue
            if not msgs:
                break
            if compacted:
                # holes here are compaction's, not trim loss: mirror at
                # the records' offsets (an in-memory local refuses a hole,
                # surfaced as a sync error, never renumbered)
                try:
                    for m in msgs:
                        self.local.produce_at(
                            t, p, m.offset, m.value, key=m.key,
                            timestamp_ms=m.timestamp_ms, headers=m.headers)
                except ValueError as e:
                    self.sync_errors.append(f"compacted {t}:{p}: {e}")
                    break
                copied += len(msgs)
                continue
            if msgs[0].offset != local_end:
                # trimmed past our cursor: appending at the local end
                # would shift every later offset
                self._realign(t, p, local_end, msgs[0].offset)
            for m in msgs:
                self.local.produce(t, m.value, key=m.key, partition=p,
                                   timestamp_ms=m.timestamp_ms,
                                   headers=m.headers)
            copied += len(msgs)
        return copied

    def _realign(self, t: str, p: int, local_end: int, begin: int) -> None:
        self.sync_errors.append(f"trimmed past cursor {t}:{p} "
                                f"{local_end}->{begin}; realigned")
        self.local.reset_partition(t, p, begin)

    def _sync_raw(self, t: str, p: int, local_end: int, compacted: bool):
        """One zero-copy round: RAW_FETCH the leader's frames, validate
        them, append the in-range bytes as they are (the leader's
        offsets already stamped: identical offsets and bytes).  Returns
        ``(records copied, verdict)``: ``continue`` (progress or a
        realignment: poll again), ``break`` (caught up) or ``classic``
        (the per-record leg takes this batch; a leader without RAW_FETCH
        pins the whole follower back)."""
        from ..data.pipeline import raw_batch_bytes
        from ..ops import framing

        try:
            raw = self._leader.fetch_raw(t, p, local_end,
                                         max_bytes=raw_batch_bytes())
        except NotImplementedError:
            self._raw_mirror = False  # one way, as every raw client
            return 0, "classic"
        except OffsetOutOfRangeError as e:
            begin = max(e.earliest, self._leader.begin_offset(t, p))
            if begin <= local_end:
                return 0, "break"  # raced a concurrent trim; next round
            self._realign(t, p, local_end, begin)
            return 0, "continue"
        if raw is None:
            return 0, "break"
        try:
            v = framing.validate_frame_batch(raw.data,
                                             start_offset=local_end)
        except framing.CorruptFrameError as e:
            # a corrupt frame mid-batch: the classic leg re-reads it
            self.sync_errors.append(f"raw mirror {t}:{p}: {e}")
            return 0, "classic"
        if v["count"] == 0:
            # a batch with no whole frame in range: torn at the cursor (a
            # record over the raw byte cap, which the classic leg takes,
            # so the mirror never parks) or alignment slack
            return 0, ("classic" if raw.data else "break")
        if not compacted and v["first"] != local_end:
            self._realign(t, p, local_end, v["first"])
        if compacted and not getattr(self.local, "durable", False) and \
                (v["first"] != local_end or not v["contiguous"]):
            # holes need a durable local (a dense list cannot hold them)
            return 0, "classic"
        blob = raw.data[v["start_pos"]:v["end_pos"]]
        try:
            self.local.produce_raw_at(t, p, blob)
        except ValueError as e:
            self.sync_errors.append(f"raw mirror {t}:{p}: {e}")
            return 0, "classic"
        self._raw_mirror = True
        self.raw_mirrored += v["count"]
        return v["count"], "continue"

    def lag(self) -> Dict[str, int]:
        """Records a topic the leader has that this follower lacks: the
        loss window if the leader died now.  Also the live gauge
        ``iotml_replica_lag_records{topic=...}``."""
        out: Dict[str, int] = {}
        for t, n in self._parts.items():
            out[t] = sum(
                max(0, self._leader.end_offset(t, p)
                    - self.local.end_offset(t, p))
                for p in range(n) if self._owns(t, p))
            obs_metrics.replica_lag.set(out[t], topic=t)
        return out

    # ---------------------------------------------------------- failover
    def promote(self, epoch: int) -> str:
        """Make this follower the SERVING LEADER at ``epoch``: stop the
        mirror (no round mid-copy while the log changes owner), drop the
        leader client, stamp the epoch on this follower's wire server (a
        resurrected old leader, still at its old epoch, then refuses
        current clients).  Returns the serving address for the topology
        publish."""
        if self.promoted:
            raise RuntimeError("already promoted")
        self._stop.set()
        # close the leader client BEFORE joining: a round stalled in recv
        # against a wedged leader fails fast instead of holding the join
        try:
            self._leader.close()
        except OSError:
            pass
        self.resume()  # a parked loop must see _stop
        if self._thread is not None:
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                # a round still running could append stale records after
                # post-failover produces: refuse to serve
                raise RuntimeError(
                    "sync loop did not stop within 10s; refusing to "
                    "promote over a possibly mid-copy log")
        self.server.set_epoch(epoch)
        self.promoted = True
        obs_metrics.failover_epoch.set(epoch)
        for t in self._parts:
            obs_metrics.replica_lag.set(0, topic=t)  # no leader: no lag
        host = self.server.server_address[0]
        return f"{host}:{self.port}"

    def caught_up(self, timeout_s: float = 10.0) -> bool:
        """Block until every mirrored topic's lag is zero (or timeout)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                if all(v == 0 for v in self.lag().values()) and self._parts:
                    return True
            except (OSError, RuntimeError, KeyError):
                pass
            time.sleep(0.05)
        return False
