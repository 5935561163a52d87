"""Partition-parallel fleets: scorers and KSQL pumps as consumer groups
(``iotml.cluster.fleet``'s copy).

The reference scales inference as a Deployment of predict pods in one
consumer group over 10 partitions: kill a pod and its partitions
rebalance to the survivors.  These fleets are that shape over the
partitioned cluster: each member is a ``GroupConsumer`` over the wire
group protocol (the coordinator pinned to one broker), fetching from
whichever shard leads each partition it was assigned.

Members are DRIVEN, not threaded, by default: ``pump_once()`` advances
every member one round deterministically (tests, the chaos runner), and
``start()`` runs each member on a registered daemon thread.  ``kill(i)``
stops driving member i without leaving the group, a crashed pod: the
coordinator expires it at its session timeout and the survivors inherit
its partitions at the last committed offsets.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Sequence

from ..stream.group import GroupConsumer
from ..stream.kafka_wire import RemoteGroupCoordinator


class _Member:
    """One member: a group-elastic consumer and its round's drive
    function; ``alive`` gates driving (``kill(i)`` clears it)."""

    __slots__ = ("name", "consumer", "drive", "alive", "rounds",
                 "payload", "client")

    def __init__(self, name: str, consumer: GroupConsumer,
                 drive: Callable[[], int], payload=None, client=None):
        self.name = name
        self.consumer = consumer
        self.drive = drive
        self.alive = True
        self.rounds = 0
        #: the member's worker (StreamScorer / StreamTask)
        self.payload = payload
        #: the member's own broker client: stop() closes its sockets
        self.client = client


class _Fleet:
    """The shared driving machinery; subclasses build the members."""

    def __init__(self):
        self.members: List[_Member] = []
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    def pump_once(self) -> int:
        """Drive every live member one round; the records handled."""
        n = 0
        for m in self.members:
            if m.alive:
                n += m.drive()
                m.rounds += 1
        return n

    def kill(self, i: int) -> None:
        """Stop driving member i WITHOUT leaving the group (a crashed
        pod): its partitions move to the survivors only after the
        coordinator's session timeout expires it."""
        self.members[i].alive = False

    def assignments(self) -> List[Sequence]:
        return [m.consumer.assignment for m in self.members]

    def start(self, poll_interval_s: float = 0.05) -> "_Fleet":
        from ..supervise.registry import register_thread

        self._stop.clear()
        self._threads = []
        for m in self.members:
            def run(m=m):
                while not self._stop.is_set():
                    if m.alive:
                        moved = m.drive()
                        m.rounds += 1
                        if moved:
                            continue
                    self._stop.wait(poll_interval_s)

            t = register_thread(threading.Thread(
                target=run, daemon=True,
                name=f"iotml-torch-fleet-{m.name}"))
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        for m in self.members:
            if m.alive:
                try:
                    m.consumer.close()  # commit and leave cleanly
                except (ConnectionError, RuntimeError, OSError):
                    pass
            # a dead member keeps a crashed pod's semantics (no commit,
            # no leave), but its sockets are released all the same
            if m.client is not None:
                try:
                    m.client.close()
                except (ConnectionError, RuntimeError, OSError):
                    pass


class ScorerFleet(_Fleet):
    """N partition-parallel ``StreamScorer`` members in one group.

    Each member scores its share of the input partitions (the group's
    assignment) and writes its predictions to its OWN partition of the
    output topic, so each member's ``OutputSequence`` stays one ordered
    stream, one partition a member as the reference's predict pods.

    Args:
      client_factory: () -> broker duck-type, a fresh ``ClusterClient``
        a member (members must not share a coordinator connection).
      model / params: as ``StreamScorer``.
      in_topic / group: the scored stream and the fleet's group.
      out_topic: the predictions topic (the caller creates it with at
        least ``n_members`` partitions).
      registry: a ``mlops.ModelRegistry`` whose serving channel one
        shared ``RegistryWatcher`` follows, hot-swapping EVERY member
        between rounds (``pump_once``) or on its thread (``start``).
      device: where the members' forwards run (the card unless given).

    Each member's ``SensorBatches`` takes the columnar path over the raw
    frames the ``ClusterClient`` routes whenever the owning shards serve
    RAW_FETCH; the process knobs IOTML_DECODE_RING_BUFFERS and
    IOTML_RAW_BATCH_BYTES (``data.pipeline``; ``cluster up`` flags) tune
    every member's pipeline at once.
    """

    def __init__(self, client_factory, model, params, n_members: int,
                 in_topic: str, out_topic: str,
                 group: str = "scorer-fleet",
                 session_timeout_ms: int = 10_000,
                 batch_size: int = 100, registry=None,
                 registry_poll_s: float = 0.25, device=None):
        super().__init__()
        from ..data.dataset import SensorBatches
        from ..serve.scorer import StreamScorer
        from ..stream.producer import OutputSequence
        from ..utils.device import resolve_device

        self.group = group
        self.device = resolve_device(device)
        self.watcher = None
        if registry is not None:
            from ..mlops.rollout import RegistryWatcher

            self.watcher = RegistryWatcher(registry,
                                           poll_interval_s=registry_poll_s)
        for i in range(n_members):
            client = client_factory()
            coord = RemoteGroupCoordinator(
                client, group, session_timeout_ms=session_timeout_ms)
            consumer = GroupConsumer(coord, [in_topic])
            batches = SensorBatches(consumer, batch_size=batch_size,
                                    only_normal=False)
            out = OutputSequence(client, out_topic, partition=i)
            scorer = StreamScorer(model, params, batches, out,
                                  device=self.device)

            def drive(scorer=scorer, consumer=consumer):
                try:
                    return scorer.score_available()
                except ConnectionError:
                    consumer.rewind_to_committed()
                    return 0

            self.members.append(_Member(f"scorer-{i}", consumer, drive,
                                        payload=scorer, client=client))
            if self.watcher is not None:
                self.watcher.attach(scorer)

    def pump_once(self) -> int:
        if self.watcher is not None:
            # swap before driving: a promotion lands on every member at
            # the same point, between fleet rounds
            self.watcher.poll_once()
        return super().pump_once()

    def start(self, poll_interval_s: float = 0.05) -> "_Fleet":
        if self.watcher is not None:
            self.watcher.start()
        return super().start(poll_interval_s)

    def stop(self) -> None:
        if self.watcher is not None:
            self.watcher.stop()
        super().stop()

    def scored(self) -> int:
        return sum(m.payload.scored for m in self.members)


class PumpFleet(_Fleet):
    """N group-elastic KSQL pump members over one task class.

    Each member is a ``StreamTask`` of its own whose consumer is a
    ``GroupConsumer`` of the shared group: the task's source partitions
    split across the members and rebalance on a death.  A task with a
    raw leg (``process_raw``) produces RAW batches to its partitions
    through the member's ``ClusterClient.produce_raw``, routed to the
    owning shard; IOTML_RAW_PRODUCE / IOTML_PRODUCE_BATCH_BYTES
    (``cluster up --raw-produce / --produce-batch-bytes``) select that
    plane for every member at once.
    """

    def __init__(self, client_factory, task_factory, n_members: int,
                 src_topic: str, group: str = "pump-fleet",
                 session_timeout_ms: int = 10_000):
        super().__init__()
        self.group = group
        for i in range(n_members):
            client = client_factory()
            coord = RemoteGroupCoordinator(
                client, group, session_timeout_ms=session_timeout_ms)
            consumer = GroupConsumer(coord, [src_topic])
            task = task_factory(client, consumer)

            def drive(task=task):
                try:
                    return task.process_available()
                except ConnectionError:
                    task.consumer.rewind_to_committed()
                    return 0

            self.members.append(_Member(f"pump-{i}", consumer, drive,
                                        payload=task, client=client))
