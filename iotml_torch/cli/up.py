"""One-command platform bring-up (``iotml.cli.up``'s twin, cut to what
the port has).

The reference provisions its stack with Terraform shelling into
`01_installConfluentPlatform.sh` (Prometheus operator, ZK/Kafka/SR/Connect/
KSQL via Helm, topic creation, KSQL DDL) plus `hivemq/setup.sh` (MQTT
broker + Kafka extension) — hundreds of lines of orchestration before the
first record can flow (SURVEY §2.6, §3.5).  Here the same platform comes up
in one process:

    python -m iotml_torch.cli.up [--sasl user:pass] [--fleet N] [--quiet]

brings up and prints endpoints for
  - the stream broker, served over the real Kafka wire protocol (TCP,
    optional SASL/PLAIN like the reference's `gcp.yaml:29-32`), with the
    reference's topics pre-created (`sensor-data`, `model-predictions`,
    10 partitions — `01_installConfluentPlatform.sh:180-183`)
  - an MQTT broker behind the epoll front (TCP) bridged into
    `sensor-data` with the reference's topic mapping
    `vehicles/sensor/data/#` (`kafka-config.yaml:20-29`)
  - the Schema Registry REST API (with both car schemas pre-registered)
  - the KSQL-equivalent REST API, reference DDL pipeline pre-installed,
    the engine owning `SENSOR_DATA_S_AVRO`
  - the Kafka-Connect REST API (`connect`), with the car-health twin: a
    `DocumentStoreSink` (`car-health-twin`) upserting the `car-health`
    topic's alert records by car
  - a Prometheus /metrics + /healthz exporter
  - with `--registry DIR`, a versioned model registry and a watcher on
    its serving channel
  - with `--durable` / `--store-dir DIR`, the broker on a durable
    segmented log (`store`): crash recovery, persisted consumer offsets,
    disk retention, a background compactor; with `--tier-uri URI` also
    a remote tier (a directory or `gs://…`) and its background uploader

With `--fleet N`, N simulated cars publish continuously over real MQTT.
Ctrl-C stops everything.  This is also importable:
`Platform(device="cpu").start()` in the tests.  `Platform` and `main` resolve a device (``cuda`` unless the
caller passes another; no card and no device given raises) and hand it
to what a caller attaches to the platform (``Platform.device``).

The store directory comes from `--store-dir`, else the config's
`store.dir` (`IOTML_STORE_DIR`), else with `--durable` `iotml-store` in
the temporary directory; the fsync, segment and retention policy ride the
`store.*` section, the tier's budget and cadence the `tier.*` section, as
in the JAX package; `--tier-uri` without durable mode is a usage error.

`cc_port` / `--cc-port` serve the control center (`obs.control_center`:
`GET /` and `GET /api/status`, its row `control-center` in
`endpoints()`), and `connect_port` / `--connect-port` Kafka Connect and
the car-health twin (`connect`, its row `connect`); the command line
always serves both (port 0 by default, as in the JAX package),
`Platform` each when given a port.

With `--supervise` (or `IOTML_SUPERVISE=1`) the component lifecycles
run under a supervisor (``Platform.supervised()``): a crashed serving
thread restarts under backoff, and a trainer's checkpoint writer handed
to ``attach_checkpointer`` runs as a supervised loop.

``pump()`` advances the KSQL queries and the connectors once;
``drain_ingest()`` waits until every message the simulated fleet sent is
bridged and the KSQL outputs stop moving.  `--prefetch-depth`,
`--decode-ring-buffers`, `--raw-batch-bytes`, `--raw-produce` and
`--produce-batch-bytes` set their knobs through ``data.pipeline.set_knobs`` before the platform is
built, as in the JAX package; an invalid value is a usage error.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import threading
import time
from typing import Optional

from ..utils.device import DeviceLike, resolve_device


class Platform:
    """All ported reference services over one in-process broker."""

    def __init__(self, sasl: Optional[tuple] = None, partitions: int = 10,
                 kafka_port: int = 0, mqtt_port: int = 0,
                 registry_port: int = 0, ksql_port: int = 0,
                 connect_port: Optional[int] = None,
                 host: str = "127.0.0.1",
                 retention_messages: Optional[int] = None,
                 cc_port: Optional[int] = None,
                 store_dir: Optional[str] = None, store_policy=None,
                 tier=None,
                 trusted_passthrough: Optional[bool] = None,
                 registry_dir: Optional[str] = None,
                 registry_watch_poll_s: float = 0.25,
                 device: DeviceLike = None):
        #: the device the platform's consumers (trainers, scorers) run on
        self.device = resolve_device(device)
        from ..core.schema import CAR_SCHEMA, KSQL_CAR_SCHEMA
        from ..mqtt.bridge import KafkaBridge
        from ..mqtt.broker import MqttBroker
        from ..mqtt.eventserver import MqttEventServer
        from ..obs import metrics as obs_metrics
        from ..stream import Broker, SchemaRegistry, SchemaRegistryServer
        from ..stream.kafka_wire import KafkaWireServer
        from ..stream.registry import subject_for_topic
        from ..streamproc import KsqlServer, SqlEngine
        from ..streamproc.sql import install_reference_pipeline

        # durable mode (store): every partition a crash-recoverable
        # segmented log, consumer offsets persisted, and a restarted
        # platform re-serves everything it acked
        self.store_dir = store_dir
        self.broker = Broker(store_dir=store_dir, store_policy=store_policy,
                             tier=tier)
        # a durable broker gets the background dirty-ratio compactor (a
        # no-op cadence without compact topics), a tiered one the
        # uploader; built here, started in start() like every other
        # component thread
        self.compactor = None
        self.uploader = None
        if self.broker.store is not None:
            from ..store import StoreCompactor, TierUploader

            self.compactor = StoreCompactor(
                self.broker,
                interval_s=self.broker.store.policy.compact_interval_s)
            if tier:
                self.uploader = TierUploader(self.broker,
                                             interval_s=tier.interval_s)
        # the reference's two topics, its partition count.  retention
        # bounds the log for long-running platforms (the reference sets
        # retention.ms=100000 — aggressive 100s retention,
        # 01_installConfluentPlatform.sh:180-183); None keeps everything
        # in memory and inherits the store.* default when durable
        self.broker.create_topic("sensor-data", partitions=partitions,
                                 retention_messages=retention_messages)
        self.broker.create_topic("model-predictions", partitions=partitions,
                                 retention_messages=retention_messages)

        self.host = host
        self.kafka = KafkaWireServer(self.broker, host=host, port=kafka_port,
                                     credentials=sasl)
        self.registry = SchemaRegistry()
        self.registry.register(subject_for_topic("sensor-data"),
                               CAR_SCHEMA.avro_json())
        self.registry.register(subject_for_topic("SENSOR_DATA_S_AVRO"),
                               KSQL_CAR_SCHEMA.avro_json())
        self.registry_server = SchemaRegistryServer(self.registry, host=host,
                                                    port=registry_port)

        # trusted pass-through: the REKEY leg reads the AVRO leg this same
        # engine encodes in-process.  The premise (only the engine writes
        # the AVRO leg) is enforced: the broker marks SENSOR_DATA_S_AVRO*
        # engine-owned, and a wire producer gets TOPIC_AUTHORIZATION_FAILED.
        # Trust defaults off when the platform binds a non-loopback
        # address; on loopback one batch in 32 is still validated.
        exposed = host not in ("127.0.0.1", "localhost", "::1")
        if trusted_passthrough is None:
            trusted_passthrough = not exposed
        owner = self.broker.restrict_topic("SENSOR_DATA_S_AVRO")
        self.sql = SqlEngine(self.broker, registry=self.registry,
                             trusted_passthrough=trusted_passthrough,
                             owner_token=owner,
                             passthrough_sample=32)
        install_reference_pipeline(self.sql)
        self.ksql = KsqlServer(self.sql, host=host, port=ksql_port)

        # Kafka Connect, when a port was given (0 binds a free one), with
        # the digital twin for car health (the reference's MongoDB sink on
        # the car stream, mongodb-connector-configmap.yaml:6-23): the
        # per-car failure detector publishes keyed alert records onto
        # `car-health` (serve/carhealth.py) and this sink upserts them by
        # car id; the control center lists the active alerts, and the
        # ConnectServer's driver thread pumps the sink once started
        self.connect_worker = None
        self.connect = None
        self.car_twin = None
        if connect_port is not None:
            from ..connect import (ConnectServer, ConnectWorker,
                                   DocumentStoreSink)

            self.connect_worker = ConnectWorker(self.broker)
            self.connect = ConnectServer(self.connect_worker, host=host,
                                         port=connect_port)
            self.broker.create_topic("car-health",
                                     retention_messages=retention_messages)
            self.car_twin = DocumentStoreSink(id_field="car")
            self.connect.register_sink(
                "car-health-twin", self.car_twin, ["car-health"],
                kind="DocumentStoreSink",
                config={"connector.class": "DocumentStoreSink",
                        "topics": "car-health", "document.id.field": "car"})

        self.mqtt_broker = MqttBroker()
        self.bridge = KafkaBridge(self.mqtt_broker, self.broker,
                                  partitions=partitions)
        # the epoll front: fleet-scale connection counts + HiveMQ-style
        # overload protection (watermark backpressure, slow-consumer
        # eviction) — same MqttProtocol semantics as the threaded server
        self.mqtt = MqttEventServer(self.mqtt_broker, host=host,
                                    port=mqtt_port)

        # model-lifecycle wing (mlops): mount the versioned registry,
        # sweep torn publishes from a prior kill, and keep a watcher on
        # the serving channel — scorers attach to it.  A trainer hands
        # its AsyncCheckpointer to attach_checkpointer() so supervised()
        # owns the writer loop
        self.registry_dir = registry_dir
        self.model_registry = None
        self.registry_watcher = None
        self.checkpoint_writer = None
        if registry_dir:
            from ..mlops import ModelRegistry
            from ..mlops.rollout import RegistryWatcher

            self.model_registry = ModelRegistry(registry_dir,
                                                component="platform")
            self.model_registry.recover()
            self.registry_watcher = RegistryWatcher(
                self.model_registry, component="platform",
                poll_interval_s=registry_watch_poll_s)

        #: the status UI, when a port was given (0 binds a free one)
        self.control_center = None
        if cc_port is not None:
            from ..obs.control_center import ControlCenter

            self.control_center = ControlCenter(self, host=host, port=cc_port)
        self._obs = obs_metrics
        self.metrics_server = None
        self._fleet_stop = threading.Event()
        self._fleet_thread: Optional[threading.Thread] = None
        self._fleet_published = 0
        self._fleet_lock = threading.Lock()
        self.started = False

    def attach_checkpointer(self, checkpointer):
        """Register a trainer's AsyncCheckpointer so ``supervised()`` runs
        its writer as a supervised unit (a crash restarts it under
        backoff, pending snapshots surviving in the queue)."""
        self.checkpoint_writer = checkpointer
        return checkpointer

    def start(self, metrics_port: Optional[int] = None) -> "Platform":
        self.kafka.start()
        self.registry_server.start()
        self.ksql.start()
        if self.connect is not None:
            self.connect.start()
        self.mqtt.start()
        if self.registry_watcher is not None:
            self.registry_watcher.start()
        if self.compactor is not None:
            self.compactor.start()
        if self.uploader is not None:
            self.uploader.start()
        if metrics_port is not None:
            self.metrics_server = self._obs.start_http_server(metrics_port)
        if self.control_center is not None:
            self.control_center.start()
        self.started = True
        return self

    def endpoints(self) -> dict:
        out = {} if self.store_dir is None else {"store": self.store_dir}
        if self.uploader is not None:
            out["tier"] = self.broker.store.tier.uri
        if self.registry_dir:
            out["registry"] = self.registry_dir
        out.update({
            "kafka": f"{self.host}:{self.kafka.port}",
            "mqtt": f"{self.host}:{self.mqtt.port}",
            "schema-registry": self.registry_server.url,
            "ksql": self.ksql.url,
        })
        if self.connect is not None:
            out["connect"] = self.connect.url
        if self.control_center is not None:
            out["control-center"] = self.control_center.url
        if self.metrics_server is not None:
            out["metrics"] = "http://127.0.0.1:" + \
                str(self.metrics_server.server_address[1]) + "/metrics"
        return out

    # ------------------------------------------------------------- fleet
    def start_fleet(self, num_cars: int, rate_hz: float = 1.0,
                    failure_rate: float = 0.01) -> None:
        """Continuous simulated fleet publishing over real MQTT (the device
        simulator's role, `scenario.xml` semantics at 1 msg/`rate_hz`)."""
        from ..core.schema import KSQL_CAR_SCHEMA
        from ..gen.simulator import FleetGenerator, FleetScenario
        from ..mqtt.wire import MqttClient

        scenario = FleetScenario(num_cars=num_cars, failure_rate=failure_rate)
        gen = FleetGenerator(scenario)

        def run():
            import json as _json

            # socket budget: at most 64 TCP connections; cars beyond that
            # multiplex round-robin over the open connections (every car
            # still publishes on its own MQTT topic every tick)
            n_conns = min(num_cars, 64)
            # connect to the address the platform actually listens on; a
            # wildcard bind is reachable via loopback
            connect_host = "127.0.0.1" if self.host in ("0.0.0.0", "::") \
                else self.host
            clients = [
                MqttClient(connect_host, self.mqtt.port, scenario.car_id(i))
                for i in range(n_conns)
            ]
            try:
                while not self._fleet_stop.wait(1.0 / rate_hz):
                    cols = gen.step_columns()
                    for i in range(num_cars):
                        rec = gen.row_record(cols, i, KSQL_CAR_SCHEMA)
                        clients[i % n_conns].publish(
                            f"vehicles/sensor/data/{scenario.car_id(i)}",
                            _json.dumps(rec).encode(), qos=0)
                        with self._fleet_lock:
                            self._fleet_published += 1
            finally:
                for c in clients:
                    try:
                        c.disconnect()
                    except OSError:
                        pass

        from ..supervise.registry import register_thread

        self._fleet_thread = register_thread(threading.Thread(
            target=run, daemon=True, name="iotml-fleet"))
        self._fleet_thread.start()

    def stop_fleet(self) -> None:
        """Stop the simulated fleet: join its publisher after its last
        send.  The MQTT front may still hold frames it has not parsed;
        ``drain_ingest`` waits for them."""
        self._fleet_stop.set()
        if self._fleet_thread is not None:
            self._fleet_thread.join(timeout=10)
            self._fleet_thread = None

    def fleet_published(self) -> int:
        """Messages the simulated fleet has sent to the MQTT front."""
        with self._fleet_lock:
            return self._fleet_published

    def _ksql_ends(self) -> dict:
        topics = set(self.broker.topics())
        return {(q.task.dst, p): self.broker.end_offset(q.task.dst, p)
                for q in list(self.sql.queries.values())
                if q.task.dst in topics
                for p in range(self.broker.topic(q.task.dst).partitions)}

    def drain_ingest(self, deadline_s: float = 30.0) -> int:
        """Wait until the bridge has forwarded every message the fleet
        published, then pump the continuous queries until their output
        topics' end offsets stop moving; returns the messages bridged.
        Past the deadline it raises TimeoutError saying how many messages
        are missing: it never returns a short stream quietly."""
        deadline = time.monotonic() + deadline_s
        want = self.fleet_published()
        while self.bridge.forwarded() < want:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ingest drain: {want - self.bridge.forwarded()} of "
                    f"{want} published messages not bridged after "
                    f"{deadline_s}s")
            time.sleep(0.01)
        ends = None
        while True:
            emitted = self.pump()
            now = self._ksql_ends()
            if emitted == 0 and now == ends:
                return self.bridge.forwarded()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ingest drain: the KSQL outputs still moved after "
                    f"{deadline_s}s ({emitted} records in the last pump)")
            ends = now

    def pump(self) -> int:
        """Advance the continuous queries and the connectors once
        (deterministic); returns the queries' records."""
        n = self.ksql.pump_now()
        if self.connect is not None:
            self.connect.pump_now()
        return n

    # ------------------------------------------------------- supervision
    def supervised(self, poll_interval_s: Optional[float] = None):
        """A Supervisor owning this platform's component lifecycles.

        ``start()`` alone launches every component fire-and-forget; this
        wraps each component's serving thread in a probed unit, so a
        crashed accept loop, pump loop or event loop is detected and its
        thread respawned under backoff: the kubelet role the reference
        gives to Kubernetes Deployments.  The units: ``kafka-wire``,
        ``mqtt-front``, ``ksql-tasks`` (the pump thread alone respawned),
        ``connect-driver`` (the Connect driver thread alone, when the
        platform serves Connect), ``schema-registry``, ``control-center``
        (when the platform serves one), ``fleet`` (when a fleet runs),
        ``registry-watcher`` (with a registry) and the ``ckpt-writer``
        loop (with an attached checkpointer).  The MQTT→Kafka bridge has
        no thread of its own and needs no unit.  ``poll_interval_s``
        defaults to ``IOTML_SUPERVISE_POLL_S``, else 0.25.  Returns the
        Supervisor; the caller starts and stops it."""
        from ..supervise.registry import register_thread
        from ..supervise.supervisor import Supervisor

        if poll_interval_s is None:
            # laxer than the Supervisor's own default (these probe thread
            # liveness, not failover), but the knob wins when set
            poll_interval_s = float(os.environ.get(
                "IOTML_SUPERVISE_POLL_S", "0.25"))
        sup = Supervisor(poll_interval_s=poll_interval_s,
                         name="platform-supervisor")

        def thread_alive(get_thread):
            def probe():
                t = get_thread()
                return t is not None and t.is_alive()
            return probe

        def respawn(get_thread, spawn):
            def restart():
                t = get_thread()
                if t is None or not t.is_alive():
                    spawn()
            return restart

        def probed(name, get_thread, spawn=None):
            sup.add_probed(name, thread_alive(get_thread),
                           restart=None if spawn is None
                           else respawn(get_thread, spawn))

        def spawn_ksql_pump():
            # the pump thread alone: KsqlServer.start() would also start a
            # second REST serving thread
            self.ksql._pump_thread = register_thread(threading.Thread(
                target=self.ksql._pump_loop, daemon=True,
                name="iotml-ksql-pump"))
            self.ksql._pump_thread.start()

        probed("kafka-wire", lambda: self.kafka._thread, self.kafka.start)
        probed("mqtt-front", lambda: self.mqtt._thread, self.mqtt.start)
        probed("ksql-tasks", lambda: self.ksql._pump_thread,
               spawn_ksql_pump)
        if self.connect is not None:
            def spawn_connect_driver():
                self.connect._driver = register_thread(threading.Thread(
                    target=self.connect._drive, daemon=True,
                    name="iotml-connect-driver"))
                self.connect._driver.start()

            probed("connect-driver", lambda: self.connect._driver,
                   spawn_connect_driver)
        for name, rest in (("schema-registry", self.registry_server),
                           ("control-center", self.control_center)):
            if rest is not None:
                probed(name, lambda r=rest: r._thread, rest.start)
        if self._fleet_thread is not None:
            probed("fleet", lambda: self._fleet_thread)
        # the model-lifecycle units: the watcher's poll thread is probed
        # and respawned like a serving thread; an attached writer runs as
        # a supervised loop, restarted with its queue intact
        if self.registry_watcher is not None:
            probed("registry-watcher",
                   lambda: self.registry_watcher._thread,
                   self.registry_watcher.start)
        if self.checkpoint_writer is not None:
            sup.add_loop("ckpt-writer", self.checkpoint_writer.unit_loop(),
                         heartbeat_timeout_s=30.0)
        return sup

    def stop(self) -> None:
        self._fleet_stop.set()
        if self._fleet_thread is not None:
            self._fleet_thread.join(timeout=3)
        if self.registry_watcher is not None:
            self.registry_watcher.stop()
        if self.checkpoint_writer is not None:
            self.checkpoint_writer.stop(flush=True)
        for s in (self.connect, self.ksql, self.registry_server,
                  self.control_center):
            if s is not None:
                s.stop()
        self.kafka.shutdown()
        self.kafka.server_close()
        self.mqtt.stop()
        if self.metrics_server is not None:
            self.metrics_server.shutdown()
            self.metrics_server.server_close()
            self.metrics_server = None
        if self.uploader is not None:
            self.uploader.stop()
        if self.compactor is not None:
            self.compactor.stop()
        self.broker.close()  # durable: fsync + release fds (no-op else)
        self.started = False


def main(argv=None, device: DeviceLike = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m iotml_torch.cli.up",
        description="Bring up the streaming-ML platform in one process")
    ap.add_argument("--sasl", metavar="USER:PASS", default=None,
                    help="require SASL/PLAIN on the Kafka wire port")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="start N simulated cars publishing over MQTT")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="fleet publish rate per car (Hz)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address for every server (0.0.0.0 in a pod)")
    ap.add_argument("--kafka-port", type=int, default=0)
    ap.add_argument("--mqtt-port", type=int, default=0)
    ap.add_argument("--registry-port", type=int, default=0)
    ap.add_argument("--ksql-port", type=int, default=0)
    ap.add_argument("--connect-port", type=int, default=0,
                    help="Kafka Connect REST port (connectors, the "
                         "car-health twin)")
    ap.add_argument("--cc-port", type=int, default=0,
                    help="control-center UI port (topics/queries/metrics)")
    ap.add_argument("--metrics-port", type=int, default=9100)
    ap.add_argument("--retention", type=int, default=0, metavar="N",
                    help="keep at most N messages per partition "
                         "(0 = unbounded; the reference retains ~100s). "
                         "Validated by the broker (negative rejected).")
    ap.add_argument("--durable", action="store_true",
                    help="mount the broker on a durable segmented log "
                         "(store): crash recovery, persisted consumer "
                         "offsets, disk retention.  Dir from --store-dir "
                         "/ IOTML_STORE_DIR / iotml-store in the "
                         "temporary directory; fsync & retention knobs "
                         "ride the store.* config section.")
    ap.add_argument("--store-dir", default=None, metavar="DIR",
                    help="store directory for --durable (also enables "
                         "durable mode when given)")
    ap.add_argument("--tier-uri", default=None, metavar="URI",
                    help="object-store URI (gs://... or a local path) for "
                         "tiered storage: sealed segments upload to the "
                         "remote tier and the local dir becomes a hot "
                         "cache.  Requires durable mode.  Also via "
                         "IOTML_TIER_URI; budget/lag knobs ride the "
                         "tier.* config section.")
    ap.add_argument("--registry", default=None, metavar="DIR",
                    help="mount a versioned model registry (mlops): "
                         "torn publishes swept at boot, the serving "
                         "channel watched.  Also via "
                         "IOTML_MLOPS_REGISTRY_DIR.")
    ap.add_argument("--supervise", action="store_true",
                    help="run component lifecycles under the supervisor "
                         "(crashed serving threads restart under "
                         "backoff).  Also enabled by IOTML_SUPERVISE=1.")
    ap.add_argument("--trust-passthrough", dest="trust_passthrough",
                    action="store_true", default=None,
                    help="opt back into trusted pass-through on a "
                         "non-loopback host (default: exposed platforms "
                         "fully re-validate pass-through batches; "
                         "loopback trusts with 1-in-32 sampling)")
    ap.add_argument("--prefetch-depth", type=int, default=None,
                    metavar="N",
                    help="host-to-device prefetch queue depth for every "
                         "prefetching pipeline this process builds (sets "
                         "IOTML_PREFETCH_DEPTH; default 2, min 1)")
    ap.add_argument("--decode-ring-buffers", type=int, default=None,
                    metavar="N",
                    help="reusable columnar decode buffers per pipeline "
                         "(sets IOTML_DECODE_RING_BUFFERS; default 4, "
                         "min 2)")
    ap.add_argument("--raw-batch-bytes", type=int, default=None,
                    metavar="BYTES",
                    help="max bytes per raw frame fetch on the columnar "
                         "consume path (sets IOTML_RAW_BATCH_BYTES; "
                         "default 1 MiB)")
    ap.add_argument("--raw-produce", default=None,
                    choices=("auto", "on", "off"),
                    help="raw produce plane (sets IOTML_RAW_PRODUCE): "
                         "auto = RAW_PRODUCE where supported with classic "
                         "fallback, on = raw required, off = classic "
                         "everywhere")
    ap.add_argument("--produce-batch-bytes", type=int, default=None,
                    metavar="BYTES",
                    help="max frame bytes per RAW_PRODUCE request "
                         "(sets IOTML_PRODUCE_BATCH_BYTES; default "
                         "1 MiB)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    from ..data.pipeline import set_knobs

    try:
        set_knobs(prefetch_depth=args.prefetch_depth,
                  decode_ring_buffers=args.decode_ring_buffers,
                  raw_batch_bytes=args.raw_batch_bytes,
                  produce_batch_bytes=args.produce_batch_bytes,
                  raw_produce=args.raw_produce)
    except ValueError as e:
        ap.error(str(e))

    from ..config import load_config
    from ..store import StorePolicy, TierPolicy

    cfg, _ = load_config([])
    sasl = tuple(args.sasl.split(":", 1)) if args.sasl else None
    # the store.* section (file < IOTML_STORE_* env) supplies the durable
    # dir and its policy; the flags win
    store_dir = args.store_dir or (
        (cfg.store.dir or os.path.join(tempfile.gettempdir(), "iotml-store"))
        if args.durable else (cfg.store.dir or None))
    tier = None
    if store_dir:
        tier = TierPolicy.from_config(cfg.tier)
        if args.tier_uri:
            tier.uri = args.tier_uri
        if not tier:
            tier = None
    elif args.tier_uri:
        ap.error("--tier-uri requires durable mode (--durable/--store-dir)")
    try:
        plat = Platform(sasl=sasl, host=args.host,
                        kafka_port=args.kafka_port,
                        mqtt_port=args.mqtt_port,
                        # 0 (the default) = UNSET, so durable topics
                        # inherit the store.* retention policy; negatives
                        # still reach the broker's validation below
                        retention_messages=args.retention
                        if args.retention else None,
                        store_dir=store_dir,
                        store_policy=(StorePolicy.from_config(cfg.store)
                                      if store_dir else None),
                        tier=tier,
                        registry_port=args.registry_port,
                        ksql_port=args.ksql_port,
                        connect_port=args.connect_port,
                        trusted_passthrough=args.trust_passthrough,
                        registry_dir=args.registry
                        or (cfg.mlops.registry_dir or None),
                        registry_watch_poll_s=cfg.mlops.watch_poll_s,
                        cc_port=args.cc_port, device=device)
    except ValueError as e:  # e.g. negative retention: clean usage error
        ap.error(str(e))
    supervise = args.supervise or os.environ.get(
        "IOTML_SUPERVISE", "").strip().lower() in ("1", "true", "yes", "on")
    sup = None
    try:
        plat.start(metrics_port=args.metrics_port)
        if args.fleet:
            plat.start_fleet(args.fleet, rate_hz=args.rate)
        if supervise:
            sup = plat.supervised().start()
        if not args.quiet:
            print("iotml platform up:")
            for k, v in plat.endpoints().items():
                print(f"  {k:16s} {v}")
            if args.fleet:
                print(f"  fleet            {args.fleet} cars @ {args.rate} "
                      f"Hz → mqtt topic vehicles/sensor/data/<car>")
            print(f"  device           {plat.device}")
            if sup is not None:
                print(f"  supervisor       {len(sup.units())} units "
                      f"(self-healing; states on /healthz)")
            print("Ctrl-C to stop.", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
    finally:
        if sup is not None:
            sup.stop()
        plat.stop()
    if not args.quiet:
        print("stopped.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
