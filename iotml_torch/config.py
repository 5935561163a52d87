"""Typed configuration (``iotml.config``'s resolver and its sections).

One dataclass tree with one resolution order:

    defaults  <  config file (JSON)  <  environment  <  CLI flags

Environment keys: ``IOTML_<SECTION>_<FIELD>`` (e.g. ``IOTML_TRAIN_EPOCHS``,
``IOTML_BROKER_SASL_USERNAME``).  CLI flags: ``--<section>.<field>=<value>``
(or ``--<section>.<field> <value>``).
Values are coerced to the field's type, so a typo'd value fails at load
time.  An unknown section or field raises ValueError, as in the JAX
package, and so does a key the JAX package parses and never reads
(``UNREAD_KEYS``: the whole ``stream``, ``artifacts`` and ``scenario``
sections and ``mesh.seq`` among them, kept so ``Config()`` has the JAX
package's sections), so a setting is never dropped quietly.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class BrokerConfig:
    """Stream-broker connection (the reference's Kafka client config):
    the SASL/PLAIN credentials the wire client sends to a ``host:port``
    server (the deploy manifests set ``IOTML_BROKER_SASL_USERNAME`` and
    ``IOTML_BROKER_SASL_PASSWORD``)."""

    sasl_username: str = ""       # reference: hard-coded 'test'
    sasl_password: str = ""


@dataclasses.dataclass
class StreamConfig:
    """Topics and cursor: the reference CLI's positional arguments (never
    read: see ``UNREAD_KEYS``)."""

    topic: str = "SENSOR_DATA_S_AVRO"
    result_topic: str = "model-predictions"
    offset: int = 0
    group: str = "cardata-autoencoder"


@dataclasses.dataclass
class TrainConfig:
    """The reference train job's knobs (cardata-v3.py:176-218)."""

    epochs: int = 20
    batch_size: int = 100
    take_batches: int = 100
    learning_rate: float = 1e-3
    only_normal: bool = True


@dataclasses.dataclass
class ServeConfig:
    """The long-lived scorer's knobs (``cli/serve.py``)."""

    skip_batches: int = 100
    take_batches: int = 100
    poll_interval_s: float = 0.5
    checkpoint_every_batches: int = 50
    threshold: float = 0.0   # >0: append anomaly verdicts (notebook thr 5)


@dataclasses.dataclass
class ArtifactConfig:
    """The artifact root and model file (never read: see
    ``UNREAD_KEYS``)."""

    root: str = "/tmp/iotml-artifacts"   # dir or gs:// bucket
    model_file: str = "model1"


@dataclasses.dataclass
class ScenarioConfig:
    """Fleet load generation, the XML scenario dialect typed (never read:
    see ``UNREAD_KEYS``)."""

    num_cars: int = 25
    msgs_per_car: int = 40
    interval_s: float = 5.0
    ramp_up_s: float = 5.0
    qos: int = 1
    failure_rate: float = 0.01


@dataclasses.dataclass
class StoreConfig:
    """Durable segmented-log storage (``store``).

    ``dir`` empty (the default) keeps the broker in memory; set it
    (``IOTML_STORE_DIR``), or pass ``--durable`` / ``--store-dir`` to the
    platform CLI, to mount a crash-recoverable log per partition.
    Retention here is the store-wide default; a topic's own retention
    overrides it."""

    dir: str = ""                    # empty = in-memory broker
    fsync: str = "interval"          # never | interval | always
    fsync_interval_s: float = 0.05
    segment_bytes: int = 16 * 1024 * 1024
    segment_age_s: float = 0.0       # 0 = roll by bytes only
    retention_bytes: int = 0         # 0 = unbounded
    retention_ms: int = 0            # 0 = unbounded (reference: 100000)
    retention_messages: int = 0      # 0 = unbounded (segment-granular)
    index_interval_bytes: int = 4096
    # cleanup_policy="compact" topics: the background compactor's
    # dirty-ratio trigger and the tombstone grace window (Kafka's
    # min.cleanable.dirty.ratio / delete.retention.ms)
    compact_min_dirty_ratio: float = 0.5
    compact_grace_ms: int = 60_000
    compact_interval_s: float = 5.0  # background compactor cadence


@dataclasses.dataclass
class TierConfig:
    """Object-store tiered log storage (``store.tiered``).

    ``uri`` empty (the default) keeps the durable log local; set it to a
    directory or ``gs://bucket/prefix`` (``IOTML_TIER_URI``), or pass
    ``--tier-uri`` to the platform CLI, and sealed segments offload to
    the remote tier, reads falling through below the local base.  Only
    meaningful with a durable store."""

    uri: str = ""                 # empty = no remote tier
    local_hot_bytes: int = 0      # hot-tier budget/partition; 0 = no evict
    upload_lag_s: float = 0.0     # min sealed age before upload
    remote_retention_ms: int = 0  # remote history age cap; 0 = forever
    cache_segments: int = 4       # RemoteSegmentCache entries/partition
    interval_s: float = 5.0       # background TierUploader cadence


@dataclasses.dataclass
class MlopsConfig:
    """Model lifecycle (``mlops``): versioned registry + async
    checkpointing + rollout.

    ``registry_dir`` empty (the default) keeps the artifact-store pointer
    flow; set it (``IOTML_MLOPS_REGISTRY_DIR``) or pass ``--registry`` to
    the live CLI to publish every training round as a committed,
    offsets-stamped registry version that scorers hot-swap to."""

    registry_dir: str = ""        # empty = no registry
    queue_depth: int = 2          # pending snapshots before drop-oldest
    auto_promote: bool = True     # serving follows every publish
    watch_poll_s: float = 0.25    # scorer-side channel poll cadence
    save_opt_state: bool = True   # archive optimizer moments per version
    keep_versions: int = 16       # prune beyond newest N (0 = keep all)


@dataclasses.dataclass
class OnlineConfig:
    """True online learning (``online``): per-window incremental updates
    with drift-triggered adaptation.

    The learner itself is constructed explicitly (``python -m
    iotml_torch.online run`` or the drill); these knobs set its detector
    thresholds and adaptation policy.  Detector deltas are unit-free
    (the monitor normalizes the error signal by its own stable
    baseline)."""

    window: int = 100            # records per incremental SGD update
    detector: str = "both"       # ph | adwin | both
    ph_delta: float = 0.15       # Page-Hinkley drift allowance
    ph_threshold: float = 2.5    # Page-Hinkley trip level (lambda)
    adwin_delta: float = 0.002   # ADWIN cut confidence
    adapt: str = "auto"          # boost | refit | reset | auto
    lr_boost: float = 5.0        # LR multiplier while adapting
    boost_updates: int = 80      # windows the boost stays active
    refit_epochs: int = 2        # replay-buffer passes on "refit"
    publish_every: int = 20      # windows between steady-state publishes
    buffer_batches: int = 32     # replay-buffer depth (windows)


@dataclasses.dataclass
class SloConfig:
    """Burn-rate SLO engine over the log-native TSDB (``obs.slo``).

    ``rules_path`` empty (the default) materializes the canary-backed
    starter pair (``obs.canary.default_slo_rules``); set it
    (``IOTML_SLO_RULES_PATH``) to a JSON file holding a list of
    declarative rule dicts in the ``SloRule.from_dict`` shape.
    ``window_scale`` compresses every rule's burn windows by the same
    factor (a drill runs the 5 m/1 h pair in seconds without changing
    the alert logic)."""

    rules_path: str = ""         # JSON list of SLO rule dicts
    window_scale: float = 1.0    # burn-window compression factor
    interval_s: float = 2.0      # engine evaluation cadence
    tsdb_chunk_ms: int = 60_000  # TSDB appender chunk window


def slo_rules(cfg: SloConfig) -> list:
    """Materialize the declarative rule dicts an ``SloEngine`` takes:
    the JSON file when configured, the canary defaults otherwise
    (``window_scale`` applies to both)."""
    if not cfg.rules_path:
        from .obs.canary import default_slo_rules
        return default_slo_rules(window_scale=cfg.window_scale)
    with open(cfg.rules_path) as f:
        docs = json.load(f)
    if not isinstance(docs, list):
        raise ValueError(f"{cfg.rules_path}: expected a JSON list of "
                         f"SLO rule dicts, got {type(docs).__name__}")
    for doc in docs:
        doc.setdefault("window_scale", cfg.window_scale)
    return docs


@dataclasses.dataclass
class MeshConfig:
    """The training mesh's shape (the CLIs' ``--mesh.data`` /
    ``--mesh.model``).

    The env key ``IOTML_MESH_DATA`` is the streaming process knob
    (``data.pipeline``, in ``NON_CONFIG``), so ``data`` is set by the
    flag or a config file."""

    data: int = -1      # -1 = every device on the data axis
    model: int = 1
    seq: int = 1


@dataclasses.dataclass
class Config:
    broker: BrokerConfig = dataclasses.field(default_factory=BrokerConfig)
    stream: StreamConfig = dataclasses.field(default_factory=StreamConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    artifacts: ArtifactConfig = dataclasses.field(
        default_factory=ArtifactConfig)
    scenario: ScenarioConfig = dataclasses.field(
        default_factory=ScenarioConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    store: StoreConfig = dataclasses.field(default_factory=StoreConfig)
    tier: TierConfig = dataclasses.field(default_factory=TierConfig)
    mlops: MlopsConfig = dataclasses.field(default_factory=MlopsConfig)
    online: OnlineConfig = dataclasses.field(default_factory=OnlineConfig)
    slo: SloConfig = dataclasses.field(default_factory=SloConfig)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def dumps(self) -> str:
        return json.dumps(self.as_dict(), indent=2, sort_keys=True)


_UNREAD_SECTIONS = {
    StreamConfig: ("stream", "the CLIs take their topics, offset and group "
                             "as positional arguments"),
    ArtifactConfig: ("artifacts", "the CLIs take the artifact root and "
                                  "model file as positional arguments"),
    ScenarioConfig: ("scenario", "the platform's --fleet/--rate flags and "
                                 "devsim's scenario files size the fleet"),
}

#: keys the JAX package parses and never reads; the port refuses them, so
#: a setting that would do nothing is never accepted quietly
UNREAD_KEYS = {
    "broker.servers": "the positional <servers> argument names the broker",
    "broker.partitions": "the CLIs create no topics: the broker's owner "
                         "sets their partitions",
    "broker.retention_messages": "the CLIs create no topics: the broker's "
                                 "owner sets their retention",
    "mesh.seq": "the training mesh is ('data', 'model'): the "
                "sequence-parallel step takes its mesh from its caller",
    **{f"{section}.{f.name}": why
       for cls, (section, why) in _UNREAD_SECTIONS.items()
       for f in dataclasses.fields(cls)},
}

#: IOTML_-prefixed process knobs of the JAX package that are not config
#: (test platform, lock/trace checkers, chaos, supervision, pipeline and
#: serving knobs); the resolver passes over them as the JAX one does
NON_CONFIG = {
    "IOTML_CONFIG", "IOTML_TEST_PLATFORM", "IOTML_LOCKCHECK",
    "IOTML_LOCKCHECK_STRICT", "IOTML_TRACECHECK", "IOTML_TRACE",
    "IOTML_TRACE_SAMPLE", "IOTML_TRACE_PATH", "IOTML_CHAOS",
    "IOTML_CHAOS_SEED", "IOTML_CHAOS_SCENARIO", "IOTML_CHAOS_RECORDS",
    "IOTML_DEVSIM_DIR", "IOTML_SUPERVISE", "IOTML_SUPERVISE_POLL_S",
    "IOTML_SUPERVISE_MAX_RESTARTS", "IOTML_PREFETCH_DEPTH",
    "IOTML_DECODE_RING_BUFFERS", "IOTML_RAW_BATCH_BYTES",
    "IOTML_RAW_PRODUCE", "IOTML_PRODUCE_BATCH_BYTES", "IOTML_WATERMARK",
    "IOTML_PROC", "IOTML_OBS_ENDPOINTS", "IOTML_MESH_DATA",
    "IOTML_DEVICE_NORMALIZE", "IOTML_REST_MAX_CONCURRENCY",
}


def env_key_names(cfg: Optional[Config] = None) -> list:
    """Every IOTML_<SECTION>_<FIELD> env var the resolver accepts: the
    JAX package's list (``iotml/config.py`` ``env_key_names``) over the
    port's sections, less the keys it refuses as unread
    (``UNREAD_KEYS``).  The drift pass (D1) checks every IOTML_* read
    in the tree against these and ``NON_CONFIG``."""
    cfg = cfg or Config()
    return [f"IOTML_{section.upper()}_{field.upper()}"
            for section, sub in dataclasses.asdict(cfg).items()
            for field in sub if f"{section}.{field}" not in UNREAD_KEYS]


def _coerce(value: Any, typ: type, where: str) -> Any:
    if isinstance(value, typ) and not (typ is int and isinstance(value, bool)):
        return value
    if typ is bool:
        if isinstance(value, str):
            low = value.strip().lower()
            if low in ("1", "true", "yes", "on"):
                return True
            if low in ("0", "false", "no", "off"):
                return False
        raise ValueError(f"{where}: cannot parse {value!r} as bool")
    try:
        return typ(value)
    except (TypeError, ValueError) as e:
        raise ValueError(f"{where}: cannot parse {value!r} as "
                         f"{typ.__name__}") from e


def _apply(cfg: Config, dotted: str, value: Any, applied: set) -> None:
    section, _, field = dotted.partition(".")
    if not field:
        raise ValueError(f"config key {dotted!r}: expected section.field")
    if dotted in UNREAD_KEYS:
        raise ValueError(f"config key {dotted!r} is not read: "
                         f"{UNREAD_KEYS[dotted]}")
    if not hasattr(cfg, section):
        raise ValueError(f"unknown config section {section!r} "
                         f"(have: {[f.name for f in dataclasses.fields(cfg)]})")
    sub = getattr(cfg, section)
    flds = {f.name: f for f in dataclasses.fields(sub)}
    if field not in flds:
        raise ValueError(f"unknown config key {dotted!r} "
                         f"(section {section!r} has: {sorted(flds)})")
    typ = {"int": int, "float": float, "str": str,
           "bool": bool}[flds[field].type]
    setattr(sub, field, _coerce(value, typ, dotted))
    applied.add(dotted)


def load_config(argv: Optional[Sequence[str]] = None,
                env: Optional[Dict[str, str]] = None,
                path: Optional[str] = None) -> Tuple[Config, List[str]]:
    """Resolve a Config.  Returns (config, leftover_argv).

    argv: flags of the form --section.field=value (or --section.field
      value); anything else is passed through in leftover_argv, so
      positional CLIs keep working in front of this.
    env: mapping (defaults to os.environ); keys IOTML_<SECTION>_<FIELD>.
    path: JSON config file; also honors env IOTML_CONFIG.

    ``config.applied`` is the set of keys any layer set explicitly, so a
    caller can tell "configured" from "default"."""
    cfg = Config()
    applied: set = set()
    env = dict(os.environ if env is None else env)

    path = path or env.get("IOTML_CONFIG")
    if path:
        with open(path) as fh:
            doc = json.load(fh)
        for section, sub in doc.items():
            if not isinstance(sub, dict):
                raise ValueError(f"config file {path}: section {section!r} "
                                 f"must be an object")
            for field, value in sub.items():
                _apply(cfg, f"{section}.{field}", value, applied)

    for key, value in env.items():
        if not key.startswith("IOTML_") or key in NON_CONFIG:
            continue
        section, _, field = key[len("IOTML_"):].lower().partition("_")
        _apply(cfg, f"{section}.{field}", value, applied)

    leftover: List[str] = []
    argv = list(argv or [])
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--") and "." in a:
            body = a[2:]
            if "=" in body:
                dotted, value = body.split("=", 1)
            elif i + 1 < len(argv):
                dotted, value = body, argv[i + 1]
                i += 1
            else:
                raise ValueError(f"flag {a!r} is missing a value")
            _apply(cfg, dotted, value, applied)
        else:
            leftover.append(a)
        i += 1
    cfg.applied = applied
    return cfg, leftover
