"""Typed configuration (``iotml.config``'s resolver, cut to its ``broker``,
``train``, ``serve`` and ``mlops`` sections).

One dataclass tree with one resolution order:

    defaults  <  config file (JSON)  <  environment  <  CLI flags

Environment keys: ``IOTML_<SECTION>_<FIELD>`` (e.g. ``IOTML_TRAIN_EPOCHS``,
``IOTML_BROKER_SASL_USERNAME``).  CLI flags: ``--<section>.<field>=<value>``
(or ``--<section>.<field> <value>``).
Values are coerced to the field's type, so a typo'd value fails at load
time.  An unknown section or field raises ValueError, as in the JAX
package, and so does a key the JAX package parses and never reads
(``UNREAD_KEYS``); a section the JAX package has and the port does not
yet raises NotImplementedError naming the ROADMAP item, so a setting is
never dropped quietly.
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
class Config:
    broker: BrokerConfig = dataclasses.field(default_factory=BrokerConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    mlops: MlopsConfig = dataclasses.field(default_factory=MlopsConfig)


#: the JAX package's other sections, and the ROADMAP item that ports each
UNPORTED_SECTIONS = {
    "mesh": "A10 (multi-GPU data parallel)",
    "stream": "A6 (the CLIs)",
    "artifacts": "A6 (the CLIs)", "scenario": "A6 (the CLIs)",
    "store": "A13 (the rest of the tooling)",
    "tier": "A13 (the rest of the tooling)",
    "online": "A8 (online learning)",
    "slo": "A13 (the rest of the tooling)",
}

#: keys the JAX package parses and never reads; the port refuses them, so
#: a setting that would do nothing is never accepted quietly
UNREAD_KEYS = {
    "broker.servers": "the positional <servers> argument names the broker",
    "broker.partitions": "the CLIs create no topics: the broker's owner "
                         "sets their partitions",
    "broker.retention_messages": "the CLIs create no topics: the broker's "
                                 "owner sets their retention",
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
    if section in UNPORTED_SECTIONS:
        raise NotImplementedError(
            f"config key {dotted!r}: the {section!r} section is not ported "
            f"yet (ROADMAP {UNPORTED_SECTIONS[section]})")
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
