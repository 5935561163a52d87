"""The port's configuration (``iotml_torch.config``) held against the JAX
package's (``tests/test_config.py``'s cases on both resolvers).

The ``stream``, ``artifacts``, ``scenario`` and ``mesh`` sections are
the JAX package's dataclasses (fields, types, defaults), so ``Config()``
has its sections and ``dumps()`` writes the same JSON for every section
the two share.  The JAX package reads none of the first three sections'
keys nor ``mesh.seq``, so the port refuses each key naming why (the CLIs
take topics and paths as positional arguments), as it refuses
``broker.servers``; ``--mesh.data``/``--mesh.model`` resolve as JAX's.  ``store``, ``tier`` and ``slo`` resolve
equal to JAX's from file, environment and flags, and ``slo_rules`` gives
JAX's rule dicts (the canary defaults, a JSON file, ``window_scale``).
"""

import dataclasses
import json

import pytest

from iotml import config as j_config
from iotml_torch import config as t_config

SHARED = [f.name for f in dataclasses.fields(t_config.Config)]
#: sections the port cut to the keys it reads (``broker`` without the
#: unread servers/partitions/retention keys, ``train`` without the
#: ``model`` switch of the CLIs' other models); compared on the port's keys
CUT = ("broker", "train")


def _sections(cfg) -> dict:
    return {name: dataclasses.asdict(getattr(cfg, name)) for name in SHARED}


def _shared(t_doc: dict, j_doc: dict) -> None:
    """Every shared section equal; a cut one on the port's keys."""
    for name in SHARED:
        want = j_doc[name]
        if name in CUT:
            want = {k: want[k] for k in t_doc[name]}
        assert t_doc[name] == want, name


def test_config_has_the_jax_sections_but_the_unported():
    """Every JAX section is ported (``mesh`` was the last)."""
    want = [f.name for f in dataclasses.fields(j_config.Config)]
    assert SHARED == want
    assert not hasattr(t_config, "UNPORTED_SECTIONS")


@pytest.mark.parametrize("section", ["stream", "artifacts", "scenario",
                                     "store", "tier", "slo", "mesh"])
def test_sections_are_the_jax_dataclasses(section):
    t_cls = type(getattr(t_config.Config(), section))
    j_cls = type(getattr(j_config.Config(), section))
    t_fields = [(f.name, f.type, f.default) for f in dataclasses.fields(t_cls)]
    j_fields = [(f.name, f.type, f.default) for f in dataclasses.fields(j_cls)]
    assert t_fields == j_fields


def test_defaults_match_reference_knobs():
    t_cfg, t_rest = t_config.load_config([], env={})
    j_cfg, j_rest = j_config.load_config([], env={})
    assert t_rest == j_rest == []
    _shared(_sections(t_cfg), dataclasses.asdict(j_cfg))
    assert t_cfg.train.epochs == 20 and t_cfg.train.batch_size == 100
    assert t_cfg.stream.topic == "SENSOR_DATA_S_AVRO"
    assert t_cfg.scenario.num_cars == 25


def test_dumps_equals_jax_on_the_shared_sections():
    t_doc = json.loads(t_config.Config().dumps())
    j_doc = json.loads(j_config.Config().dumps())
    assert list(t_doc) == sorted(SHARED)
    _shared(t_doc, j_doc)
    assert t_config.Config().as_dict() == t_doc


def test_layering_file_env_cli(tmp_path):
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as fh:
        json.dump({"train": {"epochs": 5, "batch_size": 64},
                   "store": {"dir": "/data/s", "fsync": "never"}}, fh)
    argv = ["positional", "--train.epochs=7", "--store.fsync", "always",
            "pos2"]
    env = {"IOTML_TRAIN_EPOCHS": "6", "IOTML_SERVE_POLL_INTERVAL_S": "2.5",
           "IOTML_TIER_CACHE_SEGMENTS": "9"}
    t_cfg, t_rest = t_config.load_config(argv, env=env, path=path)
    j_cfg, j_rest = j_config.load_config(argv, env=env, path=path)
    assert t_rest == j_rest == ["positional", "pos2"]
    assert t_cfg.applied == j_cfg.applied
    _shared(_sections(t_cfg), dataclasses.asdict(j_cfg))
    assert (t_cfg.train.epochs, t_cfg.train.batch_size) == (7, 64)
    assert t_cfg.serve.poll_interval_s == 2.5
    assert (t_cfg.store.dir, t_cfg.store.fsync) == ("/data/s", "always")
    assert t_cfg.tier.cache_segments == 9


def test_env_ignored_without_prefix_and_config_pointer(tmp_path):
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as fh:
        json.dump({"train": {"epochs": 3}}, fh)
    env = {"IOTML_CONFIG": path, "TRAIN_EPOCHS": "9"}
    assert t_config.load_config([], env=env)[0].train.epochs == \
        j_config.load_config([], env=env)[0].train.epochs == 3


@pytest.mark.parametrize("argv,match", [
    (["--train.epoch=3"], "unknown config key"),
    (["--trane.epochs=3"], "unknown config section"),
    (["--train.epochs=ten"], "cannot parse"),
    (["--train.only_normal=maybe"], "bool"),
    (["--store.segment_bytes=big"], "cannot parse"),
    (["--tier.nope=1"], "unknown config key")])
def test_bool_coercion_and_errors(argv, match):
    for mod in (t_config, j_config):
        with pytest.raises(ValueError, match=match):
            mod.load_config(argv, env={})
    for mod in (t_config, j_config):
        cfg, _ = mod.load_config([], env={"IOTML_TRAIN_ONLY_NORMAL": "yes"})
        assert cfg.train.only_normal is True


def test_applied_keys_tracked():
    argv, env = ["--train.epochs=7"], {"IOTML_STORE_FSYNC": "always"}
    t_cfg, _ = t_config.load_config(argv, env=env)
    j_cfg, _ = j_config.load_config(argv, env=env)
    assert t_cfg.applied == j_cfg.applied == {"train.epochs", "store.fsync"}


@pytest.mark.parametrize("key,value", [
    ("stream.topic", "x"), ("stream.result_topic", "y"),
    ("stream.offset", "3"), ("stream.group", "g"),
    ("artifacts.root", "/data"), ("artifacts.model_file", "m"),
    ("scenario.num_cars", "100000"), ("scenario.failure_rate", "0.5")])
def test_unread_section_keys_are_refused_naming_why(tmp_path, key, value):
    """JAX parses these keys and no module of it reads them; the port
    refuses each from a flag, the environment and a file."""
    section, field = key.split(".")
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as fh:
        json.dump({section: {field: value}}, fh)
    for kw in ({"argv": [f"--{key}={value}"], "env": {}},
               {"argv": [], "env": {f"IOTML_{section.upper()}_"
                                    f"{field.upper()}": value}},
               {"argv": [], "env": {}, "path": path}):
        with pytest.raises(ValueError, match="positional|fleet") as e:
            t_config.load_config(**kw)
        assert key in str(e.value)
        j_cfg, _ = j_config.load_config(**kw)  # JAX takes it, unread
        assert key in j_cfg.applied


def test_a_jax_dump_loads_only_without_the_unread_sections(tmp_path):
    """A JAX ``dumps()`` file holds keys the port refuses; with the
    refused sections and keys dropped it resolves as in JAX."""
    j_cfg, _ = j_config.load_config(["--store.retention_ms=100000",
                                     "--tier.uri=/t"], env={})
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as fh:
        fh.write(j_cfg.dumps())
    with pytest.raises(ValueError):
        t_config.load_config([], env={}, path=path)
    doc = json.loads(j_cfg.dumps())
    for name in ("broker", "stream", "artifacts", "scenario"):
        doc.pop(name)
    doc["train"].pop("model")
    doc["mesh"].pop("seq")
    with open(path, "w") as fh:
        json.dump(doc, fh)
    t_cfg, _ = t_config.load_config([], env={}, path=path)
    assert t_cfg.store.retention_ms == 100000 and t_cfg.tier.uri == "/t"
    assert _sections(t_cfg)["store"] == dataclasses.asdict(j_cfg.store)


@pytest.mark.parametrize("argv,env", [
    ([], {}),
    (["--mesh.data=2"], {}),
    (["--mesh.data", "4", "--mesh.model=2"], {"IOTML_MESH_DATA": "8"}),
    ([], {"IOTML_MESH_MODEL": "2", "IOTML_MESH_DATA": "3"})])
def test_the_mesh_section_resolves_as_jax(argv, env):
    """``mesh.data``/``mesh.model`` from flags and the environment; the
    ``IOTML_MESH_DATA`` process knob never reaches the config tree."""
    t_cfg, t_rest = t_config.load_config(argv + ["x"], env=env)
    j_cfg, j_rest = j_config.load_config(argv + ["x"], env=env)
    assert dataclasses.asdict(t_cfg.mesh) == dataclasses.asdict(j_cfg.mesh)
    assert t_cfg.applied == j_cfg.applied
    assert t_rest == j_rest == ["x"]


def test_mesh_seq_is_refused_as_unread():
    """JAX parses ``mesh.seq`` and no module of it reads the key."""
    with pytest.raises(ValueError, match="mesh.seq"):
        t_config.load_config(["--mesh.seq=2"], env={})
    j_cfg, _ = j_config.load_config(["--mesh.seq=2"], env={})
    assert "mesh.seq" in j_cfg.applied


@pytest.mark.parametrize("argv,env", [
    ([], {}),
    (["--slo.interval_s=0.5", "--slo.tsdb_chunk_ms", "2000"], {}),
    ([], {"IOTML_SLO_WINDOW_SCALE": "0.01", "IOTML_SLO_INTERVAL_S": "3"}),
    (["--slo.window_scale=2"], {"IOTML_SLO_WINDOW_SCALE": "0.5"})])
def test_the_slo_section_resolves_as_jax(argv, env):
    t_cfg, t_rest = t_config.load_config(argv + ["x"], env=env)
    j_cfg, j_rest = j_config.load_config(argv + ["x"], env=env)
    assert dataclasses.asdict(t_cfg.slo) == dataclasses.asdict(j_cfg.slo)
    assert t_rest == j_rest == ["x"]
    assert t_config.slo_rules(t_cfg.slo) == j_config.slo_rules(j_cfg.slo)


def test_slo_rules_from_a_file_as_jax(tmp_path):
    rules = [{"name": "lat", "objective": 0.99,
              "indicator": {"kind": "latency", "metric": "m_seconds",
                            "threshold_s": 0.2}},
             {"name": "avail", "objective": 0.9, "window_scale": 3.0,
              "indicator": {"kind": "ratio", "bad": "b", "total": "t"}}]
    path = tmp_path / "rules.json"
    path.write_text(json.dumps(rules))
    env = {"IOTML_SLO_RULES_PATH": str(path),
           "IOTML_SLO_WINDOW_SCALE": "0.25"}
    t_cfg, _ = t_config.load_config([], env=env)
    j_cfg, _ = j_config.load_config([], env=env)
    assert t_config.slo_rules(t_cfg.slo) == j_config.slo_rules(j_cfg.slo)
    assert [r["window_scale"] for r in t_config.slo_rules(t_cfg.slo)] == \
        [0.25, 3.0]
    path.write_text(json.dumps({"not": "a list"}))
    errs = []
    for mod, cfg in ((t_config, t_cfg), (j_config, j_cfg)):
        with pytest.raises(ValueError) as e:
            mod.slo_rules(cfg.slo)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_a_bad_slo_value_fails_as_jax():
    for mod in (t_config, j_config):
        with pytest.raises(ValueError, match="slo.interval_s"):
            mod.load_config(["--slo.interval_s=fast"], env={})
