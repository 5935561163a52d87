"""The port imports torch and numpy, never the JAX stack or the JAX
package: every module under ``iotml_torch/`` and ``chip_smoke.py`` is
parsed with ``ast`` and each import is checked, at any depth (a function
body's import counts too)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
#: the JAX stack, the JAX package, and google_crc32c (the JAX store's
#: CRC32C; the port's is its native engine's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "h5py", "iotml",
             "google_crc32c")
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "iotml_torch").rglob("*.py")) + \
    ["chip_smoke.py"]


def _imported(tree: ast.AST):
    """(line, top-level module) of every absolute import in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_the_guard_sees_every_kind_of_import():
    src = ("import jax.numpy as jnp\nfrom iotml.ops import avro\n"
           "def f():\n    import orbax.checkpoint\n"
           "from iotml_torch.ops import framing\nfrom . import native\n")
    assert [m for _, m in _imported(ast.parse(src))
            if m in FORBIDDEN] == ["jax", "iotml", "orbax"]


def test_the_wire_layer_is_covered():
    assert {"iotml_torch/stream/kafka_wire.py",
            "iotml_torch/utils/net.py"} <= set(FILES)


def test_the_live_services_are_covered():
    assert {"iotml_torch/stream/native_kafka.py", "iotml_torch/cli/live.py",
            "iotml_torch/train/live.py", "iotml_torch/serve/live.py",
            "iotml_torch/serve/carhealth.py"} <= set(FILES)


def test_the_creditcard_lstm_and_mnist_jobs_are_covered():
    assert {"iotml_torch/evaluate/anomaly.py",
            "iotml_torch/evaluate/report.py",
            "iotml_torch/data/creditcard.py", "iotml_torch/cli/creditcard.py",
            "iotml_torch/models/lstm.py", "iotml_torch/cli/lstm.py",
            "iotml_torch/models/mnist.py", "iotml_torch/data/mnist_stream.py",
            "iotml_torch/cli/mnist_smoke.py"} <= set(FILES)


OBS_MODULES = ["iotml_torch/obs/metrics.py", "iotml_torch/obs/tracing.py",
               "iotml_torch/obs/watermark.py", "iotml_torch/obs/profile.py",
               "iotml_torch/obs/federate.py", "iotml_torch/obs/__main__.py",
               "iotml_torch/chaos/faults.py", "iotml_torch/data/prefetch.py",
               "iotml_torch/data/pipeline.py"]


def test_the_observability_plane_is_covered():
    assert set(OBS_MODULES) <= set(FILES)


def test_the_observability_plane_loads_no_jax_stack():
    """Imported in a fresh interpreter, the new modules pull in no module
    of the JAX stack or the JAX package."""
    import subprocess
    import sys

    mods = [p[:-3].replace("/", ".") for p in OBS_MODULES]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\nprint(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


KSQL_MODULES = ["iotml_torch/supervise/registry.py", "iotml_torch/utils/rest.py",
                "iotml_torch/stream/registry.py",
                "iotml_torch/stream/registry_server.py",
                "iotml_torch/stream/csv_source.py",
                "iotml_torch/streamproc/dlq.py",
                "iotml_torch/streamproc/tasks.py",
                "iotml_torch/streamproc/sql.py",
                "iotml_torch/streamproc/server.py",
                "iotml_torch/streamproc/__init__.py"]


def test_the_ksql_stage_is_covered_and_loads_no_jax_stack():
    import subprocess
    import sys

    assert set(KSQL_MODULES) <= set(FILES)
    mods = [p[:-3].replace("/", ".").removesuffix(".__init__")
            for p in KSQL_MODULES]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\nprint(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


INGEST_MODULES = ["iotml_torch/mqtt/__init__.py",
                  "iotml_torch/mqtt/topic_tree.py",
                  "iotml_torch/mqtt/broker.py", "iotml_torch/mqtt/wire.py",
                  "iotml_torch/mqtt/eventserver.py",
                  "iotml_torch/mqtt/bridge.py",
                  "iotml_torch/mqtt/native_ingest.py",
                  "iotml_torch/mqtt/scenario.py",
                  "iotml_torch/obs/canary.py", "iotml_torch/cli/devsim.py",
                  "iotml_torch/cli/up.py", "iotml_torch/cli/demo.py"]


def test_the_ingest_front_is_covered_and_loads_no_jax_stack():
    import subprocess
    import sys

    assert set(INGEST_MODULES) <= set(FILES)
    mods = [p[:-3].replace("/", ".").removesuffix(".__init__")
            for p in INGEST_MODULES]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\nprint(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


STORE_MODULES = ["iotml_torch/store/__init__.py",
                 "iotml_torch/store/segment.py", "iotml_torch/store/log.py",
                 "iotml_torch/store/offsets.py",
                 "iotml_torch/store/mount.py",
                 "iotml_torch/store/compact.py",
                 "iotml_torch/store/remote.py",
                 "iotml_torch/store/tiered.py", "iotml_torch/ops/framing.py",
                 "iotml_torch/stream/broker.py",
                 "iotml_torch/train/artifacts.py", "iotml_torch/config.py"]


def test_the_durable_store_is_covered_and_loads_no_jax_stack():
    """The store's modules, imported and driven (a durable broker mounts,
    frames a batch natively, reads it back) in a fresh interpreter, pull
    in no module of the JAX stack, the JAX package or google_crc32c."""
    import subprocess
    import sys

    assert set(STORE_MODULES) <= set(FILES)
    assert "iotml_torch/cpp/frame_engine.cc" in {
        p.relative_to(ROOT).as_posix()
        for p in (ROOT / "iotml_torch").rglob("*.cc")}
    mods = [p[:-3].replace("/", ".").removesuffix(".__init__")
            for p in STORE_MODULES]
    code = ("import sys, tempfile\n" +
            "".join(f"import {m}\n" for m in mods) +
            "from iotml_torch.stream.broker import Broker\n"
            "d = tempfile.mkdtemp()\n"
            "b = Broker(store_dir=d)\n"
            "b.produce_many('t', [(b'k', b'v', 1), (None, None, 2)])\n"
            "assert [m.value for m in b.fetch('t', 0, 0)] == [b'v', None]\n"
            "b.close()\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\nprint(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


TELEMETRY_MODULES = ["iotml_torch/supervise/supervisor.py",
                     "iotml_torch/supervise/drill.py",
                     "iotml_torch/obs/tsdb.py", "iotml_torch/obs/slo.py",
                     "iotml_torch/obs/federate.py",
                     "iotml_torch/obs/drill.py",
                     "iotml_torch/obs/dashboards.py",
                     "iotml_torch/obs/control_center.py",
                     "iotml_torch/obs/tb.py", "iotml_torch/obs/__main__.py",
                     "iotml_torch/chaos/scenarios.py",
                     "iotml_torch/chaos/__main__.py",
                     "iotml_torch/cli/up.py", "iotml_torch/config.py"]


def test_the_telemetry_plane_is_covered_and_loads_no_jax_stack():
    """The telemetry plane's modules, imported and driven (a supervised
    SLO engine over a TSDB appended on a durable broker, a fleet scrape,
    a dashboard, a scenario armed from the environment) in a fresh
    interpreter, pull in no module of the JAX stack or the JAX
    package."""
    import subprocess
    import sys

    assert set(TELEMETRY_MODULES) <= set(FILES)
    mods = [p[:-3].replace("/", ".") for p in TELEMETRY_MODULES]
    code = ("import sys, tempfile, time\n" +
            "".join(f"import {m}\n" for m in mods) +
            "from iotml_torch.stream.broker import Broker\n"
            "from iotml_torch.obs import tsdb, slo, federate, dashboards\n"
            "from iotml_torch.chaos import faults\n"
            "from iotml_torch.supervise.supervisor import Supervisor\n"
            "from iotml_torch.obs.canary import default_slo_rules\n"
            "b = Broker(store_dir=tempfile.mkdtemp())\n"
            "a = tsdb.TsdbAppender(b, chunk_ms=1000)\n"
            "a.append([('m_total', {}, 1.0)], ts_ms=1000)\n"
            "a.append([('m_total', {}, 3.0)], ts_ms=2000)\n"
            "assert tsdb.query(tsdb.read_series(b), 'rate(m_total[5s])')\n"
            "e = slo.SloEngine(b, default_slo_rules(), interval_s=0.01)\n"
            "s = Supervisor(poll_interval_s=0.01).start()\n"
            "s.add_loop('slo', e.loop)\n"
            "time.sleep(0.1)\n"
            "s.stop()\n"
            "federate.FleetCollector(endpoints=[]).collect()\n"
            "dashboards.dashboard_configmap()\n"
            "faults.arm_from_env({'IOTML_CHAOS': '1'})\n"
            "faults.disarm()\n"
            "b.close()\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\nprint(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


REPLICATION_MODULES = ["iotml_torch/replication/__init__.py",
                       "iotml_torch/replication/isr.py",
                       "iotml_torch/replication/manager.py",
                       "iotml_torch/replication/drill.py",
                       "iotml_torch/replication/__main__.py",
                       "iotml_torch/stream/replica.py",
                       "iotml_torch/store/hwm.py",
                       "iotml_torch/supervise/topology.py",
                       "iotml_torch/supervise/drill.py",
                       "iotml_torch/supervise/__main__.py",
                       "iotml_torch/stream/kafka_wire.py",
                       "iotml_torch/stream/broker.py",
                       "iotml_torch/ops/framing.py"]


def test_replication_is_covered_and_loads_no_jax_stack():
    """The replication modules, imported and driven (a durable leader
    with one follower, an acks=all produce at the quorum, a consumer
    fetch at the quorum HWM, a promotion at epoch 1, the HWM file) in a
    fresh interpreter, pull in no module of the JAX stack or the JAX
    package."""
    import subprocess
    import sys

    assert set(REPLICATION_MODULES) <= set(FILES)
    mods = [p[:-3].replace("/", ".").removesuffix(".__init__")
            for p in REPLICATION_MODULES]
    code = ("import sys, tempfile, threading, time\n" +
            "".join(f"import {m}\n" for m in mods) +
            "from iotml_torch.stream.broker import Broker\n"
            "from iotml_torch.stream.kafka_wire import (KafkaWireBroker,\n"
            "    KafkaWireServer)\n"
            "from iotml_torch.replication import ReplicaSet\n"
            "from iotml_torch.store.hwm import HwmFile\n"
            "d = tempfile.mkdtemp()\n"
            "b = Broker(store_dir=d)\n"
            "b.create_topic('t')\n"
            "s = KafkaWireServer(b).start()\n"
            "rs = ReplicaSet(leader_broker=b, leader_server=s,\n"
            "    n_followers=1, min_isr=2, topics=['t'],\n"
            "    hwm_file=HwmFile(d)).start()\n"
            "assert rs.await_isr(2, 't', 0, timeout_s=30)\n"
            "c = KafkaWireBroker(f'127.0.0.1:{s.port}')\n"
            "assert c.produce_many('t', [(b'k', b'v', 1)]) == 0\n"
            "assert [m.value for m in c.fetch('t', 0, 0)] == [b'v']\n"
            "s.kill()\n"
            "rid, addr = rs.promote(1)\n"
            "p = KafkaWireBroker(addr, epoch=1)\n"
            "assert [m.value for m in p.fetch('t', 0, 0)] == [b'v']\n"
            "rs.stop()\n"
            "b.close()\n"
            "assert HwmFile(d).load() == {('t', 0): 1}\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\nprint(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", FILES)
def test_port_module_imports_no_jax_stack(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [f"{path}:{line} imports {mod}" for line, mod in _imported(tree)
           if mod in FORBIDDEN]
    assert not bad, bad


CLUSTER_MODULES = ["iotml_torch/cluster/__init__.py",
                   "iotml_torch/cluster/__main__.py",
                   "iotml_torch/cluster/client.py",
                   "iotml_torch/cluster/controller.py",
                   "iotml_torch/cluster/fleet.py",
                   "iotml_torch/cluster/partition_map.py",
                   "iotml_torch/cluster/shard.py",
                   "iotml_torch/replication/reassign.py",
                   "iotml_torch/chaos/runner.py",
                   "iotml_torch/chaos/__main__.py"]


def test_the_cluster_is_covered_and_loads_no_jax_stack():
    """The cluster modules, imported and driven (a quorum cluster of 3,
    a routed produce and fetch, an add-broker over CLUSTER_ADMIN, the
    rebalance-under-chaos runner) in a fresh interpreter, pull in no
    module of the JAX stack or the JAX package, and no torch: the
    cluster's command line starts without it."""
    import subprocess
    import sys

    assert set(CLUSTER_MODULES) <= set(FILES)
    mods = [p[:-3].replace("/", ".").removesuffix(".__init__")
            for p in CLUSTER_MODULES]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "from iotml_torch.cluster import ClusterController\n"
            "from iotml_torch.stream.kafka_wire import KafkaWireBroker\n"
            "from iotml_torch.chaos.runner import ChaosRunner\n"
            "ctl = ClusterController(replication_factor=3,\n"
            "                        replica_sync='manual').start()\n"
            "ctl.create_topic('t', partitions=3)\n"
            "c = ctl.client()\n"
            "c.produce_many('t', [(b'k', b'v', 1)], acks=1)\n"
            "p = __import__('zlib').crc32(b'k') % 3\n"
            "assert [m.value for m in c.fetch('t', p, 0)] == [b'v']\n"
            "for _ in range(3):\n"
            "    ctl.sync_replicas_once()\n"
            "w = KafkaWireBroker(ctl.bootstrap())\n"
            "assert w.cluster_admin('add-broker', {'shard': 1})"
            "['state'] == 'retired'\n"
            "w.close()\n"
            "c.close()\n"
            "ctl.stop()\n"
            "assert ChaosRunner('rebalance-under-chaos', records=100)"
            ".run().ok\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('torch',)!r})\nprint(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


SINK_TWIN_MODULES = ["iotml_torch/connect/__init__.py",
                     "iotml_torch/connect/runtime.py",
                     "iotml_torch/connect/connectors.py",
                     "iotml_torch/connect/server.py",
                     "iotml_torch/ops/avro_container.py",
                     "iotml_torch/twin/__init__.py",
                     "iotml_torch/twin/state.py",
                     "iotml_torch/twin/service.py",
                     "iotml_torch/twin/features.py",
                     "iotml_torch/twin/drill.py",
                     "iotml_torch/twin/__main__.py",
                     "iotml_torch/__main__.py"]


def test_the_sinks_and_twin_are_covered_and_load_no_jax_stack():
    """Connect, the Avro container writer and the twin, imported and
    driven (the twin-rebuild drill over a durable broker and the connect
    REST) in a fresh interpreter, pull in no module of the JAX stack or
    the JAX package."""
    import subprocess
    import sys

    assert set(SINK_TWIN_MODULES) <= set(FILES)
    mods = [p[:-3].replace("/", ".").removesuffix(".__init__")
            for p in SINK_TWIN_MODULES]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "from iotml_torch.twin.drill import run_twin_rebuild_drill\n"
            "assert run_twin_rebuild_drill(seed=11, records=300).ok\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\nprint(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
