"""The port imports torch and numpy, never the JAX stack or the JAX
package: every module under ``iotml_torch/`` and ``chip_smoke.py`` is
parsed with ``ast`` and each import is checked, at any depth (a function
body's import counts too)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "h5py", "iotml")
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


@pytest.mark.parametrize("path", FILES)
def test_port_module_imports_no_jax_stack(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [f"{path}:{line} imports {mod}" for line, mod in _imported(tree)
           if mod in FORBIDDEN]
    assert not bad, bad
