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


@pytest.mark.parametrize("path", FILES)
def test_port_module_imports_no_jax_stack(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [f"{path}:{line} imports {mod}" for line, mod in _imported(tree)
           if mod in FORBIDDEN]
    assert not bad, bad
