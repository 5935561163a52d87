"""The port's CUDA build bookkeeping and the flash kernels' design rule,
on the CPU.

No ``nvcc`` runs here: ``_build.library_path`` only hashes sources,
``_build.build`` runs a stand-in compiler, and
``flash_design`` is plain Python, held here against the rule as the CUDA
sources state it (the built libraries' ``iotml_flash_fwd_design`` and
``iotml_flash_bwd_design`` are held against it on the card by
``chip_smoke.py``).
"""

import re
import subprocess
from pathlib import Path

import pytest
import torch

from iotml_torch.ops import _build
from iotml_torch.ops.attention import flash_design


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary ``csrc`` with one source and one header."""
    (tmp_path / "kern.cu").write_text('#include "blocks.cuh"\n')
    (tmp_path / "blocks.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_library_name_follows_the_source(csrc):
    before = _build.library_path("kern")
    assert _build.library_path("kern") == before
    (csrc / "kern.cu").write_text('#include "blocks.cuh"\n// edited\n')
    assert _build.library_path("kern") != before
    assert _build.library_path("kern").parent == _build.BUILD


def test_library_name_follows_every_header(csrc):
    before = _build.library_path("kern")
    (csrc / "blocks.cuh").write_text("// v2\n")
    after_edit = _build.library_path("kern")
    assert after_edit != before
    (csrc / "more.cuh").write_text("// a new header\n")
    assert _build.library_path("kern") not in (before, after_edit)


def test_library_name_ignores_other_files(csrc):
    before = _build.library_path("kern")
    (csrc / "notes.txt").write_text("not a header\n")
    (csrc / "other.cu").write_text("// another source\n")
    assert _build.library_path("kern") == before


@pytest.fixture
def fake_nvcc(csrc, tmp_path_factory, monkeypatch):
    """A temporary ``build`` directory and a stand-in compiler that
    writes its ``-o`` file and prints one ptxas line; returns the build
    directory and the list of libraries it was asked for."""
    build = tmp_path_factory.mktemp("build")
    calls = []

    def run(cmd, **kwargs):
        out = Path(cmd[cmd.index("-o") + 1])
        calls.append(out)
        out.write_text("library\n")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info: Used 1 "
                                           "registers\n")

    monkeypatch.setattr(_build, "BUILD", build)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", run)
    return build, calls


def test_build_log_rebuilds_a_library_without_its_log(fake_nvcc):
    """A library left by a build that kept its log elsewhere is built
    again, so its log can be read; one with its log is reused."""
    build, calls = fake_nvcc
    target = _build.library_path("kern")
    target.write_text("stale library\n")
    (build / "kern.log").write_text("a log at the old place\n")
    assert _build.build_log("kern") == "ptxas info: Used 1 registers\n"
    assert len(calls) == 1 and target.read_text() == "library\n"
    assert _build.build_log("kern") == "ptxas info: Used 1 registers\n"
    assert _build.build("kern") == ""
    assert len(calls) == 1
    assert sorted(p.name for p in build.iterdir()) == sorted(
        ["kern.log", target.name, target.with_suffix(".log").name])


FLASH_SOURCES = ("flash_attention", "flash_attention_bwd")


@pytest.mark.parametrize("header", ["hopper.cuh", "flash_tiles.cuh"])
@pytest.mark.parametrize("source", FLASH_SOURCES)
def test_backward_library_name_follows_hopper_cuh(source, header, tmp_path,
                                                   monkeypatch):
    """Both flash sources include hopper.cuh and flash_tiles.cuh: a copy
    of csrc with either header edited names another library."""
    for src in _build.CSRC.iterdir():
        if src.is_file():
            (tmp_path / src.name).write_bytes(src.read_bytes())
    assert f'#include "{header}"' in (tmp_path / f"{source}.cu").read_text()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path(source)
    with open(tmp_path / header, "a") as edited:
        edited.write("// edited\n")
    assert _build.library_path(source) != before


@pytest.mark.parametrize("dtype,head_dim,design", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "fma"),
    (torch.bfloat16, 8, "fma"),
    (torch.float32, 128, "fma"),
    (torch.float32, 16, "fma"),
    (torch.float32, 8, "fma"),
])
def test_flash_design(dtype, head_dim, design):
    assert flash_design(dtype, head_dim) == design


@pytest.mark.parametrize("source", FLASH_SOURCES)
def test_sources_state_the_design_rule_of_flash_design(source):
    """The rule is written once, as ``tensor_core_design`` in
    flash_tiles.cuh; each source dispatches by it and states no rule of
    its own, and the rule picks what ``flash_design`` says for every
    dtype code (0 float32, 1 bfloat16) and head dim."""
    header = (_build.CSRC / "flash_tiles.cuh").read_text()
    rule = re.search(r"bool tensor_core_design\(int dtype, int d\) \{\s*"
                     r"return dtype == (\d+) && d == (\d+);\s*\}", header)
    assert rule, "tensor_core_design not found in flash_tiles.cuh"
    code = (_build.CSRC / f"{source}.cu").read_text()
    assert '#include "flash_tiles.cuh"' in code
    assert "tensor_core_design(dtype, d)" in code
    assert "bool tensor_core_design" not in code
    dtypes = {0: torch.float32, 1: torch.bfloat16}
    for dtype_code, dtype in dtypes.items():
        for d in (8, 16, 128):
            tc = dtype_code == int(rule.group(1)) and d == int(rule.group(2))
            assert flash_design(dtype, d) == ("wgmma" if tc else "fma")


def test_forward_ring_depth_is_the_one_constant_the_timing_script_sets():
    """The tensor-core forward's K/V ring depth is one ``kStages``
    constant, at least the three stages a step holds, written as the
    pattern scripts/fwd_ring_depth.py replaces to build other depths."""
    import importlib.util

    script = _build.CSRC.parents[2] / "scripts" / "fwd_ring_depth.py"
    spec = importlib.util.spec_from_file_location("fwd_ring_depth", script)
    ring = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ring)
    code = (_build.CSRC / "flash_attention.cu").read_text()
    found = ring.STAGES.findall(code)
    assert len(found) == 1
    assert int(re.search(r"\d+", found[0]).group()) >= 3
    assert "static_assert(kStages >= 3" in code
