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


def test_build_variant_builds_an_edited_copy(fake_nvcc, csrc):
    """A variant is built from an edited copy of csrc under
    build/variants/<tag>/; csrc itself is not touched, and an edit whose
    text is not in its file raises before any build."""
    build, calls = fake_nvcc
    lib, log = _build.build_variant("kern", "v2",
                                    [("blocks.cuh", "// v1", "// v2")])
    where = build / "variants" / "v2"
    assert lib == where / "libkern.so" and calls == [lib]
    assert log == "ptxas info: Used 1 registers\n"
    assert (where / "blocks.cuh").read_text() == "// v2\n"
    assert (where / "kern.cu").read_text() == '#include "blocks.cuh"\n'
    assert (csrc / "blocks.cuh").read_text() == "// v1\n"
    with pytest.raises(RuntimeError, match="not in blocks.cuh"):
        _build.build_variant("kern", "v3", [("blocks.cuh", "// v9", "")])
    assert calls == [lib]


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_Z5aKernILi8EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z5aKernILi8EEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 380 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z5aKernILi16EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z5aKernILi16EEvPf
    24 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherPf' for 'sm_90a'
ptxas info    : Function properties for _Z5otherPf
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, 380 bytes cmem[0]
"""


def test_ptxas_kernels_reads_registers_and_spills():
    """Each named kernel's registers and spilled bytes; kernels the
    namer leaves out, and functions with no register line, are not
    reported."""
    def name_of(mangled):
        found = re.match(r"_Z5aKernILi(\d+)E", mangled)
        return f"D={found.group(1)}" if found else None

    assert _build.ptxas_kernels(PTXAS_LOG, name_of) == {
        "D=8": {"registers": 96, "spill_stores": 0, "spill_loads": 0},
        "D=16": {"registers": 255, "spill_stores": 12, "spill_loads": 8}}
    assert _build.ptxas_kernels(PTXAS_LOG, lambda mangled: None) == {}


def _variant_edits(script_name):
    """The text edits of the VARIANTS of scripts/<script_name>."""
    import importlib.util

    script = _build.CSRC.parents[2] / "scripts" / script_name
    spec = importlib.util.spec_from_file_location(script.stem, script)
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    return [edit for _, e in variants.VARIANTS.values() for edit in e]


def test_backward_variant_edits_match_the_sources():
    """Every text edit of scripts/bwd_tf32_variants.py is in the file it
    edits, so each variant builds what it says."""
    edits = _variant_edits("bwd_tf32_variants.py")
    assert edits
    for file, old, new in edits:
        assert old in (_build.CSRC / file).read_text(), (file, old)
        assert new != old


def test_forward_variant_edits_match_the_sources():
    """Every text edit of scripts/fwd_tf32_variants.py is in the file it
    edits exactly once, so each variant changes what it says and nothing
    else."""
    edits = _variant_edits("fwd_tf32_variants.py")
    assert edits
    for file, old, new in edits:
        assert (_build.CSRC / file).read_text().count(old) == 1, (file, old)
        assert new != old


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


def _names_another_library(source, header, tmp_path, monkeypatch) -> bool:
    """Whether a copy of csrc with ``header`` edited names another library
    for ``source`` (which must include it)."""
    for src in _build.CSRC.iterdir():
        if src.is_file():
            (tmp_path / src.name).write_bytes(src.read_bytes())
    code = (tmp_path / f"{source}.cu").read_text()
    assert f'#include "{header}"' in code
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path(source)
    with open(tmp_path / header, "a") as edited:
        edited.write("// edited\n")
    return _build.library_path(source) != before


def test_backward_library_name_follows_mma_tf32_cuh(tmp_path, monkeypatch):
    """The backward source includes mma_tf32.cuh (the split-TF32 building
    blocks): a copy of csrc with it edited names another backward
    library."""
    assert _names_another_library("flash_attention_bwd", "mma_tf32.cuh",
                                  tmp_path, monkeypatch)


def test_forward_library_name_follows_mma_tf32_cuh(tmp_path, monkeypatch):
    """The forward source includes mma_tf32.cuh too (its split-TF32
    kernel shares the backward's blocks): a copy of csrc with it edited
    names another forward library."""
    assert _names_another_library("flash_attention", "mma_tf32.cuh",
                                  tmp_path, monkeypatch)


#: (dtype, head dim, forward design, backward design)
DESIGNS = [(torch.bfloat16, 128, "wgmma", "wgmma"),
           (torch.bfloat16, 16, "fma", "fma"),
           (torch.bfloat16, 8, "fma", "fma"),
           (torch.float32, 128, "fma", "fma"),
           (torch.float32, 16, "mma_tf32x3", "mma_tf32x3"),
           (torch.float32, 8, "mma_tf32x3", "mma_tf32x3")]


@pytest.mark.parametrize("dtype,head_dim,design,direction", [
    *[pytest.param(dt, d, fwd, "forward", id=f"dtype{i}-{d}-{fwd}")
      for i, (dt, d, fwd, _) in enumerate(DESIGNS)],
    *[pytest.param(dt, d, bwd, "backward",
                   id=f"backward-dtype{i}-{d}-{bwd}")
      for i, (dt, d, _, bwd) in enumerate(DESIGNS)]])
def test_flash_design(dtype, head_dim, design, direction):
    assert flash_design(dtype, head_dim, direction) == design


def test_flash_design_needs_a_direction():
    with pytest.raises(ValueError):
        flash_design(torch.float32, 16, "both")


#: the header enum's names and what flash_design calls them
ENUM_NAMES = {"kFma": "fma", "kWgmma": "wgmma", "kMmaTf32x3": "mma_tf32x3"}


def _header_enum():
    """flash_tiles.cuh's design codes: [(name, code)] in the enum's
    order."""
    header = (_build.CSRC / "flash_tiles.cuh").read_text()
    enum = re.search(r"enum Design : int \{([^}]*)\};", header)
    assert enum, "the design enum not found in flash_tiles.cuh"
    return [(name, int(code)) for name, code in
            re.findall(r"(\w+) = (\d+)", enum.group(1))]


def _header_rules():
    """The forward and backward rules as flash_tiles.cuh writes them,
    as functions of (dtype code, d) giving a design name."""
    header = (_build.CSRC / "flash_tiles.cuh").read_text()
    fwd = re.search(
        r"int fwd_design\(int dtype, int d\) \{\s*"
        r"return dtype == (\d+) && d == (\d+) \? (\w+)\s*"
        r": dtype == (\d+) && \(d == (\d+) \|\| d == (\d+)\) "
        r"\? (\w+)\s*: (\w+);\s*\}", header)
    assert fwd, "fwd_design not found in flash_tiles.cuh"
    bwd = re.search(r"int bwd_design\(int dtype, int d\) \{\s*"
                    r"return fwd_design\(dtype, d\);\s*\}", header)
    assert bwd, "bwd_design not found in flash_tiles.cuh"
    names = dict(_header_enum())
    assert {fwd.group(3), fwd.group(7), fwd.group(8)} <= set(names)

    def forward(code, d):
        if code == int(fwd.group(1)) and d == int(fwd.group(2)):
            return ENUM_NAMES[fwd.group(3)]
        if code == int(fwd.group(4)) and d in (int(fwd.group(5)),
                                               int(fwd.group(6))):
            return ENUM_NAMES[fwd.group(7)]
        return ENUM_NAMES[fwd.group(8)]

    return {"forward": forward, "backward": forward}


@pytest.mark.parametrize("source", FLASH_SOURCES)
def test_sources_state_the_design_rule_of_flash_design(source):
    """Each rule is written once in flash_tiles.cuh (``fwd_design`` for
    the forward, ``bwd_design``, on top of it, for the backward); each
    source dispatches by its rule and states no rule of its own, and the
    rule picks what ``flash_design`` says for every dtype code (0
    float32, 1 bfloat16) and head dim."""
    direction = {"flash_attention": "forward",
                 "flash_attention_bwd": "backward"}[source]
    rules = _header_rules()
    code = (_build.CSRC / f"{source}.cu").read_text()
    assert '#include "flash_tiles.cuh"' in code
    call = {"forward": "fwd_design(dtype, d)",
            "backward": "bwd_design(dtype, d)"}[direction]
    assert call in code
    assert "int fwd_design" not in code
    assert "int bwd_design" not in code
    assert "enum Design" not in code
    dtypes = {0: torch.float32, 1: torch.bfloat16}
    for dtype_code, dtype in dtypes.items():
        for d in (8, 16, 128):
            assert flash_design(dtype, d, direction) == \
                rules[direction](dtype_code, d)


def test_python_names_the_backward_design_codes():
    """``FLASH_DESIGNS`` reads ``iotml_flash_bwd_design``'s codes (and
    ``iotml_flash_fwd_design``'s: one enum) in the order the header's
    enum gives them."""
    from iotml_torch.ops.attention import FLASH_DESIGNS

    assert FLASH_DESIGNS == ("fma", "wgmma", "mma_tf32x3")


def test_python_names_the_forward_design_codes_in_the_enum_order():
    """The forward's codes are the header enum's, 0, 1, 2 in order, and
    ``FLASH_DESIGNS`` names them in that order; every name is one that
    ``flash_design`` gives in the forward."""
    from iotml_torch.ops.attention import FLASH_DESIGNS

    enum = _header_enum()
    assert [code for _, code in enum] == list(range(len(enum)))
    assert tuple(ENUM_NAMES[name] for name, _ in enum) == FLASH_DESIGNS
    said = {flash_design(dtype, d, "forward")
            for dtype in (torch.float32, torch.bfloat16) for d in (8, 16, 128)}
    assert said == set(FLASH_DESIGNS)


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
