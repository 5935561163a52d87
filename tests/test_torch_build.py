"""The port's CUDA build bookkeeping and backward-design rule, on the CPU.

No ``nvcc`` runs here: ``_build.library_path`` only hashes sources, and
``flash_bwd_design`` is plain Python (the library's
``iotml_flash_bwd_design`` is held against it on the card by
``chip_smoke.py``).
"""

import pytest
import torch

from iotml_torch.ops import _build
from iotml_torch.ops.attention import flash_bwd_design


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


def test_backward_library_name_follows_hopper_cuh(tmp_path, monkeypatch):
    """The repository's flash_attention_bwd.cu includes hopper.cuh: a
    copy of csrc with that header edited names another library."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    assert '#include "hopper.cuh"' in \
        (tmp_path / "flash_attention_bwd.cu").read_text()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("flash_attention_bwd")
    with open(tmp_path / "hopper.cuh", "a") as header:
        header.write("// edited\n")
    assert _build.library_path("flash_attention_bwd") != before


@pytest.mark.parametrize("dtype,head_dim,design", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "fma"),
    (torch.bfloat16, 8, "fma"),
    (torch.float32, 128, "fma"),
    (torch.float32, 16, "fma"),
    (torch.float32, 8, "fma"),
])
def test_flash_bwd_design(dtype, head_dim, design):
    assert flash_bwd_design(dtype, head_dim) == design
