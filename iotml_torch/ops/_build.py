"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers,
so ``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

The library lands in ``iotml_torch/ops/build/`` (gitignored), named by
the hash of its source and of the ``csrc/*.cuh`` headers, so an edited
source or header builds anew and an unchanged one is reused.  The
compiler's log lies beside the library (``build_log``); a library
without its log is built again.  A ``<name>.lock`` file in the build
directory keeps two processes from building one source together
(different sources build in parallel); one left behind by a killed build
must be deleted by hand (the error names it).  Nothing here runs at
import.

For the timing scripts, ``build_variant`` builds a copy of ``csrc`` with
text edits under ``build/variants/<tag>/``, and ``ptxas_kernels`` reads
each kernel's registers and spills from a compiler log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LOCK_WAIT_S = 600.0

_LOADED: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library goes: named by the hash of the
    source and of every ``csrc/*.cuh`` header it may include."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels build on a "
                       "machine with the CUDA toolkit")


class _BuildLock:
    def __init__(self, path: Path):
        self.path = path

    def __enter__(self):
        deadline = time.monotonic() + LOCK_WAIT_S
        while True:
            try:
                os.close(os.open(self.path, os.O_CREAT | os.O_EXCL))
                return self
            except FileExistsError:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"{self.path} held for {LOCK_WAIT_S:.0f} s: if no "
                        f"build is running, delete it") from None
                time.sleep(0.2)

    def __exit__(self, *exc):
        os.unlink(self.path)


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library and the library's
    log exist.  Returns the compiler log (``-Xptxas -v``: registers,
    shared memory, spills), or "" when nothing was built; raises
    RuntimeError on a failed build."""
    BUILD.mkdir(parents=True, exist_ok=True)
    with _BuildLock(BUILD / f"{name}.lock"):
        target = library_path(name)
        if target.exists() and target.with_suffix(".log").exists():
            return ""
        tmp = target.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        target.with_suffix(".log").write_text(proc.stdout)
        if proc.returncode != 0:
            if tmp.exists():
                tmp.unlink()
            raise RuntimeError(f"CUDA build of {name} failed (nvcc exit "
                               f"{proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, target)
    return proc.stdout


def build_log(name: str) -> str:
    """Build ``csrc/<name>.cu`` if needed; the compiler's log of the
    library that is there now (``-Xptxas -v``: registers, shared memory,
    spills)."""
    build(name)
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build(name)
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib


def build_variant(name: str, tag: str,
                  edits: Iterable[Tuple[str, str, str]]) -> Tuple[Path, str]:
    """Build ``csrc/<name>.cu`` from a copy of ``csrc`` under
    ``build/variants/<tag>/`` in which each ``(file, old, new)`` edit
    replaces every ``old`` in ``file`` by ``new``.  Returns the library's
    path and the compiler log; raises RuntimeError on an edit whose
    ``old`` is not in its file or on a failed build.  The port itself
    loads only what ``build`` makes."""
    where = BUILD / "variants" / tag
    shutil.rmtree(where, ignore_errors=True)
    shutil.copytree(CSRC, where)
    for file, old, new in edits:
        text = (where / file).read_text()
        if old not in text:
            raise RuntimeError(f"variant {tag}: {old!r} not in {file}")
        (where / file).write_text(text.replace(old, new))
    lib = where / f"lib{name}.so"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(where / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {tag}: nvcc exit {proc.returncode}\n"
                           f"{proc.stdout}")
    return lib, proc.stdout


def ptxas_kernels(log: str, name_of: Callable[[str], Optional[str]]
                  ) -> Dict[str, Dict[str, int]]:
    """Registers and spilled bytes of each kernel in an ``-Xptxas -v``
    log: ``{name: {"registers", "spill_stores", "spill_loads"}}``, where
    ``name_of`` gives a kernel's name from its mangled symbol, or None to
    leave it out."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name = name_of(found.group(1))
            if name is not None:
                out[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   line).group(1))
            name = None
    return out
