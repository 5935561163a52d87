"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers,
so ``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

The library lands in ``iotml_torch/ops/build/`` (gitignored), named by
the hash of its source, so an edited source builds anew and an unchanged
one is reused.  A ``<name>.lock`` file in the build directory keeps two
processes from building one source together (different sources build in
parallel); one left behind by a killed build must be deleted by hand
(the error names it).  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LOCK_WAIT_S = 600.0

_LOADED: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


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
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns the
    compiler log (``-Xptxas -v``: registers, shared memory, spills), or ""
    when nothing was built; raises RuntimeError on a failed build."""
    BUILD.mkdir(parents=True, exist_ok=True)
    with _BuildLock(BUILD / f"{name}.lock"):
        target = library_path(name)
        if target.exists():
            return ""
        tmp = target.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        (BUILD / f"{name}.log").write_text(proc.stdout)
        if proc.returncode != 0:
            if tmp.exists():
                tmp.unlink()
            raise RuntimeError(f"CUDA build of {name} failed (nvcc exit "
                               f"{proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, target)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build(name)
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
