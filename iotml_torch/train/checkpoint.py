"""Checkpoint/resume: model state + explicit stream cursors
(``iotml.train.checkpoint``'s ``CheckpointManager``).

One checkpoint step holds the params, the Adam state ``(count, mu, nu)``,
the step count and the ``(topic, partition, next_offset)`` cursors from
``StreamConsumer.positions()``, so a restarted job resumes both model
and stream.  The JAX package writes an orbax pytree; the port writes
``step_<n>/arrays.npz`` (float32 arrays under ``params/``, ``mu/`` and
``nu/`` + the state_dict key, the autoencoder's or the LSTM's dotted
names alike) and ``step_<n>/manifest.json`` (step,
Adam count, cursors), which numpy and the standard library read.

Crash safety: a save stages into a hidden ``.tmp_step_<n>`` directory,
fsyncs its files, renames it into place and fsyncs the parent, so a kill
mid-save never leaves a half-written ``step_*`` under the canonical
name; ``restore()`` walks steps newest-first and skips a torn one back
to the newest intact step, counting it in ``skipped_torn``.
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Optional

import numpy as np
import torch

from ..store.segment import fsync_dir
from .optim import AdamState

FORMAT = "iotml_torch.checkpoint/1"
ARRAYS = "arrays.npz"
MANIFEST = "manifest.json"
#: what a torn or corrupt step raises while it loads
_TORN = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _write_synced(path: str, write) -> None:
    with open(path, "wb") as fh:
        write(fh)
        fh.flush()
        os.fsync(fh.fileno())


class CheckpointManager:
    """save/restore (train state, cursors) under one directory."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        #: torn/corrupt step dirs skipped by the last restore() walk
        self.skipped_torn = 0

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def save(self, state, cursors=None, step: Optional[int] = None) -> str:
        """Write ``state`` (a ``TrainState``: step, params state_dict,
        ``AdamState``) and the cursors as step ``step`` (default: the
        state's step); returns the step directory."""
        step = int(state.step) if step is None else step
        opt = state.opt_state
        arrays = {}
        for prefix, tree in (("params", state.params), ("mu", opt.mu),
                             ("nu", opt.nu)):
            for name, value in tree.items():
                arrays[f"{prefix}/{name}"] = _host(value)
        manifest = {"format": FORMAT, "step": int(state.step),
                    "adam_count": int(opt.count),
                    "params": list(state.params),
                    "cursors": [list(c) for c in (cursors or [])]}
        final = self._path(step)
        tmp = os.path.join(self.directory, f".tmp_step_{step:010d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        _write_synced(os.path.join(tmp, ARRAYS),
                      lambda fh: np.savez(fh, **arrays))
        _write_synced(os.path.join(tmp, MANIFEST),
                      lambda fh: fh.write(json.dumps(manifest).encode()))
        fsync_dir(tmp)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        fsync_dir(self.directory)
        return final

    def steps(self) -> list:
        """Committed step ids, ascending (staged .tmp dirs excluded)."""
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        """Restore ``step``, or the newest INTACT checkpoint (None when
        there is none).  An explicit step raises if it is torn: the
        caller named it.

        Returns ``{"params": {name: CPU tensor}, "opt_state": AdamState,
        "step": int, "cursors": [(topic, partition, offset)]}``."""
        self.skipped_torn = 0
        if step is not None:
            return self.load_dir(self._path(step))
        for s in reversed(self.steps()):
            try:
                return self.load_dir(self._path(s))
            except _TORN:
                self.skipped_torn += 1
        return None

    @staticmethod
    def load_dir(path: str) -> dict:
        """Load one step directory (as ``restore`` returns it)."""
        with open(os.path.join(path, MANIFEST), "rb") as fh:
            manifest = json.loads(fh.read())
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{path}: not an {FORMAT} checkpoint")
        with np.load(os.path.join(path, ARRAYS), allow_pickle=False) as z:
            trees = {prefix: {name: torch.from_numpy(
                         np.array(z[f"{prefix}/{name}"]))
                         for name in manifest["params"]}
                     for prefix in ("params", "mu", "nu")}
        return {"params": trees["params"],
                "opt_state": AdamState(count=int(manifest["adam_count"]),
                                       mu=trees["mu"], nu=trees["nu"]),
                "step": int(manifest["step"]),
                "cursors": [(c[0], int(c[1]), int(c[2]))
                            for c in manifest["cursors"]]}
