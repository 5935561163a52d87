"""Training scalar logging: TensorBoard + JSONL (``iotml.obs.tb``'s
twin).

The reference wires TensorBoard callbacks into fit and commits the resulting
event files (SURVEY §5 'tracing/profiling').  Here: a `ScalarLogger` that
writes TensorBoard event files via tensorboardX where that package imports
and always mirrors to a plain JSONL file (grep-able, no reader dep), plus a
`TorchProfiler` class over `obs.profile.trace` (``torch.profiler``) — the
counterpart of the JAX package's `JaxProfiler`.
"""

from __future__ import annotations

import json
import os
import time


class ScalarLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "wall_time": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def history(self, history: dict, prefix: str = "train"):
        """Log a Trainer.fit history dict (per-epoch scalars)."""
        for i, loss in enumerate(history.get("loss", [])):
            self.scalar(f"{prefix}/loss", loss, i)
        for i, acc in enumerate(history.get("accuracy", [])):
            self.scalar(f"{prefix}/accuracy", acc, i)
        for i, s in enumerate(history.get("seconds", [])):
            self.scalar(f"{prefix}/epoch_seconds", s, i)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class TorchProfiler:
    """``torch.profiler`` capture session → a trace directory.

    Thin class wrapper over `obs.profile.trace` (``maybe_trace`` offers
    the same capture conditioned on a directory); after the block,
    ``capture`` holds the window's capture (``summary()``)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._cm = None
        self.capture = None

    def __enter__(self):
        from .profile import trace

        self._cm = trace(self.log_dir)
        self.capture = self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)
