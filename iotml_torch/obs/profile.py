"""Profiler captures on ``torch.profiler`` (``iotml.obs.profile``'s twin).

    from iotml_torch.obs.profile import trace, annotate

    with trace("./logs") as cap:           # one captured window
        trainer.fit_compiled(batches, epochs=20)
    print(cap.summary())                   # busy share, top device ops

    with annotate("decode"):               # a named span in a capture
        batches = list(iter(sensor_batches))

``trace`` writes a Chrome / TensorBoard trace (``*.pt.trace.json``) into
``logdir``; Perfetto and TensorBoard's profile plugin read it.  On a CUDA
device it synchronizes at both ends of the window, so queued work from
before the window is not measured in it.  ``device_summary`` reads a
written trace: the device's busy share is the UNION of its kernel, copy
and memset intervals over the window (intervals on two streams overlap,
so their sum would count twice), and its top operations by summed time.
``maybe_trace(logdir)`` captures when it is given a directory and is a
no-op otherwise, for a call site driven by its own option.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, List, Optional

import torch

#: trace-event categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Capture:
    """One capture window: ``path`` of the trace written (set when the
    window closes), ``window_s`` its wall seconds, ``cuda`` whether the
    device was traced."""

    def __init__(self, logdir: str, cuda: bool):
        self.logdir = logdir
        self.cuda = cuda
        self.path: Optional[str] = None
        self.window_s = 0.0

    def summary(self, top: int = 5) -> dict:
        return device_summary(self.path, self.window_s, top=top)


@contextlib.contextmanager
def trace(logdir: str = "./logs") -> Iterator[Capture]:
    """Capture a profiler window into ``logdir``; yields its ``Capture``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    cap = Capture(logdir, cuda)
    if cuda:
        torch.cuda.synchronize()
    prof = profile(activities=acts)
    prof.__enter__()
    t0 = time.perf_counter()
    try:
        yield cap
    finally:
        if cuda:
            torch.cuda.synchronize()
        cap.window_s = time.perf_counter() - t0
        prof.__exit__(None, None, None)
        cap.path = os.path.join(
            logdir, f"iotml.{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(cap.path)


def annotate(name: str):
    """A named span on the trace timeline (``record_function``)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def maybe_trace(logdir: Optional[str]) -> Iterator[Optional[Capture]]:
    """``trace`` into ``logdir`` when one is given; a no-op yielding None
    otherwise."""
    if logdir:
        with trace(logdir) as cap:
            yield cap
    else:
        yield None


def trace_files(logdir: str) -> List[str]:
    """Paths of captured trace files under a log directory."""
    out = []
    for root, _dirs, files in os.walk(logdir):
        for f in files:
            if ".trace" in f or f.endswith((".pb", ".json.gz", ".xplane.pb")):
                out.append(os.path.join(root, f))
    return sorted(out)


def union_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_summary(path: str, window_s: float, top: int = 5) -> dict:
    """Busy share and top device operations of a written trace.

    ``busy_share`` = union of the device intervals / ``window_s``;
    ``device_ms`` the union, ``device_sum_ms`` the plain sum (above the
    union when streams overlapped); ``top`` the ``top`` operations by
    summed time, each with its count."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((ts, ts + dur))
        name = e.get("name", "?")
        n, d = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, d + dur)
    busy_us = union_us(spans)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"window_ms": window_s * 1e3, "device_ms": busy_us / 1e3,
            "device_sum_ms": sum(e - s for s, e in spans) / 1e3,
            "device_ops": len(spans),
            "busy_share": busy_us / 1e6 / window_s if window_s > 0 else 0.0,
            "top": [{"name": k, "count": n, "ms": d / 1e3}
                    for k, (n, d) in ranked]}
