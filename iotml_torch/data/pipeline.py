"""The columnar decode ring and the pipeline's process-level knobs
(``iotml.data.pipeline``'s twin).

Raw frame batches (``Broker.fetch_raw``, the wire's RAW_FETCH) are
decoded by the native ``stream.native.FrameDecoder`` straight into a
small ring of reusable column buffers (float32 numeric, fixed-stride
labels and keys), so the steady state allocates nothing a record and
nothing a chunk beyond the normalized output block.  Decode runs on
whatever thread drains the batch iterator.

Knobs are environment toggles in ``config.NON_CONFIG``, like
``IOTML_TRACE``; a malformed value fails loudly:

  IOTML_PREFETCH_DEPTH       ``DevicePrefetcher`` queue depth (default 2,
                             double buffering; at least 1)
  IOTML_DECODE_RING_BUFFERS  slots in the decode ring (default 4; at
                             least 2, so the decode of chunk N + 1 never
                             overwrites a chunk the batcher still views)
  IOTML_RAW_BATCH_BYTES      most bytes a raw frame fetch asks for
                             (default 1 MiB: one disk or wire read a
                             decode call; at least 4096)
  IOTML_RAW_PRODUCE          auto | on | off (default auto): ``auto``
                             ships RAW_PRODUCE where the broker has it and
                             pins back to PRODUCE on UNSUPPORTED_VERSION,
                             ``on`` requires it (a server without it is
                             an error), ``off`` takes PRODUCE everywhere
                             and makes the durable broker's
                             ``produce_many`` frame record by record
  IOTML_PRODUCE_BATCH_BYTES  most frame bytes a RAW_PRODUCE request
                             carries (default 1 MiB; at least 4096):
                             larger batches split at frame boundaries
  IOTML_MESH_DATA            data-axis size of the training mesh (default
                             0 = off; 1 behaves like 0; >= 2 trains
                             data-parallel over that many devices, the
                             deploy manifests' chip count)
  IOTML_DEVICE_NORMALIZE     fold the normalization into the sharded step
                             (default off; needs IOTML_MESH_DATA >= 2)
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

#: name → (default, least allowed)
_DEFAULTS = {
    "IOTML_PREFETCH_DEPTH": (2, 1),
    "IOTML_DECODE_RING_BUFFERS": (4, 2),
    "IOTML_RAW_BATCH_BYTES": (1 << 20, 4096),
    "IOTML_PRODUCE_BATCH_BYTES": (1 << 20, 4096),
    "IOTML_MESH_DATA": (0, 0),
}

_RAW_PRODUCE_MODES = ("auto", "on", "off")


def _env_int(name: str) -> int:
    default, lo = _DEFAULTS[name]
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        value = int(raw)
    except ValueError as e:
        raise ValueError(f"env {name}={raw!r}: expected an integer "
                         f"(>= {lo})") from e
    if value < lo:
        why = "prefetch depth 0 would be UNBOUNDED, " \
            if "PREFETCH" in name else ""
        raise ValueError(f"env {name}={value}: must be >= {lo} ({why}"
                         f"see data/pipeline.py)")
    return value


def prefetch_depth() -> int:
    """DevicePrefetcher queue depth (IOTML_PREFETCH_DEPTH, default 2)."""
    return _env_int("IOTML_PREFETCH_DEPTH")


def decode_ring_buffers() -> int:
    """Decode-ring slot count (IOTML_DECODE_RING_BUFFERS, default 4)."""
    return _env_int("IOTML_DECODE_RING_BUFFERS")


def raw_batch_bytes() -> int:
    """Most bytes a raw frame fetch asks for (IOTML_RAW_BATCH_BYTES,
    1 MiB)."""
    return _env_int("IOTML_RAW_BATCH_BYTES")


def produce_batch_bytes() -> int:
    """Most frame bytes a RAW_PRODUCE request carries
    (IOTML_PRODUCE_BATCH_BYTES, 1 MiB)."""
    return _env_int("IOTML_PRODUCE_BATCH_BYTES")


def mesh_data() -> int:
    """Data-axis size of the training mesh (IOTML_MESH_DATA, default 0
    = off).  1 behaves like 0; >= 2 trains data-parallel."""
    return _env_int("IOTML_MESH_DATA")


def device_normalize() -> bool:
    """Device-side normalization (IOTML_DEVICE_NORMALIZE, default off);
    a malformed value fails loudly, like every knob."""
    raw = os.environ.get("IOTML_DEVICE_NORMALIZE", "0").strip().lower()
    if raw in ("", "0", "false", "off", "no"):
        return False
    if raw in ("1", "true", "on", "yes"):
        return True
    raise ValueError(f"env IOTML_DEVICE_NORMALIZE={raw!r}: expected a "
                     f"boolean (0|1|true|false|on|off)")


def raw_produce_mode() -> str:
    """Write-path plane selector (IOTML_RAW_PRODUCE): auto|on|off.
    A malformed value fails loudly, like every pipeline knob."""
    raw = os.environ.get("IOTML_RAW_PRODUCE", "auto").strip().lower()
    if raw == "":
        return "auto"
    if raw not in _RAW_PRODUCE_MODES:
        raise ValueError(f"env IOTML_RAW_PRODUCE={raw!r}: expected one "
                         f"of {'|'.join(_RAW_PRODUCE_MODES)}")
    return raw


def set_knobs(prefetch_depth: Optional[int] = None,
              decode_ring_buffers: Optional[int] = None,
              raw_batch_bytes: Optional[int] = None,
              produce_batch_bytes: Optional[int] = None,
              raw_produce: Optional[str] = None,
              mesh_data: Optional[int] = None,
              device_normalize: Optional[bool] = None) -> None:
    """CLI → env bridge: publish the given knobs into this process's
    environment (each validated before any is published; None leaves one
    as it is), so every pipeline built afterwards reads them."""
    if raw_produce is not None:
        mode = str(raw_produce).strip().lower()
        if mode not in _RAW_PRODUCE_MODES:
            raise ValueError(f"IOTML_RAW_PRODUCE={raw_produce!r}: expected "
                             f"one of {'|'.join(_RAW_PRODUCE_MODES)}")
    ints = {}
    for name, value in (("IOTML_PREFETCH_DEPTH", prefetch_depth),
                        ("IOTML_DECODE_RING_BUFFERS", decode_ring_buffers),
                        ("IOTML_RAW_BATCH_BYTES", raw_batch_bytes),
                        ("IOTML_PRODUCE_BATCH_BYTES", produce_batch_bytes),
                        ("IOTML_MESH_DATA", mesh_data)):
        if value is None:
            continue
        value = int(value)
        lo = _DEFAULTS[name][1]
        if value < lo:
            # validate BEFORE publishing: a caught error must not leave
            # an invalid value active process-wide
            raise ValueError(f"{name}={value}: must be >= {lo}")
        ints[name] = str(value)
    os.environ.update(ints)
    if raw_produce is not None:
        os.environ["IOTML_RAW_PRODUCE"] = mode
    if device_normalize is not None:
        os.environ["IOTML_DEVICE_NORMALIZE"] = \
            "1" if bool(device_normalize) else "0"


class _Slot:
    """One reusable set of column buffers (a decode target)."""

    __slots__ = ("x", "labels", "keys")

    def __init__(self, rows: int, n_numeric: int, n_strings: int,
                 label_stride: int, key_stride: int, with_keys: bool):
        self.x = np.zeros((rows, n_numeric), np.float32)
        self.labels = np.zeros((rows, max(n_strings, 1)),
                               f"S{label_stride}")
        self.keys = np.zeros((rows,), f"S{key_stride}") if with_keys \
            else None


class DecodeRing:
    """Round-robin ring of preallocated columnar decode buffers.

    The decoder fills slot i while the batcher may still hold views of
    the slots before it (the tail carried between chunks keeps at most
    the last partial chunk alive, and the normalized output is always a
    fresh block), so with at least 2 slots a decode never overwrites
    bytes a held view still reads.  The buffers are allocated once for
    the pipeline's lifetime.
    """

    def __init__(self, rows: int, n_numeric: int, n_strings: int,
                 label_stride: int = 16, key_stride: int = 64,
                 with_keys: bool = False,
                 n_buffers: Optional[int] = None):
        n = decode_ring_buffers() if n_buffers is None else int(n_buffers)
        if n < 2:
            raise ValueError(f"decode ring needs >= 2 buffers, got {n}")
        self.rows = int(rows)
        self._slots: List[_Slot] = [
            _Slot(self.rows, n_numeric, n_strings, label_stride,
                  key_stride, with_keys)
            for _ in range(n)]
        self._i = 0

    def __len__(self) -> int:
        return len(self._slots)

    def next_slot(self) -> _Slot:
        """The next decode target (round-robin reuse)."""
        slot = self._slots[self._i]
        self._i = (self._i + 1) % len(self._slots)
        return slot
