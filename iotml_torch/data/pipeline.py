"""The pipeline's process-level knobs (``iotml.data.pipeline``, cut to the
prefetch depth and the write-path selector).

Knobs are environment toggles in ``config.NON_CONFIG``, like
``IOTML_TRACE``; a malformed value fails loudly:

  IOTML_PREFETCH_DEPTH  ``DevicePrefetcher`` queue depth (default 2,
                        double buffering; at least 1)
  IOTML_RAW_PRODUCE     auto | on | off (default auto): ``off`` makes the
                        durable broker's ``produce_many`` frame record by
                        record instead of one native batch call (the JAX
                        package's debug escape hatch)

The JAX module's other knobs belong to code the port has not got: the
decode ring (``IOTML_DECODE_RING_BUFFERS``, ``IOTML_RAW_BATCH_BYTES``)
and the raw produce requests (``IOTML_PRODUCE_BATCH_BYTES``), ROADMAP
A3, item 13 with A13's raw wire extensions, and the mesh
(``IOTML_MESH_DATA``, ``IOTML_DEVICE_NORMALIZE``, A10).  ``set_knobs``
raises naming the item when one of them is given.
"""

from __future__ import annotations

import os
from typing import Optional

_PREFETCH_DEFAULT, _PREFETCH_MIN = 2, 1
#: the ROADMAP item of the raw produce/fetch requests (the next slice)
RAW_WIRE_ITEM = "A3, item 13 with A13's raw wire extensions"

#: knobs of the JAX module the port has not got → the ROADMAP item
UNPORTED_KNOBS = {"decode_ring_buffers": "A3, item 13",
                  "raw_batch_bytes": "A3, item 13",
                  "produce_batch_bytes": RAW_WIRE_ITEM,
                  "mesh_data": "A10", "device_normalize": "A10"}
_RAW_PRODUCE_MODES = ("auto", "on", "off")


def prefetch_depth() -> int:
    """DevicePrefetcher queue depth (IOTML_PREFETCH_DEPTH, default 2)."""
    raw = os.environ.get("IOTML_PREFETCH_DEPTH")
    if raw is None or raw == "":
        return _PREFETCH_DEFAULT
    try:
        value = int(raw)
    except ValueError as e:
        raise ValueError(f"env IOTML_PREFETCH_DEPTH={raw!r}: expected an "
                         f"integer (>= {_PREFETCH_MIN})") from e
    if value < _PREFETCH_MIN:
        raise ValueError(f"env IOTML_PREFETCH_DEPTH={value}: must be >= "
                         f"{_PREFETCH_MIN} (prefetch depth 0 would be "
                         f"UNBOUNDED, see data/pipeline.py)")
    return value


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
              raw_produce: Optional[str] = None, **unported) -> None:
    """CLI → env bridge: publish the given knobs into this process's
    environment (validated first; None leaves one as it is), so every
    pipeline built afterwards reads them."""
    if raw_produce is not None:
        mode = str(raw_produce).strip().lower()
        if mode not in _RAW_PRODUCE_MODES:
            # validate BEFORE publishing (same contract as below)
            raise ValueError(f"IOTML_RAW_PRODUCE={raw_produce!r}: expected "
                             f"one of {'|'.join(_RAW_PRODUCE_MODES)}")
    for name, value in unported.items():
        if name not in UNPORTED_KNOBS:
            raise TypeError(f"set_knobs() got an unexpected keyword "
                            f"argument {name!r}")
        if value is not None:
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP {UNPORTED_KNOBS[name]})")
    if prefetch_depth is not None:
        value = int(prefetch_depth)
        if value < _PREFETCH_MIN:
            # validate BEFORE publishing: a caught error must not leave
            # an invalid value active process-wide
            raise ValueError(f"IOTML_PREFETCH_DEPTH={value}: must be >= "
                             f"{_PREFETCH_MIN}")
        os.environ["IOTML_PREFETCH_DEPTH"] = str(value)
    if raw_produce is not None:
        os.environ["IOTML_RAW_PRODUCE"] = mode
