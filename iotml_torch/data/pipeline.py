"""The pipeline's process-level knobs (``iotml.data.pipeline``, cut to the
prefetch depth).

Knobs are environment toggles in ``config.NON_CONFIG``, like
``IOTML_TRACE``; a malformed value fails loudly:

  IOTML_PREFETCH_DEPTH  ``DevicePrefetcher`` queue depth (default 2,
                        double buffering; at least 1)

The JAX module's other knobs belong to code the port has not got: the
decode ring (``IOTML_DECODE_RING_BUFFERS``, ``IOTML_RAW_BATCH_BYTES``,
ROADMAP A3, item 13), the raw write path (``IOTML_RAW_PRODUCE``,
``IOTML_PRODUCE_BATCH_BYTES``, A13) and the mesh (``IOTML_MESH_DATA``,
``IOTML_DEVICE_NORMALIZE``, A10).  ``set_knobs`` raises naming the item
when one of them is given.
"""

from __future__ import annotations

import os
from typing import Optional

_PREFETCH_DEFAULT, _PREFETCH_MIN = 2, 1

#: knobs of the JAX module the port has not got → the ROADMAP item
UNPORTED_KNOBS = {"decode_ring_buffers": "A3, item 13",
                  "raw_batch_bytes": "A3, item 13",
                  "produce_batch_bytes": "A13", "raw_produce": "A13",
                  "mesh_data": "A10", "device_normalize": "A10"}


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


def set_knobs(prefetch_depth: Optional[int] = None, **unported) -> None:
    """CLI → env bridge: publish the given knobs into this process's
    environment (validated first; None leaves one as it is), so every
    pipeline built afterwards reads them."""
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
