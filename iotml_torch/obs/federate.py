"""In-process endpoint registry (``iotml.obs.federate``, cut to
``register_local_endpoint``): every metrics server records its address
here.  The federation collector, the endpoints manifest and the merged
fleet view are ROADMAP A13."""

from __future__ import annotations

import threading
from typing import Dict, List

_local_lock = threading.Lock()
_local_endpoints: Dict[str, str] = {}


def register_local_endpoint(name: str, address: str) -> None:
    with _local_lock:
        _local_endpoints[name] = address


def local_endpoints() -> List[dict]:
    with _local_lock:
        return [{"name": n, "address": a}
                for n, a in sorted(_local_endpoints.items())]
