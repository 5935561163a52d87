"""Socket primitives of the Kafka wire layer (``iotml.utils.net``'s copy)."""

from __future__ import annotations

from typing import List, Tuple


def parse_bootstrap(servers: str, default_port: int = 9092
                    ) -> List[Tuple[str, int]]:
    """bootstrap.servers string → [(host, port)], skipping malformed
    entries (one typo'd port must not defeat the rest of the list).
    Understands "host", "host:port", and bracketed IPv6 "[::1]:port"."""
    out: List[Tuple[str, int]] = []
    for entry in servers.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if entry.startswith("["):  # [v6addr]:port
            addr, _, rest = entry[1:].partition("]")
            port_s = rest.lstrip(":")
        else:
            addr, _, port_s = entry.partition(":")
        try:
            port = int(port_s) if port_s else default_port
        except ValueError:
            continue  # malformed entry: try the others
        if addr:
            out.append((addr, port))
    return out


def recv_exact(sock, n: int, closed_msg: str = "peer closed") -> bytes:
    """Read exactly n bytes or raise ConnectionError on EOF."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(closed_msg)
        buf += chunk
    return buf
