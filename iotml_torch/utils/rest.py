"""A routed JSON-over-HTTP server on the standard library
(``iotml.utils.rest``'s copy).

The reference drives two control-plane services over REST: the Schema
Registry (`register_schema.py:20-31`) and KSQL
(`01_installConfluentPlatform.sh`).  This scaffold is their one routing
layer: regex routes, JSON bodies, JSON replies, threaded serving.

Every surface mounted on it inherits two serving rules:

* **Per-request metrics**: every dispatch counts in
  ``iotml_rest_requests_total{route,code}`` and observes the matched
  route's ``iotml_rest_request_seconds``.  The route label is the
  registered PATTERN (one series per route, never per path).
* **Bounded concurrency**: a connection past ``max_concurrency``
  (``IOTML_REST_MAX_CONCURRENCY``, default 64) is answered with a raw
  ``503`` and closed before a handler thread exists; admitted handler
  threads are daemon, named and registered
  (``supervise.registry.register_thread``).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Tuple

from ..obs.metrics import default_registry
from ..supervise.registry import register_thread

#: A handler takes (match, body_dict) and returns (status_code, json_obj).
Route = Tuple[str, "re.Pattern", Callable]

#: connection-concurrency ceiling when the constructor doesn't pick one
#: (env IOTML_REST_MAX_CONCURRENCY).
DEFAULT_MAX_CONCURRENCY = 64

rest_requests = default_registry.counter(
    "iotml_rest_requests_total",
    "REST requests served, by registered route pattern and status code "
    "(route='(guard)' counts connections shed by the concurrency bound)")
rest_request_seconds = default_registry.histogram(
    "iotml_rest_request_seconds",
    "REST request handler latency by registered route pattern")


def _max_concurrency_default() -> int:
    raw = os.environ.get("IOTML_REST_MAX_CONCURRENCY")
    if raw is None:
        return DEFAULT_MAX_CONCURRENCY
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"IOTML_REST_MAX_CONCURRENCY={raw!r} is not an integer")
    if v < 1:
        raise ValueError(
            f"IOTML_REST_MAX_CONCURRENCY={v} must be >= 1: a zero bound "
            f"sheds every connection")
    return v


class RestError(Exception):
    """Raise from a route handler to produce an error reply."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class _BoundedThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a concurrent-connection ceiling and
    handler threads that are daemon, named and registered."""

    daemon_threads = True

    def __init__(self, addr, handler_cls, *, name: str, max_concurrency: int):
        super().__init__(addr, handler_cls)
        self.rest_name = name
        self.max_concurrency = max_concurrency
        self._guard_lock = threading.Lock()
        self._active = 0
        self._hseq = 0

    def active_connections(self) -> int:
        with self._guard_lock:
            return self._active

    def process_request(self, request, client_address):
        with self._guard_lock:
            if self._active >= self.max_concurrency:
                admitted = False
            else:
                admitted = True
                self._active += 1
                self._hseq += 1
                seq = self._hseq
        if not admitted:
            # shed BEFORE a handler thread exists: a raw one-shot 503 on
            # the accepted socket is the whole cost of an over-limit
            # connection — the storm can't grow the thread count
            body = (b'{"error_code":503,"message":'
                    b'"connection limit reached, retry"}')
            try:
                request.sendall(
                    b"HTTP/1.1 503 Service Unavailable\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: " + str(len(body)).encode() +
                    b"\r\nConnection: close\r\n\r\n" + body)
            except OSError:
                pass
            self.shutdown_request(request)
            rest_requests.inc(route="(guard)", code=503)
            return
        t = register_thread(threading.Thread(
            target=self._handle_admitted, args=(request, client_address),
            daemon=True, name=f"{self.rest_name}-h{seq}"))
        t.start()

    def _handle_admitted(self, request, client_address):
        try:
            self.finish_request(request, client_address)
        except (ConnectionResetError, BrokenPipeError):
            pass  # client vanished / connection severed: routine, not an error
        except Exception:
            self.handle_error(request, client_address)
        finally:
            self.shutdown_request(request)
            with self._guard_lock:
                self._active -= 1


class RestServer:
    """Routed threaded HTTP server; subclass or compose with `route()`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 name: str = "iotml-rest",
                 max_concurrency: Optional[int] = None):
        self.name = name
        self.max_concurrency = (_max_concurrency_default()
                                if max_concurrency is None
                                else int(max_concurrency))
        if self.max_concurrency < 1:
            raise ValueError(f"max_concurrency={self.max_concurrency} "
                             f"must be >= 1")
        self._routes: List[Route] = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = name
            # replies go out as two writes (header flush, then body);
            # with Nagle on, the body segment waits for the client's
            # delayed ACK — a flat ~40ms tax on every point lookup
            disable_nagle_algorithm = True

            def _dispatch(self, method: str):
                t0 = time.perf_counter()
                route_label = "(unmatched)"
                code = 404
                try:
                    route_label, code = self._dispatch_inner(method)
                finally:
                    rest_requests.inc(route=route_label, code=code)
                    rest_request_seconds.observe(
                        time.perf_counter() - t0, route=route_label)

            def _dispatch_inner(self, method: str) -> Tuple[str, int]:
                """Route + run a handler; returns (route_label, code)
                for the per-request metrics."""
                body = {}
                n = int(self.headers.get("Content-Length", 0) or 0)
                if n:
                    try:
                        body = json.loads(self.rfile.read(n))
                    except ValueError:
                        self._send(400, {"error_code": 400,
                                         "message": "malformed JSON body"})
                        return "(unmatched)", 400
                # routes match the bare path; query-string params merge
                # into the body dict (first value wins, body takes
                # precedence) so GET endpoints can take parameters
                path, _, qs = self.path.partition("?")
                if qs:
                    from urllib.parse import parse_qs

                    for k, vs in parse_qs(qs).items():
                        body.setdefault(k, vs[0])
                for m, pat, fn in outer._routes:
                    if m != method:
                        continue
                    match = pat.fullmatch(path)
                    if match:
                        try:
                            result = fn(match, body)
                            if len(result) == 3:  # (code, raw bytes, ctype)
                                self._send_raw(*result)
                                return pat.pattern, result[0]
                            code, obj = result
                        except RestError as e:
                            code, obj = e.code, {"error_code": e.code,
                                                 "message": e.message}
                        except Exception as e:  # route bug: 500, keep serving
                            code, obj = 500, {"error_code": 500, "message":
                                              f"{type(e).__name__}: {e}"}
                        self._send(code, obj)
                        return pat.pattern, code
                self._send(404, {"error_code": 404,
                                 "message": f"no route for {method} {self.path}"})
                return "(unmatched)", 404

            def _send(self, code: int, obj):
                self.send_response(code)
                if code == 204:  # No Content: a body would corrupt keep-alive
                    self.end_headers()
                    return
                payload = json.dumps(obj, default=str).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _send_raw(self, code: int, payload: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_DELETE(self):
                self._dispatch("DELETE")

            def log_message(self, *a):  # quiet
                pass

        self.httpd = _BoundedThreadingHTTPServer(
            (host, port), Handler, name=name,
            max_concurrency=self.max_concurrency)
        self.host, self.port = self.httpd.server_address
        self._thread: Optional[threading.Thread] = None

    def route(self, method: str, pattern: str, fn: Callable) -> None:
        """Register `fn(match, body) -> (code, obj)` for `method pattern`."""
        self._routes.append((method, re.compile(pattern), fn))

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def active_connections(self) -> int:
        """Handler threads currently admitted (below max_concurrency)."""
        return self.httpd.active_connections()

    def start(self):
        self._thread = register_thread(threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name=f"iotml-rest-{self.port}"))
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
