"""Record-level trace context and per-stage telemetry
(``iotml.obs.tracing``'s twin, the same spans, histograms, span log and
header wire format).

- A ``TraceContext`` is born where a record is published (the fleet
  generator, the scenario streams), rides the in-process broker in the
  record's headers (``Message.headers``, key ``iotml_trace``) so the
  Avro payload is untouched, is forked and marked ``consume`` by the
  batcher, and is closed at the train step or the scorer.
- Spans are monotonic-clock durations from the birth instant; one wall
  clock read at birth stamps the trace for the span log.
- Marks go into a lock-free collector: a per-thread bounded ``deque``
  (GIL-atomic append, drop-oldest, counted) registered once per thread.
- ``flush()`` (the ``/metrics`` scrape, ``/healthz``, atexit) drains it
  into ``iotml_stage_seconds{stage}`` and the e2e histograms and, when a
  path is set, a JSONL span log that ``python -m iotml_torch.obs trace``
  summarizes.

Off by default: every site guards on ``tracing.ENABLED``.  ``IOTML_TRACE=1``
turns it on, ``IOTML_TRACE_SAMPLE`` samples births, ``IOTML_TRACE_PATH``
names the span log; ``config.NON_CONFIG`` lists them.

Byte form, for transports that carry bytes: ``iotml1;<trace id hex16>;
<birth unix ns>;<elapsed ns>`` (``encode`` / ``decode``).  The wire and
native Kafka clients carry no headers (MessageSet v1 has no slot), so a
trace ends at a TCP broker boundary, as in the JAX package.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import metrics as _metrics

#: module flag every hot-path site guards on.  Mutated only via
#: configure(); reading a module attribute is the whole disabled cost.
ENABLED = False

#: probability a newborn record is traced (1.0 = every record).
_SAMPLE = 1.0

#: JSONL span-log path (None = histograms only).
_PATH: Optional[str] = None

#: header key the context rides under in Message.headers.
HEADER_KEY = "iotml_trace"

_WIRE_PREFIX = "iotml1"


def proc_name() -> str:
    """This process's identity in cross-process span logs: IOTML_PROC
    when the operator names the role (scorer/trainer/broker-0/...),
    else pid-derived.  Several fleet processes append to ONE span log
    (O_APPEND line writes); the proc field is what lets the trace CLI
    reconstruct which process ran which stage."""
    return os.environ.get("IOTML_PROC") or f"pid{os.getpid()}"

#: per-thread span buffer bound — overload drops oldest, counted below.
_BUFFER_BOUND = 65536

# ------------------------------------------------------------- exporters
stage_seconds = _metrics.default_registry.histogram(
    "iotml_stage_seconds", "per-stage pipeline latency (label: stage)",
    buckets=(0.00001, 0.0001, 0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0))
e2e_ingest_to_score_seconds = _metrics.default_registry.histogram(
    "iotml_e2e_ingest_to_score_seconds",
    "end-to-end latency, record ingest to scorer close")
e2e_ingest_to_train_seconds = _metrics.default_registry.histogram(
    "iotml_e2e_ingest_to_train_seconds",
    "end-to-end latency, record ingest to train-step close")
spans_dropped = _metrics.default_registry.counter(
    "iotml_trace_spans_dropped_total",
    "spans dropped by the bounded per-thread collector")
log_write_errors = _metrics.default_registry.counter(
    "iotml_trace_log_write_errors_total",
    "span-log appends that failed (unwritable path, full disk)")


# ------------------------------------------------------------- collector
class _Buf:
    """One thread's span buffer + its local overload-drop count.  The
    drop count is a plain int mutated only by the owning thread (folded
    into the shared counter at drain) so the record path touches no
    shared lock even when the buffer is saturated."""

    __slots__ = ("q", "drops", "thread")

    def __init__(self, thread: threading.Thread):
        self.q: collections.deque = collections.deque(maxlen=_BUFFER_BOUND)
        self.drops = 0
        self.thread = thread


class _Collector:
    """Per-thread bounded deques; append is GIL-atomic (no lock on the
    record path), the registry of buffers is locked only at thread
    registration and drain — never while a span is recorded."""

    def __init__(self):
        self._tls = threading.local()
        self._buffers: List[_Buf] = []
        self._reg_lock = threading.Lock()

    def buffer(self) -> _Buf:
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = _Buf(threading.current_thread())
            self._tls.buf = buf
            with self._reg_lock:
                self._buffers.append(buf)
        return buf

    def record(self, entry: tuple) -> None:
        buf = self.buffer()
        if len(buf.q) == buf.q.maxlen:
            buf.drops += 1  # thread-local; folded in at drain (no lock)
        buf.q.append(entry)

    def drain(self) -> List[tuple]:
        with self._reg_lock:
            buffers = list(self._buffers)
        out: List[tuple] = []
        for buf in buffers:
            # popleft until empty: concurrent appends land at the right
            # and are picked up by this or the next drain — never lost,
            # never double-read
            while True:
                try:
                    out.append(buf.q.popleft())
                except IndexError:
                    break
        dropped = 0
        dead: List[_Buf] = []
        # drop-count folding and dead-thread pruning under the registry
        # lock: concurrent drainers (two scrapes) must not both read the
        # same buf.drops and double-count it.  Recording threads never
        # touch this lock (registration is the documented once-per-thread
        # exception); an owner increment landing exactly between the read
        # and the reset below is lost — approximate under overload, by
        # design, never a crash.
        with self._reg_lock:
            for buf in buffers:
                if buf.drops:
                    dropped += buf.drops
                    buf.drops = 0
                # prune buffers of exited threads: without this the
                # registry grows one dead deque per finished thread.  Just
                # drained empty + owner dead = nothing can land in it.
                if not buf.q and not buf.thread.is_alive():
                    dead.append(buf)
            if dead:
                self._buffers = [b for b in self._buffers
                                 if b not in dead]
        if dropped:
            spans_dropped.inc(dropped)
        return out


_collector = _Collector()

#: stage → monotonic time of the newest drained span: per-stage liveness
#: for the /healthz status section (age = now - value).
_last_seen: Dict[str, float] = {}

#: current-trace slot for synchronous fan-out propagation (a consumer
#: that runs on the publisher's thread reads the publisher's context
#: without a header slot).
_current = threading.local()

_log_lock = threading.Lock()  # serializes span-log file appends (drain only)


class TraceContext:
    """One record's journey.  `mark(stage)` records the span since the
    previous mark; `close(closer)` marks the final stage and the e2e
    span.  All durations are monotonic-clock."""

    __slots__ = ("trace_id", "t0", "t_last", "wall0_ns", "closed")

    def __init__(self, trace_id: Optional[int] = None,
                 t0: Optional[float] = None,
                 wall0_ns: Optional[int] = None):
        self.trace_id = trace_id if trace_id is not None \
            else random.getrandbits(64)
        self.t0 = t0 if t0 is not None else time.monotonic()
        self.t_last = self.t0
        self.wall0_ns = wall0_ns if wall0_ns is not None \
            else time.time_ns()  # wallclock-ok: trace birth timestamp for the span log, not a deadline
        self.closed = False

    # ------------------------------------------------------------ spans
    def mark(self, stage: str) -> None:
        """Record the span from the previous mark to now as `stage`.

        A closed context records nothing more: an epoch re-read polls the
        same header-carried context again, and re-marking it would book
        the inter-epoch gap as pipeline latency."""
        if self.closed:
            return
        now = time.monotonic()
        # `now` rides along so liveness() can report the span's MARK
        # time, not the drain time — a stalled stage probed much later
        # must show its true age
        _collector.record(("span", self.trace_id, stage,
                           self.t_last - self.t0, now - self.t_last,
                           self.wall0_ns, now))
        self.t_last = now

    def close(self, closer: str) -> None:
        """Final stage (`train` / `score`) + the end-to-end span."""
        if self.closed:
            return
        self.mark(closer)
        self.closed = True
        _collector.record(("e2e", self.trace_id, closer,
                           self.t_last - self.t0, self.wall0_ns))

    def fork(self) -> "TraceContext":
        """Per-consumer continuation of a shared upstream context.

        The header-carried object is read by EVERY consumer group of the
        topic (a train pipeline and a serve pipeline routinely poll the
        same log).  Each reader forks at its consume boundary and closes
        only its fork — same trace id, birth instant and elapsed-so-far,
        private t_last/closed — so one pipeline's close can neither
        steal the trace from another (the first-closer-wins bug) nor
        race its marks on the shared t_last."""
        child = TraceContext(trace_id=self.trace_id, t0=self.t0,
                             wall0_ns=self.wall0_ns)
        child.t_last = self.t_last
        return child

    # ---------------------------------------------------------- headers
    def encode(self) -> bytes:
        """Byte form for transports: id, birth wall time, elapsed."""
        elapsed_ns = int((time.monotonic() - self.t0) * 1e9)
        return (f"{_WIRE_PREFIX};{self.trace_id:016x};{self.wall0_ns};"
                f"{elapsed_ns}").encode()

    @classmethod
    def decode(cls, raw: bytes) -> Optional["TraceContext"]:
        """Rebase a wire-carried context into this process's monotonic
        domain (elapsed-so-far is preserved; clock skew between hosts is
        the usual distributed-tracing caveat)."""
        try:
            prefix, tid, wall0, elapsed = raw.decode().split(";")
            if prefix != _WIRE_PREFIX:
                return None
            ctx = cls(trace_id=int(tid, 16),
                      t0=time.monotonic() - int(elapsed) / 1e9,
                      wall0_ns=int(wall0))
            ctx.t_last = time.monotonic()
            return ctx
        except (ValueError, UnicodeDecodeError):
            return None


# ------------------------------------------------------------ public API
def configure(enabled: Optional[bool] = None,
              sample: Optional[float] = None,
              path: Optional[str] = None) -> None:
    global ENABLED, _SAMPLE, _PATH
    if enabled is not None:
        ENABLED = bool(enabled)
    if sample is not None:
        _SAMPLE = min(max(float(sample), 0.0), 1.0)
    if path is not None:
        _PATH = path or None


def configure_from_env(env: Optional[Dict[str, str]] = None) -> None:
    env = os.environ if env is None else env
    raw = env.get("IOTML_TRACE")
    if raw is not None:
        configure(enabled=raw.strip().lower() in ("1", "true", "yes", "on"))
    raw = env.get("IOTML_TRACE_SAMPLE")
    if raw:
        configure(sample=float(raw))
    raw = env.get("IOTML_TRACE_PATH")
    if raw:
        configure(path=raw)


def start(stage: str) -> Optional[TraceContext]:
    """Begin a trace at a record's birth (sampling decision happens
    here); returns None when disabled or not sampled."""
    if not ENABLED:
        return None
    if _SAMPLE < 1.0 and random.random() >= _SAMPLE:
        return None
    ctx = TraceContext()
    ctx.mark(stage)
    return ctx


def current() -> Optional[TraceContext]:
    """The publisher-thread context (synchronous fan-out propagation)."""
    return getattr(_current, "ctx", None)


def set_current(ctx: Optional[TraceContext]):
    prev = getattr(_current, "ctx", None)
    _current.ctx = ctx
    return prev


def touch(stage: str) -> None:
    """Mark `stage` live WITHOUT a span — the batch-granular liveness
    beat for the columnar plane: ``poll_into``
    materialises zero records, so an untraced-record columnar consumer
    emits no consume-stage spans and the /healthz stage-age view would
    report a perfectly healthy pipeline as stalled.  A plain dict store
    under the GIL; racing a concurrent drain is benign (both write
    "recent")."""
    if ENABLED:
        _last_seen[stage] = time.monotonic()


def mark_batch(ctx: Optional[TraceContext], stage: str,
               topic: Optional[str] = None, partition: int = -1,
               first_offset: int = -1, last_offset: int = -1,
               n: int = 0) -> None:
    """One span for a whole RAW batch (the wire-trace leg): marks
    `stage` on `ctx` (the timing span, like mark()) and records a batch
    annotation — topic/partition, offset range, record count — that the
    span log carries so ``python -m iotml_torch.obs trace`` can show which
    bytes the cross-process span covered.  Batch-granular by contract:
    one call per raw batch, never per record."""
    if ctx is None or ctx.closed:
        return
    ctx.mark(stage)
    _collector.record(("batch", ctx.trace_id, stage, topic or "",
                       int(partition), int(first_offset),
                       int(last_offset), int(n), ctx.wall0_ns))


def headers_for(ctx: Optional[TraceContext]) -> Optional[Tuple]:
    """Record headers carrying `ctx` (None stays None: untraced records
    pay no header tuple)."""
    if ctx is None:
        return None
    return ((HEADER_KEY, ctx),)


def birth_headers(stage: str) -> Optional[Tuple]:
    """start() + headers_for() in one: the trace-birth idiom for
    producers that attach the context straight to the produced record.
    Call sites still guard on `tracing.ENABLED` so the disabled hot
    path makes no function call at all."""
    return headers_for(start(stage))


def from_headers(headers) -> Optional[TraceContext]:
    """Extract a context from record headers: the live object on the
    in-process path, the byte form off a transport."""
    if not headers:
        return None
    for key, value in headers:
        if key != HEADER_KEY:
            continue
        if isinstance(value, TraceContext):
            return value
        if isinstance(value, (bytes, bytearray)):
            return TraceContext.decode(bytes(value))
    return None


# ---------------------------------------------------------------- drain
def flush() -> Dict[str, int]:
    """Drain the collector into the Prometheus histograms, the liveness
    table and (when configured) the JSONL span log.  Returns counts.
    Exporting happens HERE, never on the record path — the histograms'
    internal locks are only ever taken by drainers."""
    entries = _collector.drain()
    if not entries:
        return {"spans": 0, "e2e": 0}
    n_span = n_e2e = 0
    lines: List[str] = []
    proc = proc_name()
    for e in entries:
        if e[0] == "span":
            _, tid, stage, start_s, dur_s, wall0_ns, t_mark = e
            n_span += 1
            stage_seconds.observe(dur_s, stage=stage)
            # the MARK instant, not the drain instant: liveness ages
            # must keep growing for a stalled stage even when the first
            # probe in a long while is what triggers this drain
            if t_mark > _last_seen.get(stage, float("-inf")):
                _last_seen[stage] = t_mark
            if _PATH:
                lines.append(json.dumps(
                    {"kind": "span", "trace": f"{tid:016x}", "stage": stage,
                     "start_us": int(start_s * 1e6),
                     "dur_us": int(dur_s * 1e6), "wall0_ns": wall0_ns,
                     "proc": proc}))
        elif e[0] == "batch":
            # batch annotation (mark_batch): the timing span was already
            # recorded by the mark() inside mark_batch — this line
            # carries the WHAT (topic/partition/offset range/count) for
            # the cross-process trace reconstruction
            _, tid, stage, topic, part, first, last, n, wall0_ns = e
            if _PATH:
                lines.append(json.dumps(
                    {"kind": "batch", "trace": f"{tid:016x}",
                     "stage": stage, "topic": topic, "partition": part,
                     "first_offset": first, "last_offset": last,
                     "n": n, "wall0_ns": wall0_ns, "proc": proc}))
        else:
            _, tid, closer, dur_s, wall0_ns = e
            n_e2e += 1
            if closer == "score":
                e2e_ingest_to_score_seconds.observe(dur_s)
            elif closer == "train":
                e2e_ingest_to_train_seconds.observe(dur_s)
            if _PATH:
                lines.append(json.dumps(
                    {"kind": "e2e", "trace": f"{tid:016x}", "closer": closer,
                     "dur_us": int(dur_s * 1e6), "wall0_ns": wall0_ns,
                     "proc": proc}))
    if lines and _PATH:
        try:
            with _log_lock:
                with open(_PATH, "a", encoding="utf-8") as fh:
                    fh.write("\n".join(lines) + "\n")
        except OSError:
            # an unwritable span-log path (permissions, full disk) must
            # not turn into a /metrics scrape outage or an atexit crash —
            # the histograms above already have the spans; count the loss
            # under its own family (distinct from collector overload)
            log_write_errors.inc(len(lines))
    return {"spans": n_span, "e2e": n_e2e}


def liveness() -> Dict[str, float]:
    """Stage → seconds since its newest span (drains first).  The
    /healthz status section: a stage whose age keeps growing while
    upstream stages stay fresh is the stalled one."""
    flush()
    now = time.monotonic()
    # snapshot first: a concurrent flush() (ThreadingHTTPServer: /metrics
    # scrape vs /healthz probe) may insert a first-seen stage key, and
    # iterating the live dict would raise mid-probe
    snapshot = dict(_last_seen)
    return {stage: round(now - t, 3) for stage, t in sorted(snapshot.items())}


def reset() -> None:
    """Test hook: drop collected spans, liveness and current-trace state
    (the module flag and sampling survive — configure() owns those)."""
    _collector.drain()
    _last_seen.clear()
    _current.ctx = None


configure_from_env()
atexit.register(flush)
