"""KSQL-equivalent SQL dialect over the stream engine
(``iotml.streamproc.sql``'s copy).

The reference's stream-preprocessing layer is driven by SQL text posted
to the KSQL REST API (reference
``infrastructure/confluent/01_installConfluentPlatform.sh:229-258``
issues CREATE STREAM / CSAS / CTAS / TERMINATE / DROP statements, and its
docs verify with ``PRINT 'sensor-data' FROM BEGINNING`` and ``SHOW
STREAMS``, reference ``infrastructure/confluent/README.md:99``):

  CREATE STREAM s (col TYPE, ...) WITH (KAFKA_TOPIC='t', VALUE_FORMAT='JSON'|'AVRO'|'DELIMITED', KEY='col', PARTITIONS=n);
  CREATE STREAM s2 [WITH (...)] AS SELECT ... FROM s [WHERE e] [PARTITION BY c];
  CREATE TABLE  t  [WITH (...)] AS SELECT c, COUNT(*) AS n FROM s WINDOW TUMBLING (SIZE 5 MINUTES) GROUP BY c;
  SELECT ... FROM s [WHERE e] [LIMIT n];          -- transient (pull) query
  PRINT 'topic' [FROM BEGINNING] [LIMIT n];
  SHOW STREAMS | TABLES | QUERIES | TOPICS;
  DESCRIBE name;
  TERMINATE query_id; | TERMINATE ALL;
  DROP STREAM|TABLE [IF EXISTS] name;

Persistent queries (CSAS/CTAS) run as offset-cursored ``StreamTask``s:
``SqlEngine.pump()`` (or the REST server's pump thread) advances them.
Avro output is Confluent-framed with an id from the attached
``SchemaRegistry``, so the ML ingest layer reads it as it reads the
reference's topics.

The reference pipeline's three legs have native fast paths, each
byte-identical to the per-row Python leg: the JSON→AVRO star copy parses
and encodes in the C++ engine (``NativeCodec.json_decode_batch`` then
``encode_batch``), the REKEY leg passes the Avro payload through behind a
new key field, and the CTAS COUNT folds (key, window) pairs without
decoding records.  The engine loads or raises: nothing falls back to the
Python leg because the library is missing.  Rows the native legs cannot
reproduce exactly (escapes, nested values, ints beyond 2^53, nulls,
non-canonical Avro) take the Python leg, row by row or batch by batch as
the JAX package does, and are counted in ``stream.native.stats``
(``*_fallback_rows``).  ``process_plain`` runs a task's all-Python leg by
name.  On a durable or wire broker the star copy also has a raw produce
leg (``SqlSelectTask.process_raw``): parse, Avro encode and frame in
native calls, shipped over ``Broker.produce_raw`` / RAW_PRODUCE.
"""

from __future__ import annotations

import contextlib
import json
import re
import time
from collections import Counter
from struct import error as struct_error
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.schema import WRITER_SCHEMAS, Field, RecordSchema
from ..ops.avro import (AvroCodec, needs_resolution, resolve_record,
                        zigzag_encode)
from ..ops.framing import frame, unframe
from ..stream import native as _native
from ..stream.broker import Broker, Message, OffsetOutOfRangeError
from ..stream.native import NativeCodec
from ..stream.registry import SchemaRegistry, subject_for_topic
from .tasks import StreamTask

# ---------------------------------------------------------------- tokenizer

_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"('(?:[^']|'')*')"                      # single-quoted string
    r"|([A-Za-z_][A-Za-z0-9_]*)"             # identifier / keyword
    r"|(\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+|\d+(?:[eE][+-]?\d+)?)"  # number
    r"|(<>|<=|>=|!=|[(),*+\-/<>=;])"         # operator / punctuation
    r")"
)

# value formats the engine can encode/decode; enforced for base-stream DDL
# and CSAS/CTAS alike so an unsupported format 4xxes at CREATE time
_SUPPORTED_VALUE_FORMATS = ("JSON", "AVRO", "DELIMITED")

_KSQL_TO_AVRO = {
    "STRING": "string", "VARCHAR": "string",
    "DOUBLE": "double", "FLOAT": "double",
    "INTEGER": "int", "INT": "int",
    "BIGINT": "long", "BOOLEAN": "boolean",
}
_AVRO_TO_KSQL = {"string": "STRING", "double": "DOUBLE", "int": "INTEGER",
                 "long": "BIGINT", "boolean": "BOOLEAN", "float": "DOUBLE"}


class SqlError(ValueError):
    """Statement failed to parse or execute (KSQL's 4xx error body)."""


def tokenize(text: str) -> List[str]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                break
            raise SqlError(f"cannot tokenize at: {text[pos:pos+30]!r}")
        pos = m.end()
        tok = m.group(0).strip()
        if tok:
            out.append(tok)
    return out


def split_statements(text: str) -> List[str]:
    """Split on ';' outside single-quoted strings."""
    out, cur, in_q = [], [], False
    for ch in text:
        if ch == "'":
            in_q = not in_q
        if ch == ";" and not in_q:
            stmt = "".join(cur).strip()
            if stmt:
                out.append(stmt)
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        out.append(tail)
    return out


class _Toks:
    """Cursor over a token list with case-insensitive keyword matching."""

    def __init__(self, toks: List[str]):
        self.toks = toks
        self.i = 0

    def peek(self, ahead: int = 0) -> Optional[str]:
        j = self.i + ahead
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise SqlError("unexpected end of statement")
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def accept(self, *kw: str) -> bool:
        """Consume the next len(kw) tokens if they match (case-insensitive)."""
        for k, off in zip(kw, range(len(kw))):
            t = self.peek(off)
            if t is None or t.upper() != k:
                return False
        self.i += len(kw)
        return True

    def expect(self, *kw: str):
        if not self.accept(*kw):
            raise SqlError(f"expected {' '.join(kw)} near "
                           f"{' '.join(self.toks[self.i:self.i+4])!r}")

    def ident(self) -> str:
        tok = self.next()
        if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", tok):
            raise SqlError(f"expected identifier, got {tok!r}")
        return tok.upper()

    def string(self) -> str:
        tok = self.next()
        if not (tok.startswith("'") and tok.endswith("'")):
            raise SqlError(f"expected string literal, got {tok!r}")
        return tok[1:-1].replace("''", "'")

    def done(self) -> bool:
        return self.i >= len(self.toks)


# ------------------------------------------------------------- expressions

_SCALARS: Dict[str, Callable] = {
    "ABS": abs,
    "ROUND": round,
    "FLOOR": lambda v: float(int(v // 1)),
    "CEIL": lambda v: float(-(-v // 1)),
    "UCASE": lambda s: str(s).upper(),
    "LCASE": lambda s: str(s).lower(),
    "LEN": lambda s: len(str(s)),
}

_AGGS = ("COUNT", "SUM", "MIN", "MAX", "AVG")


def _parse_expr(t: _Toks) -> Callable[[dict], object]:
    """Recursive-descent expression → closure(record)->value.

    Records are dicts keyed by upper-case column name plus the KSQL
    pseudo-columns ROWKEY (str) and ROWTIME (epoch ms).
    """
    return _parse_or(t)


def _parse_or(t: _Toks):
    left = _parse_and(t)
    while t.accept("OR"):
        right = _parse_and(t)
        left = (lambda l, r: lambda rec: bool(l(rec)) or bool(r(rec)))(left, right)
    return left


def _parse_and(t: _Toks):
    left = _parse_not(t)
    while t.accept("AND"):
        right = _parse_not(t)
        left = (lambda l, r: lambda rec: bool(l(rec)) and bool(r(rec)))(left, right)
    return left


def _parse_not(t: _Toks):
    if t.accept("NOT"):
        inner = _parse_not(t)
        return lambda rec: not bool(inner(rec))
    return _parse_cmp(t)


def _parse_cmp(t: _Toks):
    left = _parse_add(t)
    op = t.peek()
    if op in ("=", "!=", "<>", "<", "<=", ">", ">="):
        t.next()
        right = _parse_add(t)
        fns = {
            "=": lambda a, b: a == b, "!=": lambda a, b: a != b,
            "<>": lambda a, b: a != b, "<": lambda a, b: a < b,
            "<=": lambda a, b: a <= b, ">": lambda a, b: a > b,
            ">=": lambda a, b: a >= b,
        }
        f = fns[op]
        return (lambda l, r: lambda rec: f(l(rec), r(rec)))(left, right)
    if t.accept("IS", "NOT", "NULL"):
        return (lambda l: lambda rec: l(rec) is not None)(left)
    if t.accept("IS", "NULL"):
        return (lambda l: lambda rec: l(rec) is None)(left)
    return left


def _parse_add(t: _Toks):
    left = _parse_mul(t)
    while t.peek() in ("+", "-"):
        op = t.next()
        right = _parse_mul(t)
        if op == "+":
            left = (lambda l, r: lambda rec: l(rec) + r(rec))(left, right)
        else:
            left = (lambda l, r: lambda rec: l(rec) - r(rec))(left, right)
    return left


def _parse_mul(t: _Toks):
    left = _parse_unary(t)
    while t.peek() in ("*", "/"):
        # `*` only acts as multiplication when followed by an operand —
        # in select lists it is the wildcard and never reaches here.
        op = t.next()
        right = _parse_unary(t)
        if op == "*":
            left = (lambda l, r: lambda rec: l(rec) * r(rec))(left, right)
        else:
            left = (lambda l, r: lambda rec: l(rec) / r(rec))(left, right)
    return left


def _parse_unary(t: _Toks):
    if t.peek() == "-":
        t.next()
        inner = _parse_unary(t)
        return lambda rec: -inner(rec)
    return _parse_primary(t)


def _parse_primary(t: _Toks):
    tok = t.peek()
    if tok is None:
        raise SqlError("unexpected end of expression")
    if tok == "(":
        t.next()
        inner = _parse_expr(t)
        t.expect(")")
        return inner
    if tok.startswith("'"):
        s = t.string()
        return lambda rec: s
    if re.match(r"^[\d.]", tok):
        t.next()
        num = float(tok)
        if num.is_integer() and "." not in tok and "e" not in tok.lower():
            num = int(num)
        return lambda rec: num
    up = tok.upper()
    if up in ("TRUE", "FALSE"):
        t.next()
        val = up == "TRUE"
        return lambda rec: val
    if up == "NULL":
        t.next()
        return lambda rec: None
    if up in _SCALARS and t.peek(1) == "(":
        t.next()
        t.expect("(")
        inner = _parse_expr(t)
        t.expect(")")
        f = _SCALARS[up]
        return (lambda g: lambda rec: None if g(rec) is None else f(g(rec)))(inner)
    # column reference
    name = t.ident()
    return lambda rec: rec.get(name)


# ------------------------------------------------------------- select AST


class SelectItem:
    """One projection: expression + output alias (+ aggregate marker)."""

    def __init__(self, alias: str, fn: Callable = None,
                 agg: Optional[str] = None, agg_arg: Optional[Callable] = None,
                 source_col: Optional[str] = None, star: bool = False):
        self.alias = alias
        self.fn = fn
        self.agg = agg          # COUNT/SUM/MIN/MAX/AVG or None
        self.agg_arg = agg_arg  # argument closure for SUM/MIN/MAX/AVG
        self.source_col = source_col  # set when the expr is a bare column ref
        self.star = star


class SelectStmt:
    def __init__(self):
        self.items: List[SelectItem] = []
        self.source: str = ""
        self.where: Optional[Callable] = None
        self.window_ms: Optional[int] = None
        self.group_by: Optional[str] = None
        self.partition_by: Optional[str] = None
        self.limit: Optional[int] = None
        self.emit_changes: bool = False

    @property
    def is_aggregate(self) -> bool:
        return any(it.agg for it in self.items) or self.group_by is not None


def _parse_select_item(t: _Toks) -> SelectItem:
    tok = t.peek()
    if tok == "*":
        t.next()
        return SelectItem(alias="*", star=True)
    up = tok.upper() if tok else ""
    if up in _AGGS and t.peek(1) == "(":
        t.next()
        t.expect("(")
        if up == "COUNT" and t.peek() == "*":
            t.next()
            arg = None
        else:
            arg = _parse_expr(t)
        t.expect(")")
        alias = f"KSQL_{up}"
        if t.accept("AS"):
            alias = t.ident()
        return SelectItem(alias=alias, agg=up, agg_arg=arg)
    # remember position to detect bare column refs (for schema inference)
    start = t.i
    fn = _parse_expr(t)
    consumed = t.toks[start:t.i]
    source_col = consumed[0].upper() if len(consumed) == 1 and re.match(
        r"^[A-Za-z_][A-Za-z0-9_]*$", consumed[0]) else None
    alias = source_col or "EXPR"
    if t.accept("AS"):
        alias = t.ident()
    return SelectItem(alias=alias, fn=fn, source_col=source_col)


_WINDOW_UNITS = {"MILLISECONDS": 1, "SECONDS": 1000, "SECOND": 1000,
                 "MINUTES": 60_000, "MINUTE": 60_000,
                 "HOURS": 3_600_000, "HOUR": 3_600_000,
                 "DAYS": 86_400_000, "DAY": 86_400_000}


def _parse_select(t: _Toks) -> SelectStmt:
    st = SelectStmt()
    t.expect("SELECT")
    while True:
        it = _parse_select_item(t)
        if it.alias == "EXPR":  # unaliased expression: KSQL's auto-naming
            it.alias = f"KSQL_COL_{len(st.items)}"
        st.items.append(it)
        if not t.accept(","):
            break
    t.expect("FROM")
    st.source = t.ident()
    if t.accept("WINDOW", "TUMBLING"):
        t.expect("(")
        t.expect("SIZE")
        n = t.next()
        unit = t.ident()
        if unit not in _WINDOW_UNITS:
            raise SqlError(f"unknown window unit {unit}")
        st.window_ms = int(float(n) * _WINDOW_UNITS[unit])
        t.expect(")")
    if t.accept("WHERE"):
        st.where = _parse_expr(t)
    if t.accept("GROUP", "BY"):
        st.group_by = t.ident()
    if t.accept("PARTITION", "BY"):
        st.partition_by = t.ident()
    if t.accept("EMIT", "CHANGES"):
        st.emit_changes = True
    if t.accept("LIMIT"):
        st.limit = int(t.next())
    return st


# --------------------------------------------------------------- metadata


class SourceMeta:
    """A registered STREAM or TABLE: name + topic + format + columns."""

    def __init__(self, name: str, kind: str, topic: str, value_format: str,
                 columns: List[Tuple[str, str]], key_col: Optional[str] = None,
                 query_id: Optional[str] = None, windowed: bool = False):
        self.name = name
        self.kind = kind                  # "STREAM" | "TABLE"
        self.topic = topic
        self.value_format = value_format  # "JSON" | "AVRO" | "DELIMITED"
        self.columns = columns            # [(NAME, KSQL_TYPE)]
        self.key_col = key_col
        self.query_id = query_id
        self.windowed = windowed

    def record_schema(self) -> RecordSchema:
        fields = tuple(Field(n, _KSQL_TO_AVRO[k], nullable=True)
                       for n, k in self.columns)
        return RecordSchema(name=self.name, namespace="iotml.sql", fields=fields)

    def describe(self) -> dict:
        return {"name": self.name, "type": self.kind, "topic": self.topic,
                "valueFormat": self.value_format, "keyColumn": self.key_col,
                "fields": [{"name": n, "type": k} for n, k in self.columns]}


class _NativeAvroSource:
    """Batch AVRO source decode through the C++ engine.

    This decodes a whole poll columnar-natively and rebuilds records with exact python types
    (ints stay ints, booleans stay bools).  Conservative fallbacks keep
    python-decode semantics authoritative — the whole batch takes the
    per-message python path when: the native decode errors, any nullable
    union chose its null branch (python decodes those as None; the
    columnar layout cannot represent that), any string sits at the stride
    limit (possible truncation) or is not valid ASCII/UTF-8 for numpy's
    U-cast, or any int/long exceeds the float64-exact range (2^53), or
    any message lacks the Confluent magic byte (the python path's
    unframe() treats those as poisoned).  Known narrow divergence: a
    string with TRAILING NUL bytes decodes natively with them stripped
    (numpy S-dtype semantics) — undetectable post-decode and accepted;
    embedded NULs round-trip."""

    STRIDE = 64
    INT_EXACT = 2 ** 53

    def __init__(self, schema):
        self.codec = NativeCodec(schema)

        def conv_for(avro_type):
            if avro_type in ("int", "long"):
                return int
            if avro_type == "boolean":
                return bool
            return float
        self.numeric = [(f.name, conv_for(f.avro_type))
                        for f in schema.fields if f.avro_type != "string"]
        # columns needing the 2^53 exactness guard (float64 round-trip)
        self._int_cols = [i for i, (_, conv) in enumerate(self.numeric)
                          if conv is int]
        self.strings = [f.name for f in schema.fields
                        if f.avro_type == "string"]

    def decode(self, messages) -> Optional[list]:
        """→ list[dict] for the whole batch, or None → caller falls back
        (the batch's rows counted in ``decode_fallback_rows``)."""
        recs = self._decode(messages)
        if recs is None:
            _native.count_fallback("decode", len(messages))
        return recs

    def _decode(self, messages) -> Optional[list]:
        if any(m.value[:1] != b"\x00" for m in messages):
            # python-path parity: unframe() rejects a non-zero magic byte
            # as poisoned; a blind 5-byte strip would decode it instead
            return None
        try:
            num, lab, nulls = self.codec.decode_batch_nulls(
                [m.value for m in messages], strip=5, stride=self.STRIDE)
            if nulls.any():
                # null unions decode as None only on the python path
                return None
            if self._int_cols and (
                    np.abs(num[:, self._int_cols]) >= self.INT_EXACT).any():
                return None  # int/long beyond float64-exact range
            num_l = num.tolist()
            if self.strings:
                lab_u = lab.astype("U")  # raises on non-ASCII bytes
                if (np.char.str_len(lab_u) >= self.STRIDE - 1).any():
                    return None  # possible truncation at the stride limit
                lab_l = lab_u.tolist()
            else:
                lab_l = None
        except (ValueError, TypeError, RuntimeError, UnicodeDecodeError):
            return None
        recs = []
        for i, m in enumerate(messages):
            rec = {}
            for (name, conv), v in zip(self.numeric, num_l[i]):
                rec[name] = conv(v)
            if lab_l is not None:
                for name, v in zip(self.strings, lab_l[i]):
                    rec[name] = v
            rec["ROWKEY"] = (m.key or b"").decode(errors="replace")
            rec["ROWTIME"] = m.timestamp_ms
            recs.append(rec)
        return recs


def _make_native_source(meta: SourceMeta):
    """The native batch decoder of an AVRO source (None for the other
    formats); raises if the engine cannot be loaded."""
    if meta.value_format != "AVRO":
        return None
    return _NativeAvroSource(meta.record_schema())


def _decode_batch(meta: SourceMeta, codec: Optional[AvroCodec],
                  native: Optional[_NativeAvroSource],
                  messages) -> list:
    """→ list[Optional[dict]] aligned with messages (None = poisoned)."""
    if native is not None and \
            not any(needs_resolution(m.value) for m in messages):
        # a newer-writer record in the batch forces the python path:
        # the native decoder is positional against ONE schema and would
        # silently mis-read an evolved payload, not error on it
        recs = native.decode(messages)
        if recs is not None:
            return recs
    return [_decode_record(meta, codec, m) for m in messages]


#: writer codecs for the resolving AVRO decode, built on first use
_WRITER_CODECS: Dict[int, AvroCodec] = {}


def _resolving_decode(sid: int, payload: bytes,
                      codec: AvroCodec) -> Optional[dict]:
    """Schema-evolution decode: when the frame names a KNOWN newer
    writer whose field space covers this source's reader columns,
    decode with the WRITER's layout and project by name onto the
    reader (Avro schema resolution).  Returns None when not applicable
    — an id collision from an unrelated registry subject, or a reader
    the writer cannot satisfy — so the caller keeps the legacy
    positional decode (and its DLQ failure mode) for those."""
    # id 1 is the DEFAULT frame id — every in-process registry subject
    # (arbitrary SQL-declared schemas included) starts there, so it
    # identifies nothing; only the non-default KNOWN writer ids mark an
    # evolved car-schema payload
    if sid == 1:
        return None
    ws = WRITER_SCHEMAS.get(sid)
    if ws is None or ws.fields == codec.schema.fields:
        return None
    writer_names = {f.name for f in ws.fields}
    if any(f.name not in writer_names and not f.nullable
           for f in codec.schema.fields):
        return None
    wcodec = _WRITER_CODECS.get(sid)
    if wcodec is None:
        wcodec = _WRITER_CODECS[sid] = AvroCodec(ws)
    return resolve_record(wcodec.decode(payload), codec.schema)


def _decode_record(meta: SourceMeta, codec: Optional[AvroCodec],
                   m: Message) -> Optional[dict]:
    """Message → dict keyed by upper-case column name (+ pseudo-columns)."""
    rec: Optional[dict] = None
    if meta.value_format == "JSON":
        try:
            obj = json.loads(m.value)
        except (ValueError, UnicodeDecodeError):
            return None
        if not isinstance(obj, dict):
            return None
        rec = {k.upper(): v for k, v in obj.items()}
    elif meta.value_format == "AVRO":
        try:
            sid, payload = unframe(m.value)
            # mixed-version topic: a record written under a newer known
            # schema resolves against this source's reader instead of
            # mis-decoding positionally (and failing the chunk into the
            # DLQ — or worse, silently reading the wrong field)
            rec = _resolving_decode(sid, payload, codec)
            if rec is None:
                rec = codec.decode(payload)
        except (ValueError, IndexError, struct_error):
            return None
    elif meta.value_format == "DELIMITED":
        try:
            parts = m.value.decode().split(",")
        except UnicodeDecodeError:
            return None
        if len(parts) != len(meta.columns):
            return None
        rec = {}
        try:
            for (name, ktype), raw in zip(meta.columns, parts):
                if ktype in ("DOUBLE", "FLOAT"):
                    rec[name] = float(raw)
                elif ktype in ("INTEGER", "INT", "BIGINT"):
                    rec[name] = int(float(raw))
                elif ktype == "BOOLEAN":
                    rec[name] = raw.strip().lower() == "true"
                else:
                    rec[name] = raw
        except ValueError:
            return None
    else:  # pragma: no cover - formats are validated at CREATE time
        return None
    rec["ROWKEY"] = (m.key or b"").decode(errors="replace")
    rec["ROWTIME"] = m.timestamp_ms
    return rec


# ------------------------------------------------------------------ tasks


class SqlSelectTask(StreamTask):
    """A persistent CSAS query: decode → where → project → encode."""

    def __init__(self, broker: Broker, src_meta: SourceMeta,
                 sink_meta: SourceMeta, stmt: SelectStmt,
                 registry: SchemaRegistry, group: str,
                 trusted_passthrough: bool = False,
                 passthrough_sample: int = 0):
        super().__init__(broker, src_meta.topic, sink_meta.topic,
                         partitions=broker.topic(sink_meta.topic).partitions
                         if sink_meta.topic in broker.topics() else 1,
                         group=group)
        self.src_meta = src_meta
        self.sink_meta = sink_meta
        self.stmt = stmt
        self.src_codec = (AvroCodec(src_meta.record_schema())
                          if src_meta.value_format == "AVRO" else None)
        self._native_src = _make_native_source(src_meta)
        self.sink_codec = None
        self.sink_schema_id = None
        self._native_sink = None
        if sink_meta.value_format == "AVRO":
            schema = sink_meta.record_schema()
            self.sink_codec = AvroCodec(schema)
            self.sink_schema_id = registry.register(
                subject_for_topic(sink_meta.topic), schema.avro_json())
            # native batch encode (C++ engine), byte-identical to the
            # pure codec; loads or raises
            self._native_sink = NativeCodec(schema)
            self._label_stride = _NativeAvroSource.STRIDE
            self._sink_numeric = [f.name for f in schema.fields
                                  if f.avro_type != "string"]
            self._sink_strings = [f.name for f in schema.fields
                                  if f.avro_type == "string"]
            self._sink_ints = [f.name for f in schema.fields
                               if f.avro_type in ("int", "long")]
        # ---- fused JSON→AVRO leg (the pipeline's input stage): when the
        # query is a bare star copy (SELECT * FROM <json-stream>, no WHERE,
        # no PARTITION BY — reference 01_installConfluentPlatform.sh's
        # SENSOR_DATA_S_AVRO CSAS), the C++ JSON parser emits straight into
        # the sink's columnar layout and the C++ Avro encoder takes it from
        # there: zero per-row Python on the eligible rows, byte-identical
        # output, row-level fallback for anything the parser can't
        # reproduce exactly.
        self._fused_json = None
        if (src_meta.value_format == "JSON"
                and self._native_sink is not None
                and stmt.where is None and not stmt.partition_by
                and len(stmt.items) == 1 and stmt.items[0].star
                and sink_meta.columns == src_meta.columns
                and len(sink_meta.columns) <= 64):
            self._fused_json = self._native_sink
        # ---- REKEY pass-through (SELECT ROWKEY AS X, * ... PARTITION BY
        # X over AVRO→AVRO): the sink record is the ROWKEY string field
        # followed by the source fields unchanged, and Avro encodes a
        # record as the concatenation of its field encodings — so the
        # output value is frame(avro_string(key) + source_payload) with no
        # decode/encode at all.  The source payload is still structurally
        # validated in batch (native decode); a batch that fails
        # validation, any non-framed value, or a non-UTF-8 key falls back
        # to the generic path wholesale.
        self._rekey_fast = bool(
            src_meta.value_format == "AVRO"
            and sink_meta.value_format == "AVRO"
            and self._native_src is not None
            and self.sink_schema_id is not None
            and stmt.where is None and stmt.partition_by
            and len(stmt.items) == 2
            and stmt.items[0].source_col == "ROWKEY"
            and stmt.items[0].alias == stmt.partition_by
            and stmt.items[1].star
            and sink_meta.columns[:1] == [(stmt.items[0].alias, "STRING")]
            and sink_meta.columns[1:] == list(src_meta.columns))
        if self._rekey_fast:
            # constant per task: frame header, plus the non-null union
            # branch (zigzag 1 = 0x02) when the sink key column is nullable
            self._rekey_header = frame(b"", self.sink_schema_id)
            if sink_meta.record_schema().fields[0].nullable:
                self._rekey_header += b"\x02"
        #: trusted pass-through (engine-level opt-in): skip the strict
        #: structural re-validation of rekey source payloads.  Sound only
        #: when the source topic is written exclusively by THIS engine's
        #: own native encoder (the reference pipeline's AVRO leg feeding
        #: its REKEY leg): those bytes were validated at encode time, and
        #: re-decoding every record was the rekey pump's dominant cost.
        #: External/untrusted source topics must keep validation on.
        self._trusted = bool(trusted_passthrough)
        #: sample-validation cadence under trust (engine-level knob):
        #: every Nth pass-through batch is strict-validated anyway, so a
        #: regression in the engine's own encoder surfaces within N
        #: batches instead of reaching downstream consumers silently
        self._sample_every = max(int(passthrough_sample), 0)
        self._passthrough_batches = 0
        #: whether the sink and source partition counts agree, the raw
        #: produce leg's condition (None: not checked yet, process_raw)
        self._raw_affine = None

    def _project(self, rec: dict) -> Optional[dict]:
        out = {}
        for it in self.stmt.items:
            if it.star:
                for name, _ in self.src_meta.columns:
                    out[name] = rec.get(name)
            else:
                try:
                    out[it.alias] = it.fn(rec)
                except (TypeError, ZeroDivisionError):
                    return None  # NULL in arithmetic / div-by-zero: drop row
        return out

    def _encode_avro_rows(self, rows):
        """rows → framed Avro values; native columnar batch when eligible.

        Eligibility is value-dependent: no None values (the python codec's
        null-union branch) and every string short enough for the native
        engine's fixed label stride.  Ineligible batches take the python
        codec row-by-row — output bytes are identical either way."""
        if self._native_sink is not None and rows:
            # strings checked BEFORE building the S-dtype array (it would
            # silently truncate long values rather than fail)
            # NUL-free: the C++ encoder measures strings to the first NUL
            ok = all(isinstance(row.get(n), str)
                     and len(row[n]) < self._label_stride
                     and "\x00" not in row[n]
                     for row in rows for n in self._sink_strings)
            if ok and self._sink_ints:
                # int/long ride a float64 matrix: beyond 2^53 the round
                # trip is lossy — python codec keeps exactness
                lim = _NativeAvroSource.INT_EXACT
                ok = all(isinstance(row.get(n), (int, float))
                         and abs(row[n]) < lim
                         for row in rows for n in self._sink_ints)
            if ok:
                try:
                    num = np.array(
                        [[row[n] for n in self._sink_numeric]
                         for row in rows], np.float64)
                    labels = np.array(
                        [[row[n] for n in self._sink_strings]
                         for row in rows],
                        dtype=f"S{self._label_stride}") if \
                        self._sink_strings else None
                    return self._native_sink.encode_batch(
                        num, labels, schema_id=self.sink_schema_id,
                        stride=self._label_stride)
                except (TypeError, ValueError, KeyError):
                    pass  # None/odd values: python codec handles the unions
            _native.count_fallback("encode", len(rows))
        return self._encode_avro_rows_plain(rows)

    def _encode_avro_rows_plain(self, rows):
        """rows → framed Avro values through the pure codec."""
        return [frame(self.sink_codec.encode(
            {n: row.get(n) for n, _ in self.sink_meta.columns}),
            self.sink_schema_id) for row in rows]

    def _process_fused_json(self, messages, decoded=None):
        """JSON→AVRO star copy, native end to end (see __init__).
        ``decoded`` is the chunk's ``json_decode_batch`` when the caller
        has already parsed it (the raw leg's fallback)."""
        num, lab, nulls, fb = decoded if decoded is not None else \
            self._fused_json.json_decode_batch(
                [m.value for m in messages], stride=self._label_stride)
        ok = fb == 0
        encoded = []
        if ok.any():
            idx = np.nonzero(ok)[0]
            encoded = self._native_sink.encode_batch(
                num[idx], lab[idx] if self._sink_strings else None,
                schema_id=self.sink_schema_id, stride=self._label_stride,
                nulls=nulls[idx])
        out = []
        enc_i = 0
        for i, m in enumerate(messages):
            if ok[i]:
                out.append((m.key, encoded[enc_i], m.timestamp_ms))
                enc_i += 1
            else:
                # row-level fallback: the Python leg decides (poisoned
                # rows dead-letter; nulls/escapes/big ints encode exactly)
                rec = _decode_record(self.src_meta, self.src_codec, m)
                if rec is None:
                    self.dead_letter(m, "undecodable "
                                     f"{self.src_meta.value_format} record")
                    continue
                row = self._project(rec)
                if row is None:
                    continue
                val = frame(self.sink_codec.encode(
                    {n: row.get(n) for n, _ in self.sink_meta.columns}),
                    self.sink_schema_id)
                out.append((m.key, val, m.timestamp_ms))
        return out

    def process_raw(self, messages):
        """The raw produce leg of the JSON→AVRO star copy: the native JSON
        parser fills the columns and ``NativeCodec.encode_frames`` Avro
        encodes AND frames them in one call, so a record is framed once,
        at conversion; ``RawBatchProducer`` ships each source partition's
        group to the same-numbered sink partition.  Sound by partition
        affinity: the star copy keeps the key, so with equal partition
        counts the sink's key hash names the source partition, and the
        topic is byte- and routing-identical to the classic leg's.

        Returns None (the classic leg) without the fused leg, on an
        in-memory in-process broker (its ``produce_raw`` would decode
        the frames right back), for a producer pinned classic, or when
        the partition counts differ; a group with a row the parser
        flags, or a null key, takes the classic leg by itself.  Groups
        over ``IOTML_PRODUCE_BATCH_BYTES`` split at frame boundaries."""
        if self._fused_json is None or self.sink_schema_id is None:
            return None
        if isinstance(self.broker, Broker) and self.broker.store is None:
            return None
        raw = self.raw_producer()
        if raw.engaged is False:
            return None
        if self._raw_affine is None:
            try:
                self._raw_affine = (
                    self.broker.topic(self.sink_meta.topic).partitions
                    == self.broker.topic(self.src_meta.topic).partitions)
            except KeyError:
                return None
        if not self._raw_affine:
            return None
        from ..data.pipeline import produce_batch_bytes
        from ..stream.producer import raw_produce_convert_seconds

        def classic_group(group, decoded) -> int:
            outs = self._process_fused_json(group, decoded)
            if outs:
                self.broker.produce_many(self.sink_meta.topic, outs)
            return len(outs)

        def classic_entries(group, num, lab, nulls):
            """The classic form of an encoded slice, built only when the
            producer pins back (a server without RAW_PRODUCE)."""
            vals = self._native_sink.encode_batch(
                num, lab if self._sink_strings else None,
                schema_id=self.sink_schema_id, stride=self._label_stride,
                nulls=nulls)
            return [(m.key, v, m.timestamp_ms) for m, v in zip(group, vals)]

        emitted = 0
        by_part: Dict[int, list] = {}
        for m in messages:
            by_part.setdefault(m.partition, []).append(m)
        for p, group in by_part.items():
            t0 = time.perf_counter()
            decoded = self._fused_json.json_decode_batch(
                [m.value for m in group], stride=self._label_stride)
            num, lab, nulls, fb = decoded
            keys = [m.key for m in group]
            if fb.any() or any(k is None for k in keys):
                # a row only the Python leg reproduces, or unkeyed rows
                # (round-robin in the classic partitioner, no affinity)
                emitted += classic_group(group, decoded)
                continue
            ts = np.fromiter((m.timestamp_ms for m in group), np.int64,
                             len(group))
            try:
                blob = self._fused_json.encode_frames(
                    num, lab, ts, keys=keys, nulls=nulls,
                    schema_id=self.sink_schema_id, stride=self._label_stride)
            except ValueError:
                emitted += classic_group(group, decoded)
                continue
            raw_produce_convert_seconds.observe(time.perf_counter() - t0)
            cap = produce_batch_bytes()
            if len(blob) <= cap or len(group) <= 1:
                raw.produce_frames(
                    p, blob, len(group),
                    entries=lambda g=group, n=num, la=lab, nu=nulls:
                    classic_entries(g, n, la, nu))
            else:
                # split at frame boundaries by re-encoding row slices
                per = max(1, int(len(group) * cap / len(blob)))
                for i in range(0, len(group), per):
                    sl = slice(i, i + per)
                    sub = self._fused_json.encode_frames(
                        num[sl], lab[sl], ts[sl], keys=keys[sl],
                        nulls=nulls[sl], schema_id=self.sink_schema_id,
                        stride=self._label_stride)
                    raw.produce_frames(
                        p, sub, len(keys[sl]),
                        entries=lambda g=group[sl], n=num[sl], la=lab[sl],
                        nu=nulls[sl]: classic_entries(g, n, la, nu))
            emitted += len(group)
        return emitted

    def _process_rekey(self, messages):
        """AVRO rekey pass-through (see __init__); None → generic path."""
        vals = []
        for m in messages:
            if not m.value or m.value[0] != 0:
                return None  # poisoned frame: generic path drops it
            vals.append(m.value)
        self._passthrough_batches += 1
        sampled = (self._trusted and self._sample_every
                   and self._passthrough_batches % self._sample_every == 0)
        if not self._trusted or sampled:
            try:
                # strict validation — the bytes pass through, so success
                # must guarantee forwarding the ORIGINAL payload is
                # byte-identical to decode→re-encode (no trailing bytes,
                # minimal varints, valid UTF-8, sane union branches);
                # anything else sends the whole batch to the generic path,
                # which drops/canonicalizes exactly the bad rows.  Skipped
                # under trusted_passthrough — except for the 1-in-N
                # sampled batches (passthrough_sample), which re-check
                # the engine's own encoder output as defense in depth.
                self._native_src.codec.decode_batch(
                    vals, strip=5, stride=_NativeAvroSource.STRIDE,
                    strict=True)
            except (ValueError, TypeError, RuntimeError):
                return None
        header = self._rekey_header
        out = []
        for m in messages:
            key = m.key or b""
            try:
                key.decode()
            except UnicodeDecodeError:
                return None  # replacement-char key: Python path is exact
            # avro string: zigzag-varint byte length, then the utf-8 bytes
            out.append((key,
                        header + zigzag_encode(len(key)) + key + m.value[5:],
                        m.timestamp_ms))
        return out

    def process(self, messages):
        if self._fused_json is not None:
            return self._process_fused_json(messages)
        if self._rekey_fast:
            fast = self._process_rekey(messages)
            if fast is not None:
                return fast
            _native.count_fallback("rekey", len(messages))
        return self._process_rows(messages, native=True)

    def process_plain(self, messages):
        """The all-Python leg (the pure codecs, row by row): what every
        native leg of ``process`` must reproduce byte for byte."""
        return self._process_rows(messages, native=False)

    def _process_rows(self, messages, native: bool):
        """The generic per-row path: decode → where → project → encode,
        through the engine's batch codecs when ``native`` (each falling
        back to the pure codec as ``_decode_batch`` and
        ``_encode_avro_rows`` decide), else through the pure codecs."""
        picked = []  # (key, row, timestamp) per surviving record
        if native:
            recs = _decode_batch(self.src_meta, self.src_codec,
                                 self._native_src, messages)
        else:
            recs = [_decode_record(self.src_meta, self.src_codec, m)
                    for m in messages]
        for m, rec in zip(messages, recs):
            if rec is None:
                # poisoned message: dead-letter, don't halt (the real
                # KSQL DLQ behavior this comment used to approximate)
                self.dead_letter(m, "undecodable "
                                 f"{self.src_meta.value_format} record")
                continue
            if self.stmt.where is not None:
                try:
                    if not self.stmt.where(rec):
                        continue
                except TypeError:
                    continue  # NULL in a comparison: row excluded
            row = self._project(rec)
            if row is None:
                continue
            if self.stmt.partition_by:
                kv = row.get(self.stmt.partition_by, rec.get(self.stmt.partition_by))
                key = str(kv).encode() if kv is not None else m.key
            else:
                key = m.key
            picked.append((key, row, m.timestamp_ms))
        if not picked:
            return []
        if self.sink_meta.value_format == "AVRO":
            rows = [row for _, row, _ in picked]
            vals = self._encode_avro_rows(rows) if native \
                else self._encode_avro_rows_plain(rows)
        elif self.sink_meta.value_format == "DELIMITED":
            vals = [",".join("" if row.get(n) is None else str(row[n])
                             for n, _ in self.sink_meta.columns).encode()
                    for _, row, _ in picked]
        else:
            vals = [json.dumps(row, default=str).encode()
                    for _, row, _ in picked]
        return [(key, val, ts) for (key, _, ts), val in zip(picked, vals)]


class SqlAggTask(StreamTask):
    """A persistent CTAS query: windowed/global group-by with COUNT/SUM/
    MIN/MAX/AVG, emitting continuous-refinement updates as JSON rows.

    The latest record per (group, window) key is the table value — the same
    changelog semantics KSQL tables have."""

    def __init__(self, broker: Broker, src_meta: SourceMeta,
                 sink_meta: SourceMeta, stmt: SelectStmt,
                 group: str):
        super().__init__(broker, src_meta.topic, sink_meta.topic, group=group)
        self.src_meta = src_meta
        self.sink_meta = sink_meta
        self.stmt = stmt
        self.src_codec = (AvroCodec(src_meta.record_schema())
                          if src_meta.value_format == "AVRO" else None)
        self._native_src = _make_native_source(src_meta)
        # (group_key, window_start) → {alias: accumulator}
        self.acc: Dict[tuple, dict] = {}
        # Restore changelog state only when this group has committed input
        # offsets: state + offsets were written together, so either both
        # exist (resume) or neither does (fresh query over a topic that may
        # hold another query's retained output — replaying input from 0
        # with seeded state would double-count).
        src_topic = src_meta.topic
        n_src = (broker.topic(src_topic).partitions
                 if src_topic in broker.topics() else 0)
        if any(broker.committed(group, src_topic, p) is not None
               for p in range(n_src)):
            self._restore_from_changelog()
        # ---- vectorized COUNT fast path (the reference CTAS:
        # SELECT ROWKEY AS CAR, COUNT(*) ... WINDOW TUMBLING GROUP BY
        # ROWKEY): grouping needs only (key, timestamp) and COUNT needs no
        # fields at all, so eligible batches skip per-row dict
        # materialization — the source payloads are batch-validated
        # natively (the Python path drops undecodable rows, so the count
        # must too) and the (key, window) histogram comes from one
        # Counter pass.
        self._fast_count = bool(
            stmt.where is None and stmt.group_by == "ROWKEY"
            and self._native_src is not None
            and all((it.agg == "COUNT" and it.agg_arg is None)
                    or (not it.agg and it.source_col == "ROWKEY")
                    for it in stmt.items)
            and any(it.agg == "COUNT" for it in stmt.items))

    def _restore_from_changelog(self) -> None:
        """Rebuild aggregate state from the output topic.

        The consumer resumes from committed offsets, so without this a
        restarted CTAS would silently undercount: already-consumed input is
        skipped but `acc` starts empty.  The output topic *is* the table's
        changelog (latest row per key wins — KSQL's state-store restore from
        the changelog topic); AVG additionally persists its running sum and
        count as `__sum_`/`__n_` fields in each emitted row."""
        if self.dst not in self.broker.topics():
            return
        spec = self.broker.topic(self.dst)
        for p in range(spec.partitions):
            off = self.broker.begin_offset(self.dst, p)
            end = self.broker.end_offset(self.dst, p)
            while off < end:
                try:
                    msgs = self.broker.fetch(self.dst, p, off,
                                             max_messages=1024)
                except OffsetOutOfRangeError as e:
                    off = e.earliest  # raced a retention trim: skip ahead
                    continue
                if not msgs:
                    break
                for m in msgs:
                    off = m.offset + 1
                    try:
                        row = json.loads(m.value)
                    except (ValueError, UnicodeDecodeError):
                        continue
                    if not isinstance(row, dict):
                        continue
                    gval = (m.key or b"").decode(errors="replace")
                    win = row.get("WINDOW_START_MS", 0)
                    slot = self.acc.setdefault((gval, win), {})
                    for k, v in row.items():
                        if k == "WINDOW_START_MS":
                            continue
                        slot[k] = v  # latest record per key wins

    def _changelog_row(self, slot: dict, row: dict) -> dict:
        """Add AVG aux state (`__sum_`/`__n_`) so restore is exact."""
        for it in self.stmt.items:
            if it.agg == "AVG":
                for aux in ("__sum_" + it.alias, "__n_" + it.alias):
                    if aux in slot:
                        row[aux] = slot[aux]
        return row

    def _update(self, key: tuple, rec: dict):
        slot = self.acc.setdefault(key, {})
        for it in self.stmt.items:
            if not it.agg:
                continue
            if it.agg == "COUNT":
                slot[it.alias] = slot.get(it.alias, 0) + 1
                continue
            try:
                v = it.agg_arg(rec) if it.agg_arg else None
            except (TypeError, ZeroDivisionError):
                continue  # NULL in aggregate argument: skip this input
            if v is None:
                continue
            cur = slot.get(it.alias)
            if it.agg == "SUM":
                slot[it.alias] = (cur or 0) + v
            elif it.agg == "MIN":
                slot[it.alias] = v if cur is None else min(cur, v)
            elif it.agg == "MAX":
                slot[it.alias] = v if cur is None else max(cur, v)
            elif it.agg == "AVG":
                s, n = slot.get("__sum_" + it.alias, 0), slot.get("__n_" + it.alias, 0)
                s, n = s + v, n + 1
                slot["__sum_" + it.alias], slot["__n_" + it.alias] = s, n
                slot[it.alias] = s / n

    def process(self, messages):
        """Fold a chunk into the aggregate state, transactionally: if
        anything in the chunk raises, every slot this chunk touched is
        rolled back before the exception propagates — the engine's
        rewind-and-retry would otherwise fold the same records into the
        accumulators again on every retry."""
        undo: Dict[tuple, Optional[dict]] = {}
        try:
            return self._process_chunk(messages, undo)
        except Exception:
            for key, prev in undo.items():
                if prev is None:
                    self.acc.pop(key, None)
                else:
                    self.acc[key] = prev
            raise

    def _count_batch(self, messages):
        """(key, window) → count for an eligible COUNT-only batch, or None
        → per-row path (validation failure / unframed value)."""
        vals = []
        for m in messages:
            if not m.value or m.value[0] != 0:
                return None
            vals.append(m.value)
        try:
            # the Python path drops rows that fail to decode (including
            # invalid UTF-8 in a string field) — validate the whole batch
            # in strict mode so the count matches exactly; a batch with
            # any bad row takes the per-row path (which drops it)
            self._native_src.codec.decode_batch(
                vals, strip=5, stride=_NativeAvroSource.STRIDE, strict=True)
        except (ValueError, TypeError, RuntimeError):
            return None
        w = self.stmt.window_ms
        return Counter(
            ((m.key or b"").decode(errors="replace"),
             (m.timestamp_ms // w) * w if w else 0)
            for m in messages)

    def process_plain(self, messages):
        """The all-Python leg over a fresh state (every row decoded by the
        pure codec and folded one by one): the rows ``process`` would emit
        for ``messages`` from an empty table.  The task's own state is
        left as it is."""
        saved, self.acc = self.acc, {}
        try:
            return self._process_chunk(messages, {}, native=False)
        finally:
            self.acc = saved

    def _process_chunk(self, messages, undo, native: bool = True):
        """Fold a chunk; ``native`` takes the COUNT fast path and the
        native batch decode where they apply, else the pure codec row by
        row."""
        fast = native and self._fast_count
        touched = set()
        counted = self._count_batch(messages) if fast else None
        if fast and counted is None:
            _native.count_fallback("count", len(messages))
        if counted is not None:
            for key, cnt in counted.items():
                if key not in undo:
                    undo[key] = dict(self.acc[key]) if key in self.acc \
                        else None
                slot = self.acc.setdefault(key, {})
                for it in self.stmt.items:
                    if it.agg == "COUNT":
                        slot[it.alias] = slot.get(it.alias, 0) + cnt
            touched.update(counted)
        else:
            recs = _decode_batch(self.src_meta, self.src_codec,
                                 self._native_src if native else None,
                                 messages)
            for m, rec in zip(messages, recs):
                if rec is None:
                    self.dead_letter(m, "undecodable "
                                     f"{self.src_meta.value_format} record")
                    continue
                if self.stmt.where is not None:
                    try:
                        if not self.stmt.where(rec):
                            continue
                    except TypeError:
                        continue
                gval = (rec.get(self.stmt.group_by)
                        if self.stmt.group_by else "")
                win = ((m.timestamp_ms // self.stmt.window_ms)
                       * self.stmt.window_ms if self.stmt.window_ms else 0)
                key = (str(gval), win)
                if key not in undo:  # shallow copy: slot values are scalars
                    undo[key] = (dict(self.acc[key]) if key in self.acc
                                 else None)
                self._update(key, rec)
                touched.add(key)
        out = []
        for gval, win in sorted(touched):
            slot = self.acc[(gval, win)]
            row = {}
            for it in self.stmt.items:
                if it.agg:
                    row[it.alias] = slot.get(it.alias, 0 if it.agg == "COUNT" else None)
                elif it.source_col == self.stmt.group_by:
                    row[it.alias] = gval
                elif not it.star:
                    row[it.alias] = gval if it.alias == self.stmt.group_by else None
            if self.stmt.window_ms:
                row["WINDOW_START_MS"] = win
            row = self._changelog_row(self.acc[(gval, win)], row)
            out.append((gval.encode(), json.dumps(row, default=str).encode(), win))
        return out

    def table(self) -> Dict[tuple, dict]:
        """Materialized view: (group, window_start) → aggregate row."""
        return {k: {it.alias: v.get(it.alias) for it in self.stmt.items if it.agg}
                for k, v in self.acc.items()}


class Query:
    """A running persistent query (CSAS/CTAS)."""

    def __init__(self, query_id: str, sink: str, sql: str, task: StreamTask):
        self.query_id = query_id
        self.sink = sink
        self.sql = sql
        self.task = task
        self.error: Optional[str] = None  # last pump failure, surfaced in SHOW QUERIES

    def describe(self) -> dict:
        d = {"id": self.query_id, "sink": self.sink, "queryString": self.sql,
             "state": "ERROR" if self.error else "RUNNING"}
        if self.error:
            d["error"] = self.error
        return d


# ------------------------------------------------------------------ engine


class SqlEngine:
    """Executes the KSQL-equivalent dialect against a Broker.

    One engine == one KSQL server: it owns stream/table metadata, persistent
    queries, and (via the registry) Avro schema ids for its output topics.
    """

    def __init__(self, broker: Broker, registry: Optional[SchemaRegistry] = None,
                 trusted_passthrough: bool = False,
                 owner_token: Optional[object] = None,
                 passthrough_sample: int = 0):
        self.broker = broker
        self.registry = registry or SchemaRegistry()
        self.sources: Dict[str, SourceMeta] = {}
        self.queries: Dict[str, Query] = {}
        self._qseq = 0
        #: when True, pass-through queries whose SOURCE is itself the
        #: output of one of this engine's own queries (query_id set) skip
        #: strict payload re-validation — those bytes were produced by the
        #: engine's validating encoder one hop earlier.  Sources fed by
        #: external producers always keep validation regardless.
        self.trusted_passthrough = bool(trusted_passthrough)
        #: defense-in-depth sampling under trust: validate one batch in
        #: every `passthrough_sample` even on trusted legs (0 = off).
        #: The broker's ownership grant already guarantees only the
        #: engine writes these topics; sampling catches the remaining
        #: failure class (a bug in the engine's own encoder) at ~1/N
        #: of the full re-validation cost.
        self.passthrough_sample = int(passthrough_sample)
        #: produce grant for engine-owned topics (Broker.restrict_topic):
        #: when the platform restricts the AVRO leg to this engine, pump
        #: rounds run under this token so only the engine's own tasks may
        #: write there — the write-exclusivity that makes
        #: trusted_passthrough sound, enforced instead of inferred.
        self.owner_token = owner_token

    # -- public API ---------------------------------------------------

    def execute(self, text: str) -> List[dict]:
        """Run one or more ';'-separated statements; one result dict each."""
        results = []
        for stmt in split_statements(text):
            results.append(self._execute_one(stmt))
        return results

    def pump(self, chunk: int = 4096) -> int:
        """Advance all persistent queries; returns records emitted.

        Each query is isolated: one task raising (e.g. an Avro encode type
        mismatch) marks THAT query errored — surfaced via SHOW QUERIES —
        and the rest keep pumping, instead of one poisoned query silently
        starving everything after it in dict order.

        Failure handling is at-least-once: poll() advances the in-memory
        cursor before process() runs, so on error the cursor is rewound to
        the committed offsets and the chunk is retried next pump (records
        emitted before the failure within the round may be re-emitted —
        KSQL's default delivery guarantee).  The error therefore stays
        visible in SHOW QUERIES until the chunk actually reprocesses."""
        grant = (self.broker.producer_grant(self.owner_token)
                 if self.owner_token is not None
                 and hasattr(self.broker, "producer_grant")
                 else contextlib.nullcontext())
        n = 0
        with grant:
            for q in list(self.queries.values()):
                try:
                    n += q.task.process_available(chunk)
                    q.error = None
                except Exception as e:  # noqa: BLE001 - per-query fault isolation
                    q.error = f"{type(e).__name__}: {e}"
                    q.task.consumer.rewind_to_committed()
        return n

    def table(self, name: str) -> Dict[tuple, dict]:
        """Materialized view of a CTAS table."""
        meta = self.sources.get(name.upper())
        if meta is None or meta.kind != "TABLE":
            raise SqlError(f"no such table: {name}")
        q = self.queries.get(meta.query_id)
        if q is None or not isinstance(q.task, SqlAggTask):
            raise SqlError(f"table {name} has no running query")
        return q.task.table()

    # -- statement dispatch -------------------------------------------

    def _execute_one(self, sql: str) -> dict:
        t = _Toks(tokenize(sql))
        first = (t.peek() or "").upper()
        if first == "CREATE":
            return self._create(t, sql)
        if first == "SELECT":
            return self._transient_select(_parse_select(t))
        if first == "PRINT":
            return self._print(t)
        if first == "SHOW" or first == "LIST":
            return self._show(t)
        if first == "DESCRIBE":
            t.next()
            t.accept("EXTENDED")
            name = t.ident()
            meta = self.sources.get(name)
            if meta is None:
                raise SqlError(f"no such stream/table: {name}")
            return {"statementText": sql, "sourceDescription": meta.describe()}
        if first == "TERMINATE":
            t.next()
            if t.accept("ALL"):
                ids = list(self.queries)
            else:
                ids = [t.ident()]
            for qid in ids:
                if qid not in self.queries:
                    raise SqlError(f"no such query: {qid}")
                del self.queries[qid]
            return {"statementText": sql, "commandStatus": {"status": "SUCCESS",
                    "message": f"terminated {len(ids)} queries"}}
        if first == "DROP":
            return self._drop(t, sql)
        raise SqlError(f"unsupported statement: {sql[:60]!r}")

    # -- CREATE --------------------------------------------------------

    def _parse_with(self, t: _Toks) -> dict:
        props = {}
        if t.accept("WITH"):
            t.expect("(")
            while True:
                k = t.ident()
                t.expect("=")
                tok = t.peek()
                if tok is not None and tok.startswith("'"):
                    props[k] = t.string()
                else:
                    props[k] = t.next()
                if not t.accept(","):
                    break
            t.expect(")")
        return props

    def _create(self, t: _Toks, sql: str) -> dict:
        t.expect("CREATE")
        if t.accept("STREAM"):
            kind = "STREAM"
        elif t.accept("TABLE"):
            kind = "TABLE"
        else:
            raise SqlError("expected STREAM or TABLE after CREATE")
        name = t.ident()
        if name in self.sources:
            raise SqlError(f"{kind.lower()} {name} already exists")

        if t.peek() == "(":  # explicit column list → base stream DDL
            t.expect("(")
            columns = []
            while True:
                col = t.ident()
                ktype = t.ident()
                if ktype not in _KSQL_TO_AVRO:
                    raise SqlError(f"unknown type {ktype}")
                columns.append((col, ktype))
                if not t.accept(","):
                    break
            t.expect(")")
            props = self._parse_with(t)
            topic = props.get("KAFKA_TOPIC", name.lower())
            vfmt = props.get("VALUE_FORMAT", "JSON").upper()
            if vfmt not in _SUPPORTED_VALUE_FORMATS:
                raise SqlError(f"unsupported VALUE_FORMAT {vfmt}")
            partitions = int(props.get("PARTITIONS", 1))
            self.broker.create_topic(topic, partitions=partitions)
            meta = SourceMeta(name, kind, topic, vfmt, columns,
                              key_col=props.get("KEY", "").upper() or None)
            self.sources[name] = meta
            if vfmt == "AVRO":
                self.registry.register(subject_for_topic(topic),
                                       meta.record_schema().avro_json())
            return {"statementText": sql, "commandStatus": {
                "status": "SUCCESS", "message": f"{kind} {name} created"}}

        # CSAS / CTAS
        props = self._parse_with(t)
        t.expect("AS")
        stmt = _parse_select(t)
        src = self.sources.get(stmt.source)
        if src is None:
            raise SqlError(f"unknown source: {stmt.source}")
        topic = props.get("KAFKA_TOPIC", name)
        vfmt = props.get("VALUE_FORMAT", src.value_format).upper()
        if vfmt not in _SUPPORTED_VALUE_FORMATS:
            raise SqlError(f"unsupported VALUE_FORMAT {vfmt}")
        partitions = int(props.get("PARTITIONS",
                                   self.broker.topic(src.topic).partitions))
        self.broker.create_topic(topic, partitions=partitions)

        # Consumer-group id: stable across restarts for the SAME statement
        # (so committed offsets + restored changelog state line up), but
        # keyed by a fingerprint of the SQL text so a re-created query with
        # different semantics starts fresh instead of inheriting the old
        # query's offsets and state.  Whitespace-normalized only — case
        # folding would conflate queries differing in a quoted literal's
        # case, which ARE semantically different.
        import hashlib
        fp = hashlib.sha1(" ".join(sql.split()).encode()).hexdigest()[:8]

        if kind == "TABLE" or stmt.is_aggregate:
            if not stmt.is_aggregate:
                raise SqlError("CREATE TABLE AS requires an aggregate SELECT")
            columns = []
            for it in stmt.items:
                if it.agg:
                    columns.append((it.alias, "BIGINT" if it.agg == "COUNT"
                                    else "DOUBLE"))
                elif not it.star:
                    columns.append((it.alias, self._col_type(src, it)))
            if stmt.window_ms:
                columns.append(("WINDOW_START_MS", "BIGINT"))
            meta = SourceMeta(name, "TABLE", topic, "JSON", columns,
                              key_col=stmt.group_by,
                              windowed=stmt.window_ms is not None)
            self._qseq += 1
            qid = f"CTAS_{name}_{self._qseq}"
            task = SqlAggTask(self.broker, src, meta, stmt,
                              group=f"CTAS_{name}_{fp}")
        else:
            columns = self._infer_columns(src, stmt)
            meta = SourceMeta(name, "STREAM", topic, vfmt, columns,
                              key_col=stmt.partition_by)
            self._qseq += 1
            qid = f"CSAS_{name}_{self._qseq}"
            task = SqlSelectTask(self.broker, src, meta, stmt,
                                 self.registry, group=f"CSAS_{name}_{fp}",
                                 trusted_passthrough=(
                                     self.trusted_passthrough
                                     and src.query_id is not None),
                                 passthrough_sample=self.passthrough_sample)
        meta.query_id = qid
        self.sources[name] = meta
        self.queries[qid] = Query(qid, name, sql, task)
        return {"statementText": sql, "commandStatus": {
            "status": "SUCCESS", "message": f"{kind} {name} created and "
            f"running as {qid}"}}

    @staticmethod
    def _col_type(src: SourceMeta, it: SelectItem) -> str:
        if it.source_col:
            if it.source_col in ("ROWKEY",):
                return "STRING"
            if it.source_col in ("ROWTIME",):
                return "BIGINT"
            for n, k in src.columns:
                if n == it.source_col:
                    return k
        return "DOUBLE"  # arbitrary expression: KSQL's numeric default

    def _infer_columns(self, src: SourceMeta, stmt: SelectStmt):
        columns: List[Tuple[str, str]] = []
        for it in stmt.items:
            if it.star:
                columns.extend(src.columns)
            else:
                columns.append((it.alias, self._col_type(src, it)))
        return columns

    # -- transient queries --------------------------------------------

    def _scan(self, meta: SourceMeta, limit: Optional[int] = None,
              where: Optional[Callable] = None):
        """Pull everything currently in a source's topic (from beginning)."""
        codec = (AvroCodec(meta.record_schema())
                 if meta.value_format == "AVRO" else None)
        spec = self.broker.topic(meta.topic)
        out = []
        for p in range(spec.partitions):
            off = self.broker.begin_offset(meta.topic, p)
            end = self.broker.end_offset(meta.topic, p)
            while off < end:
                try:
                    msgs = self.broker.fetch(meta.topic, p, off,
                                             max_messages=1024)
                except OffsetOutOfRangeError as e:
                    off = e.earliest  # raced a retention trim: skip ahead
                    continue
                if not msgs:
                    break
                for m in msgs:
                    rec = _decode_record(meta, codec, m)
                    off = m.offset + 1
                    if rec is None:
                        continue
                    if where is not None:
                        try:
                            if not where(rec):
                                continue
                        except TypeError:
                            continue
                    out.append(rec)
                    if limit is not None and len(out) >= limit:
                        return out
        return out

    def _transient_select(self, stmt: SelectStmt) -> dict:
        meta = self.sources.get(stmt.source)
        if meta is None:
            raise SqlError(f"unknown source: {stmt.source}")
        if stmt.is_aggregate:
            raise SqlError("transient aggregate queries are not supported; "
                           "use CREATE TABLE ... AS")
        # limit pushes down into the scan: WHERE already ran there, so the
        # scan stops at the n-th match instead of decoding the whole topic
        recs = self._scan(meta, limit=stmt.limit, where=stmt.where)
        rows = []
        header = []
        for it in stmt.items:
            if it.star:
                header.extend(n for n, _ in meta.columns)
            else:
                header.append(it.alias)
        for rec in recs:
            row = []
            try:
                for it in stmt.items:
                    if it.star:
                        row.extend(rec.get(n) for n, _ in meta.columns)
                    else:
                        row.append(it.fn(rec))
            except (TypeError, ZeroDivisionError):
                continue  # NULL in projection arithmetic: drop row
            rows.append(row)
            if stmt.limit is not None and len(rows) >= stmt.limit:
                break
        return {"header": header, "rows": rows}

    def _print(self, t: _Toks) -> dict:
        t.expect("PRINT")
        if (t.peek() or "").startswith("'"):
            topic = t.string()
        else:
            # unquoted: try the token as written, then case-folded variants
            raw = t.next()
            known = self.broker.topics()
            topic = next((c for c in (raw, raw.lower(), raw.upper())
                          if c in known), raw)
        from_beginning = t.accept("FROM", "BEGINNING")
        limit = None
        if t.accept("LIMIT"):
            limit = int(t.next())
        if topic not in self.broker.topics():
            raise SqlError(f"no such topic: {topic}")
        spec = self.broker.topic(topic)
        rows = []
        for p in range(spec.partitions):
            off = (self.broker.begin_offset(topic, p) if from_beginning
                   else max(self.broker.begin_offset(topic, p),
                            self.broker.end_offset(topic, p) - (limit or 10)))
            end = self.broker.end_offset(topic, p)
            while off < end and (limit is None or len(rows) < limit):
                try:
                    msgs = self.broker.fetch(topic, p, off, max_messages=256)
                except OffsetOutOfRangeError as e:
                    off = e.earliest  # raced a retention trim: skip ahead
                    continue
                if not msgs:
                    break
                for m in msgs:
                    rows.append({"partition": p, "offset": m.offset,
                                 "rowtime": m.timestamp_ms,
                                 "key": (m.key or b"").decode(errors="replace"),
                                 "value": self._render_value(m.value)})
                    off = m.offset + 1
                    if limit is not None and len(rows) >= limit:
                        break
        return {"topic": topic, "rows": rows}

    def _render_value(self, value: bytes) -> str:
        """Best-effort value rendering: registry Avro → JSON → utf-8 → hex."""
        try:
            sid, payload = unframe(value)
            reg = self.registry.by_id(sid)
            rec = AvroCodec(reg.record_schema).decode(payload)
            return json.dumps(rec, default=str)
        except (ValueError, KeyError, IndexError, struct_error):
            pass
        try:
            return value.decode()
        except UnicodeDecodeError:
            return value.hex()

    # -- SHOW / DROP ---------------------------------------------------

    def _show(self, t: _Toks) -> dict:
        t.next()
        what = t.ident()
        if what == "STREAMS":
            return {"streams": [m.describe() for m in self.sources.values()
                                if m.kind == "STREAM"]}
        if what == "TABLES":
            return {"tables": [m.describe() for m in self.sources.values()
                               if m.kind == "TABLE"]}
        if what == "QUERIES":
            return {"queries": [q.describe() for q in self.queries.values()]}
        if what == "TOPICS":
            return {"topics": [{"name": n,
                                "partitions": self.broker.topic(n).partitions}
                               for n in self.broker.topics()]}
        raise SqlError(f"cannot SHOW {what}")

    def _drop(self, t: _Toks, sql: str) -> dict:
        t.expect("DROP")
        if t.accept("STREAM"):
            kind = "STREAM"
        elif t.accept("TABLE"):
            kind = "TABLE"
        else:
            raise SqlError("expected STREAM or TABLE after DROP")
        if_exists = t.accept("IF", "EXISTS")
        name = t.ident()
        t.accept("DELETE", "TOPIC")  # metadata-only engine: topic retained
        meta = self.sources.get(name)
        if meta is None:
            if if_exists:
                return {"statementText": sql, "commandStatus": {
                    "status": "SUCCESS", "message": f"{name} did not exist"}}
            raise SqlError(f"no such {kind.lower()}: {name}")
        if meta.kind != kind:
            raise SqlError(f"{name} is a {meta.kind}, not a {kind}")
        # KSQL refuses to drop a source with a live query writing to it
        if meta.query_id and meta.query_id in self.queries:
            raise SqlError(f"cannot drop {name}: query {meta.query_id} is "
                           f"running (TERMINATE it first)")
        readers = [q.query_id for q in self.queries.values()
                   if q.task.src == meta.topic]
        if readers:
            raise SqlError(f"cannot drop {name}: queries {readers} read it")
        del self.sources[name]
        return {"statementText": sql, "commandStatus": {
            "status": "SUCCESS", "message": f"{kind} {name} dropped"}}


# ------------------------------------------------- reference DDL, verbatim

#: The four-object pipeline the reference installs
#: (`01_installConfluentPlatform.sh:229-258`), expressed in this dialect.
REFERENCE_PIPELINE_DDL = """
CREATE STREAM SENSOR_DATA_S (
  COOLANT_TEMP DOUBLE, INTAKE_AIR_TEMP DOUBLE, INTAKE_AIR_FLOW_SPEED DOUBLE,
  BATTERY_PERCENTAGE DOUBLE, BATTERY_VOLTAGE DOUBLE, CURRENT_DRAW DOUBLE,
  SPEED DOUBLE, ENGINE_VIBRATION_AMPLITUDE DOUBLE, THROTTLE_POS DOUBLE,
  TIRE_PRESSURE11 INTEGER, TIRE_PRESSURE12 INTEGER,
  TIRE_PRESSURE21 INTEGER, TIRE_PRESSURE22 INTEGER,
  ACCELEROMETER11_VALUE DOUBLE, ACCELEROMETER12_VALUE DOUBLE,
  ACCELEROMETER21_VALUE DOUBLE, ACCELEROMETER22_VALUE DOUBLE,
  CONTROL_UNIT_FIRMWARE INTEGER, FAILURE_OCCURRED STRING
) WITH (KAFKA_TOPIC='sensor-data', VALUE_FORMAT='JSON');

CREATE STREAM SENSOR_DATA_S_AVRO
  WITH (VALUE_FORMAT='AVRO', KAFKA_TOPIC='SENSOR_DATA_S_AVRO')
  AS SELECT * FROM SENSOR_DATA_S;

CREATE STREAM SENSOR_DATA_S_AVRO_REKEY
  AS SELECT ROWKEY AS CAR, * FROM SENSOR_DATA_S_AVRO PARTITION BY CAR;

CREATE TABLE SENSOR_DATA_EVENTS_PER_5MIN_T
  AS SELECT ROWKEY AS CAR, COUNT(*) AS EVENT_COUNT
     FROM SENSOR_DATA_S_AVRO_REKEY
     WINDOW TUMBLING (SIZE 5 MINUTES) GROUP BY ROWKEY;
"""


def install_reference_pipeline(engine: SqlEngine) -> List[dict]:
    """Run the reference's KSQL DDL (§2.3) against an engine."""
    return engine.execute(REFERENCE_PIPELINE_DDL)
