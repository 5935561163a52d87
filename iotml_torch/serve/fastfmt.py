"""Byte-identical fast ``np.array2string`` for prediction rows
(``iotml.serve.fastfmt``'s twin).

The scorer's payload contract is ``np.array2string(row)`` — the exact
string the reference's OutputCallback produced (cardata-v3.py:247) — and
that call is the scorer's host bottleneck: numpy's per-element Python
formatting pipeline (``FloatingFormat.fillFormat`` + ``_formatArray``).

``format_rows`` formats a whole [N, F] block in one call of the C++
engine (``cpp/fmt_engine.cc``): numpy's output byte for byte for 1-D
finite float rows under default print options in positional
(non-exponential) form.  Rows that would take any other numpy path —
non-finite values, the exponential trigger (|x|max ≥ 1e8, nonzero
|x|min < 1e-4, or max/min > 1000), non-default printoptions, a dtype
other than float32/float64 — are formatted by ``np.array2string``
itself, so equality holds unconditionally.  ``format_rows_plain`` is the
engine's plain version: the same eligibility, one dragon4 call per
element and numpy's padding and line-wrap assembly in Python
(numpy/_core/arrayprint.py: ``FloatingFormat.fillFormat``'s positional
branch, ``_formatArray``'s 1-D recurser with ``_extendLine``).
"""

from __future__ import annotations

import ctypes
import time
import warnings
from typing import List

import numpy as np

from ..stream import native

# the printoptions the fast paths reproduce; anything else → numpy
_DEFAULTS = {
    "precision": 8, "suppress": False, "floatmode": "maxprec",
    "sign": "-", "linewidth": 75,
}

_LINEWIDTH = 75
_HANG = " "                       # 1-D next_line_prefix
_ELEM_W = _LINEWIDTH - 1          # minus max(len(sep.rstrip()), len(']'))

# the public format_float_positional wrapper spends ~3× the C call's cost
# in argument validation; go straight to dragon4 when the private symbol
# exists (same function numpy itself dispatches to), else use the wrapper
try:
    from numpy._core._multiarray_umath import \
        dragon4_positional as _dragon4  # type: ignore[attr-defined]
except ImportError:  # numpy layout changed: correctness over speed
    _dragon4 = np.format_float_positional


def _options_are_default() -> bool:
    opts = np.get_printoptions()
    return all(opts.get(k) == v for k, v in _DEFAULTS.items())


def _numpy_only(rows: np.ndarray) -> bool:
    """Rows no fast path takes: not a 2-D float block, or non-default
    printoptions."""
    return rows.ndim != 2 or rows.dtype.kind != "f" or \
        not _options_are_default()


def _format_fast_row(row: np.ndarray) -> str:
    """One finite, non-exponential row → np.array2string(row) bytes."""
    fmt = _dragon4
    strs = [fmt(x, precision=8, unique=True, fractional=True, trim=".")
            for x in row]
    parts = [s.split(".") for s in strs]
    pad_left = max(len(p[0]) for p in parts)
    pad_right = max(len(p[1]) for p in parts)
    words = [
        " " * (pad_left - len(p[0])) + s + " " * (pad_right - len(p[1]))
        for s, p in zip(strs, parts)
    ]
    # numpy's 1-D assembly: hanging indent ' ', separator ' ' appended
    # after every element but the last, wrap when the next word would
    # cross elem_width, then strip the indent and wrap in brackets
    out = []
    line = _HANG
    last = len(words) - 1
    for i, w in enumerate(words):
        if len(line) + len(w) > _ELEM_W and len(line) > len(_HANG):
            out.append(line.rstrip())
            line = _HANG
        line += w
        if i != last:
            line += " "
    out.append(line)
    return "[" + "\n".join(out)[1:] + "]"


def fast_rows(rows: np.ndarray) -> np.ndarray:
    """[N] bool: the rows of a 2-D float block that the fast paths take
    (finite, no exponential trigger); numpy formats the others."""
    rows = np.asarray(rows)
    finite = np.isfinite(rows).all(axis=1)
    absd = np.abs(rows.astype(np.float64))
    nz = np.where(absd > 0, absd, np.nan)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"), \
            warnings.catch_warnings():
        # all-zero rows are legitimately all-NaN here; has_nz handles them
        warnings.simplefilter("ignore", RuntimeWarning)
        mx = np.nanmax(nz, axis=1)
        mn = np.nanmin(nz, axis=1)
        has_nz = ~np.isnan(mx)
        exp = has_nz & ((mx >= 1e8) | (mn < 1e-4) | (mx / mn > 1000.0))
    return finite & ~exp


def format_rows_plain(rows: np.ndarray) -> List[str]:
    """``format_rows``'s plain version: np.array2string for each row of
    [N, F], byte-identical, one dragon4 call per element of each
    ``fast_rows`` row."""
    rows = np.asarray(rows)
    if _numpy_only(rows):
        return [np.array2string(r) for r in rows]
    return [
        _format_fast_row(row) if ok else np.array2string(row)
        for row, ok in zip(rows, fast_rows(rows))
    ]


def format_rows(rows: np.ndarray) -> List[str]:
    """np.array2string for each row of [N, F], byte-identical, in one
    call of the C++ engine (which must build: no silent fallback to the
    plain version).  The engine flags the rows outside its fast path,
    and numpy formats those."""
    rows = np.asarray(rows)
    if _numpy_only(rows) or rows.dtype not in (np.float32, np.float64):
        return [np.array2string(r) for r in rows]
    lib = native.load()
    t0 = time.perf_counter()
    f32 = rows.dtype == np.float32
    fn = lib.iotml_format_rows_f32 if f32 else lib.iotml_format_rows_f64
    ptr_t = ctypes.c_float if f32 else ctypes.c_double
    rows = np.ascontiguousarray(rows)
    n, f = rows.shape
    # worst-case padded word ~ (20 left + 20 right + 2) chars; cap adds
    # wrap newlines + brackets with slack, doubled on overflow
    cap = int(n * (f * 44 + f + 18) + 64)
    while True:
        out = np.empty((cap,), np.uint8)
        offsets = np.zeros((n + 1,), np.int64)
        fallback = np.zeros((n,), np.uint8)
        total = fn(rows.ctypes.data_as(ctypes.POINTER(ptr_t)), n, f,
                   out.ctypes.data_as(ctypes.c_char_p), cap,
                   offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                   fallback.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if total >= 0:
            break
        cap *= 2
    # slice before copying: cap over-allocates ~4× the formatted bytes
    raw = out[:total].tobytes()
    msgs = [raw[offsets[i]:offsets[i + 1]].decode()
            if not fallback[i] else np.array2string(rows[i])
            for i in range(n)]
    native.tally("format", n - int(fallback.sum()), t0)
    return msgs
