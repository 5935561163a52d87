"""The port's batch JSON decoder (``iotml_torch/cpp/json_engine.cc`` behind
``NativeCodec.json_decode_batch``) and the null/strict legs of its Avro
codec held against the JAX package's ``NativeCodec`` on the CPU.

Tolerances: exact.  For every row: the fallback flag; for rows the parser
takes, every numeric column bit for bit, every label and the null bitmap
(a flagged row's columns are undefined in both packages and are not
compared).  Hostile rows: escapes, nested values, NaN/Infinity, hex,
"1.", ".5", "+1", ints at and beyond 2^53, floats in int columns,
float32 overflow, invalid UTF-8, raw control characters, duplicate and
missing keys, explicit nulls, non-ASCII keys, trailing garbage, and a
hypothesis case over generated objects.  The null-bitmap decode, the
strict decode and the null-writing encode equal JAX's, and the library
is built from the port's own copy of the source.
"""

import json
import shutil

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from iotml.core.schema import CAR_SCHEMA as J_CAR_SCHEMA
from iotml.core.schema import KSQL_CAR_SCHEMA as J_KSQL_CAR_SCHEMA
from iotml.stream.native import NativeCodec as JNativeCodec
from iotml_torch.core.schema import CAR_SCHEMA, KSQL_CAR_SCHEMA
from iotml_torch.stream import native
from iotml_torch.stream.native import NativeCodec

STRIDE = 64
PAIRS = {"ksql": (KSQL_CAR_SCHEMA, J_KSQL_CAR_SCHEMA),
         "car": (CAR_SCHEMA, J_CAR_SCHEMA)}


def _base(i=0):
    rng = np.random.default_rng(i)
    rec = {}
    for f in KSQL_CAR_SCHEMA.fields:
        if f.avro_type == "int":
            rec[f.name] = int(rng.integers(0, 40))
        elif f.avro_type == "string":
            rec[f.name] = "true" if i % 2 else "false"
        else:
            rec[f.name] = float(np.float32(rng.normal(20, 10)))
    return rec


def _dump(rec):
    return json.dumps(rec).encode()


HOSTILE = [
    _dump(_base(0)),
    _dump({k.lower(): v for k, v in _base(1).items()}),  # producer-ish case
    _dump({"tire_pressure_1_1": 30, "coolant_temp": 90.0,
           "failure_occurred": "false"}),  # producer names: mangled → null
    _dump({**_base(2), "FAILURE_OCCURRED": 'esc"aped\nnewline'}),
    _dump({**_base(3), "FAILURE_OCCURRED": "x" * 200}),
    _dump({**_base(4), "FAILURE_OCCURRED": "x" * (STRIDE - 1)}),
    _dump({**_base(5), "TIRE_PRESSURE11": 2 ** 53}),
    _dump({**_base(6), "TIRE_PRESSURE11": 2 ** 53 - 1}),
    _dump({**_base(7), "TIRE_PRESSURE11": -(2 ** 60)}),
    _dump({**_base(8), "TIRE_PRESSURE11": 1.5}),
    _dump({**_base(9), "TIRE_PRESSURE11": 1e2}),
    _dump({**_base(10), "COOLANT_TEMP": None}),
    _dump({**_base(11), "SPEED": 1e999}),  # → Infinity literal
    _dump({**_base(12), "SPEED": float("nan")}),  # → NaN literal
    _dump({**_base(13), "SPEED": {"nested": 1}}),
    _dump({**_base(14), "SPEED": [1, 2]}),
    _dump({**_base(15), "SPEED": "12.5"}),
    _dump({**_base(16), "FAILURE_OCCURRED": 1}),
    _dump({**_base(17), "FAILURE_OCCURRED": True}),
    _dump({**_base(18), "SPEED": True}),
    _dump({**_base(19), "unknown_key": {"a": [1, {"b": None}]}}),
    _dump({**_base(20), "SPEED": 1e-320}),  # subnormal
    _dump({**_base(21), "SPEED": 5e-324}),
    _dump({**_base(22), "SPEED": -0.0}),
    _dump({**_base(23), "ﬂow": 1.0}),  # non-ASCII key
    _dump({**_base(24), "FAILURE_OCCURRED": "ünïcode"}),
    json.dumps({**_base(25), "FAILURE_OCCURRED": "ünïcode"},
               ensure_ascii=False).encode(),
    b'{"SPEED": 0x1F, "COOLANT_TEMP": 1.0}',
    b'{"SPEED": 1., "COOLANT_TEMP": 1.0}',
    b'{"SPEED": .5}',
    b'{"SPEED": +1}',
    b'{"SPEED": 01}',
    b'{"SPEED": 1e}',
    b'{"SPEED": -}',
    b'{"SPEED": 1.0} trailing',
    b'{"SPEED": 1.0,}',
    b'{"SPEED" 1.0}',
    b'{SPEED: 1.0}',
    b'{"SPEED": 1.0, "SPEED": 2.0}',  # duplicate: last wins
    b'{"FAILURE_OCCURRED": "a-long-label", "FAILURE_OCCURRED": "b"}',
    b'{"FAILURE_OCCURRED": "ctl\x01char"}',
    b'{"FAILURE_OCCURRED": "tab\tchar"}',
    b'{"FAILURE_OCCURRED": "bad \xff utf8"}',
    b'{"FAILURE_OCCURRED": "over\xc0\xafong"}',
    b'{"spe\\u0065d": 3.0}',
    b'  {  "SPEED"  :  3.0  ,  "speed" : 4.0 }  ',
    b'{}',
    b'[]',
    b'null',
    b'"just a string"',
    b'',
    b'{',
    b'{"SPEED": 3.0',
    b'{"SPEED": nul}',
    b'{"SPEED": tru}',
    b'{"CONTROL_UNIT_FIRMWARE": 2000, "TIRE_PRESSURE22": -0}',
    b'{"TIRE_PRESSURE22": 1e5}',
    b'{"TIRE_PRESSURE22": 100000000000000000000}',
    b'\xef\xbb\xbf{"SPEED": 1.0}',  # a BOM
]


def _compare(got, want):
    t_num, t_lab, t_nul, t_fb = got
    j_num, j_lab, j_nul, j_fb = want
    np.testing.assert_array_equal(t_fb, j_fb)
    ok = t_fb == 0
    assert t_num.shape == j_num.shape and t_lab.shape == j_lab.shape
    np.testing.assert_array_equal(t_num[ok].view(np.int64),
                                  j_num[ok].view(np.int64))
    np.testing.assert_array_equal(t_lab[ok], j_lab[ok])
    np.testing.assert_array_equal(t_nul[ok], j_nul[ok])


@pytest.mark.parametrize("which", sorted(PAIRS))
def test_hostile_rows_equal_jax(which):
    t_sch, j_sch = PAIRS[which]
    got = NativeCodec(t_sch).json_decode_batch(HOSTILE, stride=STRIDE)
    want = JNativeCodec(j_sch).json_decode_batch(HOSTILE, stride=STRIDE)
    _compare(got, want)
    fb = got[3]
    if which == "ksql":
        # the first row is the fleet's: native; the escapes, nesting,
        # NaN/Infinity, hex, "1.", big ints and invalid UTF-8 are not
        assert fb[0] == 0 and fb[3] == fb[12] == fb[13] == fb[27] == 1
        assert fb[6] == 1 and fb[7] == 0 and fb[43] == 1


def test_fallback_rows_are_counted():
    native.reset_stats()
    _, _, _, fb = NativeCodec(KSQL_CAR_SCHEMA).json_decode_batch(
        HOSTILE, stride=STRIDE)
    assert native.stats["json_decode_rows"] == len(HOSTILE)
    assert native.stats["json_fallback_rows"] == int(fb.sum()) > 0


@pytest.mark.parametrize("stride", [8, 16, 64])
def test_label_stride_equals_jax(stride):
    rows = [_dump({**_base(i), "FAILURE_OCCURRED": "y" * n})
            for i, n in enumerate((0, 1, 7, 8, 15, 16, 63, 64))]
    _compare(NativeCodec(KSQL_CAR_SCHEMA).json_decode_batch(rows, stride),
             JNativeCodec(J_KSQL_CAR_SCHEMA).json_decode_batch(rows, stride))


def test_empty_batch_equals_jax():
    got = NativeCodec(KSQL_CAR_SCHEMA).json_decode_batch([])
    want = JNativeCodec(J_KSQL_CAR_SCHEMA).json_decode_batch([])
    assert [a.shape for a in got] == [a.shape for a in want]


_scalars = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-(2 ** 60), max_value=2 ** 60),
    st.floats(allow_nan=True, allow_infinity=True, width=64),
    st.text(max_size=20))
_values = st.recursive(_scalars, lambda inner: st.one_of(
    st.lists(inner, max_size=3),
    st.dictionaries(st.text(max_size=5), inner, max_size=3)), max_leaves=5)
_keys = st.one_of(st.sampled_from(
    [f.name for f in KSQL_CAR_SCHEMA.fields]
    + [f.name for f in CAR_SCHEMA.fields]
    + [f.name.lower() for f in KSQL_CAR_SCHEMA.fields]), st.text(max_size=8))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.dictionaries(_keys, _values, max_size=22), min_size=1,
                max_size=6), st.booleans())
def test_generated_objects_equal_jax(objs, ascii_only):
    rows = [json.dumps(o, ensure_ascii=ascii_only).encode() for o in objs]
    _compare(NativeCodec(KSQL_CAR_SCHEMA).json_decode_batch(rows, STRIDE),
             JNativeCodec(J_KSQL_CAR_SCHEMA).json_decode_batch(rows, STRIDE))


# ------------------------------------------------- nulls / strict Avro
def _avro_rows():
    t = NativeCodec(KSQL_CAR_SCHEMA)
    num, lab, nul, fb = t.json_decode_batch(HOSTILE, stride=STRIDE)
    ok = np.nonzero(fb == 0)[0]
    return num[ok], lab[ok], nul[ok]


def test_encode_with_nulls_equals_jax():
    num, lab, nul = _avro_rows()
    kw = dict(schema_id=7, stride=STRIDE, nulls=nul)
    got = NativeCodec(KSQL_CAR_SCHEMA).encode_batch(num, lab, **kw)
    assert got == JNativeCodec(J_KSQL_CAR_SCHEMA).encode_batch(num, lab, **kw)
    # a null on a non-nullable field cannot be encoded: both refuse
    n = np.zeros((1, len(CAR_SCHEMA.fields)), np.uint8)
    n[0, 0] = 1
    for codec in (NativeCodec(CAR_SCHEMA), JNativeCodec(J_CAR_SCHEMA)):
        with pytest.raises(ValueError):
            codec.encode_batch(np.zeros((1, 18)), None, nulls=n)


def test_decode_nulls_and_strict_equal_jax():
    num, lab, nul = _avro_rows()
    msgs = NativeCodec(KSQL_CAR_SCHEMA).encode_batch(
        num, lab, schema_id=1, stride=STRIDE, nulls=nul)
    t, j = NativeCodec(KSQL_CAR_SCHEMA), JNativeCodec(J_KSQL_CAR_SCHEMA)
    for a, b in zip(t.decode_batch_nulls(msgs, strip=5, stride=STRIDE),
                    j.decode_batch_nulls(msgs, strip=5, stride=STRIDE)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        t.decode_batch_nulls(msgs, strip=5, stride=STRIDE)[2], nul)
    for a, b in zip(t.decode_batch(msgs, strip=5, stride=STRIDE, strict=True),
                    j.decode_batch(msgs, strip=5, stride=STRIDE,
                                   strict=True)):
        np.testing.assert_array_equal(a, b)
    # non-canonical bytes: a trailing byte, a non-minimal varint, invalid
    # UTF-8 in the label — strict rejects each, as JAX's does
    bad = [msgs[0] + b"\x00",
           msgs[0][:5] + b"\x02" + msgs[0][6:],
           msgs[0][:-6] + b"\x08\xff\xfe\xfd\xfc"]
    for row in bad:
        outs = []
        for codec in (t, j):
            try:
                codec.decode_batch([row], strip=5, stride=STRIDE,
                                   strict=True)
                outs.append("ok")
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1]


def test_engine_library_is_built_from_the_ports_json_source(tmp_path):
    assert "json_engine.cc" in native.SOURCES
    assert (native.CPP / "json_engine.cc").exists()
    for name in native.SOURCES + native.HEADERS:
        shutil.copy(native.CPP / name, tmp_path / name)
    good = native.library_path(tmp_path)
    (tmp_path / "json_engine.cc").write_text(
        (tmp_path / "json_engine.cc").read_text() + "\nnot C++ at all;\n")
    # the hash covers the JSON source: an edit is a new library name
    assert native.library_path(tmp_path) != good
    with pytest.raises(RuntimeError, match="build failed") as ei:
        native.build(tmp_path)
    assert "json_engine.cc" in str(ei.value)
    assert native.load().iotml_json_decode_batch.argtypes is not None
