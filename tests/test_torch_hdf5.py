"""The port's HDF5 subset (``iotml_torch.utils.hdf5``) and its Keras h5
exporter and importer, held against ``h5py`` and the JAX package's
``h5_export`` / ``h5_import`` on the CPU.

Each direction tests the other: the port's files are read by ``h5py``
(high-level and its low-level ``h5f`` / ``h5a`` / ``h5t`` / ``h5d`` /
``h5s`` API) and by JAX's importer; ``h5py``'s files (JAX's exporter and
hand-made ones) are read by the port.

Tolerance: none.  Datasets are compared bit for bit (``tobytes``),
attributes as bytes with their dtypes, shapes and the Keras strings
byte for byte.
"""

import io
import os
import struct

import h5py
import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from iotml.models import h5_export as j_export
from iotml.models import h5_import as j_import
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml_torch.models import h5_export, h5_import
from iotml_torch.models.convert import params_from_jax, params_to_jax
from iotml_torch.utils import hdf5

STYLES = ["reference", "modern"]
LAYERS = ("encoder0", "encoder1", "decoder0", "decoder1")


def _jax_params(seed=3):
    """A seeded flax param tree (numpy leaves) of the car autoencoder."""
    tree = J_AE.init(jax.random.PRNGKey(seed),
                     np.zeros((1, 18), np.float32))["params"]
    rng = np.random.default_rng(seed)
    # non-zero biases, so a swapped kernel/bias would show
    return {k: {"kernel": np.asarray(v["kernel"]),
                "bias": rng.standard_normal(np.shape(v["bias"]))
                .astype(np.float32)} for k, v in tree.items()}


def _h5py_tree(path):
    """{name: (kind, attrs as {k: (dtype, shape, bytes)}, data)} of every
    object, root included, read by h5py."""
    out = {}

    def attrs(obj):
        return {k: _attr_key(obj.attrs[k]) for k in obj.attrs}

    with h5py.File(path, "r") as f:
        out["/"] = ("group", attrs(f), None)

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                a = obj[()]
                out[name] = ("dataset", attrs(obj),
                             (a.dtype.str, a.shape, a.tobytes()))
            else:
                out[name] = ("group", attrs(obj), None)

        f.visititems(visit)
    return out


def _port_tree(source):
    out = {}
    f = hdf5.File(source)

    def attrs(obj):
        return {k: _attr_key(v) for k, v in obj.attrs.items()}

    out["/"] = ("group", attrs(f), None)

    def visit(name, obj):
        if isinstance(obj, hdf5.Dataset):
            a = np.asarray(obj)
            out[name] = ("dataset", attrs(obj),
                         (a.dtype.str, a.shape, a.tobytes()))
        else:
            out[name] = ("group", attrs(obj), None)

    f.visititems(visit)
    return out


def _attr_key(v):
    a = np.asarray(v)
    return (type(v).__name__, a.dtype.str, a.shape, a.tobytes())


# ------------------------------------------------- Keras files, both ways
@pytest.mark.parametrize("style", STYLES)
def test_port_writer_equals_jax_writer_under_h5py(tmp_path, style):
    """The port's file and JAX's (h5py) file of the same params read the
    same through h5py: every object, attribute (type, dtype, shape,
    bytes) and dataset (bits)."""
    tree = _jax_params()
    jpath, tpath = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    j_export.autoencoder_params_to_h5(tree, jpath, style=style)
    h5_export.autoencoder_params_to_h5(params_from_jax(tree), tpath,
                                       style=style)
    got, want = _h5py_tree(tpath), _h5py_tree(jpath)
    assert got == want
    assert got["/"][1]["model_config"][3] == \
        j_export._model_config(18, [14, 7, 7, 18], 1e-7, style).encode()
    assert got["model_weights"][1]["layer_names"][1] == "|S7"
    assert got["model_weights/input_1"][1]["weight_names"][1:3] == \
        ("<f8", (0,))


@pytest.mark.parametrize("style", STYLES)
def test_port_reader_equals_h5py_on_jax_file(tmp_path, style):
    """JAX's file, written by h5py, read by the port: the same tree as
    h5py reads, attributes and datasets bit for bit."""
    path = str(tmp_path / "j.h5")
    j_export.autoencoder_params_to_h5(_jax_params(), path, style=style)
    with open(path, "rb") as fh:
        data = fh.read()
    assert _port_tree(path) == _port_tree(data) == _h5py_tree(path)


@pytest.mark.parametrize("style", STYLES)
def test_importers_read_each_others_files_bit_equal(tmp_path, style):
    tree = _jax_params(5)
    jpath, tpath = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    j_export.autoencoder_params_to_h5(tree, jpath, style=style)
    h5_export.autoencoder_params_to_h5(params_from_jax(tree), tpath,
                                       style=style)
    for got in (j_import.autoencoder_params_from_h5(tpath),
                params_to_jax(h5_import.autoencoder_params_from_h5(jpath)),
                params_to_jax(h5_import.autoencoder_params_from_h5(tpath))):
        for layer in LAYERS:
            for leaf in ("kernel", "bias"):
                a, b = got[layer][leaf], tree[layer][leaf]
                assert a.dtype == np.float32 and a.shape == b.shape
                assert a.tobytes() == b.tobytes(), (layer, leaf)


def test_port_file_passes_h5py_low_level_checks(tmp_path):
    """The constructs the HDF5 library checks: superblock version 0,
    sizes 8/8, no user block, the end of file at the file's length,
    IEEE float fields, null-padded ASCII strings, scalar and zero-length
    dataspaces, contiguous layout."""
    path = str(tmp_path / "t.h5")
    h5_export.autoencoder_params_to_h5(params_from_jax(_jax_params()), path)
    assert h5py.h5f.is_hdf5(path.encode())
    fid = h5py.h5f.open(path.encode(), h5py.h5f.ACC_RDONLY)
    try:
        fcpl = fid.get_create_plist()
        assert fcpl.get_version() == (0, 0, 0, 0)
        assert fcpl.get_sizes() == (8, 8)
        assert fcpl.get_userblock() == 0
        assert fid.get_filesize() == os.path.getsize(path)
        root = h5py.h5g.open(fid, b"/")
        a = h5py.h5a.open(root, b"model_config")
        t = a.get_type()
        assert t.get_class() == h5py.h5t.STRING
        assert t.get_strpad() == h5py.h5t.STR_NULLPAD
        assert t.get_cset() == h5py.h5t.CSET_ASCII
        assert a.get_space().get_simple_extent_type() == h5py.h5s.SCALAR
        g = h5py.h5g.open(fid, b"/model_weights/input_1")
        a = h5py.h5a.open(g, b"weight_names")
        assert a.get_space().get_simple_extent_type() == h5py.h5s.SIMPLE
        assert a.get_space().shape == (0,)
        assert a.get_type().get_size() == 8
        d = h5py.h5d.open(fid, b"/model_weights/dense/dense/kernel:0")
        assert d.get_create_plist().get_layout() == h5py.h5d.CONTIGUOUS
        t = d.get_type()
        assert t.get_class() == h5py.h5t.FLOAT
        assert t.get_fields() == (31, 23, 8, 0, 23)
        assert t.get_ebias() == 127
        assert t.get_norm() == h5py.h5t.NORM_IMPLIED
        assert t.get_order() == h5py.h5t.ORDER_LE
        assert t.get_precision() == 32 and t.get_offset() == 0
        assert d.get_space().shape == (18, 14)
        assert d.get_storage_size() == 18 * 14 * 4
    finally:
        fid.close()


# ------------------------------------------------------ the general subset
@settings(max_examples=40, deadline=None)
@given(shapes=st.lists(st.lists(st.integers(0, 5), min_size=0, max_size=3),
                       min_size=1, max_size=4),
       strings=st.lists(st.binary(min_size=0, max_size=40)
                        .map(lambda b: b.replace(b"\0", b"x")),
                        min_size=1, max_size=4),
       seed=st.integers(0, 2 ** 31 - 1))
def test_round_trip_over_shapes_values_and_strings(shapes, strings, seed):
    """Any float32 arrays (NaN, inf and denormals included) and byte
    strings round-trip through the port's writer, bit for bit, read by
    the port and by h5py."""
    rng = np.random.default_rng(seed)
    arrays = []
    for shape in shapes:
        bits = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64)
        arrays.append(bits.astype(np.uint32).view(np.float32))
    buf = io.BytesIO()
    with hdf5.File(buf, "w") as f:
        g = f.create_group("g")
        for i, a in enumerate(arrays):
            g.create_dataset(f"d{i}", data=a)
            g.attrs[f"a{i}"] = a
        for i, s in enumerate(strings):
            f.attrs[f"s{i}"] = np.bytes_(s)
        width = max(1, max(len(s) for s in strings))
        f.attrs["sa"] = np.array(strings, dtype=f"S{width}")
    data = buf.getvalue()
    back = hdf5.File(data)
    with h5py.File(io.BytesIO(data), "r") as h:
        for i, a in enumerate(arrays):
            for got in (np.asarray(back[f"g/d{i}"]), h[f"g/d{i}"][()],
                        back["g"].attrs[f"a{i}"], h["g"].attrs[f"a{i}"]):
                assert np.asarray(got).tobytes() == a.tobytes()
                assert np.shape(got) == a.shape
        for i, s in enumerate(strings):
            assert back.attrs[f"s{i}"] == h.attrs[f"s{i}"] == s
        assert list(back.attrs["sa"]) == list(h.attrs["sa"]) == strings


@pytest.mark.parametrize("n", [1, 8, 9, 17, 64, 256])
def test_groups_of_many_members_split_into_symbol_nodes(n):
    """A group of more than 2K = 8 members spans several symbol nodes
    under one B-tree leaf; h5py looks each name up through the B-tree's
    keys, and both readers list the names in byte order."""
    names = [f"m{i:03d}" for i in range(n)][::-1]
    buf = io.BytesIO()
    with hdf5.File(buf, "w") as f:
        for i, name in enumerate(names):
            f.create_dataset(f"grp/{name}", data=np.full(2, i, np.float32))
    data = buf.getvalue()
    with h5py.File(io.BytesIO(data), "r") as h:
        assert list(h["grp"].keys()) == sorted(names)
        for i, name in enumerate(names):
            assert h[f"grp/{name}"][0] == i
    assert hdf5.File(data)["grp"].keys() == sorted(names)


def test_a_group_over_one_leaf_raises():
    f = hdf5.File(io.BytesIO(), "w")
    for i in range(257):
        f.create_group(f"g{i}")
    with pytest.raises(ValueError, match="257 members"):
        f.tobytes()


@pytest.mark.parametrize("dtype", ["<f2", "<f4", "<f8", ">f2", ">f4", ">f8",
                                   "S1", "S13"])
def test_h5py_datasets_and_attributes_of_each_type(tmp_path, dtype):
    """h5py writes each supported type, either byte order; the port reads
    the values; the port writes them back and h5py reads the same."""
    rng = np.random.default_rng(11)
    if dtype.startswith("S"):
        a = np.array([b"ab", b"", b"xyz"], dtype=dtype)
    else:
        a = rng.standard_normal((3, 4)).astype(dtype)
    path = str(tmp_path / "h.h5")
    with h5py.File(path, "w") as h:
        h.create_dataset("d", data=a)
        h.attrs["a"] = a
        h.create_dataset("scalar", data=a.reshape(-1)[0])
    f = hdf5.File(path)
    for got in (np.asarray(f["d"]), f.attrs["a"]):
        assert got.shape == a.shape
        np.testing.assert_array_equal(got, a)
        assert got.dtype.itemsize == a.dtype.itemsize
    assert np.asarray(f["scalar"])[()] == a.reshape(-1)[0]
    buf = io.BytesIO()
    with hdf5.File(buf, "w") as w:
        w.create_dataset("d", data=a)
        w.attrs["a"] = a
    with h5py.File(io.BytesIO(buf.getvalue()), "r") as h:
        np.testing.assert_array_equal(h["d"][()], a)
        np.testing.assert_array_equal(h.attrs["a"], a)
        assert h["d"].dtype == a.dtype


def test_h5py_compact_and_empty_datasets(tmp_path):
    path = str(tmp_path / "c.h5")
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    with h5py.File(path, "w") as h:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple(a.shape)
        did = h5py.h5d.create(h.id, b"compact", h5py.h5t.IEEE_F32LE, space,
                              dcpl=dcpl)
        did.write(h5py.h5s.ALL, h5py.h5s.ALL, a)
        h.create_dataset("empty", shape=(0,), dtype=np.float64)
        h.create_group("nothing")
    f = hdf5.File(path)
    assert np.asarray(f["compact"]).tobytes() == a.tobytes()
    assert np.asarray(f["empty"]).shape == (0,)
    assert f["nothing"].keys() == []
    buf = io.BytesIO()
    with hdf5.File(buf, "w") as w:
        w.create_dataset("empty", data=np.zeros((0, 3), np.float32))
        w.create_group("nothing")
    with h5py.File(io.BytesIO(buf.getvalue()), "r") as h:
        assert h["empty"].shape == (0, 3)
        assert list(h["nothing"].keys()) == []


def _message(mtype, flags, data):
    size = (len(data) + 7) & ~7
    return struct.pack("<HHB3x", mtype, size, flags) + data + \
        b"\0" * (size - len(data))


def test_attribute_messages_v2_v3_and_dataspace_v2():
    """Attribute messages version 2 (unpadded) and 3 (with a name
    encoding byte), each with a version 2 dataspace, decode as version 1
    does; built by hand, since h5py writes version 1 under version 0."""
    reader = hdf5._Reader(hdf5.File(io.BytesIO(), "w").tobytes())
    dt = struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 31, 0, 4, 0, 32, 23, 8,
                     0, 23, 127)
    values = np.array([1.5, -2.0], np.float32)
    space = struct.pack("<BBBBQ", 2, 1, 0, 1, 2)
    name = b"w\0"
    for version, extra in ((2, b""), (3, b"\0")):
        body = struct.pack("<BBHHH", version, 0, len(name), len(dt),
                           len(space)) + extra + name + dt + space + \
            values.tobytes()
        got_name, got = reader.attribute(body)
        assert got_name == "w" and got.tobytes() == values.tobytes()
    scalar = struct.pack("<BBBB", 2, 0, 0, 0)
    body = struct.pack("<BBHHH", 2, 0, len(name), len(dt), len(scalar)) + \
        name + dt + scalar + values[:1].tobytes()
    assert reader.attribute(body)[1] == np.float32(1.5)
    null = struct.pack("<BBBB", 2, 0, 0, 2)
    body = struct.pack("<BBHHH", 2, 0, len(name), len(dt), len(null)) + \
        name + dt + null
    with pytest.raises(ValueError, match="null dataspace"):
        reader.attribute(body)


def test_header_continuation_blocks_are_followed():
    """A header whose messages go on in a continuation block (where h5py
    puts a large attribute) reads whole."""
    block = _message(0x000C, 0, hdf5._attribute_msg(
        "k", np.bytes_(b"v" * 3000)))
    data = _root_with(b"", block=block)
    assert hdf5.File(data).attrs["k"] == b"v" * 3000
    with h5py.File(io.BytesIO(data), "r") as h:
        assert h.attrs["k"] == b"v" * 3000


# ----------------------------------------------------------- the refusals
def _h5py_file(tmp_path, make, **kw):
    path = str(tmp_path / "x.h5")
    with h5py.File(path, "w", **kw) as h:
        make(h)
    return path


UNSUPPORTED = {
    "chunked": (lambda h: h.create_dataset("d", data=np.zeros((4, 4)),
                                           chunks=(2, 2)), {},
                "chunked data"),
    "filtered": (lambda h: h.create_dataset("d", data=np.zeros((4, 4)),
                                            compression="gzip"), {},
                 "filtered data"),
    "vlen string": (lambda h: h.attrs.__setitem__("s", "text"), {},
                    "variable-length"),
    "integer": (lambda h: h.create_dataset("d", data=np.arange(3)), {},
                "fixed-point"),
    "compound": (lambda h: h.create_dataset(
        "d", data=np.zeros(2, [("a", "<f4"), ("b", "<f4")])), {},
        "compound"),
    "newer superblock": (lambda h: h.create_group("g"),
                         {"libver": "latest"}, "superblock version"),
    "creation-ordered group": (lambda h: h.create_group(
        "g", track_order=True), {}, "version 2 object header"),
    "soft link": (lambda h: (h.create_group("g"),
                             h.__setitem__("l", h5py.SoftLink("/g"))), {},
                  "soft link"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_constructs_raise_naming_them(tmp_path, case):
    make, kw, words = UNSUPPORTED[case]
    path = _h5py_file(tmp_path, make, **kw)
    with pytest.raises(ValueError, match=words):
        f = hdf5.File(path)
        f.visititems(lambda name, obj: np.asarray(obj)
                     if isinstance(obj, hdf5.Dataset) else None)


def _root_with(extra: bytes, block: bytes = b"") -> bytes:
    """An empty file whose root header carries one more message
    (``extra``), or whose messages go on in a continuation ``block``."""
    w = hdf5._Writer()
    w.out = bytearray(hdf5.File(io.BytesIO(), "w").tobytes())
    root = struct.unpack_from("<Q", w.out, 64)[0]
    n = struct.unpack_from("<H", w.out, root + 2)[0] + bool(extra)
    size = struct.unpack_from("<I", w.out, root + 8)[0]
    body = bytes(w.out[root + 16:root + 16 + size]) + extra
    if block:
        body += _message(0x0010, 0, struct.pack("<QQ", w._put(block),
                                                len(block)))
        n += 2
    new_root = w._put(struct.pack("<BBHII4x", 1, 0, n, 1, len(body)) + body)
    struct.pack_into("<Q", w.out, 40, len(w.out))  # the end of file
    struct.pack_into("<Q", w.out, 64, new_root)    # the root's header
    return bytes(w.out)


HAND_BUILT = {
    "link info": (_message(0x0002, 0, bytes(20)), "new-style group"),
    "link": (_message(0x0006, 0, bytes(16)), "new-style group"),
    "group info": (_message(0x000A, 0, bytes(8)), "new-style group"),
    "filter pipeline": (_message(0x000B, 0, bytes(8)), "filtered data"),
    "external storage": (_message(0x0007, 0, bytes(8)), "external"),
    "shared message": (_message(0x0003, 0x02, bytes(8)), "shared"),
    "dense attributes": (_message(0x0015, 0, struct.pack(
        "<BBQQ", 0, 0, 4096, hdf5.UNDEF)), "dense attribute storage"),
    "unknown message": (_message(0x0042, 0, bytes(8)), "0x0042"),
}


@pytest.mark.parametrize("case", sorted(HAND_BUILT))
def test_hand_built_unsupported_messages_raise(case):
    extra, words = HAND_BUILT[case]
    assert hdf5.File(_root_with(b"")).keys() == []
    with pytest.raises(ValueError, match=words):
        hdf5.File(_root_with(extra))


def _keras_bytes():
    buf = io.BytesIO()
    h5_export.autoencoder_params_to_h5(params_from_jax(_jax_params()), buf)
    return buf.getvalue()


def _walk(data):
    f = hdf5.File(data)
    f.visititems(lambda name, obj: np.asarray(obj)
                 if isinstance(obj, hdf5.Dataset) else None)


@pytest.mark.parametrize("cut", [0, 7, 95, 96, 500, 4000, -8, -1])
def test_truncated_files_raise(cut):
    data = _keras_bytes()
    with pytest.raises(ValueError, match="truncated|signature"):
        _walk(data[:cut])


@pytest.mark.parametrize("sig", [b"\x89HDF", b"TREE", b"SNOD", b"HEAP"])
def test_bad_signatures_raise(sig):
    data = bytearray(_keras_bytes())
    at = data.find(sig)
    data[at] ^= 0xFF
    with pytest.raises(ValueError, match="signature"):
        _walk(bytes(data))


def test_flipped_bytes_raise_only_value_error():
    """Seeded corruption anywhere in a file: the reader either reads it
    or raises ValueError, never another exception."""
    data = _keras_bytes()
    rng = np.random.default_rng(0)
    raised = 0
    for _ in range(400):
        b = bytearray(data)
        for i in rng.integers(0, len(b), size=2):
            b[i] = int(rng.integers(0, 256))
        try:
            _walk(bytes(b))
        except ValueError:
            raised += 1
    assert raised > 0


# ---------------------------------------------------------------- the API
def test_group_api_and_write_errors(tmp_path):
    path = str(tmp_path / "w.h5")
    with hdf5.File(path, "w") as f:
        f.create_dataset("a/b/c", data=np.ones(2, np.float32))
        f["a"].attrs["x"] = np.array(1.25)
        with pytest.raises(ValueError, match="already exists"):
            f.create_group("a/b")
        with pytest.raises(ValueError, match="int64"):
            f.create_dataset("i", data=np.arange(3))
        with pytest.raises(ValueError, match="str"):
            f.attrs["s"] = "text"
        with pytest.raises(ValueError, match="float"):
            f.attrs["f"] = 1.25
        with pytest.raises(ValueError, match="is a dataset"):
            f.create_group("a/b/c/d")
    f = hdf5.File(path)
    assert "a/b/c" in f and "a/x" not in f and "nope" not in f
    assert f["a"].attrs["x"] == 1.25 and f["a"].attrs["x"].dtype == \
        np.float64
    seen = []
    assert f.visititems(lambda n, o: seen.append(n)) is None
    assert seen == ["a", "a/b", "a/b/c"]
    assert f.visititems(lambda n, o: n if n == "a/b" else None) == "a/b"
    with pytest.raises(KeyError):
        f["a/zz"]
    big = hdf5.File(io.BytesIO(), "w")
    big.attrs["huge"] = np.zeros(9000, np.float64)
    with pytest.raises(ValueError, match="64 KiB"):
        big.tobytes()
    with h5py.File(path, "r") as h:
        assert h["a/b/c"][()].tolist() == [1.0, 1.0]
        assert h["a"].attrs["x"] == 1.25
