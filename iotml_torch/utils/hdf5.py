"""The HDF5 subset that Keras h5 files use, read and written with numpy
and ``struct`` alone (no ``h5py``, no C library).

The JAX package moves models as Keras ``.h5`` files through ``h5py``.
What ``h5py`` 3.x writes for such a file, with the library's default
(earliest) format bounds, is the HDF5 "version 0" layout:

- a version 0 superblock at the file's start, 8-byte offsets and
  lengths, addresses relative to its base address;
- version 1 object headers, with header continuation messages;
- old-style groups: a symbol table message names a version 1 B-tree of
  type 0 (``TREE``), whose leaves are symbol nodes (``SNOD``) of up to
  2K entries sorted by name, the names in a local heap (``HEAP``);
- dataspaces (messages version 1 and 2: scalar, simple, zero-length);
- datatypes of class 1 (IEEE float, either byte order) and class 3
  (fixed-length string, null-padded or null-terminated);
- attribute messages versions 1 to 3;
- data layout version 3, contiguous or compact.

The reader takes exactly that and raises ``ValueError`` naming anything
else (new-style and dense groups, dense attribute storage, chunked or
filtered data, variable-length strings, shared messages, other datatype
classes), so a file it does not understand is refused, never guessed at.
The writer writes the same version 0 layout, so one parser reads both
its own files and ``h5py``'s.

The API is the part of ``h5py`` that a Keras weight file needs:
``File(path or bytes)``, ``f["a/b"]``, ``.attrs``, ``.keys()``,
``visititems``; on a writable ``File(path or file object, "w")``,
``create_group`` and ``create_dataset``, serialized on ``close()``.
"""

from __future__ import annotations

import io
import math
import os
import struct
from typing import Callable, Dict, List, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
#: offsets and lengths this module writes (what h5py writes)
_O = _L = 8
#: the undefined address at 8-byte offsets
UNDEF = 0xFFFFFFFFFFFFFFFF
#: the library's "group leaf node K" and "group internal node K":
#: a symbol node holds 2K entries, a B-tree node 2K children
_LEAF_K, _INTERNAL_K = 4, 16
#: the local heap's "no free block" offset (H5HL_FREE_NULL)
_FREE_NULL = 1

_MSG_NAMES = {
    0x0002: "new-style group (link info message)",
    0x0006: "new-style group (link message)",
    0x0007: "external data storage",
    0x000A: "new-style group (group info message)",
    0x000B: "filtered data (filter pipeline message)",
    0x000F: "shared message table",
    0x0018: "object header continuation in a version 2 header",
}
#: messages that say nothing the reader needs: fill value (old, new),
#: object comment, modification time (old, new), B-tree K values, file
#: info, object reference count
_SKIPPED = {0x0000, 0x0004, 0x0005, 0x000D, 0x000E, 0x0012, 0x0013,
            0x0014, 0x0016}
#: messages the reader decodes: dataspace, datatype, data layout,
#: attribute, symbol table, attribute info
_HANDLED = {0x0001, 0x0003, 0x0008, 0x000C, 0x0011, 0x0015}
_CLASS_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time",
                3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enumerated", 9: "variable-length",
                10: "array"}
#: IEEE layouts by size: (sign bit, precision, exponent location, exponent
#: size, mantissa location, mantissa size, exponent bias)
_IEEE = {2: (15, 16, 10, 5, 0, 10, 15), 4: (31, 32, 23, 8, 0, 23, 127),
         8: (63, 64, 52, 11, 0, 52, 1023)}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ================================================================ reading
class _Reader:
    """One file's bytes, its superblock, and object-header decoding."""

    def __init__(self, buf: bytes):
        self.buf = bytes(buf)
        if self.buf[:len(SIGNATURE)] != SIGNATURE:
            raise ValueError("not an HDF5 file: no format signature at "
                             "offset 0")
        self._need(0, 24, "superblock")
        b = self.buf
        if b[8] != 0:
            raise ValueError(f"superblock version {b[8]} is not supported "
                             f"(version 0 is)")
        self.O, self.L = b[13], b[14]
        if self.O not in (2, 4, 8) or self.L not in (2, 4, 8):
            raise ValueError(f"superblock sizes of offsets {self.O} and "
                             f"lengths {self.L} are not 2, 4 or 8")
        self.undef = (1 << (8 * self.O)) - 1
        p = 24
        self._need(p, 4 * self.O + 2 * self.O + 24, "superblock")
        self.base = self.addr(p)
        eof = self.addr(p + 2 * self.O)
        if self.base == self.undef:
            raise ValueError("superblock base address is undefined")
        if self.base + eof > len(self.buf):
            raise ValueError(f"truncated file: the superblock's end of file "
                             f"is {self.base + eof} bytes, {len(self.buf)} "
                             f"are present")
        root_entry = p + 4 * self.O
        self.root = self.addr(root_entry + self.O)
        self._headers: Dict[int, tuple] = {}

    def _need(self, off: int, n: int, what: str) -> None:
        if off < 0 or n < 0 or off + n > len(self.buf):
            raise ValueError(f"truncated file: {what} needs bytes "
                             f"[{off}, {off + n}) of {len(self.buf)}")

    def uint(self, off: int, n: int) -> int:
        self._need(off, n, "a field")
        return int.from_bytes(self.buf[off:off + n], "little")

    def addr(self, off: int) -> int:
        return self.uint(off, self.O)

    def length(self, off: int) -> int:
        return self.uint(off, self.L)

    def at(self, address: int, what: str) -> int:
        """File position of a defined address."""
        if address == self.undef:
            raise ValueError(f"{what} has the undefined address")
        return self.base + address

    # ------------------------------------------------------- object headers
    def header(self, address: int) -> List[Tuple[int, bytes]]:
        """The (type, data) messages of the version 1 object header at
        ``address``, continuation blocks followed."""
        if address in self._headers:
            return self._headers[address]
        pos = self.at(address, "an object header")
        self._need(pos, 16, "an object header")
        b = self.buf
        if b[pos:pos + 4] == b"OHDR":
            raise ValueError("version 2 object header (OHDR) is not "
                             "supported")
        if b[pos] != 1:
            raise ValueError(f"unknown object header version {b[pos]}")
        n_msgs = self.uint(pos + 2, 2)
        blocks = [(pos + 16, self.uint(pos + 8, 4))]
        msgs: List[Tuple[int, bytes]] = []
        seen = 0
        while blocks and seen < n_msgs:
            start, size = blocks.pop(0)
            self._need(start, size, "an object header block")
            p, end = start, start + size
            while p + 8 <= end and seen < n_msgs:
                mtype, msize, flags = struct.unpack_from("<HHB", b, p)
                if p + 8 + msize > end:
                    raise ValueError(f"object header message 0x{mtype:04x} "
                                     f"runs past its block")
                data = b[p + 8:p + 8 + msize]
                p += 8 + msize
                seen += 1
                if flags & 0x02:
                    raise ValueError(f"shared object header message "
                                     f"0x{mtype:04x} is not supported")
                if mtype == 0x0010:
                    cont = self.at(self._addr_in(data, 0), "a continuation")
                    blocks.append((cont, self._len_in(data, self.O)))
                elif mtype in _MSG_NAMES:
                    raise ValueError(f"{_MSG_NAMES[mtype]} is not supported")
                elif mtype in _HANDLED:
                    msgs.append((mtype, data))
                elif mtype not in _SKIPPED:
                    raise ValueError(f"object header message type "
                                     f"0x{mtype:04x} is not supported")
        if seen < n_msgs:
            raise ValueError(f"object header at {address} holds {seen} of "
                             f"its {n_msgs} messages")
        self._headers[address] = msgs
        return msgs

    def _addr_in(self, data: bytes, off: int) -> int:
        if off + self.O > len(data):
            raise ValueError("truncated message: an address runs past it")
        return int.from_bytes(data[off:off + self.O], "little")

    def _len_in(self, data: bytes, off: int) -> int:
        if off + self.L > len(data):
            raise ValueError("truncated message: a length runs past it")
        return int.from_bytes(data[off:off + self.L], "little")

    def node(self, address: int):
        """The ``Group`` or ``Dataset`` whose header is at ``address``."""
        msgs = self.header(address)
        types = {t for t, _ in msgs}
        attrs = {}
        for t, data in msgs:
            if t == 0x000C:
                name, value = self.attribute(data)
                attrs[name] = value
            elif t == 0x0015 and self._addr_in(
                    data, 4 if data[1:2] and data[1] & 1 else 2) != self.undef:
                raise ValueError("dense attribute storage is not supported")
        if 0x0011 in types:
            data = next(d for t, d in msgs if t == 0x0011)
            members = self.symbol_table(self._addr_in(data, 0),
                                        self._addr_in(data, self.O))
            return Group(_attrs=attrs, _members=members, _reader=self)
        if 0x0008 in types:
            return Dataset(self.dataset_value(msgs), attrs)
        raise ValueError(f"object header at {address} has neither a symbol "
                         f"table nor a data layout")

    # ------------------------------------------------------------ messages
    def dataspace(self, data: bytes) -> Tuple[int, ...]:
        if len(data) < 4:
            raise ValueError("truncated dataspace message")
        version, rank, flags = data[0], data[1], data[2]
        if version == 1:
            off = 8
        elif version == 2:
            if data[3] == 2:
                raise ValueError("null dataspace is not supported")
            if data[3] not in (0, 1):
                raise ValueError(f"unknown dataspace type {data[3]}")
            off = 4
        else:
            raise ValueError(f"unknown dataspace message version {version}")
        if flags & 0x02:
            raise ValueError("dataspace permutation index is not supported")
        return tuple(self._len_in(data, off + i * self.L)
                     for i in range(rank))

    def datatype(self, data: bytes) -> np.dtype:
        if len(data) < 8:
            raise ValueError("truncated datatype message")
        cls = data[0] & 0x0F
        bits = data[1] | data[2] << 8 | data[3] << 16
        size = int.from_bytes(data[4:8], "little")
        if cls == 1:
            if len(data) < 20:
                raise ValueError("truncated floating-point datatype")
            if bits & 0x40:
                raise ValueError("VAX-order floating point is not supported")
            offset, precision = struct.unpack_from("<HH", data, 8)
            eloc, esize, mloc, msize = data[12:16]
            bias = int.from_bytes(data[16:20], "little")
            got = ((bits >> 8) & 0xFF, precision, eloc, esize, mloc, msize,
                   bias)
            if size not in _IEEE or got != _IEEE[size] or offset != 0 or \
                    (bits >> 4) & 0x03 != 2:
                raise ValueError(f"floating-point datatype of size {size} is "
                                 f"not an IEEE layout (sign, precision, "
                                 f"exponent, mantissa, bias = {got})")
            return np.dtype((">" if bits & 1 else "<") + f"f{size}")
        if cls == 3:
            if bits & 0x0F not in (0, 1):
                raise ValueError("space-padded strings are not supported")
            if not 0 < size <= len(self.buf):
                raise ValueError(f"string datatype of size {size} in a file "
                                 f"of {len(self.buf)} bytes")
            return np.dtype(f"S{size}")
        name = _CLASS_NAMES.get(cls, "unknown")
        raise ValueError(f"datatype class {cls} ({name}) is not supported")

    def attribute(self, data: bytes) -> Tuple[str, object]:
        if len(data) < 8:
            raise ValueError("truncated attribute message")
        version = data[0]
        name_size, dt_size, ds_size = struct.unpack_from("<HHH", data, 2)
        if version == 1:
            pad, p = _pad8, 8
        elif version in (2, 3):
            if data[1] & 0x03:
                raise ValueError("attribute with a shared datatype or "
                                 "dataspace is not supported")
            pad, p = (lambda n: n), (9 if version == 3 else 8)
        else:
            raise ValueError(f"unknown attribute message version {version}")
        name = data[p:p + name_size].split(b"\0", 1)[0].decode()
        p += pad(name_size)
        dtype = self.datatype(data[p:p + dt_size])
        p += pad(dt_size)
        shape = self.dataspace(data[p:p + ds_size])
        p += pad(ds_size)
        n = math.prod(shape) * dtype.itemsize
        if p + n > len(data):
            raise ValueError(f"truncated attribute {name!r}: {n} data bytes, "
                             f"{len(data) - p} present")
        value = _native(np.frombuffer(data, dtype, math.prod(shape), p)
                        .reshape(shape))
        return name, (value[()] if shape == () else value)

    def dataset_value(self, msgs) -> np.ndarray:
        by_type = {t: d for t, d in msgs}
        for t, what in ((0x0001, "dataspace"), (0x0003, "datatype")):
            if t not in by_type:
                raise ValueError(f"dataset object header has no {what}")
        shape = self.dataspace(by_type[0x0001])
        dtype = self.datatype(by_type[0x0003])
        layout = by_type[0x0008]
        if len(layout) < 2 or layout[0] != 3:
            raise ValueError(f"data layout message version "
                             f"{layout[0] if layout else None} is not "
                             f"supported (version 3 is)")
        n = math.prod(shape) * dtype.itemsize
        cls = layout[1]
        if cls == 0:
            size = int.from_bytes(layout[2:4], "little")
            raw = layout[4:4 + size]
            if len(raw) < size:
                raise ValueError("truncated compact data")
        elif cls == 1:
            address = self._addr_in(layout, 2)
            size = self._len_in(layout, 2 + self.O)
            if address == self.undef:
                if n:
                    raise ValueError("dataset storage is not allocated")
                raw = b""
            else:
                pos = self.at(address, "dataset storage")
                self._need(pos, size, "dataset storage")
                raw = self.buf[pos:pos + size]
        elif cls == 2:
            raise ValueError("chunked data storage is not supported")
        else:
            raise ValueError(f"data layout class {cls} is not supported")
        if len(raw) < n:
            raise ValueError(f"dataset storage holds {len(raw)} bytes, its "
                             f"shape {shape} needs {n}")
        return _native(np.frombuffer(raw, dtype, math.prod(shape))
                       .reshape(shape))

    # -------------------------------------------------------------- groups
    def symbol_table(self, btree: int, heap: int) -> Dict[str, int]:
        """name → object header address, in name order."""
        names = self._local_heap(heap)
        members: Dict[str, int] = {}
        self._btree(btree, names, members, set())
        return members

    def _local_heap(self, address: int) -> Callable[[int], str]:
        pos = self.at(address, "a local heap")
        self._need(pos, 8 + 2 * self.L + self.O, "a local heap")
        if self.buf[pos:pos + 4] != b"HEAP":
            raise ValueError(f"bad local heap signature at {address}")
        size = self.length(pos + 8)
        data_pos = self.at(self.addr(pos + 8 + 2 * self.L),
                           "a local heap's data")
        self._need(data_pos, size, "a local heap's data")
        data = self.buf[data_pos:data_pos + size]

        def name(off: int) -> str:
            if off >= size:
                raise ValueError(f"name offset {off} past the local heap's "
                                 f"{size} bytes")
            end = data.find(b"\0", off)
            if end < 0:
                raise ValueError("unterminated name in the local heap")
            return data[off:end].decode()

        return name

    def _btree(self, address: int, names, members: dict, seen: set) -> None:
        if address in seen:
            raise ValueError(f"B-tree cycle at {address}")
        seen.add(address)
        pos = self.at(address, "a B-tree node")
        self._need(pos, 8 + 2 * self.O, "a B-tree node")
        b = self.buf
        if b[pos:pos + 4] != b"TREE":
            raise ValueError(f"bad B-tree signature at {address}")
        if b[pos + 4] != 0:
            raise ValueError(f"B-tree node type {b[pos + 4]} in a group "
                             f"(type 0 expected)")
        level, used = b[pos + 5], self.uint(pos + 6, 2)
        p = pos + 8 + 2 * self.O + self.L  # past the siblings and key 0
        for _ in range(used):
            child = self.addr(p)
            p += self.O + self.L
            if level:
                self._btree(child, names, members, seen)
            else:
                self._symbol_node(child, names, members)

    def _symbol_node(self, address: int, names, members: dict) -> None:
        pos = self.at(address, "a symbol table node")
        self._need(pos, 8, "a symbol table node")
        if self.buf[pos:pos + 4] != b"SNOD":
            raise ValueError(f"bad symbol table node signature at {address}")
        n = self.uint(pos + 6, 2)
        entry = 2 * self.O + 24
        self._need(pos + 8, n * entry, "a symbol table node's entries")
        for i in range(n):
            e = pos + 8 + i * entry
            name = names(self.addr(e))
            if self.uint(e + 2 * self.O, 4) == 2:
                raise ValueError(f"soft link {name!r} is not supported")
            members[name] = self.addr(e + self.O)


def _native(a: np.ndarray) -> np.ndarray:
    """A writable copy in native byte order."""
    if a.dtype.kind == "f":
        return a.astype(a.dtype.newbyteorder("="))
    return a.copy()


# ================================================================ the API
class AttributeManager(dict):
    """``.attrs``: a dict of name → numpy value (a scalar string reads as
    ``np.bytes_``, an array as an ``ndarray``).  On a writable file a value
    set here is written at ``close()``: ``np.bytes_``/``bytes`` or an
    array of ``float16/32/64`` or fixed-length bytes."""

    def __setitem__(self, name: str, value) -> None:
        super().__setitem__(name, _attr_value(name, value))


class Dataset:
    """A dataset read whole: ``np.asarray(ds)``, ``.shape``, ``.dtype``."""

    def __init__(self, value: np.ndarray, attrs=None):
        self._value = value
        self.attrs = AttributeManager(attrs or {})

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._value.shape

    @property
    def dtype(self) -> np.dtype:
        return self._value.dtype

    def __array__(self, dtype=None, copy=None):
        return self._value.copy() if dtype is None else \
            self._value.astype(dtype)


class Group:
    """A group: ``g["a/b"]``, ``keys()``, ``visititems``, ``.attrs``; on a
    writable file ``create_group`` and ``create_dataset``."""

    def __init__(self, _attrs=None, _members=None, _reader=None):
        self.attrs = AttributeManager(_attrs or {})
        #: name → object-header address (read) or node (written or loaded)
        self._members: Dict[str, object] = dict(_members or {})
        self._reader = _reader

    def _child(self, name: str):
        node = self._members[name]
        if isinstance(node, int):
            node = self._reader.node(node)
            self._members[name] = node
        return node

    def __getitem__(self, path: str):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group):
                raise KeyError(f"{path!r}: {part!r} is under a dataset")
            if part not in node._members:
                raise KeyError(f"no member {path!r}")
            node = node._child(part)
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def keys(self) -> List[str]:
        return sorted(self._members, key=str.encode)

    def visititems(self, func):
        """Call ``func(name, obj)`` on every member below, names relative
        to this group, in name order, depth first; a non-None return
        stops the walk and is returned (``h5py``'s contract)."""
        for name in self.keys():
            obj = self._child(name)
            out = func(name, obj)
            if out is not None:
                return out
            if isinstance(obj, Group):
                out = obj.visititems(
                    lambda sub, o, _n=name: func(f"{_n}/{sub}", o))
                if out is not None:
                    return out
        return None

    # ------------------------------------------------------------- writing
    def _parent_of(self, path: str) -> Tuple["Group", str]:
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError("empty name")
        node = self
        for part in parts[:-1]:
            if part not in node._members:
                node._members[part] = Group()
            node = node._child(part)
            if not isinstance(node, Group):
                raise ValueError(f"{path!r}: {part!r} is a dataset")
        if parts[-1] in node._members:
            raise ValueError(f"name {path!r} already exists")
        return node, parts[-1]

    def create_group(self, path: str) -> "Group":
        parent, name = self._parent_of(path)
        g = Group()
        parent._members[name] = g
        return g

    def create_dataset(self, path: str, data) -> Dataset:
        parent, name = self._parent_of(path)
        value = _check_array(path, np.asarray(data))
        ds = Dataset(value.copy())
        parent._members[name] = ds
        return ds


class File(Group):
    """``File(path or bytes)`` reads; ``File(path or file object, "w")``
    writes on ``close()`` (or at the end of a ``with``)."""

    def __init__(self, source: Union[str, os.PathLike, bytes, bytearray,
                                     memoryview, io.IOBase],
                 mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError(f"mode must be 'r' or 'w', not {mode!r}")
        self.mode = mode
        self._sink = None
        if mode == "w":
            super().__init__()
            self._sink = source
            return
        if isinstance(source, (bytes, bytearray, memoryview)):
            buf = bytes(source)
        else:
            with open(source, "rb") as fh:
                buf = fh.read()
        reader = _Reader(buf)
        root = reader.node(reader.root)
        if not isinstance(root, Group):
            raise ValueError("the root object is not a group")
        super().__init__(_attrs=root.attrs, _members=root._members,
                         _reader=reader)

    def tobytes(self) -> bytes:
        """The file as bytes (a writable file's current contents)."""
        return _Writer().file(self)

    def close(self) -> None:
        if self._sink is None:
            return
        data, sink, self._sink = self.tobytes(), self._sink, None
        if hasattr(sink, "write"):
            sink.write(data)
        else:
            with open(sink, "wb") as fh:
                fh.write(data)

    def __enter__(self) -> "File":
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            self.close()
        self._sink = None


def _check_array(name: str, a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "f" and a.dtype.itemsize in _IEEE:
        return a
    if a.dtype.kind == "S":
        return a if a.dtype.itemsize else a.astype("S1")
    raise ValueError(f"{name!r}: dtype {a.dtype} is not supported (float16/"
                     f"32/64 or fixed-length bytes)")


def _attr_value(name: str, value):
    if isinstance(value, (bytes, np.bytes_)):
        return np.bytes_(value)
    if isinstance(value, np.ndarray):
        return _check_array(name, value).copy()
    raise ValueError(f"attribute {name!r}: {type(value).__name__} is not "
                     f"supported (bytes, or a float or bytes array)")


# ================================================================ writing
def _datatype_msg(dtype: np.dtype) -> bytes:
    if dtype.kind == "f":
        sign, prec, eloc, esize, mloc, msize, bias = _IEEE[dtype.itemsize]
        order = 1 if dtype.byteorder == ">" or (
            dtype.byteorder == "=" and not np.little_endian) else 0
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20 | order, sign, 0,
                           dtype.itemsize, 0, prec, eloc, esize, mloc, msize,
                           bias)
    # fixed-length string, null-padded, ASCII (what h5py writes for bytes)
    return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, max(1, dtype.itemsize))


def _dataspace_msg(shape: Tuple[int, ...]) -> bytes:
    # version 1; a simple dataspace carries its maximum dims (= dims), as
    # the library writes a fixed-size one
    flags = 1 if shape else 0
    out = struct.pack("<BBB5x", 1, len(shape), flags)
    out += b"".join(struct.pack("<Q", d) for d in shape)
    if shape:
        out += b"".join(struct.pack("<Q", d) for d in shape)
    return out


def _attribute_msg(name: str, value) -> bytes:
    a = np.asarray(value)
    raw_name = name.encode() + b"\0"
    dt, ds = _datatype_msg(a.dtype), _dataspace_msg(a.shape)
    body = struct.pack("<BxHHH", 1, len(raw_name), len(dt), len(ds))
    for part in (raw_name, dt, ds):
        body += part + b"\0" * (_pad8(len(part)) - len(part))
    return body + np.ascontiguousarray(a).tobytes()


class _Writer:
    """Serializes a written ``File`` bottom up: every object lands before
    the object that points at it, the superblock last at offset 0."""

    def __init__(self):
        self.out = bytearray(96)  # the superblock's room

    def _put(self, data: bytes) -> int:
        addr = len(self.out)
        self.out += data
        self.out += b"\0" * (_pad8(len(self.out)) - len(self.out))
        return addr

    def _header(self, msgs: List[Tuple[int, int, bytes]]) -> int:
        body = b""
        for mtype, flags, data in msgs:
            size = _pad8(len(data))
            if size > 0xFFFF:
                raise ValueError(f"object header message 0x{mtype:04x} of "
                                 f"{len(data)} bytes is over the 64 KiB a "
                                 f"compact message can hold")
            body += struct.pack("<HHB3x", mtype, size, flags) + data + \
                b"\0" * (size - len(data))
        return self._put(struct.pack("<BBHII4x", 1, 0, len(msgs), 1,
                                     len(body)) + body)

    def _attr_msgs(self, attrs: dict) -> List[Tuple[int, int, bytes]]:
        return [(0x000C, 0, _attribute_msg(k, v)) for k, v in attrs.items()]

    def _dataset(self, ds: Dataset) -> int:
        a = ds._value
        raw = np.ascontiguousarray(a).tobytes()
        addr = self._put(raw) if raw else UNDEF
        # fill value message version 2: allocation late, fill written if
        # set, the default fill value (defined, of size 0), as h5py writes
        fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)
        layout = struct.pack("<BBQQ", 3, 1, addr, len(raw))
        return self._header([(0x0001, 0, _dataspace_msg(a.shape)),
                             (0x0003, 1, _datatype_msg(a.dtype)),
                             (0x0005, 1, fill), (0x0008, 0, layout)]
                            + self._attr_msgs(ds.attrs))

    def _group(self, g: Group) -> Tuple[int, int, int]:
        """→ (object header, B-tree, local heap) addresses."""
        names = g.keys()
        children = {}
        for name in names:
            node = g._child(name)
            children[name] = (self._group(node) if isinstance(node, Group)
                              else (self._dataset(node), None, None))
        # local heap: "" at offset 0, each name null-terminated and padded
        # to 8, then one free block (the library's layout)
        heap_data, offsets = bytearray(8), {}
        for name in names:
            offsets[name] = len(heap_data)
            raw = name.encode() + b"\0"
            heap_data += raw + b"\0" * (_pad8(len(raw)) - len(raw))
        free_at, free_size = len(heap_data), 2 * _L
        heap_data += struct.pack("<QQ", _FREE_NULL, free_size)
        heap_data_addr = self._put(bytes(heap_data))
        heap = self._put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data),
                                               free_at, heap_data_addr))
        # symbol nodes of up to 2K entries, name order
        per = 2 * _LEAF_K
        chunks = [names[i:i + per] for i in range(0, len(names), per)]
        if len(chunks) > 2 * _INTERNAL_K:
            raise ValueError(f"a group of {len(names)} members is over the "
                             f"{2 * _INTERNAL_K * per} one B-tree leaf holds")
        snods = []
        for chunk in chunks:
            node = b"SNOD" + struct.pack("<BxH", 1, len(chunk))
            for name in chunk:
                header, btree, sub_heap = children[name]
                if btree is None:
                    node += struct.pack("<QQII16x", offsets[name], header,
                                        0, 0)
                else:
                    node += struct.pack("<QQIIQQ", offsets[name], header, 1,
                                        0, btree, sub_heap)
            node += b"\0" * (8 + per * 40 - len(node))
            snods.append(self._put(node))
        # one B-tree leaf: key 0 is "" (heap offset 0), key i the last name
        # of child i - 1; room for 2K children, as the library reads it
        tree = b"TREE" + struct.pack("<BBHQQQ", 0, 0, len(snods), UNDEF,
                                     UNDEF, 0)
        for snod, chunk in zip(snods, chunks):
            tree += struct.pack("<QQ", snod, offsets[chunk[-1]])
        size = 8 + 2 * _O + 2 * _INTERNAL_K * _O + (2 * _INTERNAL_K + 1) * _L
        tree += b"\0" * (size - len(tree))
        btree = self._put(tree)
        stab = struct.pack("<QQ", btree, heap)
        header = self._header([(0x0011, 0, stab)] + self._attr_msgs(g.attrs))
        return header, btree, heap

    def file(self, f: File) -> bytes:
        root, btree, heap = self._group(f)
        eof = len(self.out)
        sb = SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, _O, _L, 0,
                                     _LEAF_K, _INTERNAL_K, 0)
        sb += struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
        sb += struct.pack("<QQIIQQ", 0, root, 1, 0, btree, heap)
        self.out[:96] = sb
        return bytes(self.out)
