"""HDF5, the subset that h5py writes for a few contiguous datasets in the
root group, read and written in plain Python.

The JAX package saves its PLDA model with h5py
(wespeaker_tpu/backend/plda.py::TwoCovPLDA.save): six datasets in the
root group, `mu`, `transform`, `psi` and `offset` as little-endian f64
arrays and `normalize_length`, `subtract_train_set_mean` as scalar
little-endian int64. With h5py's defaults (libver "earliest") that file
is:

  - superblock version 0, 8-byte offsets and lengths;
  - the root group as a symbol table: a version-1 B-tree node ("TREE",
    group nodes) over symbol-table nodes ("SNOD", names sorted by their
    bytes) and a local heap ("HEAP") holding the names;
  - a version-1 object header per dataset, with a dataspace message
    (version 1, simple or scalar), a datatype message (class 1, IEEE f64,
    or class 0, signed int64, both little-endian), a fill-value message
    and, where times are tracked, a modification-time message (both read
    and skipped), and a layout message (version 3, contiguous).

`read_datasets` returns `{name: ndarray}` (a scalar as a 0-d array) in
the root group's order; `write_datasets` writes that structure, which
h5py reads back to the bit. It is not h5py's byte layout (h5py pads its
headers and places blocks by its allocator), only its structure. Anything
outside the subset raises ValueError naming what it met: another
superblock (libver "v108"/"latest"), a version-2 object header, a
chunked, compact or filtered (compressed) dataset, another datatype, a
nested group, an attribute, a shared message. Nothing is guessed at.
"""

import struct
from typing import Dict, List, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
LEAF_K, INTERNAL_K = 4, 16      # h5py's defaults: SNOD holds 2 x 4 names
ENTRY_SIZE = 40                 # a symbol-table entry with 8-byte offsets
SNOD_SIZE = 8 + 2 * LEAF_K * ENTRY_SIZE
TREE_SIZE = 24 + (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8
HEAP_FREE_NULL = 1              # the local heap's "no free block"

MSG_NIL, MSG_DATASPACE, MSG_DATATYPE = 0x00, 0x01, 0x03
MSG_FILL_OLD, MSG_FILL, MSG_LAYOUT = 0x04, 0x05, 0x08
MSG_MTIME_OLD, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x0E, 0x10, 0x11
MSG_MTIME = 0x12
_SKIPPED = {MSG_NIL, MSG_FILL_OLD, MSG_FILL, MSG_MTIME_OLD, MSG_MTIME}
_MSG_NAMES = {0x02: "link-info message (a new-style group)",
              0x06: "link message (a new-style group)",
              0x07: "external data files",
              0x0A: "group-info message (a new-style group)",
              0x0B: "filter pipeline (a compressed or filtered dataset)",
              0x0C: "attribute", 0x0D: "object comment",
              0x0F: "shared message table", 0x15: "attribute info",
              0x16: "object reference count"}
_CLASS_NAMES = ("fixed-point", "floating-point", "time", "string",
                "bitfield", "opaque", "compound", "reference", "enumerated",
                "variable-length", "array")
_LAYOUT_NAMES = {0: "compact", 1: "contiguous", 2: "chunked", 3: "virtual"}

# datatype messages: (class and version, class bit fields, size,
# properties), as h5py writes them for '<f8' and '<i8'
_F8 = (bytes([0x11, 0x20, 0x3F, 0x00]) + struct.pack("<I", 8)
       + struct.pack("<HHBBBBI", 0, 64, 52, 11, 0, 52, 1023))
_I8 = (bytes([0x10, 0x08, 0x00, 0x00]) + struct.pack("<I", 8)
       + struct.pack("<HH", 0, 64))
_DTYPES = {_F8: np.dtype("<f8"), _I8: np.dtype("<i8")}


class _Reader:
    def __init__(self, buf: bytes, path: str):
        self.buf, self.path = buf, path

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what}; the reader takes h5py's "
                         "default layout of contiguous f64/int64 datasets "
                         "in the root group only")

    def u(self, fmt: str, at: int):
        return struct.unpack_from("<" + fmt, self.buf, at)

    def name(self, heap_data: int, offset: int) -> str:
        end = self.buf.index(b"\0", heap_data + offset)
        return self.buf[heap_data + offset:end].decode()

    def superblock(self) -> Tuple[int, int]:
        """-> (B-tree address, heap data address) of the root group."""
        if self.buf[:8] != SIGNATURE:
            self.fail("no HDF5 signature at byte 0")
        version = self.buf[8]
        if version != 0:
            self.fail(f"superblock version {version} (h5py's "
                      "libver='v108' or 'latest')")
        if self.buf[13] != 8 or self.buf[14] != 8:
            self.fail(f"{self.buf[13]}-byte offsets, {self.buf[14]}-byte "
                      "lengths")
        if self.u("Q", 24)[0] != 0:
            self.fail("a user block (base address not 0)")
        root = self.u("Q", 56 + 8)[0]
        for kind, data in self.messages(root, "the root group"):
            if kind == MSG_SYMBOL_TABLE:
                btree, heap = struct.unpack_from("<QQ", data)
                return btree, self.heap(heap)
        self.fail("the root group has no symbol-table message")

    def heap(self, at: int) -> int:
        if self.buf[at:at + 4] != b"HEAP" or self.buf[at + 4] != 0:
            self.fail(f"no version-0 local heap at {at}")
        return self.u("Q", at + 24)[0]

    def entries(self, at: int, heap_data: int) -> List[Tuple[str, int]]:
        """(name, object header address) of every entry under the group
        B-tree node at `at`, in key order."""
        if self.buf[at:at + 4] != b"TREE" or self.buf[at + 4] != 0:
            self.fail(f"no group B-tree node at {at}")
        level, used = self.buf[at + 5], self.u("H", at + 6)[0]
        out = []
        for i in range(used):
            child = self.u("Q", at + 24 + 8 + 16 * i)[0]
            if level > 0:
                out += self.entries(child, heap_data)
                continue
            if self.buf[child:child + 4] != b"SNOD":
                self.fail(f"no symbol-table node at {child}")
            for j in range(self.u("H", child + 6)[0]):
                e = child + 8 + ENTRY_SIZE * j
                name_off, header, cache = self.u("QQI", e)
                name = self.name(heap_data, name_off)
                if cache == 1:
                    self.fail(f"nested group {name!r}")
                if cache != 0:
                    self.fail(f"{name!r} is a symbolic link")
                out.append((name, header))
        return out

    def messages(self, at: int, what: str):
        """(type, data) of each message of the version-1 object header at
        `at`, continuation blocks followed."""
        if self.buf[at:at + 4] == b"OHDR":
            self.fail(f"{what}: a version-2 object header (h5py's "
                      "libver='v108'/'latest' or track_order)")
        if self.buf[at] != 1:
            self.fail(f"{what}: object header version {self.buf[at]}")
        blocks = [(at + 16, self.u("I", at + 8)[0])]
        while blocks:
            start, size = blocks.pop(0)
            p = start
            while p + 8 <= start + size:
                kind, length, flags = self.u("HHB", p)
                data = self.buf[p + 8:p + 8 + length]
                p += 8 + length
                if flags & 0x02:
                    self.fail(f"{what}: a shared message (type {kind:#x})")
                if kind == MSG_CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                elif kind not in _SKIPPED:
                    yield kind, data

    def dataset(self, name: str, at: int) -> np.ndarray:
        what = f"dataset {name!r}"
        shape = dtype = where = None
        for kind, d in self.messages(at, what):
            if kind == MSG_DATASPACE:
                if d[0] != 1:
                    self.fail(f"{what}: dataspace message version {d[0]}")
                shape = struct.unpack_from(f"<{d[1]}Q", d, 8)
            elif kind == MSG_DATATYPE:
                dtype = _DTYPES.get(bytes(d[:len(_F8)] if d[0] & 0x0F == 1
                                          else d[:len(_I8)]))
                if dtype is None:
                    self.fail(f"{what}: datatype {_describe(d)}")
            elif kind == MSG_LAYOUT:
                if d[0] != 3:
                    self.fail(f"{what}: layout message version {d[0]}")
                if d[1] != 1:
                    self.fail(f"{what}: "
                              f"{_LAYOUT_NAMES.get(d[1], d[1])} layout")
                where = struct.unpack_from("<QQ", d, 2)
            elif kind == MSG_SYMBOL_TABLE:
                self.fail(f"nested group {name!r}")
            else:
                self.fail(f"{what}: "
                          f"{_MSG_NAMES.get(kind, f'message type {kind:#x}')}")
        if shape is None or dtype is None or where is None:
            self.fail(f"{what}: no dataspace, datatype or layout message")
        address, size = where
        count = int(np.prod(shape, dtype=np.int64))
        if count == 0 and address == UNDEF and size == 0:
            return np.zeros(shape, dtype)   # h5py allocates no storage
        if address == UNDEF:
            self.fail(f"{what}: no data written (no storage allocated)")
        if size != count * dtype.itemsize or address + size > len(self.buf):
            self.fail(f"{what}: {size} bytes at {address:#x} for "
                      f"{count} x {dtype}")
        return np.frombuffer(self.buf, dtype, count, address).reshape(
            shape).copy()


def _describe(d: bytes) -> str:
    cls, size = d[0] & 0x0F, struct.unpack_from("<I", d, 4)[0]
    name = _CLASS_NAMES[cls] if cls < len(_CLASS_NAMES) else f"class {cls}"
    order = "big-endian " if cls in (0, 1) and d[1] & 0x01 else ""
    signed = ("unsigned " if cls == 0 and not d[1] & 0x08 else "")
    return f"{order}{signed}{name} of {size} bytes (version {d[0] >> 4})"


def read_datasets(path: str) -> Dict[str, np.ndarray]:
    """The root group's datasets, by name in the group's (sorted) order;
    a scalar comes back as a 0-d array."""
    with open(path, "rb") as f:
        reader = _Reader(f.read(), path)
    btree, heap_data = reader.superblock()
    return {name: reader.dataset(name, at)
            for name, at in reader.entries(btree, heap_data)}


# ---------------------------------------------------------------- writer

def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(kind: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", kind, len(data), flags) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _entry(name_off: int, header: int, cache: int = 0,
           scratch: bytes = b"") -> bytes:
    return struct.pack("<QQI4x", name_off, header, cache) \
        + scratch.ljust(16, b"\0")


def _dataset_header(arr: np.ndarray, address: int) -> bytes:
    dims = struct.pack(f"<{arr.ndim}Q", *arr.shape)
    space = struct.pack("<BBB5x", 1, arr.ndim, 1 if arr.ndim else 0) \
        + dims + dims
    dtype = _F8 if arr.dtype == np.float64 else _I8
    fill = bytes([2, 2, 2, 1]) + struct.pack("<I", 0)
    layout = struct.pack("<BBQQ", 3, 1, address if arr.size else UNDEF,
                         arr.nbytes)
    return _object_header([_message(MSG_DATASPACE, space),
                           _message(MSG_DATATYPE, dtype, flags=1),
                           _message(MSG_FILL, fill, flags=1),
                           _message(MSG_LAYOUT, layout)])


def write_datasets(path: str, datasets: Dict[str, object]):
    """The datasets, each f64 or int64 (a Python int or float becomes a
    scalar), as h5py's default layout lays out a root group of contiguous
    datasets; at most 2 x 16 symbol-table nodes of 8 names each."""
    arrays = {}
    for name, value in datasets.items():
        arr = np.asarray(value)
        if arr.dtype not in (np.float64, np.int64):
            raise ValueError(f"dataset {name!r}: dtype {arr.dtype}; the "
                             "writer takes f64 and int64")
        if not name or "/" in name or "\0" in name:
            raise ValueError(f"dataset name {name!r}")
        arrays[name] = arr.astype(arr.dtype.newbyteorder("<"), order="C")
    names = sorted(arrays, key=str.encode)
    groups = [names[i:i + 2 * LEAF_K]
              for i in range(0, len(names), 2 * LEAF_K)]
    if len(groups) > 2 * INTERNAL_K:
        raise ValueError(f"{len(names)} datasets; the writer takes at most "
                         f"{4 * LEAF_K * INTERNAL_K}")

    heap = bytearray(8)                 # offset 0: the root's empty name
    name_off = {}
    for name in arrays:
        name_off[name] = len(heap)
        heap += _pad8(name.encode() + b"\0")
    root_header = 96
    btree = root_header + 16 + 8 + 16
    heap_header = btree + TREE_SIZE
    heap_data = heap_header + 32
    snods = heap_data + len(heap)
    headers = {}
    p = snods + SNOD_SIZE * len(groups)
    for name in names:
        headers[name] = p
        p += len(_dataset_header(arrays[name], 0))
    data = {}
    for name in arrays:
        data[name] = p
        p += -(-arrays[name].nbytes // 8) * 8
    eof = p

    out = bytearray(eof)
    scratch = struct.pack("<QQ", btree, heap_header)
    out[0:96] = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                 + struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
                 + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
                 + _entry(0, root_header, 1, scratch))
    out[root_header:btree] = _object_header(
        [_message(MSG_SYMBOL_TABLE, scratch)])
    node = bytearray(b"TREE" + struct.pack("<BBHQQ", 0, 0, len(groups),
                                           UNDEF, UNDEF))
    node += struct.pack("<Q", 0)
    for i, group in enumerate(groups):
        node += struct.pack("<QQ", snods + SNOD_SIZE * i,
                            name_off[group[-1]])
    out[btree:btree + len(node)] = node
    out[heap_header:heap_data] = b"HEAP" + struct.pack(
        "<B3xQQQ", 0, len(heap), HEAP_FREE_NULL, heap_data)
    out[heap_data:snods] = heap
    for i, group in enumerate(groups):
        at = snods + SNOD_SIZE * i
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(group)) + b"".join(
            _entry(name_off[n], headers[n]) for n in group)
        out[at:at + len(snod)] = snod
    for name in names:
        h = _dataset_header(arrays[name], data[name])
        out[headers[name]:headers[name] + len(h)] = h
        out[data[name]:data[name] + arrays[name].nbytes] = \
            arrays[name].tobytes()
    with open(path, "wb") as f:
        f.write(out)
