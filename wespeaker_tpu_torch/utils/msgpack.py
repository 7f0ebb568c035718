"""MessagePack, the subset that flax's checkpoints use, read and written
in plain Python.

The JAX package saves its checkpoints with flax.serialization
(wespeaker_tpu/utils/checkpoint.py::save_checkpoint): the variable tree
is passed through `jax.tree_util.tree_map(np.asarray, ...)` and packed by
`msgpack.packb(tree, default=_msgpack_ext_pack, strict_types=True)`.
This module reads and writes those files without the `msgpack` package:

  - maps, arrays, str, bin, int, float64, bool and nil, at every length
    encoding; the writer always picks the shortest one, as msgpack does;
  - ext type 1, an ndarray: the payload is itself msgpack, the array
    `(shape, dtype name, C-order bytes)`; ext 3, a numpy scalar in the
    same form; ext 2, a complex number (read only);
  - arrays larger than MAX_CHUNK_SIZE bytes are stored as the map
    `{"__msgpack_chunked_array__": True, "shape": {"0": ...},
    "chunks": {"0": ...}}` and joined back on read (flax's `_chunk`,
    `_unchunk`).

`serialize` gives flax's bytes exactly: tree_map rebuilds every dict with
its keys sorted, so the writer sorts keys at every level; the chunked
maps are built after that pass, so their keys keep flax's order. A
`bfloat16` leaf, a dtype numpy lacks, is read as uint16 and returned as
a torch.bfloat16 tensor; a torch tensor is written as the array of its
dtype (bfloat16 by that name). Every other leaf is read as a read-only
numpy array over the file's bytes, as flax reads it.
"""

import struct
from typing import Any, Dict

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


# ---------------------------------------------------------------- writer

def _head(n: int, fix_base, fix_max, c8, c16, c32) -> bytes:
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    if c8 is not None and n <= 0xff:
        return bytes([c8, n])
    if n <= 0xffff:
        return struct.pack(">BH", c16, n)
    if n <= 0xffffffff:
        return struct.pack(">BI", c32, n)
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -0x20 <= v < 0:
        return struct.pack(">b", v)
    if 0x80 <= v <= 0xff:
        return struct.pack(">BB", 0xcc, v)
    if -0x80 <= v < 0:
        return struct.pack(">Bb", 0xd0, v)
    if 0xff < v <= 0xffff:
        return struct.pack(">BH", 0xcd, v)
    if -0x8000 <= v < -0x80:
        return struct.pack(">Bh", 0xd1, v)
    if 0xffff < v <= 0xffffffff:
        return struct.pack(">BI", 0xce, v)
    if -0x80000000 <= v < -0x8000:
        return struct.pack(">Bi", 0xd2, v)
    if 0xffffffff < v <= 0xffffffffffffffff:
        return struct.pack(">BQ", 0xcf, v)
    if -0x8000000000000000 <= v < -0x80000000:
        return struct.pack(">Bq", 0xd3, v)
    raise OverflowError(f"integer {v} does not fit msgpack")


def _array_payload(arr) -> bytes:
    """flax's _ndarray_to_bytes: msgpack of (shape, dtype name, bytes)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().contiguous()
        if arr.dtype == torch.bfloat16:
            return _packb((tuple(arr.shape), "bfloat16",
                           arr.view(torch.uint16).numpy().tobytes()))
        arr = arr.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return _packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    if n in _FIXEXT:
        return bytes([_FIXEXT[n], code]) + payload
    return _head(n, None, 0, 0xc7, 0xc8, 0xc9) + bytes([code]) + payload


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        out.append(_pack_int(obj))
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xcb, obj))
    elif type(obj) is str:
        b = obj.encode("utf-8")
        out.append(_head(len(b), 0xa0, 31, 0xd9, 0xda, 0xdb))
        out.append(b)
    elif type(obj) in (bytes, bytearray, memoryview):
        b = bytes(obj)
        out.append(_head(len(b), None, 0, 0xc4, 0xc5, 0xc6))
        out.append(b)
    elif type(obj) in (list, tuple):
        out.append(_head(len(obj), 0x90, 15, None, 0xdc, 0xdd))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 15, None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        out.append(_pack_ext(EXT_NDARRAY, _array_payload(obj)))
    elif isinstance(obj, np.generic):
        out.append(_pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(obj))))
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _packb(obj) -> bytes:
    out = []
    _pack(obj, out)
    return b"".join(out)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(arr) -> Dict[str, Any]:
    """flax's _chunk: the flat array in MAX_CHUNK_SIZE pieces."""
    itemsize = (arr.element_size() if isinstance(arr, torch.Tensor)
                else arr.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _canonical(tree):
    """The tree as flax packs it: dicts rebuilt with sorted keys, leaves
    as arrays, arrays over MAX_CHUNK_SIZE bytes chunked."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            v = _canonical(tree[k])
            if (isinstance(v, (np.ndarray, torch.Tensor))
                    and _nbytes(v) > MAX_CHUNK_SIZE):
                v = _chunk(v)
            out[k] = v
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_canonical(v) for v in tree)
    if tree is None or isinstance(tree, torch.Tensor):
        return tree
    return np.asarray(tree)


def serialize(tree) -> bytes:
    """The bytes that the JAX package's save_checkpoint writes for `tree`
    (nested dicts of numpy arrays, torch tensors or scalars)."""
    tree = _canonical(tree)
    if (isinstance(tree, (np.ndarray, torch.Tensor))
            and _nbytes(tree) > MAX_CHUNK_SIZE):
        tree = _chunk(tree)
    return _packb(tree)


# ---------------------------------------------------------------- reader

class _Reader:
    def __init__(self, data, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = self.take(n)
        return bytes(b) if self.raw else str(b, "utf-8")

    def array(self, n: int):
        return [self.read() for _ in range(n)]

    def map_(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def read(self):
        c = self.take(1)[0]
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map_(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return self.array(c & 0x0f)
        if 0xa0 <= c <= 0xbf:
            return self.str_(c & 0x1f)
        if c == 0xc0:
            return None
        if c in (0xc2, 0xc3):
            return c == 0xc3
        if c in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.unpack(">" + "BHI"[c - 0xc4])))
        if c in (0xc7, 0xc8, 0xc9):
            return self.ext(self.unpack(">" + "BHI"[c - 0xc7]))
        if c == 0xca:
            return self.unpack(">f")
        if c == 0xcb:
            return self.unpack(">d")
        if 0xcc <= c <= 0xcf:
            return self.unpack(">" + "BHIQ"[c - 0xcc])
        if 0xd0 <= c <= 0xd3:
            return self.unpack(">" + "bhiq"[c - 0xd0])
        if 0xd4 <= c <= 0xd8:
            return self.ext(1 << (c - 0xd4))
        if c in (0xd9, 0xda, 0xdb):
            return self.str_(self.unpack(">" + "BHI"[c - 0xd9]))
        if c in (0xdc, 0xdd):
            return self.array(self.unpack(">" + "HI"[c - 0xdc]))
        if c in (0xde, 0xdf):
            return self.map_(self.unpack(">" + "HI"[c - 0xde]))
        raise ValueError(f"msgpack type byte {c:#x} is not supported")


def _unpackb(data, raw: bool = False):
    r = _Reader(data, raw)
    obj = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         "object")
    return obj


def _array_from_payload(payload):
    """flax's _ndarray_from_bytes; bfloat16 as a torch tensor."""
    shape, name, buf = _unpackb(payload, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        arr = np.frombuffer(buf, np.uint16).reshape(shape, order="C")
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, payload):
    if code == EXT_NDARRAY:
        return _array_from_payload(payload)
    if code == EXT_NPSCALAR:
        arr = _array_from_payload(payload)
        return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
    if code == EXT_COMPLEX:
        re_, im = _unpackb(payload)
        return complex(re_, im)
    raise ValueError(f"msgpack ext type {code} is not supported")


def _join(d: Dict[str, Any]):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _join(tree)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data) -> Any:
    """The tree of flax msgpack bytes, as flax.serialization.msgpack_restore
    gives it (chunked arrays joined)."""
    return _unchunk(_unpackb(data))


def is_msgpack_map(head: bytes) -> bool:
    """Whether a file starting with `head` starts with a msgpack map."""
    return bool(head) and (0x80 <= head[0] <= 0x8f or head[0] in (0xde,
                                                                  0xdf))
