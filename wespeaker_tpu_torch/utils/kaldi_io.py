"""Kaldi binary ark/scp vector and matrix I/O in numpy.

A copy of wespeaker_tpu/utils/kaldi_io.py, so the port reads and writes
the same files: embeddings and features as kaldi binary ark/scp pairs, as
the upstream writes them through kaldiio (wespeaker/bin/extract.py:110,
score.py). Little-endian; the '\\0B' binary marker; 'FV'/'FM' (and, to
read, 'DV'/'DM') vector and matrix headers with \\x04-prefixed int32
dims. The arks are byte-identical to the JAX package's.
"""

import os
import struct
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np


def _write_int32(f, v):
    f.write(b"\x04" + struct.pack("<i", v))


def _read_int32(f):
    sz = f.read(1)
    assert sz == b"\x04", sz
    return struct.unpack("<i", f.read(4))[0]


def write_vec_ark_scp(path_prefix: str,
                      items: Iterator[Tuple[str, np.ndarray]]):
    """Write float32 vectors to `<prefix>.ark` + `<prefix>.scp`. Creates the
    parent directory (the reference's validate_path does, utils.py:72-77)."""
    ark_path = path_prefix + ".ark"
    scp_path = path_prefix + ".scp"
    parent = os.path.dirname(os.path.abspath(ark_path))
    os.makedirs(parent, exist_ok=True)
    abs_ark = os.path.abspath(ark_path)
    with open(ark_path, "wb") as ark, open(scp_path, "w") as scp:
        for key, vec in items:
            vec = np.asarray(vec, np.float32).reshape(-1)
            ark.write(key.encode() + b" ")
            offset = ark.tell()
            ark.write(b"\x00BFV ")
            _write_int32(ark, vec.shape[0])
            ark.write(vec.tobytes())
            scp.write(f"{key} {abs_ark}:{offset}\n")
    return ark_path, scp_path


def write_mat_ark_scp(path_prefix: str,
                      items: Iterator[Tuple[str, np.ndarray]]):
    """Write float32 matrices (T, F) to `<prefix>.ark` + `<prefix>.scp` —
    the kaldi 'FM' binary format the feat data_type consumes
    (data/pipeline.py::parse_feat; reference processor.py parse_feat)."""
    ark_path = path_prefix + ".ark"
    scp_path = path_prefix + ".scp"
    parent = os.path.dirname(os.path.abspath(ark_path))
    os.makedirs(parent, exist_ok=True)
    abs_ark = os.path.abspath(ark_path)
    with open(ark_path, "wb") as ark, open(scp_path, "w") as scp:
        for key, mat in items:
            mat = np.ascontiguousarray(np.asarray(mat, np.float32))
            assert mat.ndim == 2, (key, mat.shape)
            ark.write(key.encode() + b" ")
            offset = ark.tell()
            ark.write(b"\x00BFM ")
            _write_int32(ark, mat.shape[0])
            _write_int32(ark, mat.shape[1])
            ark.write(mat.tobytes())
            scp.write(f"{key} {abs_ark}:{offset}\n")
    return ark_path, scp_path


def _read_binary_payload(f):
    header = f.read(3)
    if header[:2] == b"FV":
        dim = _read_int32(f)
        return np.frombuffer(f.read(4 * dim), dtype="<f4").copy()
    if header[:2] == b"DV":
        dim = _read_int32(f)
        return np.frombuffer(f.read(8 * dim), dtype="<f8").copy()
    if header[:2] == b"FM":
        rows = _read_int32(f)
        cols = _read_int32(f)
        return np.frombuffer(f.read(4 * rows * cols),
                             dtype="<f4").reshape(rows, cols).copy()
    if header[:2] == b"DM":
        rows = _read_int32(f)
        cols = _read_int32(f)
        return np.frombuffer(f.read(8 * rows * cols),
                             dtype="<f8").reshape(rows, cols).copy()
    raise ValueError(f"unsupported kaldi binary header {header!r}")


def read_vec_scp_lines(lines: Iterable[str]
                       ) -> Iterator[Tuple[str, np.ndarray]]:
    """(key, array) from scp lines `key ark_path:offset` pointing into
    binary arks."""
    for line in lines:
        key, loc = line.strip().split(None, 1)
        ark_path, offset = loc.rsplit(":", 1)
        with open(ark_path, "rb") as ark:
            ark.seek(int(offset))
            if ark.read(2) != b"\x00B":
                raise ValueError(f"{ark_path}:{offset} is no binary kaldi "
                                 "object")
            yield key, _read_binary_payload(ark)


def read_vec_scp(scp_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (key, array) pairs from an scp pointing into binary arks."""
    with open(scp_path) as scp:
        yield from read_vec_scp_lines(scp)


def read_vec_scp_dict(scp_path: str) -> Dict[str, np.ndarray]:
    return dict(read_vec_scp(scp_path))


def read_spk2emb(scp_path: str, utt2spk_path: str) -> Dict[str, np.ndarray]:
    """speaker -> (n, D) stack of the scp's vectors whose utterance
    utt2spk lists, in scp order (the back end's training and enrollment
    sets)."""
    utt2spk = {}
    with open(utt2spk_path) as f:
        for line in f:
            u, s = line.split()
            utt2spk[u] = s
    out: Dict[str, list] = {}
    for utt, vec in read_vec_scp(scp_path):
        if utt in utt2spk:
            out.setdefault(utt2spk[utt], []).append(vec)
    return {k: np.vstack(v) for k, v in out.items()}


def read_vec_ark(ark_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream sequentially from a binary ark (no scp needed)."""
    size = os.path.getsize(ark_path)
    with open(ark_path, "rb") as f:
        while f.tell() < size:
            key = b""
            while True:
                c = f.read(1)
                if not c:
                    return
                if c == b" ":
                    break
                key += c
            marker = f.read(2)
            assert marker == b"\x00B", marker
            yield key.decode(), _read_binary_payload(f)
