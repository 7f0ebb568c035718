"""The port's HDF5 subset (wespeaker_tpu_torch/utils/hdf5.py) against
h5py and the JAX package's PLDA files, on the CPU.

- A `plda.h5` written by the JAX package's `TwoCovPLDA.save` (h5py) loads
  in the port with all six fields equal to the bit, at D = 16 and 256;
  the port's `plda.h5` loads to the bit through h5py and through JAX's
  `TwoCovPLDA.load`.
- `read_datasets` / `write_datasets` against h5py on other contents of
  the subset: more names than one symbol-table node holds, empty and
  scalar datasets, modification times.
- Each file outside the subset raises ValueError naming what it met.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both

from wespeaker_tpu.backend import plda as jplda  # noqa: E402
from wespeaker_tpu_torch.backend import plda as tplda  # noqa: E402
from wespeaker_tpu_torch.utils import hdf5  # noqa: E402

FIELDS = ("mu", "transform", "psi", "offset")


def _model(mod, dim, seed):
    rng = np.random.default_rng(seed)
    m = mod.TwoCovPLDA(dim, normalize_length=bool(seed % 2),
                       subtract_train_set_mean=not seed % 2)
    m.mu, m.transform = rng.normal(size=dim), rng.normal(size=(dim, dim))
    m.psi, m.offset = rng.uniform(0.1, 3, dim), rng.normal(size=dim)
    return m


def _same(got, want):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype == np.float64 and g.shape == w.shape
        assert g.tobytes() == w.tobytes(), name
    assert got.normalize_length == want.normalize_length
    assert got.subtract_train_set_mean == want.subtract_train_set_mean


@pytest.mark.parametrize("dim", [16, 256])
def test_jax_plda_file_loads_in_the_port_to_the_bit(tmp_path, dim):
    want = _model(jplda, dim, dim)
    path = str(tmp_path / "plda.h5")
    want.save(path)
    got = tplda.TwoCovPLDA.load(path)
    _same(got, want)
    assert got.dim == dim


@pytest.mark.parametrize("dim", [16, 256])
def test_port_plda_file_loads_in_h5py_and_jax_to_the_bit(tmp_path, dim):
    want = _model(tplda, dim, dim + 1)
    path = str(tmp_path / "plda.h5")
    want.save(path)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89HDF\r\n\x1a\n"
    _same(jplda.TwoCovPLDA.load(path), want)
    with h5py.File(path, "r") as f:
        assert sorted(f) == sorted(FIELDS + ("normalize_length",
                                             "subtract_train_set_mean"))
        for name in FIELDS:
            assert f[name].dtype == np.float64 and f[name].chunks is None
            assert f[name][()].tobytes() == getattr(want, name).tobytes()
        for name in ("normalize_length", "subtract_train_set_mean"):
            assert f[name].shape == () and f[name].dtype == np.int64
            assert f[name][()] == int(getattr(want, name))
    _same(tplda.TwoCovPLDA.load(path), want)


def _contents(seed):
    """40 datasets (five symbol-table nodes' worth): f64 and int64 arrays
    of rank 0-3, some empty, names in no sorted order."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(40):
        shape = tuple(int(n) for n in rng.integers(0, 4, size=i % 4))
        arr = rng.normal(size=shape)
        out[f"{'zyx'[i % 3]}{i * 7919 % 101}"] = (
            arr if i % 5 else (arr * 1000).astype(np.int64))
    return out


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = np.asarray(got[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


def test_h5py_files_read_equal(tmp_path):
    want = _contents(0)
    path = str(tmp_path / "h5py.h5")
    with h5py.File(path, "w") as f:
        for i, (name, arr) in enumerate(want.items()):
            f.create_dataset(name, data=arr, track_times=bool(i % 2))
    got = hdf5.read_datasets(path)
    assert list(got) == sorted(want, key=str.encode)
    _equal(got, want)


def test_written_files_read_equal_in_h5py(tmp_path):
    want = _contents(1)
    path = str(tmp_path / "port.h5")
    hdf5.write_datasets(path, want)
    with h5py.File(path, "r") as f:
        _equal({name: f[name][()] for name in f}, want)
    _equal(hdf5.read_datasets(path), want)
    with pytest.raises(ValueError, match="float32"):
        hdf5.write_datasets(path, {"x": np.zeros(3, np.float32)})


def _one(f):
    f.create_dataset("mu", data=np.zeros(4))


def _compact(f):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    h5py.h5d.create(f.id, b"mu", h5py.h5t.IEEE_F64LE,
                    h5py.h5s.create_simple((2,)), dcpl=dcpl)


# (the variant, the h5py.File keywords, what goes in, the error's words)
OUTSIDE = {
    "libver latest": ({"libver": "latest"}, _one, "superblock version 3"),
    "libver v108": ({"libver": ("v108", "v108")}, _one,
                    "superblock version 2"),
    "track_order": ({"track_order": True}, _one,
                    "version-2 object header"),
    "chunked": ({}, lambda f: f.create_dataset("mu", data=np.zeros(8),
                                               chunks=(4,)),
                "chunked layout"),
    "gzip": ({}, lambda f: f.create_dataset("mu", data=np.zeros(8),
                                            chunks=(4,), compression="gzip"),
             "compressed"),
    "compact": ({}, _compact, "compact layout"),
    "f32": ({}, lambda f: f.create_dataset("mu", data=np.zeros(4, "<f4")),
            "floating-point of 4 bytes"),
    "big-endian f64": ({}, lambda f: f.create_dataset(
        "mu", data=np.zeros(4, ">f8")), "big-endian floating-point"),
    "int32": ({}, lambda f: f.create_dataset("n", data=np.int32(1)),
              "fixed-point of 4 bytes"),
    "uint64": ({}, lambda f: f.create_dataset("n", data=np.uint64(1)),
               "unsigned fixed-point"),
    "vlen string": ({}, lambda f: f.create_dataset("s", data=b"abc"),
                    "variable-length"),
    "fixed string": ({}, lambda f: f.create_dataset(
        "s", data=np.array(b"abc", "S3")), "string of 3 bytes"),
    "subgroup": ({}, lambda f: f.create_dataset("g/mu", data=np.zeros(4)),
                 "nested group 'g'"),
    "attribute": ({}, lambda f: f.create_dataset(
        "mu", data=np.zeros(4)).attrs.create("a", 1), "attribute"),
    "no data": ({}, lambda f: f.create_dataset("mu", shape=(4,),
                                               dtype="<f8"),
                "no data written"),
}


@pytest.mark.parametrize("variant", sorted(OUTSIDE))
def test_files_outside_the_subset_raise_naming_what_they_hold(tmp_path,
                                                              variant):
    kw, fill, words = OUTSIDE[variant]
    path = str(tmp_path / "x.h5")
    with h5py.File(path, "w", **kw) as f:
        fill(f)
    with pytest.raises(ValueError, match=words):
        hdf5.read_datasets(path)
    with pytest.raises(ValueError, match=words):
        tplda.TwoCovPLDA.load(path)
