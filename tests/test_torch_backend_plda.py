"""Port parity for the rest of the scoring back end: PLDA, the embedding
processing chain, QMF calibration, their CLIs and the back-end
subcommands of prep_data, against the JAX package on the CPU.

- PLDA (`backend/plda.py`): training (accumulate, EM, get_output) and
  adaptation are the JAX package's f64 host code, so `mu`, `transform`,
  `psi` and `offset` agree within 1e-10 relative; `llr_scores` and
  `score_trials` (multisession averaging or counts, an in-domain mean)
  run in torch f32 (here on the CPU device) against JAX's jnp f32 within
  rtol 1e-5, atol 1e-4. A Kaldi binary `<Plda>` written here (f32 and
  f64 records) reads equal in both packages. `plda.h5` crosses both ways
  to the bit (the port's HDF5 writer and reader, utils/hdf5.py, against
  h5py in the JAX package; tests/test_torch_hdf5.py holds the subset);
  the `.npz` model of earlier versions of the port still loads, and an
  HDF5 file outside the subset is refused naming what it holds.
- The chain (`backend/embedding_processing.py`, host f64): sre v3's chain
  string and `update_link` within 1e-10; `embd_proc.pkl` crosses both
  ways (protocols 4 and 5) and applies exactly as the original; a pickle
  naming any other global is refused before it runs; the `.npz` chain of
  earlier versions of the port still loads.
- QMF (`backend/calibration.py`, scipy L-BFGS-B in f64): the fitted
  weights within 1e-8, and the JAX package's `qmf.npz` loads unchanged.
- The CLIs on one ark, mirroring the recipe stages that
  tests/test_recipe_e2e.py drives for the JAX package (sre v3 stages 5-8,
  vox v2's QMF stage): prep_data's wav2dur, vector_mean and
  calibration_trial give the same files line for line; embd_proc's
  processed arks within 1e-5; plda_tools' score files line for line
  (keys, order, labels) with scores within 1e-4 and its printed EER
  equal; score_calibration's output within 1e-5. Each package's
  `embd_proc.pkl` and `plda.h5` also go through the other's `embd_proc
  apply` and `plda_tools eval`, to the same arks (1e-5) and scores
  (within LLR_TOL).
"""

import contextlib
import io
import os
import pickle
import struct
import wave

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both

from wespeaker_tpu.backend import calibration as jcal  # noqa: E402
from wespeaker_tpu.backend import embedding_processing as jep  # noqa: E402
from wespeaker_tpu.backend import plda as jplda  # noqa: E402
from wespeaker_tpu.bin import embd_proc as j_ep  # noqa: E402
from wespeaker_tpu.bin import plda_tools as j_plda  # noqa: E402
from wespeaker_tpu.bin import prep_data as j_prep  # noqa: E402
from wespeaker_tpu.bin import score_calibration as j_cal  # noqa: E402
from wespeaker_tpu_torch.backend import calibration as tcal  # noqa: E402
from wespeaker_tpu_torch.backend import embedding_processing as tep  # noqa
from wespeaker_tpu_torch.backend import plda as tplda  # noqa: E402
from wespeaker_tpu_torch.bin import embd_proc as t_ep  # noqa: E402
from wespeaker_tpu_torch.bin import plda_tools as t_plda  # noqa: E402
from wespeaker_tpu_torch.bin import prep_data as t_prep  # noqa: E402
from wespeaker_tpu_torch.bin import score_calibration as t_cal  # noqa: E402
from wespeaker_tpu_torch.bin import score_norm as t_norm  # noqa: E402
from wespeaker_tpu_torch.utils.kaldi_io import (read_vec_scp_dict,  # noqa
                                                write_vec_ark_scp)

torch.set_num_threads(2)
LLR_TOL = dict(rtol=1e-5, atol=1e-4)


def _close64(got, want, rtol=1e-10):
    """Within rtol of the largest magnitude of `want`."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= rtol * scale


def _spk2emb(seed, n_spk=12, dim=24):
    """speaker -> (n_i, dim), n_i from 2 to 7 (EM groups by count)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_spk, dim)) * 2
    return {f"s{s}": (centers[s] + rng.normal(size=(2 + s % 6, dim)))
            .astype(np.float32) for s in range(n_spk)}


def _trained(mod, spk2emb, dim):
    return mod.TwoCovPLDA(dim=dim, normalize_length=True).train(spk2emb, 5)


def _same_model(t, j):
    for name in ("mu", "transform", "psi", "offset"):
        _close64(getattr(t, name), getattr(j, name))


def test_plda_train_and_adapt_match_jax():
    dim = 24
    spk2emb = _spk2emb(0, dim=dim)
    t, j = _trained(tplda, spk2emb, dim), _trained(jplda, spk2emb, dim)
    _same_model(t, j)
    adapt = np.random.default_rng(1).normal(size=(80, dim)) * 1.5 + 0.3
    _same_model(t.adapt(adapt, 0.4, 0.6), j.adapt(adapt, 0.4, 0.6))


@pytest.mark.parametrize("multisession,with_mean", [(True, False),
                                                    (False, True)])
def test_plda_scores_match_jax(multisession, with_mean):
    dim = 32
    spk2emb = _spk2emb(2, n_spk=16, dim=dim)
    t, j = _trained(tplda, spk2emb, dim), _trained(jplda, spk2emb, dim)
    rng = np.random.default_rng(3)
    enroll = {f"e{i}": rng.normal(size=(1 + i % 3, dim)) for i in range(9)}
    test = {f"t{i}": rng.normal(size=dim) for i in range(11)}
    trials = [(e, u) for e in enroll for u in test][::2]
    mean_vec = rng.normal(size=dim) * 0.1 if with_mean else None
    got = t.score_trials(enroll, test, trials, multisession, mean_vec,
                         device="cpu")
    want = j.score_trials(enroll, test, trials, multisession, mean_vec)
    assert got.dtype == np.float32 and got.shape == (len(trials),)
    np.testing.assert_allclose(got, want, **LLR_TOL)
    e = t.transform_embeddings(rng.normal(size=(7, dim)))
    u = t.transform_embeddings(rng.normal(size=(7, dim)))
    n = np.arange(1, 8)
    np.testing.assert_allclose(t.llr_scores(e, u, n, device="cpu"),
                               j.llr_scores(e, u, n), **LLR_TOL)


def _write_kaldi_plda(path, mu, transform, psi, double):
    v, m, fmt = (b"DV ", b"DM ", "<f8") if double else (b"FV ", b"FM ",
                                                        "<f4")
    with open(path, "wb") as f:
        f.write(b"\x00B<Plda> ")
        f.write(v + b"\x04" + struct.pack("<i", mu.size)
                + mu.astype(fmt).tobytes())
        f.write(m + b"\x04" + struct.pack("<i", transform.shape[0]) + b"\x04"
                + struct.pack("<i", transform.shape[1])
                + transform.astype(fmt).tobytes())
        f.write(v + b"\x04" + struct.pack("<i", psi.size)
                + psi.astype(fmt).tobytes())
        f.write(b"</Plda> ")


@pytest.mark.parametrize("double", [False, True])
def test_kaldi_plda_reads_equal(tmp_path, double):
    rng = np.random.default_rng(4)
    mu, tr, psi = rng.normal(size=16), rng.normal(size=(16, 16)), \
        rng.uniform(0.1, 3, 16)
    path = str(tmp_path / "plda.kaldi")
    _write_kaldi_plda(path, mu, tr, psi, double)
    t, j = tplda.TwoCovPLDA.load_kaldi(path), jplda.TwoCovPLDA.load_kaldi(path)
    for name in ("mu", "transform", "psi", "offset"):
        assert np.array_equal(getattr(t, name), getattr(j, name))
    assert np.array_equal(t.mu, mu.astype("<f8" if double else "<f4"))
    assert np.array_equal(tplda.TwoCovPLDA.load(path).transform, t.transform)


def test_plda_npz_round_trip_and_hdf5_refused(tmp_path):
    """plda.h5 crosses between the packages to the bit; the `.npz` model
    that earlier versions of the port wrote under that name still loads;
    an HDF5 model outside the subset (f32, as another tool may write it)
    is refused naming its datatype."""
    h5py = pytest.importorskip("h5py")
    dim = 16
    spk2emb = _spk2emb(5, dim=dim)
    t = tplda.TwoCovPLDA(dim, normalize_length=True,
                         subtract_train_set_mean=True).train(spk2emb, 3)
    j = _trained(jplda, spk2emb, dim)
    paths = {k: str(tmp_path / k) for k in ("t.h5", "j.h5", "old.h5",
                                            "f32.h5")}
    t.save(paths["t.h5"])
    j.save(paths["j.h5"])
    for got, want in ((jplda.TwoCovPLDA.load(paths["t.h5"]), t),
                      (tplda.TwoCovPLDA.load(paths["j.h5"]), j),
                      (tplda.TwoCovPLDA.load(paths["t.h5"]), t)):
        for name in ("mu", "transform", "psi", "offset"):
            assert getattr(got, name).tobytes() == \
                getattr(want, name).tobytes()
        assert (got.normalize_length, got.subtract_train_set_mean) == \
            (want.normalize_length, want.subtract_train_set_mean)
    with open(paths["old.h5"], "wb") as f:  # as earlier versions saved
        np.savez(f, mu=t.mu, transform=t.transform, psi=t.psi,
                 offset=t.offset, normalize_length=1,
                 subtract_train_set_mean=1)
    back = tplda.TwoCovPLDA.load(paths["old.h5"])
    for name in ("mu", "transform", "psi", "offset"):
        assert np.array_equal(getattr(back, name), getattr(t, name))
    assert back.normalize_length and back.subtract_train_set_mean
    with h5py.File(paths["f32.h5"], "w") as f:
        for name in ("mu", "transform", "psi", "offset"):
            f.create_dataset(name, data=getattr(t, name).astype(np.float32))
    with pytest.raises(ValueError, match="floating-point of 4 bytes"):
        tplda.TwoCovPLDA.load(paths["f32.h5"])


def _chain_data(seed, dim=20, n_spk=8, n_utt=10):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_spk, dim)) * 3
    spk2emb = {f"s{s}": centers[s] + rng.normal(size=(n_utt, dim))
               for s in range(n_spk)}
    indomain = rng.normal(size=(40, dim)) + 0.5
    return spk2emb, indomain


SRE_V3_CHAIN = ("mean-subtract --scp adapt.scp | length-norm | "
                "lda --scp cts.scp --utt2spk utt2spk --dim 6 | length-norm")


def _loaders(spk2emb, vectors):
    return {"mean-subtract": lambda a: vectors, "whitening": lambda a: vectors,
            "lda": lambda a: spk2emb}


def test_embedding_chain_and_update_link_match_jax(tmp_path):
    spk2emb, indomain = _chain_data(6)
    x = np.vstack(list(spk2emb.values()))
    t = tep.EmbeddingProcessingChain(SRE_V3_CHAIN, _loaders(spk2emb,
                                                            indomain))
    j = jep.EmbeddingProcessingChain(SRE_V3_CHAIN, _loaders(spk2emb,
                                                            indomain))
    _close64(t(x), j(x))
    assert t(x).shape == (x.shape[0], 6)
    new = indomain[::2] * 0.5
    for index, link in ((0, "mean-subtract --scp other.scp"),
                        (2, "lda --scp c.scp --utt2spk u --dim 4"),
                        (0, "whitening --scp w.scp")):
        t.update_link(index, link, _loaders(spk2emb, new))
        j.update_link(index, link, _loaders(spk2emb, new))
        _close64(t(x), j(x))
    path = str(tmp_path / "embd_proc.pkl")
    t.save(path)
    back = tep.EmbeddingProcessingChain().load(path)
    assert [type(link) for link in back.links] == \
        [type(link) for link in t.links]
    assert np.array_equal(back(x), t(x))
    jpath = str(tmp_path / "jax_proc.pkl")
    j.save(jpath)
    np.testing.assert_array_equal(tep.EmbeddingProcessingChain().load(
        jpath)(x), j(x))


WHITENING_CHAIN = ("mean-subtract --scp adapt.scp | whitening --scp w.scp "
                   "| length-norm")


@pytest.mark.parametrize("protocol", [4, 5])
@pytest.mark.parametrize("chain", [SRE_V3_CHAIN, WHITENING_CHAIN],
                         ids=["sre_v3", "whitening"])
def test_chain_pickles_cross_between_the_packages(tmp_path, monkeypatch,
                                                  chain, protocol):
    """A JAX `embd_proc.pkl` loads in the port and a port one in JAX,
    each applying exactly as the original, with the same link classes
    and attribute dicts."""
    spk2emb, indomain = _chain_data(11)
    x = np.vstack(list(spk2emb.values()))
    j = jep.EmbeddingProcessingChain(chain, _loaders(spk2emb, indomain))
    t = tep.EmbeddingProcessingChain(chain, _loaders(spk2emb, indomain))
    jpath, tpath = str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl")
    with open(jpath, "wb") as f:
        pickle.dump(j.links, f, protocol=protocol)
    monkeypatch.setattr(tep, "PICKLE_PROTOCOL", protocol)
    t.save(tpath)
    with open(tpath, "rb") as f:
        assert f.read(2) == bytes([0x80, protocol])
    in_port = tep.EmbeddingProcessingChain().load(jpath)
    in_jax = jep.EmbeddingProcessingChain().load(tpath)
    for got, want in ((in_port, j), (in_jax, t)):
        assert [type(g).__name__ for g in got.links] == \
            [type(w).__name__ for w in want.links]
        for g, w in zip(got.links, want.links):
            assert sorted(vars(g)) == sorted(vars(w))
            for name, value in vars(w).items():
                assert vars(g)[name].tobytes() == value.tobytes()
        assert np.array_equal(got(x), want(x))
    assert all(type(link).__module__ == tep.__name__
               for link in in_port.links)
    assert all(type(link).__module__ == jep.__name__
               for link in in_jax.links)


class _Runs:
    """Pickles as a call of `fn(*args)`."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("global_", [
    "os.system", "builtins.eval", "builtins.open", "numpy.load",
    "embedding_processing.chain_string_to_dict"])
def test_chain_pickle_naming_another_global_is_refused(tmp_path, global_):
    """The pickle would create a marker file when its global runs; the
    load raises naming the global and the marker never appears."""
    marker = tmp_path / "ran"
    payload = {"os.system": _Runs(os.system, f"touch {marker}"),
               "builtins.eval": _Runs(eval, f"open({str(marker)!r}, 'w')"),
               "builtins.open": _Runs(open, str(marker), "w"),
               "numpy.load": _Runs(np.load, str(marker)),
               "embedding_processing.chain_string_to_dict": _Runs(
                   jep.chain_string_to_dict, str(marker))}[global_]
    path = str(tmp_path / "embd_proc.pkl")
    with open(path, "wb") as f:
        pickle.dump([jep.LengthNorm(), payload], f)
    name = global_.split(".")[-1]
    with pytest.raises(ValueError, match=f"names .*{name}.*refused"):
        tep.EmbeddingProcessingChain().load(path)
    assert not marker.exists()


def test_npz_chain_of_earlier_versions_still_loads(tmp_path):
    spk2emb, indomain = _chain_data(12)
    x = np.vstack(list(spk2emb.values()))
    t = tep.EmbeddingProcessingChain(SRE_V3_CHAIN,
                                     _loaders(spk2emb, indomain))
    arrays = {"specs": np.asarray([s.strip() for s in
                                   SRE_V3_CHAIN.split("|")])}
    for i, link in enumerate(t.links):  # the archive as it was written
        for name in type(link).ARRAYS:
            arrays[f"{i}.{name}"] = getattr(link, name)
    path = str(tmp_path / "embd_proc.pkl")
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    back = tep.EmbeddingProcessingChain().load(path)
    assert [type(link) for link in back.links] == \
        [type(link) for link in t.links]
    assert np.array_equal(back(x), t(x))


def _factors(seed, n=300):
    rng = np.random.default_rng(seed)
    y = rng.uniform(size=n) < 0.3
    scores = rng.normal(size=n) + 2.5 * y
    mags = rng.uniform(5, 10, size=(2, n))
    cm = rng.uniform(0, 0.3, size=(2, n))
    dur = rng.uniform(1, 30, size=(2, n))
    kw = dict(enroll_dur=dur[0], test_dur=dur[1], enroll_mag=mags[0],
              test_mag=mags[1], enroll_cohort_mean=cm[0],
              test_cohort_mean=cm[1])
    return scores, kw, y


def test_qmf_fit_matches_jax_and_loads_its_file(tmp_path):
    scores, kw, y = _factors(7)
    f_t, f_j = tcal.build_factors(scores, **kw), jcal.build_factors(scores,
                                                                    **kw)
    assert np.array_equal(f_t, f_j) and f_t.shape == (300, 13)
    assert tcal.cllr(scores[y], scores[~y]) == jcal.cllr(scores[y],
                                                         scores[~y])
    t = tcal.QMFCalibrator().fit(f_t, y)
    j = jcal.QMFCalibrator().fit(f_j, y)
    np.testing.assert_allclose(t.weight, j.weight, rtol=0, atol=1e-8)
    assert abs(t.bias - j.bias) <= 1e-8
    path = str(tmp_path / "qmf.npz")
    j.save(path)
    loaded = tcal.QMFCalibrator.load(path)
    assert np.array_equal(loaded.weight, j.weight) and loaded.bias == j.bias
    assert np.array_equal(loaded(f_t), j(f_j))


# ---- the CLIs on one ark ----

def _write_corpus(root, rng, dim=16, n_spk=6, n_utt=6):
    """An ark of embeddings, utt2spk, spk2utt, wav.scp (PCM16 at 8 kHz),
    trials (utterance pairs) and an utt2utt identity enroll map."""
    centers = rng.normal(size=(n_spk, dim)) * 3
    items, u2s = [], []
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    wav_lines = []
    for s in range(n_spk):
        for u in range(n_utt):
            key = f"s{s}_u{u}"
            items.append((key, (centers[s] + rng.normal(size=dim))
                          .astype(np.float32)))
            u2s.append(f"{key} s{s}")
            path = os.path.join(root, "wav", key + ".wav")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(8000)
                w.writeframes(np.zeros(800 + 37 * (s * n_utt + u),
                                       "<i2").tobytes())
            wav_lines.append(f"{key} {path}")
    write_vec_ark_scp(os.path.join(root, "emb"), items)
    keys = [k for k, _ in items]
    files = {
        "utt2spk": "\n".join(u2s),
        "utt2utt": "\n".join(f"{k} {k}" for k in keys),
        "spk2utt": "\n".join(f"s{s} " + " ".join(
            f"s{s}_u{u}" for u in range(n_utt)) for s in range(n_spk)),
        "wav.scp": "\n".join(wav_lines),
        "trials": "\n".join(
            f"{a} {b} "
            f"{'target' if a.split('_')[0] == b.split('_')[0] else 'nontarget'}"
            for i, a in enumerate(keys) for b in keys[i + 1::5]),
    }
    for name, text in files.items():
        with open(os.path.join(root, name), "w") as f:
            f.write(text + "\n")


def _lines(path):
    with open(path) as f:
        return [line.split() for line in f]


def _same_score_lines(got_path, want_path, atol, rtol=0.0):
    got, want = _lines(got_path), _lines(want_path)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[3:] == w[3:]
        assert abs(float(g[2]) - float(w[2])) <= \
            atol + rtol * abs(float(w[2])), (g, w)


def _same_arks(got_scp, want_scp, atol):
    got, want = read_vec_scp_dict(got_scp), read_vec_scp_dict(want_scp)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol)


def _captured(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


def test_recipe_back_end_stages_match_jax(tmp_path):
    """prep_data, embd_proc (prep/apply/update) and plda_tools
    (train/adapt/eval) as sre v3's stages 5-8 run them."""
    root = str(tmp_path)
    _write_corpus(root, np.random.default_rng(8))
    p = {k: os.path.join(root, k) for k in ("utt2spk", "utt2utt", "spk2utt",
                                            "wav.scp", "trials")}
    emb = os.path.join(root, "emb.scp")
    out = {}
    for side, prep, ep, plda, kw in (("t", t_prep, t_ep, t_plda,
                                      {"device": "cpu"}),
                                     ("j", j_prep, j_ep, j_plda, {})):
        d = os.path.join(root, side)
        os.makedirs(d)
        prep.wav2dur(p["wav.scp"], os.path.join(d, "utt2dur"))
        prep.vector_mean(p["spk2utt"], emb, os.path.join(d, "spk_mean"))
        prep.generate_calibration_trial(p["utt2spk"],
                                        os.path.join(d, "cal_trials"))
        chain = (f"mean-subtract --scp {emb} | length-norm | lda --scp "
                 f"{emb} --utt2spk {p['utt2spk']} --dim 8 | length-norm")
        proc = os.path.join(d, "embd_proc.pkl")
        ep.prep(chain, proc, **kw)
        ep.update(proc, 0, f"mean-subtract --scp {d}/spk_mean.scp",
                  proc + ".upd", **kw)
        ep.apply(proc + ".upd", emb, os.path.join(d, "emb_proc"), **kw)
        proc_scp = os.path.join(d, "emb_proc.scp")
        model = os.path.join(d, "plda.h5")
        plda.train_plda(proc_scp, p["utt2spk"], model, 8, 5, **kw)
        plda.adapt_plda(model, proc_scp, model + ".adapt", **kw)
        printed = []
        for m, name in ((model, "plda.score"), (model + ".adapt",
                                                 "plda_adapt.score")):
            printed.append(_captured(
                plda.eval_plda, proc_scp, p["utt2utt"], proc_scp,
                p["trials"], os.path.join(d, name), m,
                indomain_scp=proc_scp if name == "plda.score" else None,
                **kw))
        out[side] = (d, printed)
    (td, t_printed), (jd, j_printed) = out["t"], out["j"]
    for name in ("utt2dur", "cal_trials", "spk_mean.scp"):
        a, b = _lines(os.path.join(td, name)), _lines(os.path.join(jd, name))
        if name.endswith(".scp"):
            a, b = [r[0] for r in a], [r[0] for r in b]
        assert a == b and len(a) > 0
    _same_arks(os.path.join(td, "spk_mean.scp"),
               os.path.join(jd, "spk_mean.scp"), 0)
    _same_arks(os.path.join(td, "emb_proc.scp"),
               os.path.join(jd, "emb_proc.scp"), 1e-5)
    for name in ("plda.score", "plda_adapt.score"):
        _same_score_lines(os.path.join(td, name), os.path.join(jd, name),
                          1e-4)
    assert t_printed == j_printed and "PLDA EER" in t_printed[0]
    # each package's embd_proc.pkl and plda.h5 through the other's CLIs
    for src, ep, plda, kw in ((jd, t_ep, t_plda, {"device": "cpu"}),
                              (td, j_ep, j_plda, {})):
        d = src + "_read_by_the_other"
        os.makedirs(d)
        ep.apply(os.path.join(src, "embd_proc.pkl.upd"), emb,
                 os.path.join(d, "emb_proc"), **kw)
        _same_arks(os.path.join(d, "emb_proc.scp"),
                   os.path.join(src, "emb_proc.scp"), 0)
        proc_scp = os.path.join(src, "emb_proc.scp")
        model = os.path.join(src, "plda.h5")
        for m, name in ((model, "plda.score"), (model + ".adapt",
                                                 "plda_adapt.score")):
            with contextlib.redirect_stdout(io.StringIO()):
                plda.eval_plda(
                    proc_scp, p["utt2utt"], proc_scp, p["trials"],
                    os.path.join(d, name), m,
                    indomain_scp=proc_scp if name == "plda.score" else None,
                    **kw)
            _same_score_lines(os.path.join(d, name),
                              os.path.join(src, name),
                              LLR_TOL["atol"], LLR_TOL["rtol"])


def test_qmf_recipe_stage_matches_jax(tmp_path):
    """vox v2's stage 7 on AS-Norm output: score_calibration train and
    infer with durations from wav2dur, on trials from calibration_trial."""
    root = str(tmp_path)
    _write_corpus(root, np.random.default_rng(9))
    emb = os.path.join(root, "emb.scp")
    t_prep.wav2dur(os.path.join(root, "wav.scp"),
                   os.path.join(root, "utt2dur"))
    cal_trials = os.path.join(root, "cal_trials")
    t_prep.generate_calibration_trial(os.path.join(root, "utt2spk"),
                                      cal_trials, 200, 200)
    vecs = read_vec_scp_dict(emb)
    for trials in (cal_trials, os.path.join(root, "trials")):
        with open(trials) as f, open(trials + ".score", "w") as g:
            for line in f:
                a, b, lab = line.split()
                s = float(np.dot(vecs[a], vecs[b])
                          / np.linalg.norm(vecs[a]) / np.linalg.norm(vecs[b]))
                g.write(f"{a} {b} {s:.5f} {lab}\n")
        t_norm.score_norm("asnorm", 10, trials + ".score",
                          trials + ".norm", emb, emb, device="cpu")
    dur = os.path.join(root, "utt2dur")
    for side, mod, kw in (("t", t_cal, {"device": "cpu"}), ("j", j_cal, {})):
        model = os.path.join(root, f"qmf_{side}.npz")
        mod.train_qmf(cal_trials + ".norm", model, dur, **kw)
        mod.infer_qmf(os.path.join(root, "trials.norm"), model,
                      os.path.join(root, f"trials.qmf_{side}"), dur, **kw)
    tw = np.load(os.path.join(root, "qmf_t.npz"))["weight"]
    jw = np.load(os.path.join(root, "qmf_j.npz"))["weight"]
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-8)
    _same_score_lines(os.path.join(root, "trials.qmf_t"),
                      os.path.join(root, "trials.qmf_j"), 1e-5)


def test_prep_data_refuses_the_unported_subcommands():
    """Every subcommand of the JAX package's prep_data is ported (`raw`
    and `shard` last): those two parse their own arguments, and a
    subcommand neither package has is refused."""
    for cmd in ("raw", "shard"):
        with pytest.raises(SystemExit):  # their required lists are missing
            t_prep.main([cmd, "--wav_scp", "x"])
    with pytest.raises(SystemExit):
        t_prep.main(["lmdb", "--wav_scp", "x"])


def test_back_end_entry_points_need_the_card_unless_told(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = str(tmp_path / "x")
    for cli, argv in (
            (t_plda, ["train", "--scp_path", x, "--utt2spk", x,
                      "--model_path", x, "--embed_dim", "4"]),
            (t_plda, ["eval", "--enroll_scp_path", x, "--enroll_utt2spk", x,
                      "--test_scp_path", x, "--trials", x, "--score_path", x,
                      "--model_path", x]),
            (t_ep, ["prep", "--chain", "length-norm", "--out", x]),
            (t_cal, ["infer", "--score_norm_file", x, "--model_path", x,
                     "--out_score_file", x])):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    t_ep.main(["prep", "--chain", "length-norm", "--out", x,
               "--device", "cpu"])
    assert [type(link) for link in tep.EmbeddingProcessingChain().load(
        x).links] == [tep.LengthNorm]
