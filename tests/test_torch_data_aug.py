"""Port parity for the training data path with augmentation: the packed
MUSAN/RIR stores, the reverb/noise stages, device-side augmentation,
SpeakerDataset over raw, shard and feat lists, worker striping and the
multi-process prefetcher, each against the JAX package's on the same
files and seeds.

Both pipelines draw every choice (utterance order, crops, speed, the
augmentation branch, the RIR or noise, the SNR) from numpy generators
seeded alike, so streams must agree bit for bit. `device_augment` (torch
on the CPU) is held to JAX's within 1e-5 absolute on [-1, 1] audio: both
are FFT convolutions, with different FFT libraries. The store's `.bin`
must be byte-identical; its `.idx.npz` holds the same arrays (a zip
records its write time, so its bytes differ between two writes).
"""

import io
import json
import os
import sys
import tarfile
from collections import Counter

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's train/ needs both
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.data import dataset as jds  # noqa: E402
from wespeaker_tpu.data import pipeline as jpipe  # noqa: E402
from wespeaker_tpu.data import store as jstore  # noqa: E402
from wespeaker_tpu.train.device_aug import (  # noqa: E402
    device_augment as j_device_augment)
from wespeaker_tpu_torch.bin import prep_data as t_prep  # noqa: E402
from wespeaker_tpu_torch.data import dataset as tds  # noqa: E402
from wespeaker_tpu_torch.data import pipeline as tpipe  # noqa: E402
from wespeaker_tpu_torch.data import store as tstore  # noqa: E402
from wespeaker_tpu_torch.data.wav_io import write_wav  # noqa: E402
from wespeaker_tpu_torch.train.device_aug import device_augment  # noqa
from wespeaker_tpu_torch.utils.kaldi_io import write_mat_ark_scp  # noqa

torch.set_num_threads(2)
SR = 16000


def write_aug_sources(root, seed=0):
    """RIR wavs (decaying noise of 0.3-1 s, one at 8 kHz to exercise the
    resampling) and MUSAN-like noise wavs keyed noise-/music-/speech-;
    returns the two wav.scp paths."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    scps = {}
    for kind, keys in (("rirs", [f"rir{i}" for i in range(4)]),
                       ("musan", ["noise-a", "music-b", "speech-c",
                                  "other-d"])):
        lines = []
        for i, key in enumerate(keys):
            sr = 8000 if key == "rir3" else SR
            if kind == "rirs":
                n = int(rng.uniform(0.3, 1.0) * sr)
                wav = rng.normal(0, 0.5, n) * np.exp(
                    -np.arange(n) / (0.05 * sr))
            else:
                n = int(rng.uniform(0.5, 2.0) * sr)
                wav = rng.uniform(-0.4, 0.4, n)
            path = os.path.join(root, f"{key}.wav")
            write_wav(path, np.clip(wav, -1, 1).astype(np.float32), sr)
            lines.append(f"{key} {path}")
        scps[kind] = os.path.join(root, f"{kind}.scp")
        with open(scps[kind], "w") as f:
            f.write("\n".join(lines) + "\n")
    return scps["rirs"], scps["musan"]


def build_stores(root, seed=0):
    """(rir prefix, noise prefix) written by the port's prep_data."""
    rir_scp, noise_scp = write_aug_sources(os.path.join(root, "src"), seed)
    prefixes = []
    for name, scp in (("rirs", rir_scp), ("musan", noise_scp)):
        prefix = os.path.join(root, name)
        t_prep.main(["aug_store", "--wav_scp", scp, "--out_prefix", prefix])
        prefixes.append(prefix)
    return tuple(prefixes)


def write_corpus(root, n_spk=3, n_utt=3, seed=1):
    """PCM16 wavs of 1.0-2.0 s, a jsonl raw list, tar shards of 4
    utterances, a kaldi feature ark/scp (T 60-120 x 8) and utt2spk."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    raw, u2s, items, feats = [], [], [], []
    for s in range(n_spk):
        for u in range(n_utt):
            key = f"spk{s}-utt{u}"
            n = int(rng.uniform(1.0, 2.0) * SR)
            path = os.path.join(root, f"{key}.wav")
            write_wav(path, (rng.uniform(-0.3, 0.3, n) * (1 + s)).astype(
                np.float32), SR)
            raw.append(json.dumps({"key": key, "wav": path,
                                   "spk": f"spk{s}"}))
            u2s.append(f"{key} spk{s}")
            items.append((key, f"spk{s}", path))
            feats.append((key, rng.normal(size=(int(rng.integers(60, 121)),
                                                8)).astype(np.float32)))
    files = {}
    for name, rows in (("raw.list", raw), ("utt2spk", u2s)):
        files[name] = os.path.join(root, name)
        with open(files[name], "w") as f:
            f.write("\n".join(rows) + "\n")
    shards = []
    for i in range(0, len(items), 4):
        tar_path = os.path.join(root, f"shard{i // 4}.tar")
        with tarfile.open(tar_path, "w") as tf:
            for key, spk, path in items[i:i + 4]:
                for name, data in ((f"{key}.wav", open(path, "rb").read()),
                                   (f"{key}.spk", spk.encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
        shards.append(tar_path)
    files["shard.list"] = os.path.join(root, "shard.list")
    with open(files["shard.list"], "w") as f:
        f.write("\n".join(shards) + "\n")
    ark_prefix = os.path.join(root, "feats")
    write_mat_ark_scp(ark_prefix, feats)
    files["feat.list"] = os.path.join(root, "feat.list")
    t_prep.main(["feat", "--feat_scp", ark_prefix + ".scp", "--utt2spk",
                 files["utt2spk"], "--out_list", files["feat.list"]])
    return files


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("aug"))
    rir, noise = build_stores(os.path.join(root, "stores"))
    files = write_corpus(os.path.join(root, "corpus"))
    spk2id = tpipe.spk2id_from_utt2spk(files["utt2spk"])
    return {"root": root, "rir": rir, "noise": noise, "spk2id": spk2id,
            **files}


def test_stores_are_the_same_files_in_both_packages(data, tmp_path):
    rir_scp, noise_scp = write_aug_sources(str(tmp_path / "src"))
    for name, scp in (("rirs", rir_scp), ("musan", noise_scp)):
        j_prefix = str(tmp_path / f"j_{name}")
        jstore.build_packed_store(jpipe_read_scp(scp), j_prefix)
        t_prefix = os.path.join(data["root"], "stores", name)
        with open(j_prefix + ".bin", "rb") as a, \
                open(t_prefix + ".bin", "rb") as b:
            assert a.read() == b.read()
        ji, ti = (np.load(p + ".idx.npz") for p in (j_prefix, t_prefix))
        assert sorted(ji.files) == sorted(ti.files)
        for k in ji.files:
            np.testing.assert_array_equal(ji[k], ti[k])
        # each package reads the other's store
        for reader, prefix in ((tstore.PackedAudioStore, j_prefix),
                               (jstore.PackedAudioStore, t_prefix)):
            other = (jstore.PackedAudioStore(prefix)
                     if reader is tstore.PackedAudioStore
                     else tstore.PackedAudioStore(prefix))
            got = reader(prefix)
            assert got.keys == other.keys and got.sample_rate == SR
            for i in range(len(got)):
                np.testing.assert_array_equal(got.get(i), other.get(i))
                np.testing.assert_array_equal(got.get_raw(i),
                                              other.get_raw(i))
    rirs = tstore.PackedAudioStore(data["rir"])
    assert rirs.data.dtype == np.int16 and rirs.keys[3] == "rir3"
    assert all(0.3 * SR - 2 <= n <= SR for n in rirs.lengths)
    with pytest.raises(SystemExit):  # `raw` is ported: --utt2spk missing
        t_prep.main(["raw", "--wav_scp", rir_scp])


def jpipe_read_scp(path):
    from wespeaker_tpu.bin.prep_data import read_scp
    return read_scp(path)


def _store_pair(data):
    return ((jstore.PackedAudioStore(data["rir"]),
             jstore.PackedAudioStore(data["noise"])),
            (tstore.PackedAudioStore(data["rir"]),
             tstore.PackedAudioStore(data["noise"])))


def _samples(n, seed=3, length=8000):
    rng = np.random.default_rng(seed)
    return [{"key": f"u{i}", "label": i % 3,
             "wav": rng.uniform(-0.5, 0.5, length).astype(np.float32)}
            for i in range(n)]


@pytest.mark.parametrize("which", ["both", "reverb", "noise"])
def test_augment_stages_match_jax_bit_for_bit(data, which):
    (jr, jn), (tr, tn) = _store_pair(data)
    if which == "reverb":
        jn = tn = None
    elif which == "noise":
        jr = tr = None
    for s_j, s_t in zip(_samples(12), _samples(12)):
        a = jpipe.augment_one(s_j["wav"], jr, jn, np.random.default_rng(7))
        b = tpipe.augment_one(s_t["wav"], tr, tn, np.random.default_rng(7))
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    want = list(jpipe.add_reverb_noise(_samples(16), jr, jn, 0.6,
                                       np.random.default_rng(11)))
    got = list(tpipe.add_reverb_noise(_samples(16), tr, tn, 0.6,
                                      np.random.default_rng(11)))
    changed = 0
    for w, g, orig in zip(want, got, _samples(16)):
        np.testing.assert_array_equal(g["wav"], w["wav"])
        changed += not np.array_equal(g["wav"], orig["wav"])
    assert 0 < changed < 16
    ja, ta = (jpipe.make_crop_aug(jr, jn, 0.6),
              tpipe.make_crop_aug(tr, tn, 0.6))
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for s in _samples(8):
        np.testing.assert_array_equal(ta(s["wav"], rt), ja(s["wav"], rj))
    assert tpipe._snr_range_for("speech-x") == (10, 30)
    assert tpipe._snr_range_for("music-x") == (5, 15)


@pytest.mark.parametrize("batch_size", [1, 6, 7])
def test_device_aug_fields_and_packing_match_jax(data, batch_size):
    """attach_device_aug's draws and batch_samples' reverb-first packing
    (cap = max(B // 2, 1), overflow reverb rows downgraded to mode 0)."""
    (jr, jn), (tr, tn) = _store_pair(data)
    jb = list(jpipe.batch_samples(jpipe.attach_device_aug(
        _samples(28), jr, jn, 0.9, 4000, np.random.default_rng(2)),
        batch_size))
    tb = list(tpipe.batch_samples(tpipe.attach_device_aug(
        _samples(28), tr, tn, 0.9, 4000, np.random.default_rng(2)),
        batch_size))
    assert len(tb) == len(jb) == 28 // batch_size
    modes = Counter()
    for w, g in zip(jb, tb):
        assert g["key"] == w["key"] and sorted(g) == sorted(w)
        for k in ("wav", "label", "aug_mode", "aug_rir", "aug_noise",
                  "aug_snr"):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        cap = max(batch_size // 2, 1)
        assert g["aug_rir"].shape == (cap, 4000)
        assert g["aug_rir"].dtype == np.int16
        assert np.all(g["aug_mode"][cap:] != 1)
        modes.update(g["aug_mode"].tolist())
    assert modes[1] and modes[2]


@pytest.mark.parametrize("blocks,store_dtype", [(1, "int16"), (2, "int16"),
                                                (1, "float32")])
def test_device_augment_matches_jax(data, blocks, store_dtype):
    (_, _), (tr, tn) = _store_pair(data)
    b, n = 8, 6000
    rng = np.random.default_rng(4)
    lb = b // blocks
    # each block front-packed as one process's batch would be
    blocks_out = [next(tpipe.batch_samples(tpipe.attach_device_aug(
        [{"key": str(j), "label": 0,
          "wav": rng.uniform(-0.6, 0.6, n).astype(np.float32)}
         for j in range(lb)], tr, tn, 0.9, 3000,
        np.random.default_rng(9 + i)), lb)) for i in range(blocks)]
    batch = {k: np.concatenate([x[k] for x in blocks_out])
             for k in ("wav", "aug_mode", "aug_rir", "aug_noise",
                       "aug_snr")}
    if store_dtype == "float32":
        for k in ("aug_rir", "aug_noise"):
            batch[k] = batch[k].astype(np.float32) / 32768.0
    args = [batch[k] for k in ("wav", "aug_mode", "aug_rir", "aug_noise",
                               "aug_snr")]
    want = np.asarray(j_device_augment(*[jnp.asarray(a) for a in args],
                                       blocks=blocks))
    got = device_augment(*[torch.from_numpy(a) for a in args],
                         blocks=blocks).numpy()
    assert got.dtype == np.float32 and got.shape == (b, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    mode = batch["aug_mode"]
    assert set(mode.tolist()) >= {1, 2}
    np.testing.assert_array_equal(got[mode == 0], batch["wav"][mode == 0])
    with pytest.raises(ValueError, match="blocks"):
        device_augment(*[torch.from_numpy(a) for a in args], blocks=3)


CASES = {
    "raw_host_aug": ("raw.list", "raw", {}),
    "shard_host_aug": ("shard.list", "shard", {}),
    "raw_device_aug": ("raw.list", "raw",
                       {"device_aug": True, "device_aug_rir_samples": 4000}),
    "raw_expanded": ("raw.list", "raw", {"speed_perturb_mode": "expanded"}),
    "feat": ("feat.list", "feat", {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_speaker_dataset_batches_match_jax(data, case):
    list_name, data_type, extra = CASES[case]
    conf = {"num_frms": 50, "shuffle_args": {"shuffle_size": 4},
            "filter_args": {"min_num_frames": 50, "max_num_frames": 150},
            "speed_perturb": True, "aug_prob": 0.6, **extra}
    if data_type == "feat":
        conf["utt2spk"] = data["utt2spk"]
    kw = dict(reverb_store_prefix=data["rir"],
              noise_store_prefix=data["noise"], seed=5)
    want = jds.SpeakerDataset(data_type, data[list_name], conf,
                              data["spk2id"], **kw)
    got = tds.SpeakerDataset(data_type, data[list_name], conf,
                             data["spk2id"], **kw)
    assert got.num_classes() == want.num_classes()
    n_batches = 0
    for w, g in zip(want.batches(3, max_epochs=2),
                    got.batches(3, max_epochs=2)):
        assert g["key"] == w["key"] and sorted(g) == sorted(w)
        for k in g:
            if k != "key":
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        n_batches += 1
    per_epoch = 9 * (3 if case == "raw_expanded" else 1)
    assert n_batches == 2 * per_epoch // 3
    key = "feat" if data_type == "feat" else "wav"
    assert g[key].shape[1] == (50 if data_type == "feat"
                               else 49 * 160 + 400)
    if "device_aug" in extra:
        assert "aug_mode" in g


def test_worker_and_rank_striping_match_jax(data):
    conf = {"num_frms": 50, "speed_perturb": False,
            "shuffle_args": {"shuffle_size": 3},
            "filter_args": {"min_num_frames": 50}}
    seen = Counter()
    for rank, world in ((0, 1), (1, 2)):
        for wid, nw in ((0, 1), (0, 2), (1, 2), (2, 3)):
            kw = dict(reverb_store_prefix=data["rir"], rank=rank,
                      world_size=world, worker_id=wid, num_workers=nw,
                      seed=8)
            want = jds.SpeakerDataset("raw", data["raw.list"], conf,
                                      data["spk2id"], **kw)
            got = tds.SpeakerDataset("raw", data["raw.list"], conf,
                                     data["spk2id"], **kw)
            for epoch in range(2):
                ws = list(want._epoch_iter(epoch))
                gs = list(got._epoch_iter(epoch))
                assert [s["key"] for s in gs] == [s["key"] for s in ws]
                for g, w in zip(gs, ws):
                    np.testing.assert_array_equal(g["wav"], w["wav"])
                if (rank, world, nw) == (0, 1, 2):
                    seen.update(s["key"] for s in gs)
    # two workers of one rank cover the list once an epoch
    assert sorted(seen.values()) == [2] * 9


def test_mp_prefetcher_yields_jax_workers_batches(data):
    """Two spawned workers: the multiset of batches equals what JAX's
    workers (SpeakerDataset stripes 0 and 1 of 2) produce."""
    conf = {"num_frms": 50, "speed_perturb": True, "aug_prob": 0.6,
            "shuffle_args": {"shuffle_size": 4},
            "filter_args": {"min_num_frames": 50}}
    ds_args = ("raw", data["raw.list"], conf, data["spk2id"])
    ds_kwargs = dict(reverb_store_prefix=data["rir"],
                     noise_store_prefix=data["noise"], seed=6)
    want = []
    for w in range(2):
        ds = jds.SpeakerDataset(*ds_args, worker_id=w, num_workers=2,
                                **ds_kwargs)
        want += list(ds.batches(2, max_epochs=2))
    main = vars(sys.modules["__main__"])
    before = {k: main.get(k, "absent") for k in ("__spec__", "__file__")}
    pf = tds.MPPrefetcher(ds_args, ds_kwargs, 2, num_workers=2,
                          max_epochs=2)
    # __main__ was hidden from the spawned workers only while they started
    assert {k: main.get(k, "absent") for k in before} == before
    got = list(pf)
    assert all(not p.is_alive() for p in pf.procs)

    def multiset(batches):
        return Counter((tuple(b["key"]), b["wav"].tobytes(),
                        b["label"].tobytes()) for b in batches)

    assert len(got) == len(want) >= 4
    assert multiset(got) == multiset(want)


def test_mp_prefetcher_raises_when_a_worker_fails_or_dies(data,
                                                          monkeypatch):
    conf = {"num_frms": 50, "speed_perturb": False}
    bad = tds.MPPrefetcher(("raw", os.path.join(data["root"], "missing"),
                            conf, data["spk2id"]), {}, 2, num_workers=2,
                           max_epochs=1)
    with pytest.raises(RuntimeError, match="data worker failed"):
        list(bad)
    assert all(not p.is_alive() for p in bad.procs)
    # a worker killed without a word is found by the liveness poll
    monkeypatch.setattr(tds.MPPrefetcher, "POLL_S", 1)
    pf = tds.MPPrefetcher(("raw", data["raw.list"], conf, data["spk2id"]),
                          {}, 2, num_workers=2, max_epochs=1)
    pf.procs[0].kill()
    with pytest.raises(RuntimeError, match="died with exit codes"):
        list(pf)
    assert all(not p.is_alive() for p in pf.procs)
