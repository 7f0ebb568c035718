"""Recipe stage 1 and the data-dir tools of the port against the JAX
package's, on one tiny corpus: `prep_data raw` and `shard` (tar shards
byte-identical, one wav at 8 kHz resampled to 16 kHz, and the port's
spawned writer pool giving the same bytes as one process), every
subcommand of `data_dir` and of `prep_local` (each output file the same
bytes, stdout the same text), and the dataset's empty-stripe refusal
beside a stripe that yields JAX's batches. File tools on the host: numpy,
no torch compute, so the tolerance everywhere is equality."""

import json
import os
import shutil
import tarfile

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from wespeaker_tpu.bin import data_dir as j_dd  # noqa: E402
from wespeaker_tpu.bin import prep_data as j_prep  # noqa: E402
from wespeaker_tpu.bin import prep_local as j_local  # noqa: E402
from wespeaker_tpu.data import dataset as jds  # noqa: E402
from wespeaker_tpu_torch.bin import data_dir as t_dd  # noqa: E402
from wespeaker_tpu_torch.bin import prep_data as t_prep  # noqa: E402
from wespeaker_tpu_torch.bin import prep_local as t_local  # noqa: E402
from wespeaker_tpu_torch.data import dataset as tds  # noqa: E402
from wespeaker_tpu_torch.data.wav_io import write_wav  # noqa: E402

torch.set_num_threads(2)
SR = 16000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 speakers x 3 PCM16 wavs of 0.5-1.5 s (spk1-utt2 at 8 kHz), a
    wav.scp with a key that has no speaker, utt2spk, a vad table, and a
    Kaldi data dir with the tables data_dir reads."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    scp, u2s, vad = [], [], []
    for s in range(3):
        for u in range(3):
            key = f"spk{s}-utt{u}"
            sr = 8000 if key == "spk1-utt2" else SR
            n = int(rng.uniform(0.5, 1.5) * sr)
            wav = (0.3 * np.sin(2 * np.pi * (150 + 40 * s) / sr
                                * np.arange(n))
                   + rng.uniform(-0.1, 0.1, n)).astype(np.float32)
            path = root / f"{key}.wav"
            write_wav(path, wav, sr)
            scp.append(f"{key} {path}")
            u2s.append(f"{key} spk{s}")
            vad.append(f"{key}-0000-0040 {key} 0.00 0.40")
            vad.append(f"{key}-0050-0090 {key} 0.50 {0.5 + 0.1 * u:.2f}")
    scp.append(f"orphan {root / 'spk0-utt0.wav'}")
    files = {}
    for name, rows in (("wav.scp", scp), ("utt2spk", u2s), ("vad", vad)):
        files[name] = str(root / name)
        (root / name).write_text("\n".join(rows) + "\n")
    data = root / "data"
    data.mkdir()
    for name in ("wav.scp", "utt2spk", "vad"):
        shutil.copy(files[name], data / name)
    (data / "utt2dur").write_text("".join(
        f"spk{s}-utt{u} {1.0 + 0.1 * (s + u):.2f}\n"
        for s in range(3) for u in range(3)))
    (data / "trials").write_text("spk0-utt0 spk1-utt0 nontarget\n")
    files["dir"] = str(data)
    files["root"] = root
    return files


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_raw_lists_match_jax_with_and_without_vad(corpus, tmp_path):
    for vad in (None, corpus["vad"]):
        outs = [str(tmp_path / f"{side}.list") for side in "jt"]
        n_j = j_prep.make_raw_list(corpus["wav.scp"], corpus["utt2spk"],
                                   outs[0], vad)
        t_prep.main(["raw", "--wav_scp", corpus["wav.scp"], "--utt2spk",
                     corpus["utt2spk"], "--out_list", outs[1]]
                    + (["--vad_file", vad] if vad else []))
        assert n_j == 9 and _bytes(outs[1]) == _bytes(outs[0])
    rows = [json.loads(x) for x in open(outs[1])]
    assert rows[0]["vad"] == [[0.0, 0.4], [0.5, 0.5]]


def test_shards_are_byte_identical_to_jax(corpus, tmp_path):
    """Three shards of 3 after the seeded shuffle; the 8 kHz wav comes out
    at 16 kHz through resample_poly; two spawned writers give the bytes
    one process gives."""
    runs = {}
    for side, threads in (("jax", 1), ("port", 1), ("port2", 2)):
        d = tmp_path / side
        if side == "jax":
            paths = j_prep.make_shard_list(
                corpus["wav.scp"], corpus["utt2spk"], str(d),
                str(tmp_path / f"{side}.list"), num_utts_per_shard=3,
                num_threads=threads)
        else:
            t_prep.main(["shard", "--wav_scp", corpus["wav.scp"],
                         "--utt2spk", corpus["utt2spk"], "--shards_dir",
                         str(d), "--shards_list",
                         str(tmp_path / f"{side}.list"),
                         "--num_utts_per_shard", "3", "--num_threads",
                         str(threads)])
            paths = open(tmp_path / f"{side}.list").read().split()
        runs[side] = paths
    assert [os.path.basename(p) for p in runs["port"]] == [
        f"shards_{i:09d}.tar" for i in range(3)]
    for side in ("port", "port2"):
        assert ([os.path.basename(p) for p in runs[side]]
                == [os.path.basename(p) for p in runs["jax"]])
        for a, b in zip(runs[side], runs["jax"]):
            assert _bytes(a) == _bytes(b)
    with tarfile.open(runs["port"][0]) as tf:
        members = tf.getmembers()
    assert [m.name.rsplit(".", 1)[1] for m in members] == ["wav", "spk"] * 3
    assert all(m.mtime == 0 for m in members)
    from wespeaker_tpu_torch.data.wav_io import read_wav
    rates = set()
    for p in runs["port"]:
        with tarfile.open(p) as tf:
            for m in tf.getmembers():
                if m.name.endswith(".wav"):
                    rates.add(read_wav(tf.extractfile(m).read())[1])
    assert rates == {SR}


def _copy_dir(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


@pytest.mark.parametrize("cmd", ["spk2utt", "utt2spk", "filter", "fix",
                                 "subset", "combine", "copy"])
def test_data_dir_subcommands_match_jax(corpus, tmp_path, capsys, cmd):
    outs = {}
    for side, mod in (("j", j_dd), ("t", t_dd)):
        d = _copy_dir(corpus["dir"], tmp_path / f"{side}_src")
        other = _copy_dir(corpus["dir"], tmp_path / f"{side}_other")
        for name in ("wav.scp", "utt2spk", "utt2dur", "vad"):
            rows = ["o-" + x for x in open(os.path.join(other, name))]
            open(os.path.join(other, name), "w").writelines(rows)
        dest = str(tmp_path / f"{side}_dest")
        ids = tmp_path / "ids"
        ids.write_text("spk0-utt1\nspk2-utt0\n")
        spk2utt = tmp_path / "spk2utt"
        spk2utt.write_text("spk1 spk1-utt2 spk1-utt0\nspk0 spk0-utt1\n")
        argv = {
            "spk2utt": ["spk2utt", os.path.join(d, "utt2spk")],
            "utt2spk": ["utt2spk", str(spk2utt)],
            "filter": ["filter", "-f", "2", "--exclude", str(ids),
                       os.path.join(d, "vad")],
            "fix": ["fix", d],
            "subset": ["subset", d, dest, "--spk-list", str(tmp_path /
                                                            "spks")],
            "combine": ["combine", dest, d, other],
            "copy": ["copy", d, dest, "--utt-prefix", "a-",
                     "--spk-prefix", "b-"],
        }[cmd]
        (tmp_path / "spks").write_text("spk2\n")
        if cmd == "fix":  # a duplicate, an utterance missing from utt2dur
            with open(os.path.join(d, "wav.scp"), "a") as f:
                f.write(open(os.path.join(d, "wav.scp")).readline())
                f.write("extra /x.wav\n")
        mod.main(argv)
        out = capsys.readouterr().out
        written = dest if cmd in ("subset", "combine", "copy") else d
        outs[side] = (out, {n: _bytes(os.path.join(written, n))
                            for n in sorted(os.listdir(written))})
    assert outs["t"] == outs["j"]
    assert outs["t"][0] or len(outs["t"][1]) >= 4


def test_prep_local_subcommands_match_jax(corpus, tmp_path, capsys):
    root = tmp_path
    spk2utt = root / "spk2utt"
    spk2utt.write_text("a a1 a2 a3\nb b1\nc c1 c2\n")
    utt2dur = root / "utt2dur"
    utt2dur.write_text("a1 0.5\na2 1.2\na3 0.4\nb1 0.3\nc1 2.0\nc2 0.2\n")
    cn = root / "cn" / "eval" / "lists"
    cn.mkdir(parents=True)
    (cn / "enroll.lst").write_text("s1 enroll/s1.wav\ns2 enroll/s2.wav\n")
    (cn / "trials.lst").write_text("s1 test/t1.wav 1\ns2 test/t1.wav 0\n")
    src = root / "audio" / "spk0"
    src.mkdir(parents=True)
    for i in range(2):
        shutil.copy(corpus["root"] / f"spk0-utt{i}.wav", src / f"u{i}.wav")
    (root / "utt2utts").write_text("spk0/u0-comb2 spk0/u0 spk0/u1\n")
    ori = root / "ori"
    ori.mkdir()
    for name in ("wav.scp", "utt2spk", "vad"):
        shutil.copy(os.path.join(corpus["dir"], name), ori / name)
    sad_scp = root / "sad.scp"
    sad_scp.write_text(f"spk0-utt0 {corpus['root'] / 'spk0-utt0.wav'}\n"
                       f"spk2-utt1 {corpus['root'] / 'spk2-utt1.wav'}\n")
    results = {}
    for side, mod in (("j", j_local), ("t", t_local)):
        out = root / side
        out.mkdir()
        o = str(out)
        for argv in (
                ["combine", str(spk2utt), str(utt2dur), f"{o}/utt2utts",
                 f"{o}/c_utt2spk", f"{o}/c_utt2dur", "--min-duration",
                 "1.0"],
                ["combine-audio", str(root / "utt2utts"),
                 str(root / "audio"), f"{o}/comb"],
                ["cnceleb-trials", "--cnceleb_root", str(root / "cn"),
                 "--dst_trl_path", f"{o}/trials"],
                ["voice-dur", corpus["vad"], f"{o}/voice_dur"],
                ["filter-dur", corpus["wav.scp"], f"{o}/voice_dur",
                 f"{o}/filtered.scp", "--dur-thres", "0.45"],
                ["aug-copies", str(ori), f"{o}/aug", "--aug-copy-num", "2"],
                ["system-sad", str(sad_scp), f"{o}/sad", "--threshold",
                 "0.3"]):
            mod.main(argv)
        results[side] = (capsys.readouterr().err, {
            os.path.relpath(os.path.join(dp, f), o): _bytes(
                os.path.join(dp, f))
            for dp, _, fs in os.walk(o) for f in fs})
    assert results["t"] == results["j"]
    files = results["t"][1]
    assert {"utt2utts", "comb/spk0/u0-comb2.wav", "trials", "voice_dur",
            "filtered.scp", "aug/vad", "sad"} <= set(files)
    assert files["sad"] and files["filtered.scp"]


def test_system_sad_with_a_torch_jit_vad_matches_jax(corpus, tmp_path):
    class EnergyVad(torch.nn.Module):
        def reset_states(self):
            pass

        def forward(self, chunk, sr: int):
            rms = torch.sqrt(torch.mean(chunk * chunk) + 1e-12)
            return torch.sigmoid(20.0 * torch.log10(rms) + 20.0).reshape(1)

    path = str(tmp_path / "vad.jit")
    torch.jit.script(EnergyVad()).save(path)
    outs = []
    for side, mod in (("j", j_local), ("t", t_local)):
        out = str(tmp_path / f"{side}.sad")
        n = mod.system_sad_scp(corpus["wav.scp"], out, model_path=path,
                               threshold=0.2)
        outs.append((n, _bytes(out)))
    assert outs[1] == outs[0] and outs[0][0] > 0


def _stripe_kw(rank, world, worker, workers):
    return dict(rank=rank, world_size=world, worker_id=worker,
                num_workers=workers, seed=3)


def test_an_empty_stripe_raises_naming_rank_and_list(corpus, tmp_path):
    raw = str(tmp_path / "raw.list")
    t_prep.make_raw_list(corpus["wav.scp"], corpus["utt2spk"], raw)
    lines = open(raw).readlines()
    two = str(tmp_path / "two.list")
    open(two, "w").writelines(lines[:2])
    spk2id = {f"spk{s}": s for s in range(3)}
    conf = {"num_frms": 20, "speed_perturb": False,
            "filter_args": {"min_num_frames": 10}}
    # rank 1 of 2 holds one utterance; its third worker of three, none
    ds = tds.SpeakerDataset("raw", two, conf, spk2id,
                            **_stripe_kw(1, 2, 2, 3))
    with pytest.raises(ValueError, match=r"rank 1 .*worker 2 of 3.*two\.list"):
        next(ds.batches(2))
    # a stripe that yields samples gives JAX's batches, epochs spanned
    kw = _stripe_kw(0, 2, 1, 2)
    want = jds.SpeakerDataset("raw", raw, conf, spk2id, **kw)
    got = tds.SpeakerDataset("raw", raw, conf, spk2id, **kw)
    n = 0
    for w, g in zip(want.batches(2, max_epochs=3),
                    got.batches(2, max_epochs=3)):
        assert g["key"] == w["key"]
        for k in g:
            if k != "key":
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        n += 1
    assert n >= 3
