"""Data preparation tools: the recipes' stage 1 lists and shards, the
augmentation stores, feature lists and the ones the scoring back end needs.

    python -m wespeaker_tpu_torch.bin.prep_data raw --wav_scp wav.scp \
        --utt2spk utt2spk --out_list raw.list [--vad_file vad]
    python -m wespeaker_tpu_torch.bin.prep_data shard --wav_scp wav.scp \
        --utt2spk utt2spk --shards_dir shards --shards_list shard.list \
        [--num_utts_per_shard 1000] [--num_threads 4]
    python -m wespeaker_tpu_torch.bin.prep_data aug_store --wav_scp \
        musan/wav.scp --out_prefix musan/store [--max_duration_s S]
    python -m wespeaker_tpu_torch.bin.prep_data feat --feat_scp feats.scp \
        --utt2spk utt2spk --out_list feat.list
    python -m wespeaker_tpu_torch.bin.prep_data wav2dur --wav_scp wav.scp \
        --out utt2dur
    python -m wespeaker_tpu_torch.bin.prep_data vector_mean \
        --spk2utt spk2utt --xvector_scp emb.scp --out_prefix spk_emb
    python -m wespeaker_tpu_torch.bin.prep_data calibration_trial \
        --utt2spk utt2spk --out_trials cal_trials

Counterpart of wespeaker_tpu/bin/prep_data.py (upstream
tools/make_raw_list.py, tools/make_shard_list.py, tools/make_lmdb.py,
tools/make_feat_list.py, tools/wav2dur.py, tools/vector_mean.py,
tools/generate_calibration_trial.py): the same files, byte for byte. `raw`
writes the jsonl list and `shard` the tar shards (PCM16 mono, resampled to
16 kHz) that `data/dataset.py` reads; `aug_store` writes the packed
MUSAN/RIR store of data/store.py that the trainers' `noise_data` /
`reverb_data` name. These are file tools on the host and take no
`--device`.
"""

import argparse
import io
import json
import multiprocessing
import os
import tarfile
import wave
from typing import Dict, List, Tuple

import numpy as np

from wespeaker_tpu_torch.data.dataset import _main_hidden
from wespeaker_tpu_torch.data.store import build_packed_store
from wespeaker_tpu_torch.data.wav_io import read_wav
from wespeaker_tpu_torch.utils.kaldi_io import (read_vec_scp_dict,
                                                write_vec_ark_scp)


def read_scp(path: str) -> List[Tuple[str, str]]:
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out.append((parts[0], parts[1]))
    return out


def read_utt2spk(path: str) -> Dict[str, str]:
    return dict(read_scp(path))


def make_raw_list(wav_scp, utt2spk, out_list, vad_file=None):
    """wav.scp + utt2spk (+ optional vad segments `subseg utt begin end`)
    -> the jsonl raw list, one {"key", "wav", "spk"[, "vad"]} a line in
    wav.scp's order, utterances without a speaker left out
    (tools/make_raw_list.py). Returns the number of lines."""
    u2s = read_utt2spk(utt2spk)
    vad = {}
    if vad_file:
        with open(vad_file) as f:
            for line in f:
                parts = line.split()
                utt, b, e = parts[-3], float(parts[-2]), float(parts[-1])
                vad.setdefault(utt, []).append([b, e])
    n = 0
    with open(out_list, "w") as fout:
        for key, path in read_scp(wav_scp):
            if key not in u2s:
                continue
            obj = {"key": key, "wav": path, "spk": u2s[key]}
            if key in vad:
                obj["vad"] = vad[key]
            fout.write(json.dumps(obj) + "\n")
            n += 1
    return n


def _add_member(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)  # mtime, uid and gid 0: reproducible
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _write_one_shard(args):
    """One tar of `key.wav` (PCM16 mono at `resample_rate`, resampled by
    scipy's resample_poly where the file's rate differs) and `key.spk`
    members, in the items' order; unreadable files are left out."""
    shard_path, items, resample_rate = args
    from scipy.signal import resample_poly

    with tarfile.open(shard_path, "w") as tf:
        for key, spk, path in items:
            try:
                wav, sr = read_wav(path)
            except Exception:  # as the upstream tool: skip, keep going
                continue
            if wav.ndim > 1:
                wav = wav[0]
            if resample_rate and sr != resample_rate:
                g = int(np.gcd(sr, resample_rate))
                wav = resample_poly(wav, resample_rate // g, sr // g)
                sr = resample_rate
            pcm = (np.clip(wav, -1, 1) * 32767.0).round().astype(np.int16)
            buf = io.BytesIO()
            with wave.open(buf, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes(pcm.tobytes())
            _add_member(tf, f"{key}.wav", buf.getvalue())
            _add_member(tf, f"{key}.spk", spk.encode())
    return shard_path


def make_shard_list(wav_scp, utt2spk, shards_dir, shards_list,
                    num_utts_per_shard=1000, num_threads=4,
                    resample_rate=16000, shuffle=True, seed=42):
    """wav.scp + utt2spk -> tar shards `shards_dir/shards_<i:09d>.tar` of
    `num_utts_per_shard` utterances each, after numpy's default_rng(seed)
    shuffle of the list, and the list of their paths
    (tools/make_shard_list.py). `num_threads` spawned processes write the
    shards. Returns the shard paths."""
    u2s = read_utt2spk(utt2spk)
    items = [(k, u2s[k], p) for k, p in read_scp(wav_scp) if k in u2s]
    if shuffle:
        np.random.default_rng(seed).shuffle(items)
    os.makedirs(shards_dir, exist_ok=True)
    tasks = []
    for i in range(0, len(items), num_utts_per_shard):
        shard_path = os.path.join(shards_dir,
                                  f"shards_{i // num_utts_per_shard:09d}.tar")
        tasks.append((shard_path, items[i:i + num_utts_per_shard],
                      resample_rate))
    if num_threads > 1 and len(tasks) > 1:
        ctx = multiprocessing.get_context("spawn")
        # the workers import this module and data/ only, not the caller
        with _main_hidden(), ctx.Pool(min(num_threads, len(tasks))) as pool:
            paths = pool.map(_write_one_shard, tasks)
    else:
        paths = [_write_one_shard(t) for t in tasks]
    with open(shards_list, "w") as f:
        for p in paths:
            f.write(p + "\n")
    return paths


def make_aug_store(wav_scp, out_prefix, sample_rate=16000,
                   max_duration_s=None):
    """A MUSAN or RIR wav.scp -> the packed store <out_prefix>.bin /
    .idx.npz (data/store.py; upstream tools/make_lmdb.py)."""
    return build_packed_store(read_scp(wav_scp), out_prefix, sample_rate,
                              max_duration_s)


def make_feat_list(feat_scp, utt2spk, out_list):
    """feats.scp + utt2spk -> the feature list of `data_type: feat`
    (upstream tools/make_feat_list.py): the scp lines in order, each key
    required to have a speaker."""
    u2s = read_utt2spk(utt2spk)
    with open(out_list, "w") as fout:
        for key, path in read_scp(feat_scp):
            if key not in u2s:
                raise KeyError(f"{key} missing from utt2spk")
            fout.write(f"{key} {path}\n")


def wav2dur(wav_scp, out_path):
    """`key seconds` (3 decimals) per utterance of wav.scp; returns the
    total (tools/wav2dur.py). The RIFF header's frame count and rate."""
    total = 0.0
    with open(out_path, "w") as fout:
        for key, path in read_scp(wav_scp):
            with wave.open(path, "rb") as w:
                dur = w.getnframes() / w.getframerate()
            total += dur
            fout.write(f"{key} {dur:.3f}\n")
    return total


def vector_mean(spk2utt, xvector_scp, out_prefix):
    """Per-speaker mean of utterance embeddings (tools/vector_mean.py:25-53),
    the multi-utterance enrollment of CNC-Eval-Avg."""
    utt2emb = read_vec_scp_dict(xvector_scp)

    def items():
        with open(spk2utt) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                spk, utts = parts[0], parts[1:]
                vecs = [utt2emb[u] for u in utts if u in utt2emb]
                if vecs:
                    yield spk, np.mean(vecs, axis=0)

    return write_vec_ark_scp(out_prefix, items())


def generate_calibration_trial(utt2spk, out_trials, num_target=1000,
                               num_nontarget=1000, seed=0):
    """Same- and different-speaker calibration trials drawn from utt2spk
    (tools/generate_calibration_trial.py), the JAX package's draws from
    numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    u2s = read_utt2spk(utt2spk)
    spk2utts: Dict[str, List[str]] = {}
    for u, s in u2s.items():
        spk2utts.setdefault(s, []).append(u)
    utts = list(u2s)
    spks = [s for s, us in spk2utts.items() if len(us) >= 2]
    with open(out_trials, "w") as f:
        for _ in range(num_target):
            s = spks[rng.integers(0, len(spks))]
            a, b = rng.choice(spk2utts[s], 2, replace=False)
            f.write(f"{a} {b} target\n")
        for _ in range(num_nontarget):
            while True:
                a, b = rng.choice(utts, 2, replace=False)
                if u2s[a] != u2s[b]:
                    break
            f.write(f"{a} {b} nontarget\n")
    return out_trials


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("raw")
    r.add_argument("--wav_scp", required=True)
    r.add_argument("--utt2spk", required=True)
    r.add_argument("--out_list", required=True)
    r.add_argument("--vad_file", default=None)
    s = sub.add_parser("shard")
    s.add_argument("--wav_scp", required=True)
    s.add_argument("--utt2spk", required=True)
    s.add_argument("--shards_dir", required=True)
    s.add_argument("--shards_list", required=True)
    s.add_argument("--num_utts_per_shard", type=int, default=1000)
    s.add_argument("--num_threads", type=int, default=4)
    a = sub.add_parser("aug_store")
    a.add_argument("--wav_scp", required=True)
    a.add_argument("--out_prefix", required=True)
    a.add_argument("--max_duration_s", type=float, default=None)
    fl = sub.add_parser("feat")
    fl.add_argument("--feat_scp", required=True)
    fl.add_argument("--utt2spk", required=True)
    fl.add_argument("--out_list", required=True)
    d = sub.add_parser("wav2dur")
    d.add_argument("--wav_scp", required=True)
    d.add_argument("--out", required=True)
    t = sub.add_parser("calibration_trial")
    t.add_argument("--utt2spk", required=True)
    t.add_argument("--out_trials", required=True)
    v = sub.add_parser("vector_mean")
    v.add_argument("--spk2utt", required=True)
    v.add_argument("--xvector_scp", required=True)
    v.add_argument("--out_prefix", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "raw":
        make_raw_list(args.wav_scp, args.utt2spk, args.out_list,
                      args.vad_file)
    elif args.cmd == "shard":
        make_shard_list(args.wav_scp, args.utt2spk, args.shards_dir,
                        args.shards_list, args.num_utts_per_shard,
                        args.num_threads)
    elif args.cmd == "aug_store":
        make_aug_store(args.wav_scp, args.out_prefix,
                       max_duration_s=args.max_duration_s)
    elif args.cmd == "feat":
        make_feat_list(args.feat_scp, args.utt2spk, args.out_list)
    elif args.cmd == "wav2dur":
        wav2dur(args.wav_scp, args.out)
    elif args.cmd == "vector_mean":
        vector_mean(args.spk2utt, args.xvector_scp, args.out_prefix)
    else:
        generate_calibration_trial(args.utt2spk, args.out_trials)


if __name__ == "__main__":
    main()
