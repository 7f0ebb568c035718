"""Data preparation tools: the augmentation stores, feature lists and the
ones the scoring back end needs.

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

Counterpart of wespeaker_tpu/bin/prep_data.py (upstream tools/make_lmdb.py,
tools/make_feat_list.py, tools/wav2dur.py, tools/vector_mean.py,
tools/generate_calibration_trial.py): the same files, line for line;
`aug_store` writes the packed MUSAN/RIR store of data/store.py that the
trainers' `noise_data` / `reverb_data` name. These are file tools on the
host and take no `--device`. The list and shard tools (`raw`, `shard`)
are not ported yet (ROADMAP.md Queue 1 item 8) and raise.
"""

import argparse
import wave
from typing import Dict, List, Tuple

import numpy as np

from wespeaker_tpu_torch.data.store import build_packed_store
from wespeaker_tpu_torch.utils.kaldi_io import (read_vec_scp_dict,
                                                write_vec_ark_scp)

UNPORTED = ("raw", "shard")


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
    for name in UNPORTED:
        sub.add_parser(name)
    args, rest = ap.parse_known_args(argv)
    if args.cmd in UNPORTED:
        raise NotImplementedError(
            f"prep_data {args.cmd} is not ported yet (ROADMAP.md Queue 1 "
            "item 8)")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.cmd == "aug_store":
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
