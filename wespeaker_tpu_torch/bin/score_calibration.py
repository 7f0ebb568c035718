"""QMF calibration CLI: train and infer.

    python -m wespeaker_tpu_torch.bin.score_calibration train \
        --score_norm_file cal.norm.score --save_model_path qmf.npz \
        [--wav_dur_scp utt2dur] [--device cuda|cpu]
    python -m wespeaker_tpu_torch.bin.score_calibration infer \
        --score_norm_file trials.norm.score --model_path qmf.npz \
        --out_score_file trials.qmf [--wav_dur_scp utt2dur] \
        [--device cuda|cpu]

Counterpart of wespeaker_tpu/bin/score_calibration.py (upstream
wespeaker/bin/score_calibration.py): the quality factors of each trial
from a score_norm output file (`enroll test score label enroll_mag
test_mag enroll_cohort_mean test_cohort_mean`) and, with --wav_dur_scp,
the durations; a linear model fit on Cllr with scipy's L-BFGS-B in f64 on
the host (backend/calibration.py), as in the JAX package; `--device` is
resolved as every entry point's is. The model file is the JAX package's
`.npz`, which either package reads.
"""

import argparse

import numpy as np

from wespeaker_tpu_torch.backend.calibration import (QMFCalibrator,
                                                     build_factors)
from wespeaker_tpu_torch.device import DeviceLike, resolve_device


def _read_norm_file(path, wav2dur=None, max_dur=20.0):
    with open(path) as f:
        rows = [line.split() for line in f]
    col = [np.asarray([float(r[i]) for r in rows]) for i in range(4, 8)]
    kw = dict(enroll_mag=col[0], test_mag=col[1], enroll_cohort_mean=col[2],
              test_cohort_mean=col[3], max_dur=max_dur)
    if wav2dur:
        kw["enroll_dur"] = np.asarray([wav2dur[r[0]] for r in rows])
        kw["test_dur"] = np.asarray([wav2dur[r[1]] for r in rows])
    factors = build_factors(np.asarray([float(r[2]) for r in rows]), **kw)
    return rows, factors, [r[3] for r in rows]


def read_wav2dur(path):
    out = {}
    with open(path) as f:
        for line in f:
            k, d = line.split()
            out[k] = float(d)
    return out


def train_qmf(score_norm_file, save_model_path, wav_dur_scp=None,
              max_dur=20.0, device: DeviceLike = None):
    resolve_device(device)
    wav2dur = read_wav2dur(wav_dur_scp) if wav_dur_scp else None
    _, factors, labels = _read_norm_file(score_norm_file, wav2dur, max_dur)
    y = np.asarray([lab in ("target", "tgt") for lab in labels])
    QMFCalibrator().fit(factors, y).save(save_model_path)
    return save_model_path


def infer_qmf(score_norm_file, model_path, out_score_file, wav_dur_scp=None,
              max_dur=20.0, device: DeviceLike = None):
    resolve_device(device)
    wav2dur = read_wav2dur(wav_dur_scp) if wav_dur_scp else None
    rows, factors, _ = _read_norm_file(score_norm_file, wav2dur, max_dur)
    out = QMFCalibrator.load(model_path)(factors)
    with open(out_score_file, "w") as f:
        for r, s in zip(rows, out):
            f.write(f"{r[0]} {r[1]} {s:.5f} {r[3]}\n")
    return out_score_file


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train")
    t.add_argument("--score_norm_file", required=True)
    t.add_argument("--save_model_path", required=True)
    i = sub.add_parser("infer")
    i.add_argument("--score_norm_file", required=True)
    i.add_argument("--model_path", required=True)
    i.add_argument("--out_score_file", required=True)
    for p in (t, i):
        p.add_argument("--wav_dur_scp", default=None)
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.cmd == "train":
        train_qmf(args.score_norm_file, args.save_model_path,
                  args.wav_dur_scp, device=args.device)
    else:
        infer_qmf(args.score_norm_file, args.model_path, args.out_score_file,
                  args.wav_dur_scp, device=args.device)


if __name__ == "__main__":
    main()
