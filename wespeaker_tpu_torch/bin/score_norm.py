"""AS-Norm / S-Norm CLI, on the card.

    python -m wespeaker_tpu_torch.bin.score_norm \
        --score_norm_method asnorm|snorm --top_n 300 \
        --trial_score_file scores/trials.score \
        --score_norm_file scores/trials.norm.score \
        --cohort_emb_scp cohort.scp --eval_emb_scp eval.scp \
        [--mean_vec_path mean_vec.npy] [--device cpu]

Counterpart of wespeaker_tpu/bin/score_norm.py (upstream
wespeaker/bin/score_norm.py:54-116): each trial's score z-normalized
against the top-N cohort statistics of both sides (S-Norm: the whole
cohort), written as `enroll test score label enroll_mag test_mag
enroll_cohort_mean test_cohort_mean`, the fields QMF calibration reads.
"""

import argparse

import numpy as np

from wespeaker_tpu_torch.backend.scoring import asnorm_scores, cohort_mean_std
from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.utils.kaldi_io import read_vec_scp_dict


def score_norm(score_norm_method, top_n, trial_score_file, score_norm_file,
               cohort_emb_scp, eval_emb_scp, mean_vec_path=None,
               device: DeviceLike = None):
    device = resolve_device(device)
    mean_vec = np.load(mean_vec_path) if mean_vec_path else 0.0
    with open(trial_score_file) as f:
        lines = [line.split() for line in f]
    enroll_list = sorted({seg[0] for seg in lines})
    test_list = sorted({seg[1] for seg in lines})

    eval_emb = read_vec_scp_dict(eval_emb_scp)
    enroll = np.stack([eval_emb[k] - mean_vec for k in enroll_list])
    test = np.stack([eval_emb[k] - mean_vec for k in test_list])
    cohort = np.stack([v - mean_vec
                       for v in read_vec_scp_dict(cohort_emb_scp).values()])
    if score_norm_method == "snorm":
        top_n = cohort.shape[0]
    e_mean, e_std = cohort_mean_std(enroll, cohort, top_n, device=device)
    t_mean, t_std = cohort_mean_std(test, cohort, top_n, device=device)
    e_idx = {k: i for i, k in enumerate(enroll_list)}
    t_idx = {k: i for i, k in enumerate(test_list)}
    ei = np.asarray([e_idx[seg[0]] for seg in lines])
    ti = np.asarray([t_idx[seg[1]] for seg in lines])
    raw = np.asarray([float(seg[2]) for seg in lines])
    normed = asnorm_scores(raw, e_mean, e_std, t_mean, t_std, ei, ti,
                           device=device)
    e_mag = np.linalg.norm(enroll, axis=1)
    t_mag = np.linalg.norm(test, axis=1)
    with open(score_norm_file, "w") as fout:
        for i, seg in enumerate(lines):
            label = seg[3] if len(seg) > 3 else ""
            fout.write(
                f"{seg[0]} {seg[1]} {normed[i]:.5f} {label} "
                f"{e_mag[ei[i]]:.4f} {t_mag[ti[i]]:.4f} "
                f"{e_mean[ei[i]]:.4f} {t_mean[ti[i]]:.4f}\n")
    return score_norm_file


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--score_norm_method", default="asnorm",
                    choices=["asnorm", "snorm"])
    ap.add_argument("--top_n", type=int, default=300)
    ap.add_argument("--trial_score_file", required=True)
    ap.add_argument("--score_norm_file", required=True)
    ap.add_argument("--cohort_emb_scp", required=True)
    ap.add_argument("--eval_emb_scp", required=True)
    ap.add_argument("--mean_vec_path", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    score_norm(args.score_norm_method, args.top_n, args.trial_score_file,
               args.score_norm_file, args.cohort_emb_scp, args.eval_emb_scp,
               args.mean_vec_path, device=args.device)


if __name__ == "__main__":
    main()
