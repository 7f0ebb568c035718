"""Cosine trial scoring CLI, on the card.

    python -m wespeaker_tpu_torch.bin.score --exp_dir exp \
        --eval_scp_path emb.scp [--cal_mean_dir dir] [--device cpu] \
        trials [trials ...]

Counterpart of wespeaker_tpu/bin/score.py (upstream wespeaker/bin/
score.py:38-95): with `cal_mean_dir` the mean of `<dir>/xvector.scp` is
saved to `<dir>/mean_vec.npy` and subtracted; each trial file gives
`<exp_dir>/scores/<trials>.score` (or `store_dir`) with lines `enroll test
score [label]`, the score to 5 decimals.
"""

import argparse
import os

import numpy as np

from wespeaker_tpu_torch.backend.scoring import (TrialScorer,
                                                 compute_mean_vec,
                                                 read_trials)
from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.utils.kaldi_io import read_vec_scp, read_vec_scp_dict


def score(exp_dir, eval_scp_path, cal_mean_dir=None, trials=(),
          store_dir=None, device: DeviceLike = None):
    """Returns the .score paths written."""
    device = resolve_device(device)
    mean_vec = None
    if cal_mean_dir:
        mean_vec = compute_mean_vec(read_vec_scp(
            os.path.join(cal_mean_dir, "xvector.scp")))
        np.save(os.path.join(cal_mean_dir, "mean_vec.npy"), mean_vec)
    scorer = TrialScorer(read_vec_scp_dict(eval_scp_path), mean_vec,
                         device=device)
    store_dir = store_dir or os.path.join(exp_dir, "scores")
    os.makedirs(store_dir, exist_ok=True)
    outputs = []
    for trial in trials:
        pairs, labels = read_trials(trial)
        scores = scorer.score_trials(pairs)
        out = os.path.join(store_dir, os.path.basename(trial) + ".score")
        with open(out, "w") as f:
            for (a, b), s, lab in zip(pairs, scores, labels):
                f.write(f"{a} {b} {s:.5f}" + (f" {lab}\n" if lab else "\n"))
        outputs.append(out)
    return outputs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp_dir", required=True)
    ap.add_argument("--eval_scp_path", required=True)
    ap.add_argument("--cal_mean_dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("trials", nargs="+")
    args = ap.parse_args(argv)
    score(args.exp_dir, args.eval_scp_path, args.cal_mean_dir, args.trials,
          device=args.device)


if __name__ == "__main__":
    main()
