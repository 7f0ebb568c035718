"""EER / minDCF CLI.

    python -m wespeaker_tpu_torch.bin.compute_metrics [--p_target 0.01] \
        [--c_miss 1] [--c_fa 1] [--det_png det.png] scores [scores ...]

Counterpart of wespeaker_tpu/bin/compute_metrics.py (upstream
wespeaker/bin/compute_metrics.py:26-59): per score file (`enroll test
score label` lines) it prints `EER = … %`, `threshold = …` and `minDCF
(…) = …`, computed on the host in f64 (backend/metrics.py). `--det_png`
draws the DET curve with matplotlib, which is imported only then: without
matplotlib that option raises ImportError.
"""

import argparse

import numpy as np

from wespeaker_tpu_torch.backend.metrics import (compute_metrics,
                                                 labels_from_strings,
                                                 pmiss_pfa)


def _read_scores(score_file):
    scores, labels = [], []
    with open(score_file) as f:
        for line in f:
            seg = line.split()
            scores.append(float(seg[2]))
            labels.append(seg[3])
    return np.asarray(scores), labels_from_strings(labels)


def metrics_for_file(score_file, p_target=0.01, c_miss=1, c_fa=1):
    """Prints and returns (EER %, threshold, minDCF)."""
    scores, y = _read_scores(score_file)
    e, thr, dcf = compute_metrics(scores, y, p_target, c_miss, c_fa)
    print(f"---- {score_file} -----")
    print(f"EER = {e:.3f} %")
    print(f"threshold = {thr:.5f}")
    print(f"minDCF (p_target:{p_target} c_miss:{c_miss} c_fa:{c_fa}) = "
          f"{dcf:.3f}")
    return e, thr, dcf


def plot_det(score_file, out_png):
    """DET curve with probit-warped axes (wespeaker/bin/compute_det.py)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("--det_png needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.stats import norm

    scores, y = _read_scores(score_file)
    fnr, fpr = pmiss_pfa(scores, y)
    with np.errstate(divide="ignore"):
        x, yv = norm.ppf(fpr), norm.ppf(fnr)
    ticks = [0.0001, 0.0002, 0.0005, 0.001, 0.002, 0.005, 0.01, 0.02,
             0.05, 0.1, 0.2, 0.4]
    tick_pos = norm.ppf(ticks)
    tick_labels = [str(t * 100) for t in ticks]
    fig, ax = plt.subplots()
    ax.plot(x, yv)
    ax.set_xticks(tick_pos)
    ax.set_xticklabels(tick_labels, rotation=45)
    ax.set_yticks(tick_pos)
    ax.set_yticklabels(tick_labels)
    ax.set_xlabel("False Alarm probability (%)")
    ax.set_ylabel("Miss probability (%)")
    ax.grid(True)
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    return out_png


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--p_target", type=float, default=0.01)
    ap.add_argument("--c_miss", type=float, default=1)
    ap.add_argument("--c_fa", type=float, default=1)
    ap.add_argument("--det_png", default=None)
    ap.add_argument("scores", nargs="+")
    args = ap.parse_args(argv)
    for f in args.scores:
        metrics_for_file(f, args.p_target, args.c_miss, args.c_fa)
        if args.det_png:
            plot_det(f, args.det_png)


if __name__ == "__main__":
    main()
