"""Verification metrics: EER, minDCF, DET points.

A copy of wespeaker_tpu/backend/metrics.py (upstream
wespeaker/utils/score_metrics.py: compute_pmiss_pfa_rbst:58,
compute_eer:79, compute_c_norm:96, plot_det_curve:119): the NIST SRE16
robust miss and false-alarm curves with the linearly interpolated EER, in
numpy f64, so its results equal the JAX package's to the bit.
"""

from typing import Optional, Tuple

import numpy as np


def pmiss_pfa(scores: np.ndarray, labels: np.ndarray,
              weights: Optional[np.ndarray] = None):
    """Robust FNR/FPR curves over score-sorted operating points."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    order = np.argsort(scores)
    labels = labels[order]
    w = np.ones(labels.shape, np.float64) if weights is None else \
        np.asarray(weights, np.float64)[order]
    tgt = w * (labels == 1)
    imp = w * (labels == 0)
    fnr = np.cumsum(tgt) / np.sum(tgt)
    fpr = 1 - np.cumsum(imp) / np.sum(imp)
    return fnr, fpr


def eer(fnr: np.ndarray, fpr: np.ndarray,
        scores: Optional[np.ndarray] = None):
    """Interpolated equal error rate; optionally also the threshold.
    Perfectly-separated scores (fnr-fpr never changes sign) yield EER 0."""
    diff = fnr - fpr
    above = np.flatnonzero(diff >= 0)
    below = np.flatnonzero(diff < 0)
    if len(above) == 0 or len(below) == 0:
        x = above[0] if len(above) else below[-1]
        value = 0.0
        if scores is not None:
            return value, np.sort(np.asarray(scores))[x]
        return value
    x1 = above[0]
    x2 = below[-1]
    a = (fnr[x1] - fpr[x1]) / (fpr[x2] - fpr[x1] - (fnr[x2] - fnr[x1]))
    value = fnr[x1] + a * (fnr[x2] - fnr[x1])
    if scores is not None:
        return value, np.sort(np.asarray(scores))[x1]
    return value


def min_dcf(fnr: np.ndarray, fpr: np.ndarray, p_target: float = 0.01,
            c_miss: float = 1.0, c_fa: float = 1.0) -> float:
    """Normalized minimum detection cost."""
    c_det = np.min(c_miss * fnr * p_target + c_fa * fpr * (1 - p_target))
    c_def = min(c_miss * p_target, c_fa * (1 - p_target))
    return float(c_det / c_def)


def compute_metrics(scores: np.ndarray, labels: np.ndarray,
                    p_target: float = 0.01, c_miss: float = 1.0,
                    c_fa: float = 1.0) -> Tuple[float, float, float]:
    """(EER%, threshold, minDCF) — wespeaker/bin/compute_metrics.py:26-59."""
    fnr, fpr = pmiss_pfa(scores, labels)
    e, thr = eer(fnr, fpr, scores)
    dcf = min_dcf(fnr, fpr, p_target, c_miss, c_fa)
    return float(e * 100), float(thr), dcf


def labels_from_strings(labels):
    """'target'/'tgt' -> 1 else 0."""
    return np.asarray([1 if l in ("target", "tgt") else 0 for l in labels])


def det_curve_points(fnr, fpr):
    """Probit-warped DET points (for plotting / compute_det.py)."""
    from scipy.stats import norm
    with np.errstate(divide="ignore"):
        return norm.ppf(fnr), norm.ppf(fpr)
