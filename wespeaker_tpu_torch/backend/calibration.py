"""QMF score calibration: a linear model on quality factors, trained on
Cllr, on the host in f64.

Counterpart of wespeaker_tpu/backend/calibration.py (upstream
wespeaker/bin/score_calibration.py: gather_calibration_factors:30 builds
[score, dur stats, magnitude stats, cohort-mean stats] per trial;
cllr:82; train_calibration_model:95 fits a one-layer linear model with
LBFGS; infer_calibration:142). The model is y = w.x + b; Cllr is convex
in (w, b) and is solved with scipy's L-BFGS-B in f64, as in the JAX
package. `save` writes the JAX package's `.npz` ({weight, bias}), and
`load` reads the JAX package's files unchanged.
"""

from typing import Optional

import numpy as np
from scipy.optimize import minimize


def reorder_values(a: float, b: float):
    """(min, max, max-min, max/min) — score_calibration.py:40-44."""
    lo, hi = min(a, b), max(a, b)
    return [lo, hi, hi - lo, hi / lo]


def build_factors(scores: np.ndarray,
                  enroll_dur: Optional[np.ndarray] = None,
                  test_dur: Optional[np.ndarray] = None,
                  enroll_mag: Optional[np.ndarray] = None,
                  test_mag: Optional[np.ndarray] = None,
                  enroll_cohort_mean: Optional[np.ndarray] = None,
                  test_cohort_mean: Optional[np.ndarray] = None,
                  max_dur: float = 20.0) -> np.ndarray:
    """Assemble the QMF feature matrix: [score, dur(4), mag(4), cohort(4)]
    (duration block dropped when durations are not provided)."""
    cols = [np.asarray(scores, np.float64)[:, None]]
    for kind, a, b in (("dur", enroll_dur, test_dur),
                       ("mag", enroll_mag, test_mag),
                       ("cohort", enroll_cohort_mean, test_cohort_mean)):
        if a is None or b is None:
            continue
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        if kind == "dur":
            a, b = np.minimum(a, max_dur), np.minimum(b, max_dur)
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        cols.append(np.stack([lo, hi, hi - lo, hi / lo], axis=1))
    return np.concatenate(cols, axis=1)


def cllr(target_llrs: np.ndarray, nontarget_llrs: np.ndarray) -> float:
    """Calibration loss (log-likelihood-ratio cost) in bits."""
    def nls(x):  # -log(sigmoid(x)), stable
        return np.logaddexp(0.0, -x)
    return 0.5 * (np.mean(nls(target_llrs))
                  + np.mean(nls(-nontarget_llrs))) / np.log(2)


class QMFCalibrator:
    def __init__(self, weight: Optional[np.ndarray] = None, bias: float = 0.0):
        self.weight = weight
        self.bias = bias

    def fit(self, factors: np.ndarray, is_target: np.ndarray):
        x = np.asarray(factors, np.float64)
        y = np.asarray(is_target).astype(bool)
        d = x.shape[1]
        x0 = np.concatenate([np.full(d, 1.0 / d), [0.0]])

        def objective(wb):
            z = x @ wb[:d] + wb[d]
            return cllr(z[y], z[~y])

        res = minimize(objective, x0, method="L-BFGS-B")
        self.weight, self.bias = res.x[:d], float(res.x[d])
        return self

    def __call__(self, factors: np.ndarray) -> np.ndarray:
        return np.asarray(factors, np.float64) @ self.weight + self.bias

    def save(self, path: str):
        np.savez(path, weight=self.weight, bias=self.bias)

    @classmethod
    def load(cls, path: str) -> "QMFCalibrator":
        with np.load(path, allow_pickle=False) as z:
            return cls(z["weight"], float(z["bias"]))
