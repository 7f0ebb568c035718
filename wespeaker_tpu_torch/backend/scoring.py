"""Trial scoring: cosine and AS-Norm/S-Norm on the card.

Counterpart of wespeaker_tpu/backend/scoring.py (upstream
wespeaker/bin/score.py:38-95: per-trial cosine after an optional
train-set mean subtraction; wespeaker/bin/score_norm.py:26-116: L2-norm,
emb @ cohort.T, the top-N z-norm averaged over both sides, and the
magnitudes and cohort means that QMF calibration reads). The whole trial
list is one gather and a batched dot, the cohort statistics one (N, D) x
(D, C) product and a top-k, on `device` (the card unless the caller
passes device="cpu"), in f32 as the JAX package computes them. Scores come
back as numpy f32. Top-k ties may pick other indices than JAX's
`lax.top_k`; the top values, and so their mean and std, are the same.
"""

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from wespeaker_tpu_torch.device import DeviceLike, resolve_device


def _f32(x, dev: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.float32)
    return torch.as_tensor(x, device=dev, dtype=torch.float32)


def _idx(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64), device=dev)


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    if eps:
        n = torch.clamp(n, min=eps)
    return x / n


def cosine_scores(emb, enroll_idx, test_idx,
                  device: DeviceLike = None) -> np.ndarray:
    """emb: (N, D) embeddings (mean already subtracted); enroll_idx,
    test_idx: (T,) rows of emb -> (T,) cosine per trial."""
    dev = resolve_device(device)
    emb = _f32(emb, dev)
    e = l2norm(emb[_idx(enroll_idx, dev)])
    t = l2norm(emb[_idx(test_idx, dev)])
    return (e * t).sum(dim=-1).cpu().numpy()


def _cohort_stats(emb: torch.Tensor, cohort: torch.Tensor, top_n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    scores = l2norm(emb) @ l2norm(cohort).T  # (N, C)
    top = torch.topk(scores, min(int(top_n), cohort.shape[0]), dim=1).values
    return top.mean(dim=1), top.std(dim=1, correction=0)


def cohort_mean_std(emb, cohort, top_n: int, device: DeviceLike = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and std (ddof 0) of each embedding's top_n cohort scores
    (score_norm.py:26-36); top_n is clipped to the cohort size (S-Norm
    passes the whole cohort)."""
    dev = resolve_device(device)
    mean, std = _cohort_stats(_f32(emb, dev), _f32(cohort, dev), top_n)
    return mean.cpu().numpy(), std.cpu().numpy()


def asnorm_scores(raw_scores, enroll_mean, enroll_std, test_mean, test_std,
                  enroll_idx, test_idx, device: DeviceLike = None
                  ) -> np.ndarray:
    """0.5 * (z-norm by the enroll side's cohort statistics + z-norm by
    the test side's) per trial (score_norm.py:104-107)."""
    dev = resolve_device(device)
    raw = _f32(raw_scores, dev)
    ei, ti = _idx(enroll_idx, dev), _idx(test_idx, dev)
    em, es = _f32(enroll_mean, dev)[ei], _f32(enroll_std, dev)[ei]
    tm, ts = _f32(test_mean, dev)[ti], _f32(test_std, dev)[ti]
    return (0.5 * ((raw - em) / es + (raw - tm) / ts)).cpu().numpy()


class TrialScorer:
    """Trial scoring over a dict of embeddings held on `device`: cosine,
    then optionally AS-Norm with the per-trial fields (score, magnitudes,
    cohort means) that QMF calibration reads."""

    def __init__(self, emb_dict: Dict[str, np.ndarray],
                 mean_vec: np.ndarray = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.keys = list(emb_dict)
        self.idx = {k: i for i, k in enumerate(self.keys)}
        emb = np.stack([np.asarray(emb_dict[k], np.float32)
                        for k in self.keys])
        if mean_vec is not None:
            emb = emb - np.asarray(mean_vec, np.float32)
        self.emb = _f32(emb, self.device)

    def _rows(self, trials):
        return (np.asarray([self.idx[a] for a, _ in trials]),
                np.asarray([self.idx[b] for _, b in trials]))

    def score_trials(self, trials: Sequence[Tuple[str, str]]) -> np.ndarray:
        ei, ti = self._rows(trials)
        return cosine_scores(self.emb, ei, ti, device=self.device)

    def asnorm(self, trials: Sequence[Tuple[str, str]],
               raw_scores: np.ndarray, cohort: np.ndarray,
               top_n: int = 300) -> Dict[str, np.ndarray]:
        """Normalized scores and the QMF quality factors."""
        ei, ti = self._rows(trials)
        mean, std = _cohort_stats(self.emb, _f32(cohort, self.device), top_n)
        normed = asnorm_scores(raw_scores, mean, std, mean, std, ei, ti,
                               device=self.device)
        mags = torch.linalg.vector_norm(self.emb, dim=1).cpu().numpy()
        mean = mean.cpu().numpy()
        return {"score": normed, "enroll_mag": mags[ei],
                "test_mag": mags[ti], "enroll_cohort_mean": mean[ei],
                "test_cohort_mean": mean[ti]}


def compute_mean_vec(emb_iter: Iterable[Tuple[str, np.ndarray]]
                     ) -> np.ndarray:
    """Mean embedding over a set (score.py:25-35), summed in f64."""
    total, n = None, 0
    for _, vec in emb_iter:
        total = vec.astype(np.float64) if total is None else total + vec
        n += 1
    return (total / n).astype(np.float32)


def read_trials(path: str) -> Tuple[List[Tuple[str, str]], List[str]]:
    """Trial file: `enroll test [target|nontarget]` per line."""
    pairs, labels = [], []
    with open(path) as f:
        for line in f:
            seg = line.split()
            if not seg:
                continue
            pairs.append((seg[0], seg[1]))
            labels.append(seg[2] if len(seg) > 2 else "")
    return pairs, labels
