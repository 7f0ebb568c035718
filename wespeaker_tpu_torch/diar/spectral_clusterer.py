"""Spectral clustering of subsegment embeddings.

Counterpart of wespeaker_tpu/diar/spectral_clusterer.py (upstream
wespeaker/diar/spectral_clusterer.py:33-90): cosine affinity 0.5(1+cos),
p-pruning to a binary-ish matrix, unnormalized Laplacian, eigengap
speaker-count estimate (max 20), k-means on the first-k eigenvectors.

The affinity, the pruning, the Laplacian and its eigendecomposition run
in float64 on the embeddings' device (the card in diarization): the
eigengap count flips on near-ties in float32. Only the (n, k) spectral
embeddings come back to the host, for the k-means.

The k-means is the port's own (`kmeans`: greedy k-means++ seeding and
Lloyd iterations to a fixed partition, the lowest inertia of n_init
runs), in place of sklearn.cluster.k_means(random_state=None, n_init=10),
which the card's machine lacks. Its draws come from a seeded
np.random.Generator, so the labels are reproducible where the JAX
package's are not.
"""

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


def cosine_affinity(emb: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, n) 0.5 (1 + cosine), in float64 on emb's device."""
    e = emb.double()
    e = e / torch.linalg.norm(e, dim=1, keepdim=True)
    return 0.5 * (1.0 + e @ e.T)


def prune(sim: torch.Tensor, p: float) -> torch.Tensor:
    """Row-wise: keep the top (m-n) entries as 1, zero the rest, then
    symmetrize by averaging."""
    m = sim.shape[0]
    n = max(m - 10, 2) if m < 1000 else int((1.0 - p) * m)
    order = torch.argsort(sim, dim=1, stable=True)
    out = torch.zeros_like(sim).scatter_(1, order[:, n:], 1.0)
    return 0.5 * (out + out.T)


def unnormalized_laplacian(m: torch.Tensor) -> torch.Tensor:
    a = m.clone()
    a.fill_diagonal_(0.0)
    return torch.diag(a.abs().sum(dim=1)) - a


def eigh(lap: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Ascending eigenvalues and eigenvectors of the symmetric Laplacian,
    float64, computed on its device."""
    vals, vecs = torch.linalg.eigh(lap.double())
    return vals.cpu().numpy(), vecs.cpu().numpy()


def num_speakers(eig_values: np.ndarray, max_num_spks: int = 20) -> int:
    """The eigengap estimate: the largest gap among the first
    max_num_spks + 1 eigenvalues."""
    return int(np.argmax(np.diff(eig_values[:max_num_spks + 1])) + 1)


def _sq_dist(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    d = (x * x).sum(1)[:, None] - 2.0 * x @ c.T + (c * c).sum(1)[None]
    return np.maximum(d, 0.0)


def _kmeans_pp(x: np.ndarray, k: int, rng: np.random.Generator
               ) -> np.ndarray:
    """Greedy k-means++ seeding: each new center is the best (lowest
    potential) of 2 + log(k) candidates drawn by squared distance."""
    n = len(x)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]))
    centers[0] = x[rng.integers(n)]
    closest = _sq_dist(x, centers[:1])[:, 0]
    pot = closest.sum()
    for c in range(1, k):
        cand = np.searchsorted(np.cumsum(closest), rng.uniform(size=trials)
                               * pot)
        cand = np.minimum(cand, n - 1)
        dist = np.minimum(closest[None], _sq_dist(x, x[cand]).T)
        best = int(np.argmin(dist.sum(1)))
        centers[c] = x[cand[best]]
        closest, pot = dist[best], dist[best].sum()
    return centers


def _lloyd(x: np.ndarray, centers: np.ndarray, max_iter: int
           ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Lloyd iterations until the partition stops changing. An empty
    cluster takes the point farthest from its own center."""
    k = len(centers)
    labels = np.argmin(_sq_dist(x, centers), axis=1)
    for _ in range(max_iter):
        for c in range(k):
            members = labels == c
            if members.any():
                centers[c] = x[members].mean(0)
            else:
                far = int(np.argmax(_sq_dist(x, centers)[
                    np.arange(len(x)), labels]))
                centers[c], labels[far] = x[far], c
        new = np.argmin(_sq_dist(x, centers), axis=1)
        if np.array_equal(new, labels):
            break
        labels = new
    inertia = float(((x - centers[labels]) ** 2).sum())
    return centers, labels, inertia


def kmeans(x, k: int, n_init: int = 10, seed: int = 0, max_iter: int = 300
           ) -> Tuple[np.ndarray, np.ndarray, float]:
    """(centers, labels, inertia) of the lowest-inertia run of n_init
    k-means++ / Lloyd runs, in float64, draws from np.random.Generator
    (seed)."""
    x = np.asarray(x, np.float64)
    mean = x.mean(0)
    x = x - mean  # distances are shift-invariant; better conditioned
    rng = np.random.default_rng(seed)
    best = None
    for _ in range(n_init):
        run = _lloyd(x, _kmeans_pp(x, k, rng), max_iter)
        if best is None or run[2] < best[2]:
            best = run
    centers, labels, inertia = best
    return centers + mean, labels, inertia


def laplacian(embeddings, p: float = 0.01) -> torch.Tensor:
    """The unnormalized Laplacian of the pruned affinity of (n, d)
    embeddings, float64 on their device."""
    return unnormalized_laplacian(prune(cosine_affinity(
        torch.as_tensor(embeddings)), p))


def cluster(embeddings, p: float = 0.01, num_spks: Optional[int] = None,
            min_num_spks: int = 1, max_num_spks: int = 20, seed: int = 0,
            mark: Optional[Callable[[str], None]] = None) -> List[int]:
    """Labels of (n, d) embeddings (a tensor, on the card in diarization,
    or an array). `mark(stage)`, where given, is called as each stage
    ends: "affinity", "eigh", "k-means"."""
    mark = mark or (lambda stage: None)
    if len(embeddings) <= 2:
        return [0] * len(embeddings)

    lap = laplacian(embeddings, p)
    mark("affinity")
    eig_values, eig_vectors = eigh(lap)
    mark("eigh")
    if num_spks is None:
        num_spks = num_speakers(eig_values, max_num_spks)
    num_spks = max(num_spks, min_num_spks)
    _, labels, _ = kmeans(eig_vectors[:, :num_spks], num_spks, seed=seed)
    mark("k-means")
    return labels.tolist()
