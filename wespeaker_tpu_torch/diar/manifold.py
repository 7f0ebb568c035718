"""Native UMAP for subsegment-embedding dimensionality reduction.

Counterpart of wespeaker_tpu/diar/manifold.py, which replaces the
third-party `umap-learn` dependency of the reference's UMAP+HDBSCAN
diarization backend (wespeaker/diar/umap_clusterer.py:227-230): exact kNN
fuzzy-simplicial-set construction (McInnes et al.), spectral
initialization and the curve fit of the low-dimensional kernel are host
numpy/scipy, copied; the stochastic cross-entropy layout optimizer, a
jitted `lax.fori_loop` there, is a loop of torch epochs on the
embeddings' device here (`layout_epoch`, scatter-add updates through
`index_add_`), its draws from a torch.Generator on that device. The
scatter-add sums in fixed point (int64, 2^-32 units), whose sums do not
depend on the order of the card's atomic adds: a layout is the same bits
on every run, where float atomics let HDBSCAN's clusters differ between
runs of the same embeddings.

Deviation from umap-learn, as in the JAX package (DER-level parity is the
contract): edge updates within an epoch are applied synchronously
(batched scatter-add) rather than asynchronously in sample order, and
edges fire with probability w/max_w per epoch rather than on a
deterministic epochs_per_sample schedule. The JAX package pads points and
edges to power-of-two buckets to bound its compile count; torch compiles
nothing, so the port runs the real points and edges only.
"""

import functools
from typing import Callable, Optional

import numpy as np
import torch

from wespeaker_tpu_torch.diar.density import pairwise_dist


def smooth_knn_weights(knn_dist: np.ndarray, n_iter: int = 64,
                       bandwidth_target: Optional[float] = None):
    """Per-point (rho, sigma) calibration: rho = nearest-neighbor distance,
    sigma solves sum_j exp(-(d_ij - rho)/sigma) = log2(k) by bisection.
    Returns membership weights exp(-max(0, d - rho)/sigma), shape of
    knn_dist (n, k)."""
    n, k = knn_dist.shape
    target = (np.log2(k) if bandwidth_target is None else bandwidth_target)
    rho = knn_dist[:, 0].copy()
    lo = np.zeros(n)
    hi = np.full(n, np.inf)
    mid = np.ones(n)
    shifted = np.maximum(knn_dist - rho[:, None], 0.0)
    for _ in range(n_iter):
        val = np.exp(-shifted / mid[:, None]).sum(axis=1)
        too_high = val > target
        hi = np.where(too_high, mid, hi)
        lo = np.where(too_high, lo, mid)
        mid = np.where(np.isinf(hi), lo * 2.0, 0.5 * (lo + hi))
    # umap floors sigma at a fraction of the mean knn distance
    mean_d = knn_dist.mean()
    mid = np.maximum(mid, 1e-3 * np.maximum(mean_d, 1e-12))
    return np.exp(-shifted / mid[:, None])


def fuzzy_graph(x: np.ndarray, n_neighbors: int,
                metric: str = "cosine") -> np.ndarray:
    """Symmetrized fuzzy simplicial set as a dense (n, n) weight matrix:
    W + W^T - W*W^T (probabilistic t-conorm)."""
    n = len(x)
    k = min(n_neighbors, n - 1)
    dist = pairwise_dist(x, metric)
    # exclude self by index, not by sort position: exact-duplicate rows
    # would otherwise keep themselves as a neighbor (self-loop edge)
    np.fill_diagonal(dist, np.inf)
    order = np.argsort(dist, axis=1)[:, :k]
    knn_d = np.take_along_axis(dist, order, axis=1)
    np.fill_diagonal(dist, 0.0)
    w = smooth_knn_weights(knn_d)
    mat = np.zeros((n, n))
    np.put_along_axis(mat, order, w, axis=1)
    return mat + mat.T - mat * mat.T


def spectral_init(graph: np.ndarray, dim: int,
                  seed: int = 2023) -> np.ndarray:
    """Normalized-Laplacian eigenvector initialization scaled to [-10, 10]
    plus a small jitter (umap's 'spectral' init). Only dim+1 bottom
    eigenvectors are needed: large recordings (thousands of subsegments)
    use sparse shift-invert Lanczos on the kNN graph instead of a dense
    O(n^3) eigendecomposition, started from a vector drawn from `seed`."""
    n = graph.shape[0]
    deg = np.maximum(graph.sum(axis=1), 1e-12)
    inv_sqrt = 1.0 / np.sqrt(deg)
    k = min(dim + 1, n)
    if n > 1024 and k < n - 1:
        import scipy.sparse
        import scipy.sparse.linalg
        norm_graph = scipy.sparse.csr_matrix(
            inv_sqrt[:, None] * graph * inv_sqrt[None, :])
        lap = (scipy.sparse.identity(n, format="csr") - norm_graph
               + 1e-6 * scipy.sparse.identity(n, format="csr"))
        # ARPACK's start vector from the seed: the JAX package leaves it
        # to ARPACK's own state, so its result varies from call to call
        v0 = np.random.default_rng(seed).uniform(-1.0, 1.0, n)
        _, vec = scipy.sparse.linalg.eigsh(lap, k=k, sigma=0.0, which="LM",
                                           v0=v0)
    else:
        import scipy.linalg
        lap = np.eye(n) - inv_sqrt[:, None] * graph * inv_sqrt[None, :]
        _, vec = scipy.linalg.eigh(lap, subset_by_index=(0, k - 1))
    emb = vec[:, 1:dim + 1]
    if emb.shape[1] < dim:  # degenerate tiny inputs: pad with zeros
        emb = np.pad(emb, ((0, 0), (0, dim - emb.shape[1])))
    scale = 10.0 / max(np.abs(emb).max(), 1e-12)
    rng = np.random.default_rng(seed)
    return (emb * scale
            + rng.normal(scale=1e-4, size=emb.shape)).astype(np.float32)


@functools.lru_cache(maxsize=32)
def fit_ab(min_dist: float, spread: float = 1.0):
    """Fit the differentiable low-dim kernel 1/(1+a d^{2b}) to the desired
    membership curve (umap.umap_.find_ab_params)."""
    from scipy.optimize import curve_fit
    xv = np.linspace(0.0, spread * 3.0, 300)
    yv = np.where(xv < min_dist, 1.0,
                  np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2.0 * b)),
                          xv, yv)
    return float(a), float(b)


_FIXED = 2.0 ** 32  # fixed-point units of the layout's scatter-add


def _fixed(v: torch.Tensor) -> torch.Tensor:
    return torch.round(v.double() * _FIXED).long()


def layout_epoch(y: torch.Tensor, heads: torch.Tensor, tails: torch.Tensor,
                 active: torch.Tensor, negs: torch.Tensor, a: float,
                 b: float, alpha: float) -> torch.Tensor:
    """One epoch of batched UMAP cross-entropy SGD on (n, dim) y: the
    edges with `active` set pull both endpoints together, and each
    repels its head from its `negs` (E, neg_rate) points; each gradient
    is clipped to +-4 per dimension (umap-learn) and the summed update
    (in fixed point, exact in any order) is scaled by the learning rate
    `alpha`."""
    yh, yt = y[heads], y[tails]
    diff = yh - yt
    d2 = (diff * diff).sum(1)
    att = torch.where(
        d2 > 0.0, (-2.0 * a * b * d2 ** (b - 1.0)) / (1.0 + a * d2 ** b),
        0.0)
    g_att = (att[:, None] * diff).clamp(-4.0, 4.0)
    g_att = _fixed(torch.where(active[:, None], g_att, 0.0))
    upd = torch.zeros(y.shape, dtype=torch.int64, device=y.device)
    upd.index_add_(0, heads, g_att)
    upd.index_add_(0, tails, -g_att)

    diffn = yh[:, None, :] - y[negs]
    d2n = (diffn * diffn).sum(2)
    rep = (2.0 * b) / ((0.001 + d2n) * (1.0 + a * d2n ** b))
    g_rep = (rep[..., None] * diffn).clamp(-4.0, 4.0)
    g_rep = torch.where(active[:, None, None], g_rep, 0.0)
    upd.index_add_(0, heads, _fixed(g_rep.sum(1)))
    return y + alpha * (upd.double() / _FIXED).to(y.dtype)


def optimize_layout(y0: torch.Tensor, heads: torch.Tensor,
                    tails: torch.Tensor, edge_p: torch.Tensor, a: float,
                    b: float, n_epochs: int, neg_rate: int,
                    generator: torch.Generator) -> torch.Tensor:
    """n_epochs of layout_epoch with a linearly decaying learning rate;
    per epoch each edge fires with its probability `edge_p` and draws
    `neg_rate` uniform negatives among the points, from `generator` (on
    y0's device)."""
    dev, n = y0.device, y0.shape[0]
    y = y0
    for ep in range(n_epochs):
        active = torch.rand(edge_p.shape, generator=generator,
                            device=dev) < edge_p
        negs = torch.randint(0, n, (heads.shape[0], neg_rate),
                             generator=generator, device=dev)
        y = layout_epoch(y, heads, tails, active, negs, a, b,
                         1.0 - ep / n_epochs)
    return y


def umap_embed(x, n_components: int = 32, n_neighbors: int = 16,
               min_dist: float = 0.05, metric: str = "cosine",
               n_epochs: Optional[int] = None, seed: int = 2023,
               negative_sample_rate: int = 5,
               mark: Optional[Callable[[str], None]] = None) -> np.ndarray:
    """UMAP embedding of (n, d) -> (n, n_components) float32. The graph
    and the initialization are built on the host; the layout runs on x's
    device (a tensor on the card in diarization, or an array: the CPU).
    `mark(stage)`, where given, is called as each stage ends: "UMAP
    graph+init", then "UMAP layout"."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.asarray(x, np.float64)
    n = len(x)
    if n <= 2 or n_components >= n:
        # passthrough keeps the (n, n_components) shape contract
        out = np.zeros((n, n_components), np.float32)
        d = min(x.shape[1], n_components)
        out[:, :d] = x[:, :d]
        return out
    if n_epochs is None:
        n_epochs = 500 if n <= 10000 else 200
    mark = mark or (lambda stage: None)

    graph = fuzzy_graph(x, n_neighbors, metric)
    y0 = spectral_init(graph, n_components, seed)
    a, b = fit_ab(min_dist)
    rows, cols = np.nonzero(graph)
    w = graph[rows, cols]
    mark("UMAP graph+init")
    y = optimize_layout(
        torch.as_tensor(y0, device=dev),
        torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev),
        torch.as_tensor((w / w.max()).astype(np.float32), device=dev), a, b,
        n_epochs, negative_sample_rate,
        torch.Generator(device=dev).manual_seed(seed))
    y = y.cpu().numpy()
    mark("UMAP layout")
    return y
