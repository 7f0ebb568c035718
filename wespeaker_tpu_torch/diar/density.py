"""Native HDBSCAN for subsegment-embedding clustering.

Implements the exact (dense) HDBSCAN* algorithm of Campello/Moulavi/Sander —
mutual-reachability distances, MST single-linkage hierarchy, condensed tree,
stability-based Excess-of-Mass cluster extraction — so the reference's
UMAP+HDBSCAN diarization backend (wespeaker/diar/umap_clusterer.py:229-243)
runs without the third-party `hdbscan` package. Diarization recordings yield
O(1e3-1e4) subsegments, where the dense O(n^2) formulation is both exact and
fast; parity with the reference is at the DER level (cluster structure), as
label identity is not defined across implementations.

Host numpy, a copy of wespeaker_tpu/diar/density.py: at the subsegment
counts of a long recording (~2,300) the dense distance is milliseconds.
"""

from typing import List, Optional

import numpy as np


def pairwise_dist(x: np.ndarray, metric: str) -> np.ndarray:
    """Dense pairwise distances; metric in {"cosine", "euclidean"}."""
    if metric == "cosine":
        e = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        d = np.maximum(1.0 - e @ e.T, 0.0)
    elif metric == "euclidean":
        sq = np.sum(x * x, axis=1)
        d = np.sqrt(np.maximum(
            sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0))
    else:
        raise ValueError(f"unknown metric '{metric}' "
                         "(supported: cosine, euclidean)")
    np.fill_diagonal(d, 0.0)
    return d


def mutual_reachability(dist: np.ndarray, min_samples: int) -> np.ndarray:
    """max(core_i, core_j, d_ij) with core_i = distance to the
    min_samples-th nearest neighbor (self counted at index 0)."""
    n = dist.shape[0]
    k = min(min_samples, n - 1)
    core = np.partition(dist, k, axis=1)[:, k]
    return np.maximum(np.maximum(core[:, None], core[None, :]), dist)


def mst_edges(graph: np.ndarray) -> np.ndarray:
    """Prim's MST on a dense symmetric distance matrix -> (n-1, 3) rows
    (u, v, weight), unordered."""
    n = graph.shape[0]
    in_tree = np.zeros(n, bool)
    best = np.full(n, np.inf)
    best_from = np.zeros(n, np.int64)
    edges = np.empty((n - 1, 3))
    current = 0
    in_tree[0] = True
    for i in range(n - 1):
        d = graph[current]
        closer = ~in_tree & (d < best)
        best[closer] = d[closer]
        best_from[closer] = current
        best[current] = np.inf
        nxt = int(np.argmin(np.where(in_tree, np.inf, best)))
        edges[i] = (best_from[nxt], nxt, best[nxt])
        in_tree[nxt] = True
        current = nxt
    return edges


class _UnionFind:
    """Union-find over original points + merge nodes, scipy-linkage style:
    the i-th union creates node n+i."""

    def __init__(self, n: int):
        self.parent = np.arange(2 * n - 1, dtype=np.int64)
        self.size = np.concatenate(
            [np.ones(n, np.int64), np.zeros(n - 1, np.int64)])
        self.next_label = n

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, x: int, y: int) -> int:
        label = self.next_label
        self.parent[x] = self.parent[y] = label
        self.size[label] = self.size[x] + self.size[y]
        self.next_label += 1
        return label


def single_linkage_tree(edges: np.ndarray, n: int) -> np.ndarray:
    """Sorted-MST agglomeration -> (n-1, 4) rows (left, right, dist, size)."""
    order = np.argsort(edges[:, 2], kind="stable")
    uf = _UnionFind(n)
    tree = np.empty((n - 1, 4))
    for i, e in enumerate(order):
        u, v, w = edges[e]
        ru, rv = uf.find(int(u)), uf.find(int(v))
        tree[i] = (ru, rv, w, uf.size[ru] + uf.size[rv])
        uf.union(ru, rv)
    return tree


def condense_tree(linkage: np.ndarray, n: int,
                  min_cluster_size: int) -> np.ndarray:
    """Collapse the dendrogram into clusters of >= min_cluster_size.

    Returns rows (parent, child, lambda_val, child_size) where ids < n are
    points and ids >= n are condensed clusters (root = n). lambda = 1/dist.
    A split where both sides are big spawns two child clusters; otherwise
    small-side points fall out of the parent at that lambda.
    """
    children = {}  # linkage node -> (left, right, dist)
    sizes = np.ones(2 * n - 1, np.int64)
    for i in range(n - 1):
        left, right, dist, size = linkage[i]
        children[n + i] = (int(left), int(right), dist)
        sizes[n + i] = int(size)

    if min_cluster_size < 2:
        raise ValueError("min_cluster_size must be >= 2")
    rows = []
    # (linkage node, condensed cluster id it belongs to); points always
    # leave via the fallout branch below (their size 1 < min_cluster_size),
    # so the stack only ever holds internal nodes
    next_cluster = n + 1
    stack = [(2 * n - 2, n)]
    while stack:
        node, cluster = stack.pop()
        left, right, dist = children[node]
        lam = 1.0 / max(dist, 1e-12)  # duplicate points: finite lambda cap
        sl, sr = sizes[left], sizes[right]
        if sl >= min_cluster_size and sr >= min_cluster_size:
            for side, ssize in ((left, sl), (right, sr)):
                rows.append((cluster, next_cluster, lam, int(ssize)))
                stack.append((side, next_cluster))
                next_cluster += 1
        else:
            for side, ssize in ((left, sl), (right, sr)):
                if ssize >= min_cluster_size:
                    stack.append((side, cluster))
                else:
                    # the whole small subtree falls out as points
                    sub = [side]
                    while sub:
                        s = sub.pop()
                        if s < n:
                            rows.append((cluster, s, lam, 1))
                        else:
                            sub.extend(children[s][:2])
    return np.asarray(rows, dtype=np.float64).reshape(-1, 4)


def compute_stability(condensed: np.ndarray) -> dict:
    """stability(c) = sum over exits (lambda_exit - lambda_birth) * size."""
    births = {}
    for parent, child, lam, _ in condensed:
        births[int(child)] = min(lam, births.get(int(child), np.inf))
    stability = {}
    for parent, child, lam, size in condensed:
        p = int(parent)
        birth = births.get(p, 0.0)
        stability[p] = stability.get(p, 0.0) + (lam - birth) * size
    return stability


def hdbscan_labels(x: np.ndarray, min_cluster_size: int = 4,
                   min_samples: Optional[int] = None,
                   allow_single_cluster: bool = False,
                   metric: str = "euclidean") -> List[int]:
    """Cluster labels (noise = -1) via exact HDBSCAN* with EOM selection.

    Mirrors hdbscan.HDBSCAN(min_cluster_size, allow_single_cluster,
    approx_min_span_tree=False) on a dense pairwise-distance matrix.
    """
    x = np.asarray(x, np.float64)
    n = len(x)
    if min_cluster_size < 2:
        raise ValueError("min_cluster_size must be >= 2")
    if n <= 2:
        # mirrors the library: a group smaller than min_cluster_size is
        # noise, unless a single all-points cluster is explicitly allowed
        if allow_single_cluster and n >= min_cluster_size:
            return [0] * n
        return [-1] * n
    min_samples = min_cluster_size if min_samples is None else min_samples

    dist = pairwise_dist(x, metric)
    mreach = mutual_reachability(dist, min_samples)
    np.fill_diagonal(mreach, 0.0)
    linkage = single_linkage_tree(mst_edges(mreach), n)
    condensed = condense_tree(linkage, n, min_cluster_size)
    if len(condensed) == 0:
        return [0] * n if allow_single_cluster else [-1] * n

    stability = compute_stability(condensed)
    cluster_rows = condensed[condensed[:, 1] >= n]
    child_map = {}
    for parent, child, _, _ in cluster_rows:
        child_map.setdefault(int(parent), []).append(int(child))

    # Excess-of-Mass: bottom-up over cluster ids (children always have
    # larger ids than their parent by construction)
    clusters = sorted({int(c) for c in condensed[:, 0]}
                      | {int(c) for c in cluster_rows[:, 1]})
    root = n
    selected = {}
    for c in reversed(clusters):
        kids = child_map.get(c, [])
        subtree = sum(stability.get(k, 0.0) for k in kids)
        if c == root and not allow_single_cluster:
            # the root is not a candidate cluster (hdbscan semantics):
            # its children keep whatever selection they already won
            selected[c] = False
            continue
        if (not kids) or stability.get(c, 0.0) >= subtree:
            selected[c] = True
            # deselect all descendants
            desc = list(kids)
            while desc:
                d = desc.pop()
                selected[d] = False
                desc.extend(child_map.get(d, []))
        else:
            stability[c] = subtree
            selected[c] = False

    # label each point by its nearest selected ancestor cluster
    parent_of = {}
    for parent, child, _, _ in condensed:
        parent_of[int(child)] = int(parent)
    label_ids = sorted(c for c, sel in selected.items() if sel)
    relabel = {c: i for i, c in enumerate(label_ids)}
    labels = np.full(n, -1, np.int64)
    for p in range(n):
        c = parent_of.get(p)
        while c is not None:
            if selected.get(c):
                labels[p] = relabel[c]
                break
            c = parent_of.get(c)
    return list(labels)
