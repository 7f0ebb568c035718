"""UMAP + HDBSCAN clustering with PAHC agglomerative repair.

Counterpart of wespeaker_tpu/diar/umap_clusterer.py (upstream
wespeaker/diar/umap_clusterer.py, PAHC:37, cluster:224): native UMAP
(`diar/manifold.py`, its layout on the embeddings' device) + native exact
HDBSCAN (`diar/density.py`, host) + PAHC (host, copied). The JAX
package's `impl="reference"` routes through the third-party umap-learn
and hdbscan packages; the card's machine has neither, so the port refuses
it.
"""

import heapq
from collections import defaultdict
from typing import Callable, List, Optional

import numpy as np
import torch

from wespeaker_tpu_torch.diar.density import hdbscan_labels
from wespeaker_tpu_torch.diar.manifold import umap_embed


class PAHC:
    """Probability-aware agglomerative repair of HDBSCAN labels: greedily
    merge clusters by normalized summed-cosine cost, then absorb minor
    clusters into their closest major cluster."""

    def __init__(self, merge_cutoff=0.3, min_cluster_size=3,
                 absorb_cutoff=0.0):
        self.merge_cutoff = merge_cutoff
        self.min_cluster_size = min_cluster_size
        self.absorb_cutoff = absorb_cutoff

    def fit_predict(self, labels, embeddings) -> List[int]:
        embeddings = np.asarray(embeddings)
        normed = embeddings / np.linalg.norm(embeddings, axis=1,
                                             keepdims=True)

        # cluster index sets; each noise point (-1) becomes its own cluster
        label_map = defaultdict(list)
        for i, lab in enumerate(labels):
            label_map[lab].append(i)
        num_labeled = len(label_map) - (1 if -1 in label_map else 0)
        clusters = {}
        for k in sorted(k for k in label_map if k != -1):
            clusters[len(clusters)] = list(label_map[k])
        for idx in label_map.get(-1, []):
            clusters[len(clusters)] = [idx]

        active = set(clusters)
        next_index = len(clusters)
        # cost(i, j) = sum-vector dot product; merging adds costs linearly
        sums = {k: normed[v].sum(axis=0) for k, v in clusters.items()}
        cost = {}
        heap = []
        keys = sorted(clusters)
        for a in range(len(keys)):
            for b in range(a + 1, len(keys)):
                i, j = keys[a], keys[b]
                if i < num_labeled and j < num_labeled:
                    cost[(i, j)] = -np.inf
                    continue
                c = float(np.dot(sums[i], sums[j]))
                cost[(i, j)] = c
                norm_c = c / (len(clusters[i]) * len(clusters[j]))
                if norm_c >= self.merge_cutoff:
                    heapq.heappush(heap, (-norm_c, (i, j)))

        while heap:
            _, (i, j) = heapq.heappop(heap)
            if i not in active or j not in active:
                continue
            # merge i+j into a fresh index, updating costs linearly
            for k in list(active):
                if k in (i, j):
                    continue
                p1 = (min(k, i), max(k, i))
                p2 = (min(k, j), max(k, j))
                c = cost[p1] + cost[p2]
                cost[(k, next_index)] = c
                norm_c = c / ((len(clusters[i]) + len(clusters[j]))
                              * len(clusters[k]))
                if norm_c >= self.merge_cutoff:
                    heapq.heappush(heap, (-norm_c, (k, next_index)))
            clusters[next_index] = clusters[i] + clusters[j]
            sums[next_index] = sums[i] + sums[j]
            active.add(next_index)
            for dead in (i, j):
                active.remove(dead)
                del clusters[dead]
            next_index += 1

        # absorb minor clusters into the closest major one
        minors = {k for k in clusters
                  if len(clusters[k]) < self.min_cluster_size}
        majors = set(clusters) - minors
        if majors:
            for i in sorted(minors):
                best, best_cost = None, -np.inf
                for j in majors:
                    pair = (min(i, j), max(i, j))
                    c = cost.get(pair)
                    if c is None:
                        c = float(np.dot(sums[i], sums[j]))
                    norm_c = c / (len(clusters[i]) * len(clusters[j]))
                    if norm_c > best_cost:
                        best_cost, best = norm_c, j
                if best_cost >= self.absorb_cutoff:
                    clusters[best].extend(clusters[i])
                    del clusters[i]

        out = [-1] * len(labels)
        for k, idxs in clusters.items():
            for idx in idxs:
                out[idx] = k
        remap = {}
        for lab in out:
            if lab not in remap:
                remap[lab] = len(remap)
        return [remap[lab] for lab in out]


def cluster(embeddings, n_neighbors=16, min_dist=0.05,
            impl: str = "native",
            mark: Optional[Callable[[str], None]] = None) -> List[int]:
    """UMAP(32d, cosine) -> HDBSCAN(min_cluster 4, single-cluster ok) ->
    PAHC repair. `embeddings`: (n, d), a tensor (the layout runs on its
    device) or an array. `mark(stage)`, where given, is called as each
    stage ends: umap_embed's two, "HDBSCAN", "PAHC"."""
    if impl == "reference":
        raise NotImplementedError(
            "impl='reference' needs the third-party umap-learn (umap) and "
            "hdbscan packages, which the port does not use; impl='native' "
            "is the port's")
    if impl != "native":
        raise ValueError(f"unknown impl '{impl}' "
                         "(choices: native, reference)")
    mark = mark or (lambda stage: None)
    if len(embeddings) <= 2:
        return [0] * len(embeddings)

    n_components = min(32, len(embeddings) - 2)
    reduced = umap_embed(embeddings, n_components=n_components,
                         n_neighbors=n_neighbors, min_dist=min_dist,
                         metric="cosine", mark=mark)
    labels = hdbscan_labels(reduced, min_cluster_size=4,
                            allow_single_cluster=True)
    mark("HDBSCAN")
    host = (embeddings.cpu().numpy() if isinstance(embeddings, torch.Tensor)
            else np.asarray(embeddings))
    labels = PAHC(merge_cutoff=0.3, min_cluster_size=3,
                  absorb_cutoff=0.0).fit_predict(labels, host)
    mark("PAHC")
    return labels
