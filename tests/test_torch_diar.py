"""Port parity for diarization's host logic and clustering, against the JAX
package on the CPU (wespeaker_tpu_torch/diar against wespeaker_tpu/diar).

- Exact equality for the copied host logic: subsegment ids and windows
  (the port's one gather against np.resize), `read_labels`,
  `merge_segments`, `write_rttm`/`read_rttm`, `oracle_sad`, `compute_der`
  (random overlapping sets, collar 0 and 0.25), silero's
  `get_speech_timestamps` over random probability tracks (with and without
  `max_speech_s` splits), `energy_probs`, `energy_vad`, `system_sad`,
  HDBSCAN's labels and condensed tree on blobs plus noise, PAHC,
  `fuzzy_graph`, `spectral_init` at n <= 1024, `fit_ab`; `spectral_init`
  above n = 1024 (sparse, ARPACK) spans JAX's subspace (its singular
  values >= 1 - 1e-6) and repeats itself (its start vector comes from the
  seed; JAX's does not repeat).
- Spectral: `cosine_affinity` (float64 embeddings; both sides in f64) and
  the Laplacian within 1e-6, `prune` exactly in both regimes (m < 1000:
  top 10; m >= 1000: the p-quantile) on the same similarity matrix, the
  eigengap count equal; the port's k-means against
  sklearn.cluster.k_means (imported here only, never by the port): the
  same partition and inertia within 1e-6 relative (1e-12 absolute, for
  spectral embeddings whose clusters collapse to points); `cluster` gives
  JAX's partition on separable blobs.
- UMAP: `layout_epoch` against JAX's `_optimize_layout(..., n_epochs=k)`
  for k = 1 and 3 at 1e-5, fed JAX's own draws (the key chain of
  manifold.py:130-147: split(key, 3), uniform, randint) for the real
  edges; `umap_embed` + HDBSCAN and the whole UMAP clusterer give JAX's
  partition on separable blobs; `impl="reference"` is refused.
"""

import io

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import scipy.linalg  # noqa: E402

from wespeaker_tpu.diar import density as jden  # noqa: E402
from wespeaker_tpu.diar import manifold as jman  # noqa: E402
from wespeaker_tpu.diar import pipeline as jpipe  # noqa: E402
from wespeaker_tpu.diar import rttm as jrttm  # noqa: E402
from wespeaker_tpu.diar import spectral_clusterer as jspec  # noqa: E402
from wespeaker_tpu.diar import subsegment as jsub  # noqa: E402
from wespeaker_tpu.diar import umap_clusterer as jumap  # noqa: E402
from wespeaker_tpu.diar import vad as jvad  # noqa: E402
from wespeaker_tpu_torch.diar import density as tden  # noqa: E402
from wespeaker_tpu_torch.diar import manifold as tman  # noqa: E402
from wespeaker_tpu_torch.diar import rttm as trttm  # noqa: E402
from wespeaker_tpu_torch.diar import spectral_clusterer as tspec  # noqa: E402
from wespeaker_tpu_torch.diar import subsegment as tsub  # noqa: E402
from wespeaker_tpu_torch.diar import umap_clusterer as tumap  # noqa: E402
from wespeaker_tpu_torch.diar import vad as tvad  # noqa: E402

torch.set_num_threads(2)


def partition(labels):
    """Labels renamed by first appearance: equal iff the same partition."""
    names = {}
    return [names.setdefault(lab, len(names)) for lab in labels]


def blobs(n_per=40, k=3, dim=32, scale=5.0, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, dim)) * scale
    return np.concatenate([c + rng.normal(size=(n_per, dim))
                           for c in centers])


# ------------------------------------------------------------ subsegment

@pytest.mark.parametrize("num_frames,begin_s,end_s", [
    (98, 0.0, 1.0),       # one repeat-padded window
    (148, 1.2, 2.7),      # seg_length 150: still one window
    (151, 0.0, 1.535),    # just over: two windows, the last short
    (300, 0.0, 3.02),
    (709, 3.25, 10.37)])  # the last window's frames from the fbank's end
def test_subsegment_gather_matches_numpy(num_frames, begin_s, end_s):
    rng = np.random.default_rng(num_frames)
    fbank = rng.normal(size=(num_frames, 40)).astype(np.float32)
    sid = jsub.segment_id("rec-1", begin_s, end_s)
    assert tsub.segment_id("rec-1", begin_s, end_s) == sid
    want_ids, want = jsub.subsegment(fbank, sid, 150, 75)
    got_ids, starts, lengths = tsub.plan(num_frames, sid, 150, 75)
    got = tsub.gather_windows(torch.as_tensor(fbank), starts, lengths, 150)
    assert got_ids == want_ids
    assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------------------ rttm

def _random_segments(rng, utts=("a", "b-1", "c"), spks="ABC", n=8):
    out = {}
    for u in utts:
        segs = []
        for _ in range(n):
            b = float(np.round(rng.uniform(0, 30), 2))
            segs.append((b, float(np.round(b + rng.uniform(0.2, 4), 2)),
                         str(rng.choice(list(spks)))))
        out[u] = segs
    return out


def test_rttm_io_merge_and_oracle_sad_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    lines = []
    for u in ("rec1", "rec-2"):
        for b in range(0, 4000, 750):
            sid = f"{u}-{b:08d}-{b + 2000:08d}"
            for s in range(0, 200, 75):
                lines.append(f"{sid}-{s:08d}-{min(s + 150, 200):08d} "
                             f"{rng.integers(3)}")
    labels = tmp_path / "labels"
    labels.write_text("\n".join(lines) + "\n")
    got = trttm.read_labels(str(labels))
    assert got == jrttm.read_labels(str(labels))
    merged = trttm.merge_segments(got)
    assert merged == jrttm.merge_segments(got)
    bufs = [io.StringIO(), io.StringIO()]
    trttm.write_rttm(merged, bufs[0])
    jrttm.write_rttm(merged, bufs[1])
    assert bufs[0].getvalue() == bufs[1].getvalue()
    path = tmp_path / "hyp.rttm"
    path.write_text(bufs[0].getvalue() + "SPKR-INFO x\n")
    assert trttm.read_rttm(str(path)) == jrttm.read_rttm(str(path))
    for min_dur in (0.255, 1.0):
        assert (trttm.oracle_sad(str(path), min_dur)
                == jrttm.oracle_sad(str(path), min_dur))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_der_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ref = _random_segments(rng)
    hyp = _random_segments(rng, spks="xyzw")
    hyp.pop("c")  # a recording with no hypothesis
    for collar in (0.0, 0.25):
        assert (trttm.compute_der(ref, hyp, collar)
                == jrttm.compute_der(ref, hyp, collar))


# ------------------------------------------------------------------- vad

def _prob_track(rng, n):
    walk = np.cumsum(rng.normal(0, 0.25, n))
    return (1 / (1 + np.exp(-(walk - walk.mean())))).astype(np.float32)


@pytest.mark.parametrize("max_speech_s", [None, 1.0, 3.0])
def test_speech_timestamps_match_jax(max_speech_s):
    rng = np.random.default_rng(7)
    for _ in range(20):
        probs = _prob_track(rng, int(rng.integers(50, 600)))
        threshold = float(rng.choice([0.18, 0.5]))
        args = (probs, 512, len(probs) * 512 - int(rng.integers(0, 511)),
                16000)
        kw = dict(threshold=threshold, max_speech_s=max_speech_s)
        assert (tvad.get_speech_timestamps(*args, **kw)
                == jvad.get_speech_timestamps(*args, **kw))


def test_energy_sad_matches_jax():
    rng = np.random.default_rng(3)
    sr = 16000
    wav = np.zeros(sr * 9, np.float32)
    for b, e in ((0.5, 2.0), (2.2, 4.1), (5.0, 5.2), (6.0, 8.7)):
        n = int((e - b) * sr)
        wav[int(b * sr):int(b * sr) + n] = 0.4 * np.sin(
            2 * np.pi * rng.uniform(150, 600) * np.arange(n) / sr)
    wav += 1e-4 * rng.standard_normal(len(wav)).astype(np.float32)
    assert np.array_equal(tvad.energy_probs(wav, sr),
                          jvad.energy_probs(wav, sr))
    assert tvad.energy_vad(wav, sr) == jpipe.energy_vad(wav, sr)
    for kw in ({}, {"min_duration": 1.0, "threshold": 0.18}):
        assert tvad.system_sad(wav, sr, **kw) == jvad.system_sad(wav, sr,
                                                                 **kw)


# -------------------------------------------------------------- spectral

@pytest.mark.parametrize("n_per,k", [(60, 3), (280, 4)])
def test_affinity_prune_laplacian_and_count_match_jax(n_per, k):
    """m = 180 takes the top-10 regime, m = 1120 the p-quantile one."""
    emb = blobs(n_per, k, dim=24, scale=0.6, seed=n_per)
    got = tspec.cosine_affinity(torch.as_tensor(emb))
    want = jspec.cosine_affinity(emb)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    pruned = tspec.prune(torch.as_tensor(want), 0.01)
    want_pruned = jspec.prune(want, 0.01)
    assert np.array_equal(pruned.numpy(), want_pruned)
    lap = tspec.unnormalized_laplacian(pruned)
    want_lap = jspec.unnormalized_laplacian(want_pruned)
    np.testing.assert_allclose(lap.numpy(), want_lap, rtol=0, atol=1e-6)
    vals, _ = tspec.eigh(lap)
    want_vals = scipy.linalg.eigh(want_lap, eigvals_only=True)
    assert (tspec.num_speakers(vals)
            == int(np.argmax(np.diff(want_vals[:21])) + 1))


def _kmeans_cases():
    emb = blobs(30, 3, dim=16, scale=3.0, seed=5)
    lap = tspec.unnormalized_laplacian(tspec.prune(
        tspec.cosine_affinity(torch.as_tensor(emb)), 0.01))
    spectral = tspec.eigh(lap)[1][:, :3]
    rng = np.random.default_rng(6)
    overlapping = np.concatenate([rng.normal(c, 1.0, (50, 2)) for c in
                                  ((0, 0), (4, 0), (0, 4), (4, 4))])
    return [(spectral, 3), (overlapping, 4)]


def test_kmeans_matches_sklearn():
    from sklearn.cluster import k_means
    for x, k in _kmeans_cases():
        _, want_labels, want_inertia = k_means(x, k, random_state=0,
                                               n_init=10)
        centers, labels, inertia = tspec.kmeans(x, k, seed=0)
        assert partition(labels) == partition(want_labels)
        np.testing.assert_allclose(inertia, want_inertia, rtol=1e-6,
                                   atol=1e-12)
        assert centers.shape == (k, x.shape[1])


def test_spectral_cluster_matches_jax():
    emb = blobs().astype(np.float32)
    want = jspec.cluster(emb)
    assert len(set(want)) == 3
    assert partition(tspec.cluster(torch.as_tensor(emb))) == partition(want)
    assert partition(tspec.cluster(emb, num_spks=3)) == partition(
        jspec.cluster(emb, num_spks=3))
    assert tspec.cluster(emb[:2]) == [0, 0]


# ------------------------------------------------------- HDBSCAN and PAHC

def test_hdbscan_and_condensed_tree_match_jax():
    rng = np.random.default_rng(2)
    x = np.vstack([rng.normal(4.0 * i, 0.4, (25, 6)) for i in range(3)]
                  + [rng.uniform(-4, 12, (12, 6))])
    for metric in ("euclidean", "cosine"):
        d = tden.pairwise_dist(x, metric)
        assert np.array_equal(d, jden.pairwise_dist(x, metric))
        mr = tden.mutual_reachability(d, 4)
        np.fill_diagonal(mr, 0.0)
        tree = tden.single_linkage_tree(tden.mst_edges(mr), len(x))
        assert np.array_equal(tree, jden.single_linkage_tree(
            jden.mst_edges(mr), len(x)))
        assert np.array_equal(tden.condense_tree(tree, len(x), 4),
                              jden.condense_tree(tree, len(x), 4))
        for single in (False, True):
            kw = dict(min_cluster_size=4, allow_single_cluster=single,
                      metric=metric)
            got = tden.hdbscan_labels(x, **kw)
            assert got == jden.hdbscan_labels(x, **kw)
    euclidean = tden.hdbscan_labels(x, 4)
    assert -1 in euclidean and len(set(euclidean)) == 4  # 3 blobs + noise


def test_pahc_matches_jax():
    emb = blobs(30, 3, seed=1)
    rng = np.random.default_rng(4)
    fake = np.repeat(np.arange(5), 18)
    fake[rng.choice(len(fake), 15, replace=False)] = -1
    fake[:2] = 7  # a minor cluster to absorb
    for cutoff in (0.3, 0.6):
        got = tumap.PAHC(merge_cutoff=cutoff).fit_predict(list(fake), emb)
        assert got == jumap.PAHC(merge_cutoff=cutoff).fit_predict(
            list(fake), emb)


# ------------------------------------------------------------------ UMAP

def test_fuzzy_graph_spectral_init_and_fit_ab_match_jax():
    """The dense path (n <= 1024) exactly; the sparse one (n > 1024) by
    its span: JAX leaves ARPACK's start vector to ARPACK's state, so
    its own result moves between calls, while the port draws it from the
    seed and repeats itself."""
    assert tman.fit_ab(0.05) == jman.fit_ab(0.05)
    assert tman.fit_ab(0.3, 1.5) == jman.fit_ab(0.3, 1.5)
    x = blobs(50, 3, dim=12, scale=1.0, seed=50)
    graph = tman.fuzzy_graph(x, 16, "cosine")
    assert np.array_equal(graph, jman.fuzzy_graph(x, 16, "cosine"))
    assert np.array_equal(tman.spectral_init(graph, 8),
                          jman.spectral_init(graph, 8))
    x = np.random.default_rng(9).normal(size=(1100, 6))  # connected
    graph = tman.fuzzy_graph(x, 8, "euclidean")
    assert np.array_equal(graph, jman.fuzzy_graph(x, 8, "euclidean"))
    got = tman.spectral_init(graph, 4)
    assert np.array_equal(got, tman.spectral_init(graph, 4))
    q_t = np.linalg.qr(got.astype(np.float64))[0]
    q_j = np.linalg.qr(jman.spectral_init(graph, 4).astype(np.float64))[0]
    assert np.linalg.svd(q_t.T @ q_j, compute_uv=False).min() > 1 - 1e-6


def _jax_draws(key, n_epochs, e_pad, edge_p, n_real, neg_rate):
    """JAX's per-epoch draws, by manifold.py:130-147's key chain."""
    for _ in range(n_epochs):
        key, k_fire, k_neg = jax.random.split(key, 3)
        active = jax.random.uniform(k_fire, (e_pad,)) < edge_p
        negs = jax.random.randint(k_neg, (e_pad, neg_rate), 0, n_real)
        yield np.asarray(active), np.asarray(negs)


@pytest.mark.parametrize("n_epochs", [1, 3])
def test_layout_epoch_matches_jax_optimize_layout(n_epochs):
    x = blobs(20, 3, dim=10, scale=1.0, seed=3)
    n, dim, neg_rate = len(x), 4, 5
    graph = jman.fuzzy_graph(x, 8, "cosine")
    y0 = jman.spectral_init(graph, dim)
    a, b = jman.fit_ab(0.05)
    rows, cols = np.nonzero(graph)
    w = graph[rows, cols]
    e = len(rows)
    n_pad, e_pad = jman._next_pow2(n, 64), jman._next_pow2(e, 1024)
    y_pad = np.zeros((n_pad, dim), np.float32)
    y_pad[:n] = y0
    heads = np.full(e_pad, n_pad - 1, np.int32)
    tails = np.full(e_pad, n_pad - 1, np.int32)
    probs = np.zeros(e_pad, np.float32)
    heads[:e], tails[:e], probs[:e] = rows, cols, w / w.max()
    key = jax.random.PRNGKey(11)
    want = np.asarray(jman._optimize_layout(
        jnp.asarray(y_pad), jnp.asarray(heads), jnp.asarray(tails),
        jnp.asarray(probs), jnp.int32(n), key, jnp.float32(a),
        jnp.float32(b), n_epochs, neg_rate))[:n]
    y = torch.as_tensor(y0)
    th, tt = torch.as_tensor(rows), torch.as_tensor(cols)
    for ep, (active, negs) in enumerate(_jax_draws(
            key, n_epochs, e_pad, jnp.asarray(probs), n, neg_rate)):
        y = tman.layout_epoch(y, th, tt, torch.tensor(active[:e]),
                              torch.tensor(negs[:e], dtype=torch.int64),
                              a, b, 1.0 - ep / n_epochs)
    assert not np.array_equal(want, y0)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_umap_embed_and_cluster_match_jax_partition():
    emb = blobs(40, 3, dim=32).astype(np.float32)
    got = tman.umap_embed(torch.as_tensor(emb), n_components=16)
    want = jman.umap_embed(emb, n_components=16)
    assert got.shape == want.shape == (120, 16) and got.dtype == np.float32
    got_labels = tden.hdbscan_labels(got, 4, allow_single_cluster=True)
    want_labels = jden.hdbscan_labels(want, 4, allow_single_cluster=True)
    assert partition(got_labels) == partition(want_labels)
    assert len(set(want_labels) - {-1}) == 3
    want = jumap.cluster(emb)
    assert partition(tumap.cluster(torch.as_tensor(emb))) == partition(want)
    assert len(set(want)) == 3
    with pytest.raises(NotImplementedError, match="umap-learn"):
        tumap.cluster(emb, impl="reference")
    with pytest.raises(ValueError, match="unknown impl"):
        tumap.cluster(emb, impl="other")
