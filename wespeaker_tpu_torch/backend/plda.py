"""Two-covariance PLDA (Kaldi's parametrization): training and adaptation
on the host in f64, the log-likelihood ratios of a trial list on the
card.

Counterpart of wespeaker_tpu/backend/plda.py (upstream
wespeaker/utils/plda/two_cov_plda.py: PldaStats:38, em_one_iter:112,
get_output:142, log_likelihood_ratio:165, eval_sv:186, adapt:258;
plda_utils.py: the Kaldi length norm x sqrt(dim)). The estimation works
on D x D matrices and stays numpy/scipy f64 on the host, as in the JAX
package. `llr_scores` is a closed-form diagonal Gaussian ratio, computed
in torch f32 on `device` (the card unless the caller passes "cpu"), one
row per trial. `score_trials` transforms each enroll and each test
embedding once on the host, moves the two tables to the device and
gathers them there by trial index, as backend/scoring.py's TrialScorer
does for cosine: the JAX package stacks one enroll and one test vector per
trial on the host, which at SRE16's ~2 million trials and D = 256 in f64
is gigabytes. The scores are the same.

Persistence: the six fields (mu, transform, psi, offset,
normalize_length, subtract_train_set_mean) as an HDF5 file in the
layout h5py gives the JAX package's `save`, written and read by the
port's own HDF5 subset (utils/hdf5.py; the card's machine has no h5py),
so that a `plda.h5` of either package loads in the other to the bit.
`load` also reads Kaldi's binary `<Plda>` model and the `.npz` archive
that earlier versions of the port wrote under the same names.
"""

import math
import struct
from typing import Dict, Optional

import numpy as np
import torch

from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.utils import hdf5

_KALDI_PLDA = b"\x00B<Plda> "


def norm_embeddings(emb, kaldi_style=True):
    """Unit-length (optionally x sqrt(dim)) normalization
    (plda_utils.py:46-59)."""
    scale = math.sqrt(emb.shape[-1]) if kaldi_style else 1.0
    return scale * emb / np.linalg.norm(emb, axis=-1, keepdims=True)


def _cholesky_whitener(covar):
    try:
        c = np.linalg.cholesky(covar)
    except np.linalg.LinAlgError:
        c = np.linalg.cholesky(covar + np.eye(covar.shape[0]) * 1e-6)
    return np.linalg.inv(c)


class PldaStats:
    """Per-speaker sufficient statistics (two_cov_plda.py:38-63)."""

    def __init__(self, dim):
        self.dim = dim
        self.num_classes = 0
        self.class_weight = 0.0
        self.example_weight = 0.0
        self.sum_ = np.zeros(dim)
        self.offset_scatter = np.zeros((dim, dim))
        self.weights = []
        self.counts = []
        self.means = []

    def add_samples(self, weight, spk_embeddings):
        emb = np.asarray(spk_embeddings, np.float64)
        n = emb.shape[0]
        mean = emb.mean(axis=0)
        centered = emb - mean
        self.offset_scatter += weight * centered.T @ centered
        self.weights.append(weight)
        self.counts.append(n)
        self.means.append(mean)
        self.num_classes += 1
        self.class_weight += weight
        self.example_weight += weight * n
        self.sum_ += weight * mean


def _llr(psi: torch.Tensor, e: torch.Tensor, t: torch.Tensor,
         n: torch.Tensor) -> torch.Tensor:
    """log N(t; n psi/(n psi + 1) e, 1 + psi/(n psi + 1)) - log N(t; 0,
    1 + psi) per row, diagonal (two_cov_plda.py:165). The two
    log-likelihoods are differenced per dimension before the sum: the JAX
    package sums each with its 2 pi constant (~184 at D = 100) and then
    subtracts them, which costs f32 ~1e-5 of every score."""
    mean = n * psi / (n * psi + 1.0) * e
    var_given = 1.0 + psi / (n * psi + 1.0)
    var_without = psi + 1.0
    return -0.5 * (torch.log(var_given / var_without)
                   + (t - mean) ** 2 / var_given
                   - t ** 2 / var_without).sum(dim=1)


class TwoCovPLDA:
    def __init__(self, dim: int = 256, normalize_length: bool = False,
                 subtract_train_set_mean: bool = False):
        self.dim = dim
        self.normalize_length = normalize_length
        self.subtract_train_set_mean = subtract_train_set_mean
        self.mu = np.zeros(dim)
        self.transform = np.eye(dim)
        self.psi = np.zeros(dim)
        self.offset = np.zeros(dim)
        self.B = np.eye(dim)
        self.W = np.eye(dim)
        self.stats: Optional[PldaStats] = None

    # ---------------- estimation (host, f64) ----------------

    def accumulate(self, spk2embeddings: Dict[str, np.ndarray]):
        """spk2embeddings: speaker -> (n_i, D) array."""
        stats = PldaStats(self.dim)
        if self.subtract_train_set_mean:
            allv = np.concatenate([np.asarray(v).reshape(-1, self.dim)
                                   for v in spk2embeddings.values()])
            train_mean = allv.mean(0)
        else:
            train_mean = np.zeros(self.dim)
        for emb in spk2embeddings.values():
            emb = np.asarray(emb, np.float64).reshape(-1, self.dim) - train_mean
            if self.normalize_length:
                emb = norm_embeddings(emb)
            stats.add_samples(1.0, emb)
        self.stats = stats
        self.mu = stats.sum_ / stats.class_weight
        return self

    def em_one_iter(self):
        """One EM step over the per-class stats; the per-speaker solve is
        grouped by example count n (the (B^-1 + n W^-1)^-1 term depends on
        n only)."""
        st = self.stats
        W_stats = st.offset_scatter.copy()
        W_count = st.example_weight - st.class_weight
        B_stats = np.zeros((st.dim, st.dim))
        B_count = 0.0
        B_inv = np.linalg.inv(self.B)
        W_inv = np.linalg.inv(self.W)
        gmean = st.sum_ / st.class_weight

        weights = np.asarray(st.weights)
        counts = np.asarray(st.counts)
        means = np.stack(st.means) - gmean  # (S, D)
        for n in np.unique(counts):
            sel = counts == n
            m = means[sel]  # (Sn, D)
            w8 = weights[sel][:, None]
            mix_var = np.linalg.inv(B_inv + n * W_inv)  # (D, D)
            w = (m @ (n * W_inv).T) @ mix_var.T  # (Sn, D)
            m_w = m - w
            sw = float(np.sum(weights[sel]))
            B_stats += sw * mix_var + (w * w8).T @ w
            B_count += sw
            W_stats += n * (sw * mix_var + (m_w * w8).T @ m_w)
            W_count += sw
        self.W = 0.5 * (W_stats / W_count + (W_stats / W_count).T)
        self.B = 0.5 * (B_stats / B_count + (B_stats / B_count).T)

    def get_output(self):
        """Diagonalize: whiten W (Cholesky), eigh the projected B
        (two_cov_plda.py:142-154)."""
        st = self.stats
        self.mu = st.sum_ / st.class_weight
        t1 = _cholesky_whitener(self.W)
        b_proj = t1 @ self.B @ t1.T
        s, u = np.linalg.eigh(b_proj)
        s = np.maximum(s, 0.0)
        order = np.argsort(-s)
        s, u = s[order], u[:, order]
        self.transform = u.T @ t1
        self.psi = s
        self.offset = -self.transform @ self.mu

    def train(self, spk2embeddings, num_em_iters: int = 5):
        self.accumulate(spk2embeddings)
        for _ in range(num_em_iters):
            self.em_one_iter()
        self.get_output()
        return self

    # ---------------- scoring (device, f32) ----------------

    def transform_embeddings(self, emb: np.ndarray) -> np.ndarray:
        """(N, D) -> (N, D) into the diagonalized space, with the Kaldi
        sqrt(dim)/||x|| renorm when normalize_length is on (host, f64)."""
        emb = np.asarray(emb, np.float64).reshape(-1, self.dim)
        out = emb @ self.transform.T + self.offset
        if self.normalize_length:
            out = out * (math.sqrt(self.dim)
                         / np.linalg.norm(out, axis=1, keepdims=True))
        return out

    def _psi(self, dev: torch.device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.psi, np.float32), device=dev)

    def llr_scores(self, enroll: np.ndarray, test: np.ndarray,
                   enroll_counts: np.ndarray,
                   device: DeviceLike = None) -> np.ndarray:
        """Log-likelihood ratios of aligned (T, D) arrays of *transformed*
        enroll and test embeddings, in f32 on `device`."""
        dev = resolve_device(device)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        n = f32(enroll_counts)[:, None]
        return _llr(self._psi(dev), f32(enroll), f32(test), n).cpu().numpy()

    def trial_tables(self, enroll_dict, test_dict, trials,
                     multisession_avg=True, mean_vec=None):
        """The host side of score_trials, in f64: (enroll table (E, D),
        test table (U, D), enroll counts (E,), enroll row and test row of
        each trial), each side transformed once."""
        mean_vec = np.zeros(self.dim) if mean_vec is None else mean_vec
        pooled, counts = [], []
        for value in enroll_dict.values():
            value = np.asarray(value, np.float64).reshape(-1, self.dim)
            counts.append(1 if multisession_avg else value.shape[0])
            p = (value - mean_vec).mean(0)
            if self.normalize_length:
                p = norm_embeddings(p[None])[0]
            pooled.append(p)
        test = np.stack([np.asarray(v, np.float64) for v in
                         test_dict.values()]) - mean_vec
        if self.normalize_length:
            test = norm_embeddings(test)
        e_row = {k: i for i, k in enumerate(enroll_dict)}
        t_row = {k: i for i, k in enumerate(test_dict)}
        return (self.transform_embeddings(np.stack(pooled)),
                self.transform_embeddings(test), np.asarray(counts),
                np.asarray([e_row[a] for a, _ in trials], np.int64),
                np.asarray([t_row[b] for _, b in trials], np.int64))

    def score_trials(self, enroll_dict, test_dict, trials,
                     multisession_avg=True, mean_vec=None,
                     device: DeviceLike = None) -> np.ndarray:
        """enroll_dict: spk -> (n, D); test_dict: utt -> (D,); trials:
        [(enroll, test)] -> (T,) scores (eval_sv:186-256). Each side is
        transformed once on the host; the trial list is a gather on
        `device`."""
        dev = resolve_device(device)
        tables = self.trial_tables(enroll_dict, test_dict, trials,
                                   multisession_avg, mean_vec)
        e_tab, t_tab, n_tab = (torch.as_tensor(x.astype(np.float32),
                                               device=dev)
                               for x in tables[:3])
        ei, ti = (torch.as_tensor(x, device=dev) for x in tables[3:])
        return _llr(self._psi(dev), e_tab[ei], t_tab[ti],
                    n_tab[ei][:, None]).cpu().numpy()

    # ---------------- adaptation (host, f64) ----------------

    def adapt(self, adapt_embeddings: np.ndarray, ac_scale=0.5,
              wc_scale=0.5) -> "TwoCovPLDA":
        """Unsupervised domain adaptation (BUT method,
        two_cov_plda.py:258-309): the excess variance of the adaptation
        data over the model's total covariance is split between across-
        and within-class."""
        import scipy.linalg as spl
        data = np.asarray(adapt_embeddings, np.float64)
        mean_vec = data.mean(0)
        data = data - mean_vec
        if self.normalize_length:
            data = norm_embeddings(data)
        W = np.linalg.inv(self.transform.T @ self.transform)
        W = (W + W.T) / 2
        B = np.linalg.inv((self.transform.T / self.psi) @ self.transform)
        B = (B + B.T) / 2
        T = B + W
        data_cov = np.cov(data.T)
        v, e = spl.eigh(data_cov, (T + T.T) / 2)
        iet = np.linalg.inv(e.T)
        excess = iet[:, v > 1] @ np.diag(np.sqrt(v[v > 1] - 1))
        B_adp = B + (excess * math.sqrt(ac_scale)) @ (
            excess * math.sqrt(ac_scale)).T
        W_adp = W + (excess * math.sqrt(wc_scale)) @ (
            excess * math.sqrt(wc_scale)).T
        A = (B_adp + B_adp.T) / 2
        Bm = (W_adp + W_adp.T) / 2
        d, vv = np.linalg.eigh(Bm)
        t1 = np.diag(1.0 / np.sqrt(d + 1e-9)) @ vv.T
        a1 = t1 @ A @ t1.T
        d2, t2 = np.linalg.eigh(a1)
        tr = t2.T @ t1
        out = TwoCovPLDA(self.dim, self.normalize_length,
                         self.subtract_train_set_mean)
        # as upstream: mu is the mean of the *centered* (and possibly
        # length-normed) adaptation data (two_cov_plda.py:283)
        out.mu = data.mean(0)
        out.transform = tr
        out.psi = np.diag(tr @ A @ tr.T).copy()
        out.offset = -out.transform @ out.mu
        return out

    # ---------------- persistence ----------------

    def save(self, path: str):
        """The six fields as HDF5 at exactly `path`, as the JAX package's
        h5py writes them."""
        hdf5.write_datasets(path, {
            "mu": self.mu, "transform": self.transform, "psi": self.psi,
            "offset": self.offset,
            "normalize_length": int(self.normalize_length),
            "subtract_train_set_mean": int(self.subtract_train_set_mean)})

    @classmethod
    def load(cls, path: str) -> "TwoCovPLDA":
        """An HDF5 model (either package's), Kaldi's binary `<Plda>`, or
        the `.npz` archive of earlier versions of the port."""
        with open(path, "rb") as f:
            head = f.read(len(_KALDI_PLDA))
        if head.startswith(hdf5.SIGNATURE):
            return cls._from_fields(hdf5.read_datasets(path))
        if head == _KALDI_PLDA:
            return cls.load_kaldi(path)
        with np.load(path, allow_pickle=False) as z:
            return cls._from_fields(dict(z))

    @classmethod
    def _from_fields(cls, fields) -> "TwoCovPLDA":
        obj = cls(dim=fields["mu"].shape[0],
                  normalize_length=bool(fields["normalize_length"]),
                  subtract_train_set_mean=bool(
                      fields["subtract_train_set_mean"]))
        obj.mu, obj.transform = fields["mu"], fields["transform"]
        obj.psi, obj.offset = fields["psi"], fields["offset"]
        return obj

    @classmethod
    def load_kaldi(cls, path: str) -> "TwoCovPLDA":
        """A Kaldi binary `<Plda>` model: mean vec, transform mat, psi vec
        (kaldi plda.cc write/read)."""
        mu, transform, psi = read_kaldi_plda(path)
        obj = cls(dim=mu.shape[0])
        obj.mu, obj.transform, obj.psi = mu, transform, psi
        obj.offset = -obj.transform @ obj.mu
        return obj


def _read_kaldi_vec(f):
    kind = f.read(3)
    dtype = {b"FV ": ("<f4", 4), b"DV ": ("<f8", 8)}[kind]
    if f.read(1) != b"\x04":
        raise ValueError("bad Kaldi vector size marker")
    dim = struct.unpack("<i", f.read(4))[0]
    return np.frombuffer(f.read(dim * dtype[1]), dtype=dtype[0]).astype(
        np.float64)


def _read_kaldi_mat(f):
    kind = f.read(3)
    dtype = {b"FM ": ("<f4", 4), b"DM ": ("<f8", 8)}[kind]
    if f.read(1) != b"\x04":
        raise ValueError("bad Kaldi matrix size marker")
    rows = struct.unpack("<i", f.read(4))[0]
    if f.read(1) != b"\x04":
        raise ValueError("bad Kaldi matrix size marker")
    cols = struct.unpack("<i", f.read(4))[0]
    return np.frombuffer(f.read(rows * cols * dtype[1]),
                         dtype=dtype[0]).reshape(rows, cols).astype(np.float64)


def read_kaldi_plda(path: str):
    with open(path, "rb") as f:
        if f.read(len(_KALDI_PLDA)) != _KALDI_PLDA:
            raise ValueError(f"{path}: not a binary Kaldi <Plda> model")
        mu = _read_kaldi_vec(f)
        transform = _read_kaldi_mat(f)
        psi = _read_kaldi_vec(f)
    return mu, transform, psi
