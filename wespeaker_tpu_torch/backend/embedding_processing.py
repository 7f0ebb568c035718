"""Composable embedding post-processing chain, on the host in f64.

Counterpart of wespeaker_tpu/backend/embedding_processing.py (upstream
wespeaker/utils/embedding_processing.py: chain_string_to_dict:23,
Lda:70, Length_norm:181, MeanSubtraction:204,
EmbeddingProcessingChain:219). A pipe string like

    "mean-subtract --scp m.scp | length-norm | lda --scp l.scp
     --utt2spk u2s --dim 100 | length-norm"

builds a chain in which each estimated link (mean, LDA, whitening) sees
its training data through the chain's prefix, as upstream does. Data
come from kaldi scp files or from in-memory loaders.

Persistence differs from the JAX package, which pickles its link objects:
those pickles name wespeaker_tpu classes, and loading a pickle runs code.
The port stores the chain as an `.npz` archive at exactly the path given:
each link's spec string ("specs") and its arrays ("<i>.<name>"); loading
reads arrays only (allow_pickle=False). A JAX pickle is refused by name.
"""

import re
from typing import Dict, Optional

import numpy as np
import scipy.linalg as spl

from wespeaker_tpu_torch.utils.kaldi_io import read_spk2emb, read_vec_scp


def chain_string_to_dict(chain_string: Optional[str]):
    links = chain_string.split("|") if chain_string else []
    out = []
    for link in links:
        parts = link.split("--")
        method = parts.pop(0).strip()
        args = {}
        for p in parts:
            p = re.sub("=", " ", p)
            p = re.sub(" +", " ", p).strip()
            k, v = p.split(" ")
            args[k] = v
        out.append([method, args])
    return out


def _load_vectors(args, loader=None):
    if loader is not None:
        return loader(args)
    return np.vstack([v for _, v in read_vec_scp(args["scp"])])


def _load_spk2emb(args, loader=None):
    if loader is not None:
        return loader(args)
    return read_spk2emb(args["scp"], args["utt2spk"])


class _Link:
    """A link's arrays, by name, for the archive."""
    ARRAYS = ()

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray]):
        link = cls.__new__(cls)
        for name in cls.ARRAYS:
            setattr(link, name, arrays[name])
        return link


class LengthNorm(_Link):
    def __init__(self, args=None, current_chain=None, **_):
        pass

    def __call__(self, embd):
        return embd / np.sqrt((embd ** 2).sum(axis=1, keepdims=True))


class MeanSubtraction(_Link):
    ARRAYS = ("mean",)

    def __init__(self, args, current_chain=None, vec_loader=None, **_):
        data = _load_vectors(args, vec_loader)
        if current_chain is not None:
            data = current_chain(data)
        self.mean = np.mean(data, axis=0)

    def __call__(self, embd):
        return embd - self.mean


class Lda(_Link):
    """Whitened-within-class LDA with Kaldi-style eigenvalue flooring
    (embedding_processing.py:70-178)."""
    ARRAYS = ("m", "lda")

    def __init__(self, args, current_chain=None, spk_loader=None,
                 equal_speaker_weight=False, **_):
        dim = int(args["dim"])
        eps = float(args.get("eps", 1e-6))
        spk2emb = _load_spk2emb(args, spk_loader)

        counts, means, covs = [], [], []
        for emb in spk2emb.values():
            if current_chain is not None:
                emb = current_chain(emb)
            if emb.shape[0] > 1:
                counts.append(emb.shape[0])
                means.append(emb.mean(axis=0))
                covs.append(np.cov(emb, rowvar=False, bias=True))
        counts = np.asarray(counts)
        means = np.vstack(means)
        covs = np.asarray(covs)
        if equal_speaker_weight:
            self.m = means.mean(axis=0)
            bc = np.cov(means, rowvar=False, bias=True)
            wc = covs.sum(axis=0) / len(spk2emb)
        else:
            self.m = (counts[:, None] * means).sum(axis=0) / counts.sum()
            bc = np.cov(means, rowvar=False, bias=True, fweights=counts)
            wc = (counts[:, None, None] * covs).sum(axis=0) / counts.sum()

        e, m = spl.eigh(wc)
        e = np.maximum(e, np.max(e) * eps)
        t1 = np.diag(1.0 / np.sqrt(e)) @ m.T
        bc_w = t1 @ bc @ t1.T
        d, lda = spl.eigh(bc_w)
        self.lda = t1.T @ lda[:, -dim:]

    def __call__(self, embd):
        return (embd - self.m) @ self.lda


class Whitening(_Link):
    """ZCA whitening on a held-out set (upstream declares this link and
    leaves it unimplemented; the JAX package implements it)."""
    ARRAYS = ("mean", "w")

    def __init__(self, args, current_chain=None, vec_loader=None, **_):
        data = _load_vectors(args, vec_loader)
        if current_chain is not None:
            data = current_chain(data)
        self.mean = data.mean(axis=0)
        cov = np.cov(data - self.mean, rowvar=False)
        e, v = np.linalg.eigh(cov)
        e = np.maximum(e, 1e-8)
        self.w = v @ np.diag(1.0 / np.sqrt(e)) @ v.T

    def __call__(self, embd):
        return (embd - self.mean) @ self.w


STRING2CLASS = {
    "lda": Lda,
    "length-norm": LengthNorm,
    "whitening": Whitening,
    "mean-subtract": MeanSubtraction,
}


def _build_link(spec: str, prefix, loaders):
    parsed = chain_string_to_dict(spec)
    if len(parsed) != 1:
        raise ValueError(f"one link expected: {spec!r}")
    method, args = parsed[0]
    kw = {}
    if method in ("mean-subtract", "whitening"):
        kw["vec_loader"] = loaders.get(method)
    if method == "lda":
        kw["spk_loader"] = loaders.get(method)
    return STRING2CLASS[method](args, prefix, **kw)


class EmbeddingProcessingChain:
    def __init__(self, chain: Optional[str] = None, loaders=None):
        """loaders: optional dict method-name -> data loader callable, for
        supplying in-memory data instead of scp files (tests, library
        use)."""
        self.links = []
        self.specs = []
        for spec in (chain.split("|") if chain else []):
            self.links.append(_build_link(spec, self, loaders or {}))
            self.specs.append(spec.strip())

    def __call__(self, embd):
        for link in self.links:
            embd = link(embd)
        return embd

    def save(self, path):
        arrays = {"specs": np.asarray(self.specs, dtype=np.str_)}
        for i, link in enumerate(self.links):
            for name in link.ARRAYS:
                arrays[f"{i}.{name}"] = getattr(link, name)
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    def load(self, path):
        with open(path, "rb") as f:
            head = f.read(2)
        if head[:1] == b"\x80":
            raise ValueError(
                f"{path} is a pickle (the JAX package's chain format), which "
                "the port does not load: rebuild it with the port's "
                "embd_proc prep, which writes an .npz archive")
        with np.load(path, allow_pickle=False) as z:
            self.specs = [str(s) for s in z["specs"]]
            self.links = []
            for i, spec in enumerate(self.specs):
                cls = STRING2CLASS[chain_string_to_dict(spec)[0][0]]
                self.links.append(cls.from_arrays(
                    {n: z[f"{i}.{n}"] for n in cls.ARRAYS}))
        return self

    def update_link(self, index: int, new_link: str, loaders=None):
        """Replace one estimated link, estimated through the chain's
        prefix (domain adaptation, upstream wespeaker/bin/
        update_embd_proc.py)."""
        prefix = EmbeddingProcessingChain()
        prefix.links = self.links[:index]
        self.links[index] = _build_link(new_link, prefix, loaders or {})
        self.specs[index] = new_link.strip()
