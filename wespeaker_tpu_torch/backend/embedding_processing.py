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

Persistence: a pickle of the list of links, as the JAX package writes
(`pickle.dump(self.links, f)`), so that an `embd_proc.pkl` of either
package loads in the other with the same attribute dicts. The port
writes the classes under the JAX package's module name without importing
it (`_ChainPickler`), and reads through a restricted unpickler
(`_ChainUnpickler`) that maps those names to the port's link classes and
allows numpy's array-rebuilding globals only; any other global is
refused by name before anything runs. `load` also reads the `.npz`
archive (each link's spec string and arrays) that earlier versions of
the port wrote under the same names.
"""

import pickle
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
    """A link's arrays, by name, for the `.npz` archive."""
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


JAX_MODULE = "wespeaker_tpu.backend.embedding_processing"
_LINKS = {cls.__name__: cls for cls in STRING2CLASS.values()}
# numpy's own reducers: an array pickles as _reconstruct (protocol < 5) or
# _frombuffer (protocol 5, in-band), a numpy scalar as scalar; numpy 2
# names their module numpy._core, numpy 1 numpy.core
_ALLOWED = {("numpy", "ndarray"): np.ndarray, ("numpy", "dtype"): np.dtype}
for _core in ("numpy._core", "numpy.core"):
    _ALLOWED.update({
        (_core + ".multiarray", "_reconstruct"): np.zeros(1).__reduce__()[0],
        (_core + ".multiarray", "scalar"): np.float64(0).__reduce__()[0],
        (_core + ".numeric", "_frombuffer"): np.zeros(1).__reduce_ex__(5)[0]})


class _ChainUnpickler(pickle.Unpickler):
    """The JAX package's link classes as the port's, numpy's array
    globals, and nothing else."""

    def find_class(self, module, name):
        if module == JAX_MODULE and name in _LINKS:
            return _LINKS[name]
        if (module, name) in _ALLOWED:
            return _ALLOWED[(module, name)]
        raise ValueError(f"embedding chain pickle names {module}.{name}, "
                         "which is not a link class or a numpy array "
                         "global: refused")


class _ChainPickler(pickle._Pickler):
    """The stock pickler checks a class by importing its module: the link
    classes are written as STACK_GLOBAL under JAX_MODULE without it."""

    def save_global(self, obj, name=None):
        if _LINKS.get(getattr(obj, "__name__", None)) is not obj:
            return super().save_global(obj, name)
        self.save(JAX_MODULE)
        self.save(obj.__name__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


# as the JAX package's pickle.dump; 4 or more since Python 3.8, as
# STACK_GLOBAL needs
PICKLE_PROTOCOL = pickle.DEFAULT_PROTOCOL


class EmbeddingProcessingChain:
    def __init__(self, chain: Optional[str] = None, loaders=None):
        """loaders: optional dict method-name -> data loader callable, for
        supplying in-memory data instead of scp files (tests, library
        use)."""
        self.links = []
        for spec in (chain.split("|") if chain else []):
            self.links.append(_build_link(spec, self, loaders or {}))

    def __call__(self, embd):
        for link in self.links:
            embd = link(embd)
        return embd

    def save(self, path):
        with open(path, "wb") as f:
            _ChainPickler(f, PICKLE_PROTOCOL).dump(self.links)

    def load(self, path):
        with open(path, "rb") as f:
            if f.read(1) == pickle.PROTO:
                f.seek(0)
                links = _ChainUnpickler(f).load()
                if not isinstance(links, list) or not all(
                        isinstance(link, _Link) for link in links):
                    raise ValueError(f"{path}: not a list of chain links")
                self.links = links
                return self
        with np.load(path, allow_pickle=False) as z:
            self.links = []
            for i, spec in enumerate(z["specs"]):
                cls = STRING2CLASS[chain_string_to_dict(str(spec))[0][0]]
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
