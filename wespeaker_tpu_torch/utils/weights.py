"""Weights between the JAX package, upstream checkpoints and the port.

`from_jax_variables` turns the JAX package's flax variable tree
({"params", "batch_stats"} as nested dicts of arrays) into the port's
state_dict. It inverts the rules of wespeaker_tpu/utils/torch_compat.py:

  - conv kernel (K, I, O) -> weight (O, I, K)
  - dense kernel (I, O)   -> weight (O, I)
  - BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
    running_var, plus num_batches_tracked = 0, which flax does not keep
  - ECAPA child names: block_<i> -> se_res2block.<i>, convs_<i> ->
    convs.<i>, bns_<i> -> bns.<i>

`load_checkpoint` reads an upstream or port `.pt` state_dict into a model
with `load_state_dict(strict=True)`; the keys the port has no use for are
handled by name, not by a lenient load.
"""

import re
from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

_LEAF_TO_TORCH = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}

_ECAPA_RULES = (
    (r"\bblock_(\d+)\b", r"se_res2block.\1"),
    (r"\bconvs_(\d+)\b", r"convs.\1"),
    (r"\bbns_(\d+)\b", r"bns.\1"),
)

# upstream training checkpoints carry the margin head beside the model
_TRAINING_ONLY_PREFIXES = ("projection.",)


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(mods, leaf: str) -> str:
    key = ".".join(mods + (_LEAF_TO_TORCH.get(leaf, leaf),))
    for pat, repl in _ECAPA_RULES:
        key = re.sub(pat, repl, key)
    return key


def from_jax_variables(variables: Mapping[str, Any]) -> "OrderedDict":
    """flax {"params", "batch_stats"} tree (nested dicts of numpy or JAX
    arrays) -> the port's state_dict of torch tensors."""
    sd = OrderedDict()
    bn_prefixes = []
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            *mods, leaf = path
            arr = np.asarray(value, dtype=np.float32)
            if leaf == "kernel":
                arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
            key = _torch_key(tuple(mods), leaf)
            sd[key] = torch.tensor(arr)
            if collection == "batch_stats" and leaf == "mean":
                bn_prefixes.append(key[:-len("running_mean")])
    for prefix in bn_prefixes:
        sd[prefix + "num_batches_tracked"] = torch.tensor(0)
    return sd


def _unwrap(obj: Any) -> Dict[str, torch.Tensor]:
    if isinstance(obj, nn.Module):
        obj = obj.state_dict()
    for key in ("state_dict", "model"):
        if isinstance(obj, Mapping) and isinstance(obj.get(key), Mapping):
            obj = obj[key]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Load a `.pt` state_dict saved by the port or by upstream wespeaker
    into `model`, strictly. Training-only keys (the margin head) are dropped
    and BatchNorm counters missing from older checkpoints are set to 0,
    each by name; any other mismatch raises."""
    sd = _unwrap(torch.load(path, map_location="cpu", weights_only=True))
    sd = {k: v for k, v in sd.items()
          if not k.startswith(_TRAINING_ONLY_PREFIXES)}
    for key, buf in model.state_dict().items():
        if key.endswith("num_batches_tracked") and key not in sd:
            sd[key] = torch.zeros_like(buf)
    model.load_state_dict(sd, strict=True)
    return model
