"""Training checkpoints: the port's torch `.pt` files and the JAX
package's flax msgpack `.ckpt` files.

Counterpart of wespeaker_tpu/utils/checkpoint.py (upstream
wespeaker/utils/checkpoint.py). A `.pt` file holds
`{"state_dict": model.state_dict(), "projection": head.state_dict()}`
(or is a bare model state_dict); a `.ckpt` file is the JAX trainer's tree
({"params", "batch_stats", "projection"(, "projection_batch_stats")}, or
the DINO trainer's, whose "params" hold the teacher's backbone), read and
written by utils/msgpack.py without the msgpack package. `load_checkpoint`
tells the two apart by content (a torch zip starts with `PK`, a flax file
with a msgpack map) and loads the model strictly either way: where the
JAX package's non-strict load keeps the init of a leaf the file lacks,
the port raises. `save_msgpack_checkpoint` and `average_checkpoints` are
the JAX package's `save_checkpoint` and `average_checkpoints`: the same
bytes for the same tree.
"""

import glob
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from wespeaker_tpu_torch.models.projections import full_state_dict
from wespeaker_tpu_torch.parallel.mesh import barrier
from wespeaker_tpu_torch.utils import msgpack
from wespeaker_tpu_torch.utils.weights import (_unwrap, from_jax_checkpoint,
                                               rules_name)

# upstream training checkpoints carry the margin head beside the model
_TRAINING_ONLY_PREFIXES = ("projection.",)


def save_checkpoint(path: str, model: nn.Module,
                    projection: Optional[nn.Module] = None,
                    projection_state: Optional[Mapping] = None) -> None:
    """model (and the head, or its given `projection_state`) to `path`."""
    obj = {"state_dict": {k: v.detach().cpu()
                          for k, v in model.state_dict().items()}}
    if projection is not None and projection_state is None:
        projection_state = projection.state_dict()
    if projection_state is not None:
        obj["projection"] = {k: v.detach().cpu()
                             for k, v in projection_state.items()}
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint_collective(path: str, model: nn.Module,
                               projection: nn.Module, mesh,
                               device: torch.device) -> None:
    """The trainers' save over ranks (parallel/mesh.py): every rank joins
    the gather of a model-axis head's rows (models/projections.py::
    full_state_dict), rank 0 writes, and every rank waits at a barrier
    until the file is there, so that a rank that reads it next finds it."""
    head = full_state_dict(projection)
    if mesh.rank == 0:
        save_checkpoint(path, model, projection_state=head)
    barrier(mesh, device)


def save_msgpack_checkpoint(path: str, tree: Mapping[str, Any]) -> None:
    """A flax variable tree (nested dicts of numpy arrays or tensors) as
    the JAX package's save_checkpoint writes it."""
    data = msgpack.serialize(tree)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def read_msgpack_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return msgpack.restore(f.read())


def checkpoint_format(path: str) -> str:
    """"torch" or "msgpack", by the file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:2] == b"PK":
        return "torch"
    if head == b"\x89HDF":  # also a msgpack fixmap's first byte
        raise ValueError(f"{path} is an HDF5 file, not a checkpoint")
    if msgpack.is_msgpack_map(head):
        return "msgpack"
    raise ValueError(f"{path}: neither a torch zip nor a flax msgpack "
                     f"checkpoint (starts {head!r})")


def read_checkpoint(path: str, model_name: str
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Optional[Dict[str, torch.Tensor]]]:
    """(the model's state_dict, the margin head's or None) of a `.pt` or
    `.ckpt` file; `model_name` chooses the flax name rules."""
    if checkpoint_format(path) == "msgpack":
        return from_jax_checkpoint(read_msgpack_checkpoint(path),
                                   model_name)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    projection = obj.get("projection") if isinstance(obj, Mapping) else None
    sd = {k: v for k, v in _unwrap(obj).items()
          if not k.startswith(_TRAINING_ONLY_PREFIXES)}
    return sd, projection


def _load_projection(projection: nn.Module, saved: dict) -> None:
    """The head by name: each of its tensors must be in `saved`; a weight
    whose class count changed keeps the saved rows that fit and the fresh
    ones beyond (the speed-perturb -> large-margin transition, upstream
    checkpoint.py:33-67). Any other mismatch raises."""
    own = projection.state_dict()
    missing = sorted(set(own) - set(saved))
    unexpected = sorted(set(saved) - set(own))
    if missing or unexpected:
        raise KeyError(f"projection keys: missing {missing}, unexpected "
                       f"{unexpected}")
    out = {}
    for key, cur in own.items():
        val = saved[key]
        if val.shape != cur.shape:
            if key != "weight" or val.shape[1:] != cur.shape[1:]:
                raise ValueError(f"projection {key}: {tuple(val.shape)} vs "
                                 f"{tuple(cur.shape)}")
            rows = min(val.shape[0], cur.shape[0])
            val = torch.cat([val[:rows].to(cur), cur[rows:]], dim=0)
        out[key] = val
    projection.load_state_dict(out, strict=True)


def load_checkpoint(path: str, model: nn.Module,
                    projection: Optional[nn.Module] = None) -> nn.Module:
    """Load the model strictly from a `.pt` (port or upstream) or `.ckpt`
    file and, when `projection` is given, the head by name
    (_load_projection). Training-only keys of a `.pt` (the margin head)
    are dropped and BatchNorm counters missing from older ones set to 0,
    each by name; any other mismatch raises. The model's
    utils/weights.py::rules_name (its class name: ECAPA_TDNN, CAMPPlus,
    Gemini_DF_ResNet, ResNet, ERes2Net, Res2Net, XVEC, SimAM_ResNet_ASP,
    RepVGG, ReDimNet, ReDimNet2Wrap; a composite's "<frontend
    family>+<speaker model>") chooses the flax name rules of a `.ckpt`."""
    sd, saved_head = read_checkpoint(path, rules_name(model))
    for key, buf in model.state_dict().items():
        if key.endswith("num_batches_tracked") and key not in sd:
            sd[key] = torch.zeros_like(buf)
    model.load_state_dict(sd, strict=True)
    if projection is not None:
        if saved_head is None:
            raise KeyError(f"{path} holds no projection head")
        _load_projection(projection, saved_head)
    return model


def _flat(tree: Mapping[str, Any], prefix=()):
    """flax's flatten_dict: the leaves by path, empty dicts dropped."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _f64(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(torch.float64).numpy()
    return np.asarray(leaf, np.float64)


def average_checkpoints(paths: List[str]) -> Dict[str, Any]:
    """The JAX package's average_checkpoints over `.ckpt` files: every
    leaf summed in f64 in file order, divided by the count, cast to f32."""
    if not paths:
        raise ValueError("no checkpoints to average")
    acc = None
    for p in paths:
        flat = dict(_flat(read_msgpack_checkpoint(p)))
        if acc is None:
            acc = {k: _f64(v) for k, v in flat.items()}
        else:
            for k in acc:
                acc[k] = acc[k] + _f64(flat[k])
    out = {}
    for path, v in acc.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (v / len(paths)).astype(np.float32)
    return out


_EPOCH_FILE = re.compile(r"model_(\d+)\.(pt|ckpt)")
_PREEMPT_FILE = re.compile(r"preempt_model_(\d+)\.(pt|ckpt)")


def find_epoch_checkpoints(model_dir: str, ext: str = "pt") -> List[str]:
    """model_N.<ext> files (`pt` or `ckpt`) sorted by epoch
    (average/final/preempt files excluded)."""
    out = []
    for p in glob.glob(os.path.join(model_dir, f"model_*.{ext}")):
        m = _EPOCH_FILE.fullmatch(os.path.basename(p))
        if m:
            out.append((int(m.group(1)), p))
    return [p for _, p in sorted(out)]


def parse_start_epoch(checkpoint_path: str) -> int:
    """Epoch to resume at from the file name (`.pt` or `.ckpt`):
    `model_N` is a completed epoch N -> N + 1; `preempt_model_N` was saved
    during epoch N on SIGTERM -> N (the epoch is replayed, upstream
    train.py:168-175)."""
    base = os.path.basename(checkpoint_path)
    m = _PREEMPT_FILE.fullmatch(base)
    if m:
        return int(m.group(1))
    m = _EPOCH_FILE.fullmatch(base)
    return int(m.group(1)) + 1 if m else 0
