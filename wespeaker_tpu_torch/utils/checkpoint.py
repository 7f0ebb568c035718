"""Training checkpoints as torch `.pt` files.

Counterpart of wespeaker_tpu/utils/checkpoint.py (upstream
wespeaker/utils/checkpoint.py). A file holds
`{"state_dict": model.state_dict(), "projection": head.state_dict()}`;
`utils.weights.load_checkpoint` reads the model part for evaluation and
serving. Reading the JAX package's msgpack checkpoints is not ported yet.
"""

import glob
import os
import re
from typing import List, Optional

import torch
import torch.nn as nn

from wespeaker_tpu_torch.utils.weights import load_checkpoint as _load_model


def save_checkpoint(path: str, model: nn.Module,
                    projection: Optional[nn.Module] = None) -> None:
    obj = {"state_dict": {k: v.detach().cpu()
                          for k, v in model.state_dict().items()}}
    if projection is not None:
        obj["projection"] = {k: v.detach().cpu()
                             for k, v in projection.state_dict().items()}
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


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
    """Load the model strictly (utils.weights.load_checkpoint) and, when
    `projection` is given, the head by name."""
    _load_model(model, path)
    if projection is not None:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if "projection" not in obj:
            raise KeyError(f"{path} holds no projection head")
        _load_projection(projection, obj["projection"])
    return model


def find_epoch_checkpoints(model_dir: str) -> List[str]:
    """model_N.pt files sorted by epoch (average/final/preempt files
    excluded)."""
    out = []
    for p in glob.glob(os.path.join(model_dir, "model_*.pt")):
        m = re.search(r"(?:^|/)model_(\d+)\.pt$", p)
        if m:
            out.append((int(m.group(1)), p))
    return [p for _, p in sorted(out)]


def parse_start_epoch(checkpoint_path: str) -> int:
    """Epoch to resume at from the file name: `model_N.pt` is a completed
    epoch N -> N + 1; `preempt_model_N.pt` was saved during epoch N on
    SIGTERM -> N (the epoch is replayed, upstream train.py:168-175)."""
    base = os.path.basename(checkpoint_path)
    m = re.fullmatch(r"preempt_model_(\d+)\.pt", base)
    if m:
        return int(m.group(1))
    m = re.fullmatch(r"model_(\d+)\.pt", base)
    return int(m.group(1)) + 1 if m else 0
