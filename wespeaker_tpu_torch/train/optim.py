"""Optimizer construction from config.

Counterpart of wespeaker_tpu/train/optim.py (upstream
wespeaker/bin/train.py:188-204). The JAX package chains optax's
add_decayed_weights and sgd; torch.optim.SGD with weight_decay, momentum,
nesterov and dampening 0 is the same update (decay added to the gradient
before the momentum buffer, whose first value is that gradient in both).
Adam and AdamW map to their torch classes (Adam: decay added to the
gradient; AdamW: decoupled). The trainer writes the scheduled LR into
every param_group before each step. The JAX package's frozen-frontend
mask is the parameter list itself here: build_train_state passes only
the parameters that require gradients, and a frozen frontend's do not
(models/with_frontend.py), so they take no update and no decay.
"""

from typing import Iterable

import torch


def make_optimizer(conf: dict, params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    name = conf.get("optimizer", "SGD").lower()
    args = conf.get("optimizer_args", {})
    wd = float(args.get("weight_decay", 1e-4))
    momentum = float(args.get("momentum", 0.9))
    nesterov = bool(args.get("nesterov", True))
    params = list(params)
    # lr 0 until the trainer writes the scheduled value before each step
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                               nesterov=nesterov, weight_decay=wd)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, weight_decay=wd)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, weight_decay=wd)
    raise ValueError(f"unknown optimizer {name}")


def lr_scale_ratio(world_size: int, batch_size: int) -> float:
    """Linear LR scaling for the global batch (upstream train.py:201-204)."""
    return world_size * batch_size / 64.0
