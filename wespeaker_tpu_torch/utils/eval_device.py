"""Eval-time placement shared by the batch-eval CLIs (extract).

Counterpart of wespeaker_tpu/utils/eval_device.py. Two differences from
the JAX package:
- bf16 makes the activations bf16 and leaves the parameters f32: each
  layer and kernel casts its weights to the activations' type per call
  (models/layers.py), where JAX casts the weight tree once.
- data_parallel over more than one visible card is refused (multi-card
  data parallelism is not ported; ROADMAP Queue 1 item 4, DDP). With one
  card it changes nothing, as in JAX.
"""

from typing import Tuple

import torch
import torch.nn as nn

from wespeaker_tpu_torch.device import DeviceLike, resolve_device


def prepare_eval_placement(model: nn.Module, bf16: bool = False,
                           data_parallel: bool = False,
                           device: DeviceLike = None
                           ) -> Tuple[nn.Module, torch.dtype]:
    """Returns (model on `device` in eval mode, compute dtype). The batch
    size JAX's version returns is the caller's own: one card changes
    nothing, and more are refused."""
    dev = resolve_device(device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    if data_parallel and n_dev > 1:
        raise NotImplementedError(
            f"data_parallel over {n_dev} cards is not ported yet (multi-card "
            "data parallelism, ROADMAP Queue 1 item 4: DDP); stripe the list "
            "over processes with num_splits / split_index, one card each")
    compute_dtype = torch.bfloat16 if bf16 else torch.float32
    return model.to(dev).eval(), compute_dtype
