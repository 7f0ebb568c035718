"""Eval-time placement shared by the batch-eval CLIs (extract, diarize).

Counterpart of wespeaker_tpu/utils/eval_device.py. bf16 makes the
activations bf16 and leaves the parameters f32: each layer and kernel
casts its weights to the activations' type per call (models/layers.py),
where JAX casts the weight tree once.

`data_parallel` is JAX's single-process form: the weights replicated and
each batch split over the replicas, the batch size rounded up to a
multiple of their number, a ragged batch padded by repeating its last
row, and the outputs back in the batch's order. Here a replica is a copy
of the model on a device of an explicit `devices` list (every visible
card by default), so two replicas may share one device (["cpu", "cpu"],
["cuda:0", "cuda:0"]) to rehearse the split where one card is all there
is. Each replica's launches run under its own device (the ctypes
launchers set the current device, ops/_build.py::on_device).
"""

import copy
import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from wespeaker_tpu_torch.device import DeviceLike, resolve_device


def prepare_eval_placement(model: nn.Module, bf16: bool = False,
                           device: DeviceLike = None
                           ) -> Tuple[nn.Module, torch.dtype]:
    """Returns (model on `device` in eval mode, compute dtype)."""
    dev = resolve_device(device)
    compute_dtype = torch.bfloat16 if bf16 else torch.float32
    return model.to(dev).eval(), compute_dtype


def replica_devices(data_parallel: bool, device: DeviceLike = None,
                    devices: Optional[Sequence[DeviceLike]] = None
                    ) -> List[torch.device]:
    """The devices of the replicas: `devices` if given, else with
    data_parallel every visible card (JAX's every local device) or the
    one CPU, else `device` alone."""
    if devices:
        return [resolve_device(d) for d in devices]
    dev = resolve_device(device)
    if data_parallel and dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def round_batch(batch_size: int, replicas: int) -> int:
    """batch_size rounded up to a multiple of the replicas (JAX's
    prepare_eval_placement)."""
    if batch_size % replicas:
        rounded = -(-batch_size // replicas) * replicas
        logging.info(f"data_parallel: batch_size rounded up to {rounded} "
                     f"({replicas} replicas)")
        return rounded
    return batch_size


def replicate(model: nn.Module, devices: Sequence[torch.device]
              ) -> List[nn.Module]:
    """The model on the first device and a copy on each other one, in
    eval mode."""
    first = model.to(devices[0]).eval()
    return [first] + [copy.deepcopy(first).to(d).eval()
                      for d in devices[1:]]


def _rows(x, sl):
    return {k: v[sl] for k, v in x.items()} if isinstance(x, dict) \
        else x[sl]


def _pad_rows(x, pad):
    def one(v):
        if isinstance(v, np.ndarray):
            return np.concatenate([v, np.repeat(v[-1:], pad, 0)])
        return torch.cat([v, v[-1:].expand((pad,) + tuple(v.shape[1:]))])

    return {k: one(v) for k, v in x.items()} if isinstance(x, dict) \
        else one(x)


def split_over(fns: Sequence[Callable]) -> Callable:
    """fn(batch) over the replicas' fns: the batch (an array or tensor, or
    a dict of them, batch first) padded to a multiple of the replicas by
    repeating its last row, split into equal blocks in order, each block
    embedded by its replica (every launch queued before any result is
    read, so replicas on several cards overlap), and the rows back on
    the CPU in the batch's order with the padding dropped. One replica is
    its fn as it is."""
    if len(fns) == 1:
        return fns[0]
    n = len(fns)

    def fn(batch):
        first = next(iter(batch.values())) if isinstance(batch, dict) \
            else batch
        real = len(first)
        if real % n:
            batch = _pad_rows(batch, n - real % n)
        per = -(-real // n)
        outs = [f(_rows(batch, slice(i * per, (i + 1) * per)))
                for i, f in enumerate(fns)]
        return torch.cat([o.cpu() for o in outs])[:real]

    return fn
