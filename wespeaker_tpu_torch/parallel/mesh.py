"""Process groups for data and model parallelism, and the data stripe.

Counterpart of wespeaker_tpu/parallel/mesh.py. The JAX package runs SPMD
over one global array on a ('data', 'model') device mesh, which it gets
from `jax.distributed.initialize` (the `distributed_args` keys
`coordinator`, `num_processes`, `process_id`) or from one process over
every local chip. Here each rank is one process with one card: the ranks
come from `distributed_args` (a `tcp://coordinator` rendezvous) or from a
`torchrun` launch (its RANK / WORLD_SIZE / LOCAL_RANK), and form a
data x model grid as the JAX mesh does, rank r at data coordinate
r // model and model coordinate r % model. One process over every card
has no counterpart in training.

Everything that the JAX package reduces over the batch axis of its global
array is reduced here over the data group with explicit collectives
(parallel/collect.py): the BatchNorm statistics (`global_batch_stats`,
read by models/layers.py::batch_norm), the gradient mean, DINO's centre,
MoCo's queue and SimCLR's negatives. Every collective is an `all_reduce`
or a `broadcast`, the two that the gloo backend takes on CUDA tensors as
NCCL does, so the one-card rehearsal (two ranks over gloo on one card)
runs the code that NCCL runs across cards.
"""

import dataclasses
import datetime
import os
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: Optional[str] = "cuda") -> Tuple[int, int]:
    """Join the ranks; returns (rank, world size). The JAX package's keys:
    `coordinator` "host:port" of rank 0, `num_processes`, `process_id`.
    Without them a torchrun launch (RANK, WORLD_SIZE, MASTER_ADDR/PORT in
    the environment) is joined; with neither, or one process, nothing is
    done and (0, 1) returned. A second call in one process returns the
    group it joined.

    `backend` is NCCL for `device` cuda and gloo for cpu unless given:
    "gloo" on cuda runs two ranks on one card, which NCCL refuses. Each
    rank binds cuda:<local rank> (LOCAL_RANK, else the process id modulo
    the cards) before it builds anything, so the bare "cuda" that
    device.py resolves is that card."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = "WORLD_SIZE" in os.environ and num_processes is None
    world = int(os.environ["WORLD_SIZE"]) if env else int(num_processes or 1)
    if world <= 1:
        return 0, 1
    rank = int(os.environ["RANK"]) if env else int(process_id)
    on_card = torch.device(device or "cuda").type == "cuda"
    if on_card:
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    kw = dict(backend=backend or ("nccl" if on_card else "gloo"),
              world_size=world, rank=rank,
              timeout=datetime.timedelta(minutes=10))
    if not env:
        if not coordinator:
            raise ValueError("distributed_args needs `coordinator` "
                             "(host:port of rank 0)")
        kw["init_method"] = f"tcp://{coordinator}"
    if kw["backend"] == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(**kw)
    return rank, world


@dataclasses.dataclass
class Mesh:
    """The ranks as a (data, model) grid with this rank's two groups:
    `data_group` holds the ranks of its model coordinate (they see
    different rows and reduce over the batch), `model_group` those of its
    data coordinate (they see the same rows and hold different rows of
    the margin head). A group of one rank is None: nothing to reduce."""
    rank: int = 0
    world: int = 1
    data: int = 1
    model: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model


def make_mesh(model: int = 1) -> Mesh:
    """The grid over every rank that init_distributed joined (one rank
    when it joined none). Every rank makes every group, in one order, as
    torch.distributed.new_group requires."""
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    if model < 1 or world % model:
        raise ValueError(f"parallel_args.model {model} must divide the "
                         f"world size {world}")
    data = world // model
    mesh = Mesh(rank, world, data, model)
    if world == 1:
        return mesh
    for m in range(model):
        ranks = list(range(m, world, model))
        g = dist.new_group(ranks) if data > 1 else None
        if rank in ranks:
            mesh.data_group = g
    for d in range(data):
        ranks = list(range(d * model, (d + 1) * model))
        g = dist.new_group(ranks) if model > 1 else None
        if rank in ranks:
            mesh.model_group = g
    return mesh


def process_data_stripe(mesh: Mesh) -> Tuple[int, int]:
    """(stripe, num_stripes): the ranks of one model group load the same
    rows, so stripe = rank // model of world // model stripes (JAX's
    process_data_stripe on a mesh of one card a process)."""
    return mesh.data_index, mesh.data


class _Group:
    """A process group held by a module: deep copies (DINO's teacher,
    MoCo's key encoder) share it, as a group cannot be copied."""

    def __init__(self, group: dist.ProcessGroup):
        self.group = group

    def __deepcopy__(self, memo):
        return self


def _direct_call(module, args):
    if module.training:
        raise RuntimeError(
            f"{type(module).__name__} called directly in training: its "
            "statistics would be this rank's only; route it through "
            "models/layers.py::batch_norm")


def global_batch_stats(modules: Iterable[nn.Module],
                       group: Optional[dist.ProcessGroup]) -> None:
    """Make every BatchNorm of `modules` normalise by the statistics of
    the batch over `group` in training (the JAX package's global batch):
    models/layers.py::batch_norm reads them with one all_reduce. A None
    group leaves the modules as they are. A BatchNorm that a model calls
    directly, not through that helper, raises in training."""
    if group is None:
        return
    held = _Group(group)
    for mod in modules:
        for m in mod.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.stats_group = held
                m.register_forward_pre_hook(_direct_call)


def stats_group(bn: nn.Module) -> Optional[dist.ProcessGroup]:
    held = getattr(bn, "stats_group", None)
    return None if held is None else held.group


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Optional[dist.ProcessGroup]) -> int:
    return 0 if group is None else dist.get_rank(group)


def barrier(mesh: Mesh, device: torch.device) -> None:
    """Every rank waits for every other: one all_reduce of one element
    (the gloo and NCCL forms alike)."""
    if mesh.world > 1:
        dist.all_reduce(torch.zeros(1, device=device))
