"""Collectives over a process group, and the evaluation helpers on rows
split over ranks.

Counterpart of wespeaker_tpu/parallel/collect.py, where shard_map and
lax.all_gather work on a mesh. Here each rank holds its own rows and the
helpers return what JAX's return on a mesh of the group's size, in rank
order: `all_gather_embeddings` the (N, D) rows of every rank,
`sharded_cohort_stats` this rank's rows' AS-Norm statistics, and
`sharded_affinity` this rank's row block of the (N, N) affinity.

Every gather is an all_reduce of a zero buffer in which each rank fills
its own slot: the one form that gloo on CUDA tensors and NCCL both run
(gloo's all_gather takes no CUDA tensor). The differentiable forms state
their backward:
- `all_reduce_sum`: the sum of the incoming gradients over the group
  (every rank's copy of the sum depends on every rank's input), which is
  SyncBatchNorm's rule;
- `all_gather_rows(..., backward="sum")`: the gathered gradient summed
  over the group, then this rank's slot: for a loss that each rank
  computes over its own rows against every rank's (SimCLR), so that the
  mean of the ranks' gradients is the gradient of the global mean;
- `all_gather_rows(..., backward="slice")`: this rank's slot only: for a
  loss that every rank of the group computes in full and alike (the
  model-axis margin head), where a sum would count it once a rank;
- `copy_to_group`: the identity forward, the sum over the group backward,
  for an input that every rank of the group uses on its own rows of a
  weight (the model-axis head's embedding).
"""

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from wespeaker_tpu_torch.backend.scoring import l2norm
from wespeaker_tpu_torch.parallel.mesh import group_rank, group_size


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    if group_size(group) > 1:
        dist.all_reduce(y, group=group)
    return y


def _gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    slots = x.new_zeros((n,) + tuple(x.shape))
    slots[group_rank(group)] = x
    dist.all_reduce(slots, group=group)
    return torch.cat(slots.unbind(0), dim=dim)


def _slot(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    return g.chunk(n, dim=dim)[group_rank(group)].contiguous()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _sum(g, ctx.group)
        return _slot(g, ctx.group, ctx.dim), None, None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group (a new tensor); differentiable."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group, dim: int = 0,
                    backward: str = "sum") -> torch.Tensor:
    """Every rank's x (one shape on every rank) concatenated along `dim`
    in rank order; differentiable with the `backward` rule of the module
    docstring ("sum" or "slice")."""
    if backward not in ("sum", "slice"):
        raise ValueError(f"backward {backward!r}: sum or slice")
    if group_size(group) == 1:
        return x
    return _GatherRows.apply(x, group, dim, backward == "sum")


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """x itself; its gradient summed over the group."""
    if group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


@torch.no_grad()
def all_gather_embeddings(embs: torch.Tensor,
                          group: Optional[dist.ProcessGroup]
                          ) -> torch.Tensor:
    """This rank's (N_local, D) rows -> every rank's (N, D), in rank
    order, on every rank (one N_local on every rank, as JAX's sharding
    requires)."""
    return _gather(embs, group)


@torch.no_grad()
def sharded_cohort_stats(emb: torch.Tensor, cohort: torch.Tensor,
                         top_n: int, group: Optional[dist.ProcessGroup]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AS-Norm statistics of this rank's embedding rows against the whole
    cohort (which every rank holds): the mean and the population std of
    each row's top_n cosine scores. JAX returns them row-sharded; the
    ranks' results in rank order are its rows. The cohort is the same on
    every rank, so no collective is needed."""
    del group
    scores = l2norm(emb) @ l2norm(cohort).t()
    top = torch.topk(scores, top_n, dim=1).values
    return top.mean(dim=1), top.std(dim=1, correction=0)


@torch.no_grad()
def sharded_affinity(emb: torch.Tensor,
                     group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Diarization's cosine affinity 0.5 (1 + cos) of this rank's rows
    against every rank's: the (N_local, N) row block of the (N, N)
    matrix."""
    full = _gather(emb, group)
    return 0.5 * (1.0 + l2norm(emb) @ l2norm(full).t())


def mean_gradients(params, group: Optional[dist.ProcessGroup],
                   *scalars: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Average the gradients of `params` over the group in place, and the
    0-d `scalars` (a loss, an accuracy) with them: one all_reduce of one
    flat buffer, then a division by the group's size. Each rank's loss is
    its own rows' mean, so the mean of the ranks' gradients is the
    gradient of the global batch's mean, JAX's. Parameters without a
    gradient stay so (every rank has the same set). Returns the averaged
    scalars."""
    n = group_size(group)
    if n == 1:
        return scalars
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [s.detach().reshape(1).float() for s in scalars])
    dist.all_reduce(flat, group=group)
    flat /= n
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return tuple(flat[offset:].unbind(0))
