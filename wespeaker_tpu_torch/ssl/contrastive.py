"""MoCo and SimCLR contrastive pretraining on the card.

Counterpart of wespeaker_tpu/ssl/contrastive.py (upstream
wespeaker/ssl/models/moco_wrapper.py: momentum key encoder and a ring
buffer of negatives; simclr_wrapper.py: InfoNCE over n_views). The JAX
package runs both on one global batch, in place of upstream's
concat_all_gather of the keys and its shuffled-BN trick; across data
ranks (a `mesh`, parallel/mesh.py) the port follows it: the query
encoder's BatchNorms take the global statistics, gradients and metrics
are averaged over the ranks (one all_reduce), MoCo enqueues every rank's
keys in rank order on every rank (the queues stay identical), and
SimCLR's rows see every rank's rows as negatives, each rank's loss over
its own rows of the global view-major batch, so that the ranks' mean
gradient is the global loss's.

MoCo: the query encoder trains; the key encoder runs in eval mode under
no_grad (on the card, with an ECAPA backbone, the SE-Res2 block and
MFA+ASTP tail kernels), its parameters an EMA of the query encoder's
(m = 0.999) and its BatchNorm buffers copies of the query encoder's new
ones; the keys of each step enter a (K, D) queue at its pointer. SimCLR:
one encoder over the views stacked view-major. Parameters stay f32 and
the features are cast to the compute type (the JAX package's AMP).
"""

import copy
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from wespeaker_tpu_torch.parallel.collect import (all_gather_embeddings,
                                                  all_gather_rows,
                                                  mean_gradients)
from wespeaker_tpu_torch.parallel.mesh import (Mesh, global_batch_stats,
                                               group_rank, group_size)
from wespeaker_tpu_torch.train.train_step import _on


def l2norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / max(||x||, 1e-12)."""
    return F.normalize(x, dim=dim, eps=1e-12)


def moco_loss(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor,
              T: float = 0.07
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """InfoNCE with each query's key as its positive and the queue as the
    negatives. q, k: (B, D); queue: (K, D). Returns (loss, accuracy of
    the positive, the normalised keys without gradient)."""
    q = l2norm(q)
    k = l2norm(k).detach()
    l_pos = (q * k).sum(dim=1, keepdim=True)
    logits = torch.cat([l_pos, q @ queue.t()], dim=1) / T
    labels = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
    loss = F.cross_entropy(logits, labels)
    acc = (logits.detach().argmax(dim=1) == 0).float().mean()
    return loss, acc, k


def enqueue(queue: torch.Tensor, ptr: int, keys: torch.Tensor
            ) -> Tuple[torch.Tensor, int]:
    """Write (B, D) keys into the queue at ptr, in place; -> (queue, the
    next pointer). The trainer asserts K % B == 0, so a write never
    wraps."""
    b = keys.shape[0]
    if ptr + b > queue.shape[0]:
        raise ValueError(f"{b} keys at {ptr} overrun a queue of "
                         f"{queue.shape[0]}")
    queue[ptr:ptr + b] = keys.to(queue.dtype)
    return queue, (ptr + b) % queue.shape[0]


def simclr_loss(features: torch.Tensor, n_views: int = 2,
                T: float = 0.07) -> torch.Tensor:
    """InfoNCE over every view: features (n_views * B, D), view-major; each
    row's positives are the other views of its utterance, its negatives
    the rows of other utterances; log-sum-exp over the positives less
    log(n_views - 1) against log-sum-exp over both. The mean of
    simclr_terms."""
    return simclr_terms(features, n_views, T).mean()


def simclr_terms(features: torch.Tensor, n_views: int = 2,
                 T: float = 0.07) -> torch.Tensor:
    """simclr_loss's (n_views * B,) per-row terms."""
    n = features.shape[0]
    bs = n // n_views
    labels = torch.arange(bs, device=features.device).repeat(n_views)
    same = labels[None, :] == labels[:, None]
    eye = torch.eye(n, dtype=torch.bool, device=features.device)
    feats = l2norm(features)
    sim = feats @ feats.t() / T
    pos_mask = same & ~eye
    neg_inf = torch.full_like(sim, float("-inf"))
    denom = torch.logsumexp(torch.where(pos_mask | ~same, sim, neg_inf),
                            dim=1)
    pos = torch.logsumexp(torch.where(pos_mask, sim, neg_inf), dim=1)
    return denom - (pos - float(np.log(n_views - 1.0)))


def global_view_major(local: torch.Tensor, n_views: int, group
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's view-major (n_views * B, D) rows as the global batch's
    view-major (n_views * W * B, D) rows (view v: rank 0's B rows, rank
    1's, ...), differentiable (each rank's gradient summed over the
    ranks); and the global row indices of this rank's rows."""
    w, r = group_size(group), group_rank(group)
    b = local.shape[0] // n_views
    full = all_gather_rows(local, group, backward="sum")
    full = full.reshape(w, n_views, b, -1).transpose(0, 1).reshape(
        w * n_views * b, -1)
    mine = (torch.arange(n_views, device=local.device)[:, None] * w * b
            + r * b + torch.arange(b, device=local.device)[None, :])
    return full, mine.reshape(-1)


class MoCoTrainStep:
    """{"q_feat", "k_feat"} (B, T, F) -> metrics {loss, acc (device
    tensors), lr}; updates the query encoder, the key encoder, the queue
    and its pointer in place and counts steps in `step`."""

    def __init__(self, encoder: nn.Module, optimizer: torch.optim.Optimizer,
                 lr_fn: Callable, queue: torch.Tensor, m: float = 0.999,
                 T: float = 0.07,
                 compute_dtype: torch.dtype = torch.float32,
                 mesh: Mesh = None):
        self.encoder, self.optimizer, self.lr_fn = encoder, optimizer, lr_fn
        self.group = (mesh or Mesh()).data_group
        self.key_encoder = copy.deepcopy(encoder)
        global_batch_stats([encoder, self.key_encoder], self.group)
        for p in self.key_encoder.parameters():
            p.requires_grad_(False)
        self.queue, self.queue_ptr = queue, 0
        self.m, self.T, self.compute_dtype = m, T, compute_dtype
        self.device = queue.device
        self.step = 0

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        lr = float(self.lr_fn(self.step))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        q_feat = _on(batch["q_feat"], self.device, self.compute_dtype)
        k_feat = _on(batch["k_feat"], self.device, self.compute_dtype)
        self.encoder.train()
        q = self.encoder(q_feat).float()
        self.key_encoder.eval()
        with torch.no_grad():
            k = self.key_encoder(k_feat).float()
        loss, acc, k = moco_loss(q, k, self.queue, self.T)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss, acc = mean_gradients(self.encoder.parameters(), self.group,
                                   loss.detach(), acc)
        self.optimizer.step()
        with torch.no_grad():
            k_params = list(self.key_encoder.parameters())
            torch._foreach_mul_(k_params, self.m)
            torch._foreach_add_(k_params, list(self.encoder.parameters()),
                                alpha=1.0 - self.m)
            for kb, qb in zip(self.key_encoder.buffers(),
                              self.encoder.buffers()):
                kb.copy_(qb)
            self.queue, self.queue_ptr = enqueue(
                self.queue, self.queue_ptr,
                all_gather_embeddings(k, self.group))
        self.step += 1
        return {"loss": loss, "acc": acc, "lr": lr}


class SimCLRTrainStep:
    """{"feat": (n_views * B, T, F) view-major} -> metrics {loss (device
    tensor), lr}; updates the encoder and the optimizer in place and
    counts steps in `step`."""

    def __init__(self, encoder: nn.Module, optimizer: torch.optim.Optimizer,
                 lr_fn: Callable, n_views: int = 2, T: float = 0.07,
                 compute_dtype: torch.dtype = torch.float32,
                 mesh: Mesh = None):
        self.encoder, self.optimizer, self.lr_fn = encoder, optimizer, lr_fn
        self.group = (mesh or Mesh()).data_group
        global_batch_stats([encoder], self.group)
        self.n_views, self.T, self.compute_dtype = n_views, T, compute_dtype
        self.device = next(encoder.parameters()).device
        self.step = 0

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        lr = float(self.lr_fn(self.step))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.encoder.train()
        emb = self.encoder(_on(batch["feat"], self.device,
                               self.compute_dtype)).float()
        full, mine = global_view_major(emb, self.n_views, self.group)
        loss = simclr_terms(full, self.n_views, self.T)[mine].mean()
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss, = mean_gradients(self.encoder.parameters(), self.group,
                               loss.detach())
        self.optimizer.step()
        self.step += 1
        return {"loss": loss, "lr": lr}
