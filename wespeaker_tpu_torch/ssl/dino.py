"""DINO self-supervised training on the card.

Counterpart of wespeaker_tpu/ssl/dino.py (upstream
wespeaker/ssl/models/dino_wrapper.py: DINOHead:78, DINOLoss:132, DINO:233
with the EMA :271; wespeaker/ssl/utils/dino_utils.py: cosine_scheduler
:105, clip_gradients:26, cancel_gradients_last_layer:38, LARS:126,
get_params_groups:180).

The student and the teacher are two `DINOModel`s (backbone + head), the
teacher a copy of the student whose parameters get no gradient. One step
(`DINOTrainStep`) is

    student forward on the global crops, then on the local crops (train
    mode: the BatchNorm statistics are updated twice, in that order) ->
    teacher forward on the global crops (eval mode, no autograd) -> DINO
    loss against the centred, sharpened teacher -> backward -> per-tensor
    gradient clip -> last-layer gradients zeroed while step <
    freeze_last_layer_iters -> optimizer step -> teacher parameters
    EMA'd towards the student, teacher BatchNorm buffers copied from the
    student -> center EMA'd towards the teacher's batch mean

with the LR, the teacher momentum and the teacher temperature read from
host schedules at the step before it is incremented. On the card an
ECAPA backbone with `fused=True` takes the repo's kernels: the teacher's
eval forward the SE-Res2 block and the MFA+ASTP tail kernels, the
student's training forward and backward the training tail's kernels. The
head, the 65,536-way loss, the EMA and the centering are plain PyTorch,
as they are plain jnp in the JAX package.

AMP is the JAX package's: parameters stay f32 and are cast to the
activation type where they are used; the features are cast to the
compute type and the head outputs back to f32 for the loss.

Across data ranks (a `mesh`, parallel/mesh.py) the step is the JAX
package's on its global batch: the student's BatchNorms take the global
statistics, the gradients and the loss are averaged over the ranks
before the clip (one all_reduce, parallel/collect.py::mean_gradients),
and the centre moves towards the teacher output's mean over every rank's
rows (one all_reduce).
"""

import copy
import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from wespeaker_tpu_torch.models.layers import batch_norm
from wespeaker_tpu_torch.parallel.collect import (all_reduce_sum,
                                                  mean_gradients)
from wespeaker_tpu_torch.parallel.mesh import (Mesh, global_batch_stats,
                                               group_size)
from wespeaker_tpu_torch.train.train_step import _on


def _trunc_normal(*shape: int, std: float = 0.02) -> torch.Tensor:
    """flax's truncated_normal(std): N(0, std) cut at +-2 std."""
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std,
                                 b=2 * std)


class DINOHead(nn.Module):
    """MLP (hidden_dim, optional BatchNorm, tanh-GELU) to bottleneck_dim,
    L2-normalised, then a weight-normed linear layer without bias:
    w = v / ||v||_axis0 * g. With norm_last_layer, g gets no gradient.

    Child names are the JAX package's (mlp_<i>, mlp_bn_<i>, last_layer_v
    (in, out), last_layer_g), so its trees map by the rank rule of
    utils/weights.py."""

    def __init__(self, in_dim: int, out_dim: int, use_bn: bool = False,
                 norm_last_layer: bool = True, nlayers: int = 3,
                 hidden_dim: int = 2048, bottleneck_dim: int = 256,
                 normalize_input: bool = False):
        super().__init__()
        self.nlayers, self.use_bn = nlayers, use_bn
        self.normalize_input = normalize_input
        dims = ([in_dim] + [hidden_dim] * (nlayers - 1) + [bottleneck_dim]
                if nlayers >= 1 else [in_dim])
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            lin = nn.Linear(a, b)
            with torch.no_grad():
                lin.weight.copy_(_trunc_normal(b, a))
                lin.bias.zero_()
            setattr(self, f"mlp_{i}", lin)
            if use_bn and i < nlayers - 1:
                setattr(self, f"mlp_bn_{i}", nn.BatchNorm1d(b, eps=1e-5))
        self.last_layer_v = nn.Parameter(_trunc_normal(dims[-1], out_dim))
        self.last_layer_g = nn.Parameter(torch.ones(out_dim),
                                         requires_grad=not norm_last_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, in_dim) -> (B, out_dim) in x's dtype."""
        if self.normalize_input:
            x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        for i in range(self.nlayers):
            lin = getattr(self, f"mlp_{i}")
            x = F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))
            if i < self.nlayers - 1:
                if self.use_bn:
                    x = batch_norm(x, getattr(self, f"mlp_bn_{i}"))
                x = F.gelu(x, approximate="tanh")  # flax nn.gelu's default
        x = F.normalize(x, dim=-1, eps=1e-12)
        v = self.last_layer_v.float()
        w = v / torch.linalg.vector_norm(v, dim=0, keepdim=True)
        return x @ (w * self.last_layer_g.float()).to(x.dtype)


class DINOModel(nn.Module):
    """backbone + head: (B, T, F) features -> (B, out_dim)."""

    def __init__(self, backbone: nn.Module, head: DINOHead):
        super().__init__()
        self.backbone, self.head = backbone, head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(x))


def cosine_scheduler(base_value: float, final_value: float, epochs: int,
                     iters_per_epoch: int, warmup_epochs: int = 0,
                     start_warmup_value: float = 0.0
                     ) -> Callable[[int], float]:
    """step -> value: a linear warm-up over warmup_epochs, then a cosine
    from base_value to final_value at epochs * iters_per_epoch."""
    warmup_iters = warmup_epochs * iters_per_epoch
    total_iters = epochs * iters_per_epoch

    def fn(step) -> float:
        step = float(step)
        if step < warmup_iters:
            return start_warmup_value + (base_value - start_warmup_value) * (
                step / max(warmup_iters, 1))
        progress = (step - warmup_iters) / max(total_iters - warmup_iters, 1)
        return final_value + 0.5 * (base_value - final_value) * (
            1 + math.cos(math.pi * progress))

    return fn


def teacher_temp_schedule(warmup_teacher_temp: float, teacher_temp: float,
                          nepochs: int, iters_per_epoch: int,
                          warmup_ratio: float = 0.2
                          ) -> Callable[[int], float]:
    """step -> teacher temperature: linear from warmup_teacher_temp over
    the first warmup_ratio of the epochs, then teacher_temp."""
    warm_epochs = int(nepochs * warmup_ratio)

    def fn(step) -> float:
        epoch = float(step) / iters_per_epoch
        if epoch < warm_epochs:
            return warmup_teacher_temp + (
                teacher_temp - warmup_teacher_temp) * (
                    epoch / max(warm_epochs, 1))
        return float(teacher_temp)

    return fn


def dino_loss(student_out: torch.Tensor, teacher_out: torch.Tensor,
              center: torch.Tensor, teacher_temp: float, n_scrops: int,
              n_tcrops: int, student_temp: float = 0.1,
              mode: int = 0) -> torch.Tensor:
    """Cross-entropy between the sharpened, centred teacher views and the
    student views, averaged over the terms of `mode`: 0 every pair but a
    view with itself, 1 only a view with itself, 2 the teacher views
    against the local student views. student_out: (n_scrops * B, K),
    teacher_out: (n_tcrops * B, K), both view-major. The terms are formed
    one at a time, each student view's log-softmax once."""
    for out, n in ((student_out, n_scrops), (teacher_out, n_tcrops)):
        if out.shape[0] % n:
            raise ValueError(f"{out.shape[0]} rows do not split into {n} "
                             "views")
    s = student_out / student_temp
    t = torch.softmax((teacher_out - center) / teacher_temp, dim=-1).detach()
    s_chunks = s.split(s.shape[0] // n_scrops)
    t_chunks = t.split(t.shape[0] // n_tcrops)
    log_p = {}
    total, terms = 0.0, 0
    for iq, q in enumerate(t_chunks):
        for v in range(n_scrops):
            if (mode == 0 and v == iq) or (mode == 1 and v != iq) or (
                    mode == 2 and v < 2):
                continue
            if v not in log_p:
                log_p[v] = F.log_softmax(s_chunks[v], dim=-1)
            total = total - (q * log_p[v]).sum(dim=-1).mean()
            terms += 1
    return total / max(terms, 1)


def no_weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """name -> True where weight decay applies: not on biases, nor on 1-D
    parameters (norm scales, last_layer_g)."""
    return {n: p.dim() > 1 and n.rsplit(".", 1)[-1] != "bias"
            for n, p in model.named_parameters()}


class LARS(torch.optim.Optimizer):
    """optax.lars's update with its defaults (trust coefficient 1e-3, eps
    0, momentum 0.9, no Nesterov): u = g + weight_decay * p; u *= 1e-3 *
    ||p|| / ||u|| (1 where either norm is 0); buf = -lr * u + momentum *
    buf; p += buf. The momentum trace holds LR-scaled updates, as optax's
    does."""

    def __init__(self, params, lr: float = 0.0, weight_decay: float = 0.0,
                 momentum: float = 0.9, trust_coefficient: float = 1e-3,
                 eps: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      momentum=momentum,
                                      trust_coefficient=trust_coefficient,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LARS takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad
                if group["weight_decay"]:
                    u = u.add(p, alpha=group["weight_decay"])
                p_norm = torch.linalg.vector_norm(p)
                u_norm = torch.linalg.vector_norm(u)
                trust = torch.where(
                    (p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                    group["trust_coefficient"] * p_norm
                    / (u_norm + group["eps"]))
                u = u * (trust * -group["lr"])
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = u.clone()
                else:
                    state["momentum_buffer"].mul_(group["momentum"]).add_(u)
                p.add_(state["momentum_buffer"])


def make_dino_optimizer(kind: str, model: nn.Module,
                        weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    """SGD (momentum 0.9), "adamw" (optax.adam after the decay, i.e.
    torch's Adam with weight_decay) or "lars", the decay added to the
    gradient first and masked off biases and 1-D parameters
    (`no_weight_decay_mask`). The trainer writes the LR into every group
    before each step."""
    mask = no_weight_decay_mask(model)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    groups = [{"params": [p for n, p in named if mask[n] == decay],
               "weight_decay": weight_decay if decay else 0.0}
              for decay in (True, False)]
    groups = [g for g in groups if g["params"]]
    kind = kind.lower()
    if kind == "lars":
        return LARS(groups)
    if kind == "adamw":
        return torch.optim.Adam(groups, lr=0.0)
    return torch.optim.SGD(groups, lr=0.0, momentum=0.9)


@dataclasses.dataclass(frozen=True)
class DINOConfig:
    out_dim: int = 65536
    n_global: int = 2
    n_local: int = 4
    student_temp: float = 0.1
    center_momentum: float = 0.9
    freeze_last_layer_iters: int = 0
    clip_grad: float = 3.0
    mode: int = 0


def param_wise_clip(grads: List[torch.Tensor], clip: float
                    ) -> List[torch.Tensor]:
    """DINO's per-tensor clip, in place: g *= min(1, clip / (||g|| +
    1e-6))."""
    if grads:
        norms = torch._foreach_norm(grads)
        torch._foreach_mul_(grads, [torch.clamp(clip / (n + 1e-6), max=1.0)
                                    for n in norms])
    return grads


class DINOState(NamedTuple):
    student: DINOModel
    teacher: DINOModel
    center: torch.Tensor        # (1, out_dim) f32
    optimizer: torch.optim.Optimizer


def init_dino_state(backbone: nn.Module, head: DINOHead,
                    optimizer_fn: Callable[[nn.Module],
                                           torch.optim.Optimizer],
                    device: torch.device) -> DINOState:
    """The student (backbone + head) on `device`, the teacher as its copy
    with no gradient, a zero center and optimizer_fn(student). The caller
    seeds torch before building the modules."""
    student = DINOModel(backbone, head).to(device)
    teacher = copy.deepcopy(student)
    for p in teacher.parameters():
        p.requires_grad_(False)
    center = torch.zeros((1, head.last_layer_g.shape[0]), device=device)
    return DINOState(student, teacher, center, optimizer_fn(student))


class DINOTrainStep:
    """{"global_feat": (n_global * B, T, F), "local_feat": (n_local * B,
    T', F)} view-major features -> metrics {loss (device tensor), lr,
    momentum, teacher_temp (floats)}; updates the student, the teacher,
    the center and the optimizer in place and counts steps in `step`.
    Over a `mesh` each rank passes its own rows and the loss is the global
    batch's."""

    def __init__(self, state: DINOState, lr_fn: Callable,
                 momentum_fn: Callable, temp_fn: Callable,
                 cfg: DINOConfig = DINOConfig(),
                 compute_dtype: torch.dtype = torch.float32,
                 mesh: Mesh = None):
        self.student, self.teacher, self.center, self.optimizer = state
        self.group = (mesh or Mesh()).data_group
        global_batch_stats([self.student, self.teacher], self.group)
        self.lr_fn, self.momentum_fn, self.temp_fn = (lr_fn, momentum_fn,
                                                      temp_fn)
        self.cfg, self.compute_dtype = cfg, compute_dtype
        self.device = self.center.device
        self.step = 0

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        cfg, step = self.cfg, self.step
        lr = float(self.lr_fn(step))
        m = float(self.momentum_fn(step))
        temp = float(self.temp_fn(step))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        g_feat = _on(batch["global_feat"], self.device, self.compute_dtype)
        l_feat = _on(batch["local_feat"], self.device, self.compute_dtype)
        self.student.train()
        s_out = torch.cat([self.student(g_feat),
                           self.student(l_feat)]).float()
        self.teacher.eval()
        with torch.no_grad():
            t_out = self.teacher(g_feat).float()
        loss = dino_loss(s_out, t_out, self.center, temp,
                         cfg.n_global + cfg.n_local, cfg.n_global,
                         cfg.student_temp, cfg.mode)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        named = [(n, p) for n, p in self.student.named_parameters()
                 if p.grad is not None]
        loss, = mean_gradients([p for _, p in named], self.group,
                               loss.detach())
        param_wise_clip([p.grad for _, p in named], cfg.clip_grad)
        if step < cfg.freeze_last_layer_iters:
            # zeros, not None: the momentum buffers decay as optax's do
            for n, p in named:
                if "last_layer" in n:
                    p.grad.zero_()
        self.optimizer.step()
        with torch.no_grad():
            t_params = list(self.teacher.parameters())
            torch._foreach_mul_(t_params, m)
            torch._foreach_add_(t_params, list(self.student.parameters()),
                                alpha=1.0 - m)
            for tb, sb in zip(self.teacher.buffers(), self.student.buffers()):
                tb.copy_(sb)
            # every rank holds as many rows: the global mean
            t_mean = all_reduce_sum(t_out.sum(dim=0, keepdim=True),
                                    self.group) / (
                t_out.shape[0] * group_size(self.group))
            self.center = (self.center * cfg.center_momentum
                           + t_mean * (1 - cfg.center_momentum))
        self.step += 1
        return {"loss": loss, "lr": lr, "momentum": m,
                "teacher_temp": temp}

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resumed run continues from, on the CPU."""
        def cpu(sd):
            return {k: v.detach().cpu() for k, v in sd.items()}

        return {"student": cpu(self.student.state_dict()),
                "teacher": cpu(self.teacher.state_dict()),
                "optimizer": self.optimizer.state_dict(),
                "center": self.center.detach().cpu(), "step": self.step}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.student.load_state_dict(sd["student"], strict=True)
        self.teacher.load_state_dict(sd["teacher"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.center = sd["center"].to(self.device, torch.float32)
        self.step = int(sd["step"])
