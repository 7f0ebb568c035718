"""Temporal pooling: frame-level features -> utterance-level statistics.

Counterpart of wespeaker_tpu/models/pooling_layers.py. Layout (B, T, D);
every pooling takes an optional (B, T) frame-validity mask so padded
batches pool exactly like the unpadded batch=1 path. Every pooling of
the JAX package is here: TAP, TSDP, TSTP, ASTP (with and without global
context), ASP, MHASTP, MQMHASTP and XI, with the upstream module names
(ASP's `attention` Sequential, MHASTP's `heads_att_trans.<h>.att_<i>`,
MQMHASTP's `n_query.<q>`, XI's `lin1_relu_bn` and `lin2`).

TSDP, TSTP and ASTP take `fused` (None by default). In eval mode with
autograd off (as every extraction and serving entry point runs) and
`fused` not False, their statistics go through `ops.pooling`: the masked
mean and std (TSDP, TSTP, ASTP's global context) through
`fused_masked_stats`, ASTP's softmax over T and weighted mean and std
through `fused_softmax_stats` with the mask passed in. On a CUDA tensor
those launch the hand-written kernels, on a CPU tensor their plain
versions, in f32; each layer returns its result in x's dtype, as the plain
path does. Training, autograd on or `fused=False` run the plain path
below. The route is chosen from the mode before the call, never as a
fallback. (The JAX package keeps its Pallas pooling out of the models:
on the TPU, XLA overlapped the jnp tail with the convolution before it.)
ASP, MHASTP, MQMHASTP and XI are plain PyTorch, as the JAX package runs
them outside Pallas.
"""

import inspect
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from wespeaker_tpu_torch.models.layers import batch_norm, conv1d, masked_mean
from wespeaker_tpu_torch.ops.pooling import (fused_masked_stats,
                                             fused_softmax_stats)

_NEG_INF = -1e30


def _mask3(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if mask is None else mask[..., None]


def _std(x: torch.Tensor, mask: Optional[torch.Tensor], ddof: int):
    """Masked mean and std over T; std = sqrt(var + 1e-7) with
    var = sum((x - mean)^2) / max(count - ddof, 1) (torch.var's unbiased
    default at ddof=1)."""
    m = _mask3(mask)
    mean = masked_mean(x, m, dim=1, keepdim=True)
    sq = (x - mean) ** 2
    if m is not None:
        sq = sq * m
        count = m.sum(dim=1)
    else:
        # a tensor of the size, not float(size): an exported graph keeps
        # T symbolic
        count = torch.full((), x.shape[1], dtype=x.dtype, device=x.device)
    var = sq.sum(dim=1) / torch.clamp(count - ddof, min=1.0)
    return mean.squeeze(1), torch.sqrt(var + 1e-7)


class TAP(nn.Module):
    """Temporal average pooling."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.in_dim = in_dim

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return masked_mean(x, _mask3(mask), dim=1)


def _use_kernel(layer: nn.Module) -> bool:
    return (layer.fused is not False and not layer.training
            and not torch.is_grad_enabled())


class TSDP(TAP):
    """Temporal standard-deviation pooling (unbiased, as torch.var)."""

    def __init__(self, in_dim: int, fused: Optional[bool] = None):
        super().__init__(in_dim)
        self.fused = fused

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if _use_kernel(self):
            return fused_masked_stats(x.contiguous(), mask)[1].to(x.dtype)
        return _std(x, mask, ddof=1)[1]


class TSTP(TSDP):
    """Temporal statistics pooling: concat(mean, unbiased std), the
    x-vector and CAM++ default."""

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if _use_kernel(self):
            return fused_masked_stats(x.contiguous(), mask,
                                      concat=True).to(x.dtype)
        return torch.cat(_std(x, mask, ddof=1), dim=-1)


def _softmax_stats(score: torch.Tensor, x: torch.Tensor,
                   mask: Optional[torch.Tensor], floor: float):
    """Softmax of `score` over T (masked frames at -1e30), broadcast over
    x's channels, and the weighted mean and std of x (variance clamped at
    `floor`)."""
    if mask is not None:
        score = torch.where(mask[..., None] > 0, score,
                            torch.full_like(score, _NEG_INF))
    w = torch.softmax(score, dim=1)
    mean = (w * x).sum(dim=1)
    var = (w * x ** 2).sum(dim=1) - mean ** 2
    return mean, torch.sqrt(torch.clamp(var, min=floor))


class ASTP(nn.Module):
    """Attentive statistics pooling (ECAPA-TDNN), optional global context.
    Upstream parameter names: linear1 / linear2 (k=1 Conv1d)."""

    def __init__(self, in_dim: int, bottleneck_dim: int = 128,
                 global_context_att: bool = False,
                 fused: Optional[bool] = None):
        super().__init__()
        self.global_context_att = global_context_att
        self.fused = fused
        k_in = 3 * in_dim if global_context_att else in_dim
        self.linear1 = nn.Conv1d(k_in, bottleneck_dim, kernel_size=1)
        self.linear2 = nn.Conv1d(bottleneck_dim, in_dim, kernel_size=1)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        kernel = _use_kernel(self)
        if kernel:
            x = x.contiguous()
        if self.global_context_att:
            if kernel:
                ctx_mean, ctx_std = fused_masked_stats(x, mask)
            else:
                ctx_mean, ctx_std = _std(x, mask, ddof=1)
            # linear1 over concat([x, mean, std]) without materialising the
            # (B, T, 3C) concat: the context rows of the k=1 kernel reduce
            # to a per-utterance bias broadcast over T
            c = x.shape[-1]
            k = self.linear1.weight[:, :, 0].t().to(x.dtype)  # (3C, A)
            ctx = (ctx_mean.to(x.dtype) @ k[c:2 * c]
                   + ctx_std.to(x.dtype) @ k[2 * c:]
                   + self.linear1.bias.to(x.dtype))
            alpha = torch.tanh(x @ k[:c] + ctx[:, None, :])
        else:
            alpha = torch.tanh(conv1d(x, self.linear1))
        if kernel:
            # linear2 as a product, whose (B, T, C) result is contiguous
            # (conv1d's is a transposed view); the mask goes in: masked
            # frames take -1e30 inside the kernel
            logits = (alpha @ self.linear2.weight[:, :, 0].t().to(x.dtype)
                      + self.linear2.bias.to(x.dtype))
            return fused_softmax_stats(logits, x, mask,
                                       concat=True).to(x.dtype)
        return torch.cat(_softmax_stats(conv1d(alpha, self.linear2), x, mask,
                                        1e-7), dim=-1)


class ASP(nn.Module):
    """Attentive statistics pooling of the SSL and SimAM models:
    conv-relu-BN-conv attention, variance floor 1e-5."""

    def __init__(self, in_dim: int, hidden_dim: int = 128):
        super().__init__()
        self.attention = nn.Sequential(
            nn.Conv1d(in_dim, hidden_dim, kernel_size=1), nn.ReLU(),
            nn.BatchNorm1d(hidden_dim),
            nn.Conv1d(hidden_dim, in_dim, kernel_size=1))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        att = self.attention
        h = batch_norm(torch.relu(conv1d(x, att[0])), att[2])
        return torch.cat(_softmax_stats(conv1d(h, att[3]), x, mask, 1e-5),
                         dim=-1)


class MHASTP(nn.Module):
    """Multi-head attentive statistics pooling (arXiv:1906.09890): the
    channels split into `head_num` heads, each with its own k=1 conv
    stack; `d_s` 1 gives each head one attention column broadcast over its
    channels, `d_s` > 1 one a channel."""

    def __init__(self, in_dim: int, layer_num: int = 2, head_num: int = 2,
                 d_s: int = 1, bottleneck_dim: int = 64):
        super().__init__()
        assert in_dim % head_num == 0
        self.d_model = in_dim // head_num
        self.layer_num = layer_num
        dims = [bottleneck_dim] * (layer_num + 1)
        dims[0], dims[-1] = self.d_model, self.d_model if d_s > 1 else 1
        heads = []
        for _ in range(head_num):
            att = nn.Sequential()
            for i in range(layer_num - 1):
                att.add_module(f"att_{i}", nn.Conv1d(dims[i], dims[i + 1], 1))
                att.add_module(f"tanh{i}", nn.Tanh())
            att.add_module(f"att_{layer_num - 1}",
                           nn.Conv1d(dims[-2], dims[-1], 1))
            heads.append(att)
        self.heads_att_trans = nn.ModuleList(heads)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        outs = []
        for i, att in enumerate(self.heads_att_trans):
            chunk = x[..., i * self.d_model:(i + 1) * self.d_model]
            h = chunk
            for j in range(self.layer_num - 1):
                h = torch.tanh(conv1d(h, getattr(att, f"att_{j}")))
            score = conv1d(h, getattr(att, f"att_{self.layer_num - 1}"))
            outs.extend(_softmax_stats(score, chunk, mask, 1e-7))
        return torch.cat(outs, dim=-1)


class MQMHASTP(nn.Module):
    """Multi-query multi-head attentive statistics pooling
    (arXiv:2110.05042): `query_num` MHASTPs side by side."""

    def __init__(self, in_dim: int, layer_num: int = 2, query_num: int = 2,
                 head_num: int = 8, d_s: int = 2, bottleneck_dim: int = 64):
        super().__init__()
        self.n_query = nn.ModuleList(
            MHASTP(in_dim, layer_num, head_num, d_s, bottleneck_dim)
            for _ in range(query_num))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return torch.cat([q(x, mask) for q in self.n_query], dim=-1)


class XI(nn.Module):
    """Xi-vector Gaussian posterior-inference pooling: a frame's precision
    logprec = clip(2 log softplus(.), -15, 15) weights it in a softmax over
    the T frames and one prior frame (`prior_mean`, `prior_logprec`);
    masked frames take -1e30. Returns the posterior mean, and with
    `stddev` the std beside it."""

    def __init__(self, in_dim: int, hidden_size: int = 256,
                 stddev: bool = False):
        super().__init__()
        self.stddev = stddev
        self.lin1_relu_bn = nn.Sequential(
            nn.Conv1d(in_dim, hidden_size, kernel_size=1), nn.ReLU(),
            nn.BatchNorm1d(hidden_size))
        self.lin2 = nn.Conv1d(hidden_size, in_dim, kernel_size=1)
        self.prior_mean = nn.Parameter(torch.zeros(1, in_dim))
        self.prior_logprec = nn.Parameter(torch.zeros(1, in_dim))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        lin1 = self.lin1_relu_bn
        h = batch_norm(torch.relu(conv1d(x, lin1[0])), lin1[2])
        logprec = torch.clamp(
            2.0 * torch.log(F.softplus(conv1d(h, self.lin2))), -15.0, 15.0)
        if mask is not None:
            logprec = torch.where(mask[..., None] > 0, logprec,
                                  torch.full_like(logprec, _NEG_INF))
        b, _, d = x.shape
        prior = (self.prior_logprec.to(x.dtype)[None].expand(b, 1, d),
                 self.prior_mean.to(x.dtype)[None].expand(b, 1, d))
        attn = torch.softmax(torch.cat([logprec, prior[0]], dim=1), dim=1)
        feats = torch.cat([x, prior[1]], dim=1)
        phi = (feats * attn).sum(dim=1)
        if not self.stddev:
            return phi
        sigma2 = (feats ** 2 * attn).sum(dim=1)
        return torch.cat(
            [phi, torch.sqrt(torch.clamp(sigma2 - phi ** 2, min=1e-12))],
            dim=-1)


_POOLINGS = {"TAP": TAP, "TSDP": TSDP, "TSTP": TSTP, "ASTP": ASTP,
             "ASP": ASP, "MHASTP": MHASTP, "MQMHASTP": MQMHASTP, "XI": XI}


def get_pooling(name: str, in_dim: int, **kwargs) -> nn.Module:
    """The pooling `name` over in_dim channels; kwargs that its class does
    not take are dropped, as the JAX package's get_pooling drops them."""
    cls = _POOLINGS[name]
    takes = inspect.signature(cls.__init__).parameters
    return cls(in_dim, **{k: v for k, v in kwargs.items() if k in takes})


def set_pooling_fused(model: nn.Module,
                      fused: Optional[bool]) -> nn.Module:
    """Set `fused` on every TSDP, TSTP and ASTP layer of `model`: None or
    True routes eval through ops.pooling, False keeps the plain path."""
    for m in model.modules():
        if isinstance(m, (TSDP, ASTP)):
            m.fused = fused
    return model


def pooling_out_dim(name: str, in_dim: int, **kwargs) -> int:
    """The width of the pooling's output: in_dim for TAP, TSDP and XI
    without `stddev`, 2 * query_num * in_dim for MQMHASTP, 2 * in_dim for
    the rest."""
    if name not in _POOLINGS:
        raise KeyError(f"unknown pooling {name}")
    if name in ("TAP", "TSDP"):
        return in_dim
    if name == "MQMHASTP":
        return 2 * in_dim * kwargs.get("query_num", 2)
    if name == "XI":
        return 2 * in_dim if kwargs.get("stddev", False) else in_dim
    return 2 * in_dim
