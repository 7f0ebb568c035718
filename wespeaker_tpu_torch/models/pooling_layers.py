"""Temporal pooling: frame-level features -> utterance-level statistics.

Counterpart of wespeaker_tpu/models/pooling_layers.py. Layout (B, T, D);
every pooling takes an optional (B, T) frame-validity mask so padded
batches pool exactly like the unpadded batch=1 path. Ported: TAP, TSDP,
TSTP and ASTP (with and without global context); the rest raise.

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
"""

from typing import Optional

import torch
import torch.nn as nn

from wespeaker_tpu_torch.models.layers import conv1d, masked_mean
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
        count = torch.tensor(float(x.shape[1]), dtype=x.dtype,
                             device=x.device)
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
        alpha = conv1d(alpha, self.linear2)
        if mask is not None:
            alpha = torch.where(mask[..., None] > 0, alpha,
                                torch.full_like(alpha, _NEG_INF))
        alpha = torch.softmax(alpha, dim=1)
        mean = (alpha * x).sum(dim=1)
        var = (alpha * x ** 2).sum(dim=1) - mean ** 2
        std = torch.sqrt(torch.clamp(var, min=1e-7))
        return torch.cat([mean, std], dim=-1)


_POOLINGS = {"TAP": TAP, "TSDP": TSDP, "TSTP": TSTP, "ASTP": ASTP}


def get_pooling(name: str, in_dim: int, **kwargs) -> nn.Module:
    if name not in _POOLINGS:
        raise KeyError(f"pooling {name} is not ported yet; "
                       f"ported: {sorted(_POOLINGS)}")
    return _POOLINGS[name](in_dim, **kwargs)


def set_pooling_fused(model: nn.Module,
                      fused: Optional[bool]) -> nn.Module:
    """Set `fused` on every TSDP, TSTP and ASTP layer of `model`: None or
    True routes eval through ops.pooling, False keeps the plain path."""
    for m in model.modules():
        if isinstance(m, (TSDP, ASTP)):
            m.fused = fused
    return model


def pooling_out_dim(name: str, in_dim: int) -> int:
    if name not in _POOLINGS:
        raise KeyError(f"pooling {name} is not ported yet")
    return in_dim if name in ("TAP", "TSDP") else 2 * in_dim
