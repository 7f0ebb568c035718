"""The w2v-bert adapter-MFA head: an adapter on each of the frontend's
last N hidden states, their outputs side by side, ASP, and a linear
bottleneck.

Counterpart of wespeaker_tpu/models/w2vbert_adapter_mfa.py (upstream
wespeaker/models/w2vbert_adapter_mfa.py:21-124). Each adapter is
Linear -> LayerNorm -> ReLU -> Linear as a Sequential (children 0, 1, 3,
the upstream names); its LayerNorm uses flax's default eps 1e-6, as the
JAX package's `LayerNorm(name="1")` does. ASP is plain PyTorch.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn

from wespeaker_tpu_torch.models.layers import layer_norm, linear
from wespeaker_tpu_torch.models.pooling_layers import (get_pooling,
                                                       pooling_out_dim)


class Adapter(nn.Sequential):
    def __init__(self, in_dim: int, adapter_dim: int):
        super().__init__(nn.Linear(in_dim, adapter_dim),
                         nn.LayerNorm(adapter_dim, eps=1e-6), nn.ReLU(),
                         nn.Linear(adapter_dim, adapter_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(layer_norm(linear(x, self[0]), self[1]))
        return linear(h, self[3])


class W2VBert_Adapter_MFA(nn.Module):
    def __init__(self, feat_dim: int, embed_dim: int = 256,
                 pooling_func: str = "ASP", n_mfa_layers: int = -1,
                 adapter_dim: int = 128, num_frontend_hidden_layers: int = 24):
        super().__init__()
        n_avail = num_frontend_hidden_layers + 1
        self.n = n_avail if n_mfa_layers == -1 else n_mfa_layers
        self.adapter_layers = nn.ModuleList(Adapter(feat_dim, adapter_dim)
                                            for _ in range(self.n))
        self.pooling = get_pooling(pooling_func, adapter_dim * self.n,
                                   hidden_dim=adapter_dim)
        self.bottleneck = nn.Linear(
            pooling_out_dim(pooling_func, adapter_dim * self.n), embed_dim)

    def forward(self, all_hidden_states: Sequence[torch.Tensor],
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """all_hidden_states: (B, T, feat_dim) states (the input embedding
        and each layer's); the last N feed the adapters."""
        states = list(all_hidden_states)[-self.n:]
        combined = torch.cat([a(s) for a, s in zip(self.adapter_layers,
                                                   states)], dim=-1)
        return linear(self.pooling(combined, mask), self.bottleneck)
