"""The Whisper-PMFA head: ASTP with global context over the Whisper
encoder's concatenated hidden states, then BN and a linear layer.

Counterpart of wespeaker_tpu/models/whisper_PMFA.py (upstream
wespeaker/models/whisper_PMFA.py:112-139). The pooling is the port's
`get_pooling("ASTP", ...)`, so in evaluation with autograd off its
statistics run on the pooling kernels (rows 6 and 7 of PERF.md §6), at
D = 8 x 1280 = 10,240 for whisper-large-v2's layers 16-23. The BN is
`bn.norm`, the name the JAX package's torch_compat rules give it.
"""

from typing import Optional

import torch
import torch.nn as nn

from wespeaker_tpu_torch.models.layers import batch_norm, linear
from wespeaker_tpu_torch.models.pooling_layers import (get_pooling,
                                                       pooling_out_dim)


class whisper_PMFA(nn.Module):
    def __init__(self, output_size: int = 1280, embedding_dim: int = 192,
                 pooling_func: str = "ASTP", global_context_att: bool = True):
        super().__init__()
        self.pooling = get_pooling(pooling_func, output_size,
                                   global_context_att=global_context_att)
        dim = pooling_out_dim(pooling_func, output_size)
        self.bn = nn.ModuleDict({"norm": nn.BatchNorm1d(dim)})
        self.fc = nn.Linear(dim, embedding_dim)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, output_size) -> (B, embedding_dim)."""
        pooled = batch_norm(self.pooling(x, mask), self.bn["norm"])
        return linear(pooled, self.fc)


def whisper_PMFA_large_v2(feat_dim, embed_dim):
    return whisper_PMFA(output_size=feat_dim, embedding_dim=embed_dim)
