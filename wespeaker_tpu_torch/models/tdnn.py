"""Kaldi-style TDNN x-vector in PyTorch.

Counterpart of wespeaker_tpu/models/tdnn.py; module and parameter names
are the upstream torch ones (wespeaker/models/tdnn.py: TdnnLayer, XVEC),
so an upstream state_dict loads with `load_state_dict(strict=True)`.
Activations are (B, T, C) channels-last. Each TdnnLayer is an unpadded
dilated conv, relu and an affine-free BatchNorm; the five frame layers
drop 4 + 2 * 2 + 3 * 2 = 14 frames, and an optional (B, T) frame mask is
cut to the output by dropping its first 14 frames (`mask[:, lost:]`), as
the JAX package does. In eval with autograd off, TSTP (the default) runs
on the masked-statistics kernel (models/pooling_layers.py).
"""

from typing import Optional

import torch
import torch.nn as nn

from wespeaker_tpu_torch.models.layers import batch_norm, conv1d, wide
from wespeaker_tpu_torch.models.pooling_layers import (get_pooling,
                                                       pooling_out_dim)


class TdnnLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, context_size: int,
                 dilation: int = 1, padding: int = 0):
        super().__init__()
        self.conv_1d = nn.Conv1d(in_dim, out_dim, context_size,
                                 dilation=dilation, padding=padding)
        self.bn = nn.BatchNorm1d(out_dim, affine=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(torch.relu(conv1d(x, self.conv_1d)), self.bn)


class XVEC(nn.Module):
    def __init__(self, feat_dim: int = 40, hid_dim: int = 512,
                 stats_dim: int = 1500, embed_dim: int = 512,
                 pooling_func: str = "TSTP"):
        super().__init__()
        self.frame_1 = TdnnLayer(feat_dim, hid_dim, 5, 1)
        self.frame_2 = TdnnLayer(hid_dim, hid_dim, 3, 2)
        self.frame_3 = TdnnLayer(hid_dim, hid_dim, 3, 3)
        self.frame_4 = TdnnLayer(hid_dim, hid_dim, 1, 1)
        self.frame_5 = TdnnLayer(hid_dim, stats_dim, 1, 1)
        self.pool = get_pooling(pooling_func, stats_dim)
        self.seg_1 = nn.Linear(pooling_out_dim(pooling_func, stats_dim),
                               embed_dim)
        self.seg_bn_1 = nn.BatchNorm1d(embed_dim, affine=False)
        self.seg_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_frame_feat: bool = False) -> torch.Tensor:
        """x: (B, T, F) features; mask: optional (B, T). Returns
        (B, embed_dim) in x's dtype, or with return_frame_feat the frame
        features (B, T - 14, stats_dim)."""
        out = x
        for layer in (self.frame_1, self.frame_2, self.frame_3,
                      self.frame_4, self.frame_5):
            out = layer(out)
        if return_frame_feat:
            return out
        fmask = None if mask is None else mask[:, x.shape[1] - out.shape[1]:]
        h = torch.relu(self.seg_1(wide(self.pool(out, fmask))))
        return self.seg_2(batch_norm(h, self.seg_bn_1)).to(x.dtype)
