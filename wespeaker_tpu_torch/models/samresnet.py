"""SimAM-ResNet with ASP pooling (the VoxBlink models) in PyTorch.

Counterpart of wespeaker_tpu/models/samresnet.py; module and parameter
names are the upstream torch ones (wespeaker/models/samresnet.py:
SimAMBasicBlock, ResNet as `front`, ASP as `pooling`, `bottleneck`), so an
upstream state_dict loads with `load_state_dict(strict=True)`. The 2-D map
is a logical (B, C, F, T) tensor in `torch.channels_last` memory format,
as in models/resnet.py, and under `conv_dw_mode: packed` in training the
3x3 stride-1 convs of at most 64 channels take the tap-packed filter
gradient. SimAM is the parameter-free attention x * sigmoid(e_inv) of each
block; its energy takes the mean over all of (F, T), padded frames
included, as in the JAX package, so a padded batch is not the batch=1
result. An optional (B, T) frame mask, strided as `mask[:, ::8][:, :T']`,
reaches only the pooling.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn

from wespeaker_tpu_torch.models.eres2net import _conv3x3
from wespeaker_tpu_torch.models.layers import batch_norm, conv2d, wide
from wespeaker_tpu_torch.models.pooling_layers import ASP
from wespeaker_tpu_torch.models.resnet import (_residual, _shortcut,
                                               frame_features, pool_input,
                                               pooled_width, stem_input)


def simam(x: torch.Tensor, lambda_p: float = 1e-4) -> torch.Tensor:
    """x * sigmoid(d / (4 (v + lambda_p)) + 0.5), with d the squared
    deviation from each channel's mean over (F, T) and v its sum over
    F * T - 1; statistics in f32, result in x's dtype."""
    y = wide(x)
    n = x.shape[2] * x.shape[3] - 1
    d = (y - y.mean(dim=(2, 3), keepdim=True)) ** 2
    v = d.sum(dim=(2, 3), keepdim=True) / n
    return (y * torch.sigmoid(d / (4 * (v + lambda_p)) + 0.5)).to(x.dtype)


class SimAMBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv3x3(in_planes, planes, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv3x3(planes, planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = _shortcut(in_planes, planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(batch_norm(conv2d(x, self.conv1), self.bn1))
        out = simam(batch_norm(conv2d(out, self.conv2), self.bn2))
        return torch.relu(out + _residual(self.downsample, x))


class SimAMResNetTrunk(nn.Module):
    """Upstream's `front`: the stem and four stages."""

    def __init__(self, in_planes: int, num_blocks: Sequence[int]):
        super().__init__()
        p = in_planes
        self.conv1 = _conv3x3(1, p)
        self.bn1 = nn.BatchNorm2d(p)
        cur = p
        for i, (planes, stride) in enumerate(
                zip((p, 2 * p, 4 * p, 8 * p), (1, 2, 2, 2))):
            layer = []
            for s in [stride] + [1] * (num_blocks[i] - 1):
                layer.append(SimAMBasicBlock(cur, planes, s))
                cur = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(batch_norm(conv2d(x, self.conv1), self.bn1))
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            h = layer(h)
        return h


class SimAM_ResNet_ASP(nn.Module):
    def __init__(self, in_planes: int = 64,
                 num_blocks: Sequence[int] = (3, 4, 6, 3),
                 embed_dim: int = 256, feat_dim: int = 80):
        super().__init__()
        self.front = SimAMResNetTrunk(in_planes, num_blocks)
        width = pooled_width(feat_dim, 8 * in_planes)
        self.pooling = ASP(width)
        self.bottleneck = nn.Linear(2 * width, embed_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_frame_feat: bool = False) -> torch.Tensor:
        """x: (B, T, F) features; mask: optional (B, T). Returns
        (B, embed_dim) in x's dtype, or with return_frame_feat the frame
        features (B, T', F' * C)."""
        h = self.front(stem_input(x))
        if return_frame_feat:
            return frame_features(h)
        return self.bottleneck(wide(self.pooling(
            *pool_input(h, mask, 8)))).to(x.dtype)


def SimAM_ResNet34_ASP(in_planes=64, embed_dim=256, acoustic_dim=80,
                       feat_dim=None, **_):
    return SimAM_ResNet_ASP(in_planes, (3, 4, 6, 3), embed_dim,
                            feat_dim or acoustic_dim)


def SimAM_ResNet100_ASP(in_planes=64, embed_dim=256, acoustic_dim=80,
                        feat_dim=None, **_):
    return SimAM_ResNet_ASP(in_planes, (6, 16, 24, 3), embed_dim,
                            feat_dim or acoustic_dim)
