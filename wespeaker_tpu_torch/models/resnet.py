"""ResNet (r-vector) speaker encoders in PyTorch.

Counterpart of wespeaker_tpu/models/resnet.py; module and parameter names
are the upstream torch ones (wespeaker/models/resnet.py: BasicBlock,
Bottleneck, ResNet), so an upstream state_dict loads with
`load_state_dict(strict=True)`. The 2-D map is a logical (B, C, F, T)
tensor in `torch.channels_last` memory format, whose storage is the JAX
package's (B, F, T, C): cuDNN runs NHWC, and the tap-packed filter-gradient
kernel (`ops.conv_dw_pack`, under `conv_dw_mode: packed` in training)
reads rows of C. The pooling input is flattened c-major, (B, T', C * F'),
and `return_frame_feat` f-major, (B, T', F' * C), as in the JAX package.
An optional (B, T) frame mask, strided as the three stride-2 stages stride
T, reaches only the pooling.

`seg_1` takes the true pooled width, with F' = ceil(feat_dim / 8): the JAX
package writes (feat_dim // 8) * m_channels * 8 for the pooling's width,
but its Dense takes what arrives, and at a feat_dim that 8 does not divide
(20: F' = 3, not 2) the two differ.
"""

from typing import Optional, Sequence, Type

import torch
import torch.nn as nn

from wespeaker_tpu_torch.models.layers import batch_norm, conv2d, wide
from wespeaker_tpu_torch.models.pooling_layers import (get_pooling,
                                                       pooling_out_dim)


def _shortcut(in_planes: int, out_planes: int, stride: int) -> nn.Sequential:
    """Identity (an empty Sequential) or a strided 1x1 conv and BN."""
    if stride == 1 and in_planes == out_planes:
        return nn.Sequential()
    return nn.Sequential(
        nn.Conv2d(in_planes, out_planes, kernel_size=1, stride=stride,
                  bias=False), nn.BatchNorm2d(out_planes))


def _residual(shortcut: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    if len(shortcut) == 0:
        return x
    return batch_norm(conv2d(x, shortcut[0]), shortcut[1])


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, kernel_size=3,
                               stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, kernel_size=3, stride=1,
                               padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.shortcut = _shortcut(in_planes, planes * self.expansion, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(batch_norm(conv2d(x, self.conv1), self.bn1))
        out = batch_norm(conv2d(out, self.conv2), self.bn2)
        return torch.relu(out + _residual(self.shortcut, x))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, kernel_size=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, kernel_size=3, stride=stride,
                               padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * self.expansion,
                               kernel_size=1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.shortcut = _shortcut(in_planes, planes * self.expansion, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(batch_norm(conv2d(x, self.conv1), self.bn1))
        out = torch.relu(batch_norm(conv2d(out, self.conv2), self.bn2))
        out = batch_norm(conv2d(out, self.conv3), self.bn3)
        return torch.relu(out + _residual(self.shortcut, x))


def stem_input(x: torch.Tensor) -> torch.Tensor:
    """(B, T, F) features -> the (B, 1, F, T) channels_last map."""
    return x.transpose(1, 2)[:, None].contiguous(
        memory_format=torch.channels_last)


def pooled_width(feat_dim: int, channels: int) -> int:
    """C * F' after three stride-2 stages: F' = ceil(feat_dim / 8)."""
    f = feat_dim
    for _ in range(3):
        f = (f - 1) // 2 + 1
    return f * channels


def frame_features(h: torch.Tensor) -> torch.Tensor:
    """A (B, C, F', T') map as (B, T', F' * C), d = f * C + c."""
    b, c, f, t = h.shape
    return h.permute(0, 3, 2, 1).reshape(b, t, f * c)


def pool_input(h: torch.Tensor, mask: Optional[torch.Tensor], stride: int):
    """A (B, C, F', T') map as the pooling's (B, T', C * F') input, d =
    c * F' + f, and the (B, T) mask strided to T'; None for no mask or a
    mask shorter than T', as the JAX ResNet takes it."""
    b, c, f, t = h.shape
    feat = h.permute(0, 3, 1, 2).reshape(b, t, c * f)
    if mask is None or mask.shape[1] < t:
        return feat, None
    return feat, mask[:, ::stride][:, :t]


def embedding_head(model: nn.Module, pooling_func: str, stats_dim: int,
                   embed_dim: int, two_emb_layer: bool) -> None:
    """`pool`, `seg_1` and, with two_emb_layer, the affine-free `seg_bn_1`
    and `seg_2` on `model`."""
    model.pool = get_pooling(pooling_func, stats_dim)
    model.seg_1 = nn.Linear(pooling_out_dim(pooling_func, stats_dim),
                            embed_dim)
    model.two_emb_layer = two_emb_layer
    if two_emb_layer:
        model.seg_bn_1 = nn.BatchNorm1d(embed_dim, affine=False)
        model.seg_2 = nn.Linear(embed_dim, embed_dim)


def embed_map(model: nn.Module, h: torch.Tensor,
              mask: Optional[torch.Tensor], dtype,
              return_frame_feat: bool) -> torch.Tensor:
    """The embedding of the last stage's (B, C, F', T') map through
    `embedding_head`'s modules, in `dtype`, or with return_frame_feat its
    frame features."""
    if return_frame_feat:
        return frame_features(h)
    out = model.seg_1(wide(model.pool(*pool_input(h, mask, 8))))
    if model.two_emb_layer:
        out = model.seg_2(batch_norm(torch.relu(out), model.seg_bn_1))
    return out.to(dtype)


class ResNet(nn.Module):
    def __init__(self, block: Type[nn.Module], num_blocks: Sequence[int],
                 m_channels: int = 32, feat_dim: int = 40,
                 embed_dim: int = 128, pooling_func: str = "TSTP",
                 two_emb_layer: bool = False):
        super().__init__()
        m = m_channels
        self.conv1 = nn.Conv2d(1, m, kernel_size=3, stride=1, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(m)
        in_planes = m
        for i, (planes, stride) in enumerate(
                ((m, 1), (2 * m, 2), (4 * m, 2), (8 * m, 2))):
            blocks = []
            for s in [stride] + [1] * (num_blocks[i] - 1):
                blocks.append(block(in_planes, planes, s))
                in_planes = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        embedding_head(self, pooling_func, pooled_width(feat_dim, in_planes),
                       embed_dim, two_emb_layer)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_frame_feat: bool = False) -> torch.Tensor:
        """x: (B, T, F) features; mask: optional (B, T). Returns
        (B, embed_dim) in x's dtype, or with return_frame_feat the frame
        features (B, T', F' * C)."""
        h = torch.relu(batch_norm(conv2d(stem_input(x), self.conv1),
                                  self.bn1))
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            h = layer(h)
        return embed_map(self, h, mask, x.dtype, return_frame_feat)


def _constructor(block, num_blocks):
    def build(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False):
        return ResNet(block, num_blocks, feat_dim=feat_dim,
                      embed_dim=embed_dim, pooling_func=pooling_func,
                      two_emb_layer=two_emb_layer)
    return build


ResNet18 = _constructor(BasicBlock, (2, 2, 2, 2))
ResNet34 = _constructor(BasicBlock, (3, 4, 6, 3))
ResNet50 = _constructor(Bottleneck, (3, 4, 6, 3))
ResNet101 = _constructor(Bottleneck, (3, 4, 23, 3))
ResNet152 = _constructor(Bottleneck, (3, 8, 36, 3))
ResNet221 = _constructor(Bottleneck, (6, 16, 48, 3))
ResNet293 = _constructor(Bottleneck, (10, 20, 64, 3))
