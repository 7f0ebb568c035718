"""Res2Net r-vector (hierarchical split-conv residual blocks) in PyTorch.

Counterpart of wespeaker_tpu/models/res2net.py; module and parameter names
are the upstream torch ones (wespeaker/models/res2net.py:
BasicBlockRes2Net, Res2Net), so an upstream state_dict loads with
`load_state_dict(strict=True)`. Layout, activations (`relu20` in the
blocks, relu at the stem), the packed filter gradient under
`conv_dw_mode: packed`, the pooling input, `return_frame_feat` and the
mask are those of models/eres2net.py. Each block convolves `scale - 1`
splits hierarchically and passes the last one through.
"""

from typing import Optional

import torch
import torch.nn as nn

from wespeaker_tpu_torch.models.eres2net import (_conv1x1, _conv3x3,
                                                 _split_width, relu20)
from wespeaker_tpu_torch.models.layers import batch_norm, conv2d
from wespeaker_tpu_torch.models.resnet import (_residual, _shortcut,
                                               embed_map, embedding_head,
                                               pooled_width, stem_input)


class BasicBlockRes2Net(nn.Module):
    expansion = 2

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 base_width: int = 32, scale: int = 2):
        super().__init__()
        width = _split_width(planes, base_width)
        self.width, self.nums = width, scale - 1
        self.conv1 = _conv1x1(in_planes, width * scale, stride)
        self.bn1 = nn.BatchNorm2d(width * scale)
        self.convs = nn.ModuleList(_conv3x3(width, width)
                                   for _ in range(self.nums))
        self.bns = nn.ModuleList(nn.BatchNorm2d(width)
                                 for _ in range(self.nums))
        self.conv3 = _conv1x1(width * scale, planes * self.expansion)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.shortcut = _shortcut(in_planes, planes * self.expansion, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = relu20(batch_norm(conv2d(x, self.conv1), self.bn1))
        w = self.width
        outs = []
        for i in range(self.nums):
            split = out[:, i * w:(i + 1) * w]
            sp = split if i == 0 else sp + split
            sp = relu20(batch_norm(conv2d(sp, self.convs[i]), self.bns[i]))
            outs.append(sp)
        outs.append(out[:, self.nums * w:])
        out = batch_norm(conv2d(torch.cat(outs, dim=1), self.conv3),
                         self.bn3)
        return relu20(out + _residual(self.shortcut, x))


class Res2Net(nn.Module):
    def __init__(self, m_channels: int, num_blocks, feat_dim: int = 80,
                 embed_dim: int = 192, pooling_func: str = "TSTP",
                 two_emb_layer: bool = False):
        super().__init__()
        m = m_channels
        self.conv1 = _conv3x3(1, m)
        self.bn1 = nn.BatchNorm2d(m)
        in_planes = m
        for i, (planes, stride) in enumerate(
                zip((m, 2 * m, 4 * m, 8 * m), (1, 2, 2, 2))):
            layer = []
            for s in [stride] + [1] * (num_blocks[i] - 1):
                layer.append(BasicBlockRes2Net(in_planes, planes, s))
                in_planes = planes * BasicBlockRes2Net.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
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


def Res2Net34_Base(feat_dim, embed_dim, pooling_func="TSTP",
                   two_emb_layer=False):
    return Res2Net(32, (3, 4, 6, 3), feat_dim=feat_dim, embed_dim=embed_dim,
                   pooling_func=pooling_func, two_emb_layer=two_emb_layer)


def Res2Net34_Large(feat_dim, embed_dim, pooling_func="TSTP",
                    two_emb_layer=False):
    return Res2Net(64, (3, 4, 6, 3), feat_dim=feat_dim, embed_dim=embed_dim,
                   pooling_func=pooling_func, two_emb_layer=two_emb_layer)
