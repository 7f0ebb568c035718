"""ERes2Net: Res2Net blocks with local and global attentional feature
fusion, in PyTorch (Chen et al., "An Enhanced Res2Net with Local and
Global Feature Fusion for Speaker Verification", Interspeech 2023).

Counterpart of wespeaker_tpu/models/eres2net.py; module and parameter
names are the upstream torch ones (wespeaker/models/eres2net.py: AFF,
BasicBlockERes2Net, BasicBlockERes2Net_diff_AFF, ERes2Net), so an upstream
state_dict loads with `load_state_dict(strict=True)`. The 2-D map is a
logical (B, C, F, T) tensor in `torch.channels_last` memory format, as in
models/resnet.py, and every conv goes through `layers.conv2d`: under
`conv_dw_mode: packed` in training the 3x3 stride-1 convs of at most 64
channels (the stem and the Res2 convs of layers 1-3) take the tap-packed
filter gradient (`ops.conv_dw_pack`).

The blocks' activation is upstream's `ReLU`, a Hardtanh(0, 20) (`relu20`);
the stem's is a plain relu. AFF gates two maps x, y with
att = 1 + tanh(local_att([x, y])): x * att + y * (2 - att). Layers 1 and 2
are Res2 blocks whose splits add hierarchically, layers 3 and 4 fuse
them with AFF instead (`conv2_1` / `bn2_1` for the first split,
`convs.<i>` / `bns.<i>` / `fuse_models.<i>` for the rest), and the four
stage outputs fuse in turn through strided 3x3 convs
(`layer<n>_downsample`) and `fuse_mode12` / `fuse_mode123` /
`fuse_mode1234`. The pooling input is flattened c-major, (B, T', C * F'),
and `return_frame_feat` f-major, (B, T', F' * C); `seg_1` takes the true
pooled width, as in models/resnet.py. An optional (B, T) frame mask,
strided as `mask[:, ::8][:, :T']`, reaches only the pooling.
"""

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from wespeaker_tpu_torch.models.layers import batch_norm, conv2d
from wespeaker_tpu_torch.models.resnet import (_residual, _shortcut,
                                               embed_map, embedding_head,
                                               pooled_width, stem_input)


def relu20(x: torch.Tensor) -> torch.Tensor:
    """Upstream's ReLU: Hardtanh(0, 20)."""
    return torch.clamp(x, 0.0, 20.0)


def _conv1x1(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel_size=1, stride=stride, bias=False)


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel_size=3, stride=stride, padding=1,
                     bias=False)


def _split_width(planes: int, base_width: int) -> int:
    return int(math.floor(planes * (base_width / 64.0)))


class AFF(nn.Module):
    """Attentional feature fusion of two maps of `channels` channels."""

    def __init__(self, channels: int = 64, r: int = 4):
        super().__init__()
        inter = channels // r
        self.local_att = nn.Sequential(
            nn.Conv2d(channels * 2, inter, kernel_size=1),
            nn.BatchNorm2d(inter), nn.SiLU(),
            nn.Conv2d(inter, channels, kernel_size=1),
            nn.BatchNorm2d(channels))

    def forward(self, x: torch.Tensor, ds_y: torch.Tensor) -> torch.Tensor:
        la = self.local_att
        h = batch_norm(conv2d(torch.cat([x, ds_y], dim=1), la[0]), la[1])
        h = batch_norm(conv2d(F.silu(h), la[3]), la[4])
        att = 1.0 + torch.tanh(h)
        return x * att + ds_y * (2.0 - att)


class BasicBlockERes2Net(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 base_width: int = 32, scale: int = 2, expansion: int = 2):
        super().__init__()
        width = _split_width(planes, base_width)
        self.width, self.scale = width, scale
        self.conv1 = _conv1x1(in_planes, width * scale, stride)
        self.bn1 = nn.BatchNorm2d(width * scale)
        self.convs = nn.ModuleList(_conv3x3(width, width)
                                   for _ in range(scale))
        self.bns = nn.ModuleList(nn.BatchNorm2d(width) for _ in range(scale))
        self.conv3 = _conv1x1(width * scale, planes * expansion)
        self.bn3 = nn.BatchNorm2d(planes * expansion)
        self.shortcut = _shortcut(in_planes, planes * expansion, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = relu20(batch_norm(conv2d(x, self.conv1), self.bn1))
        w = self.width
        outs = []
        for i in range(self.scale):
            split = out[:, i * w:(i + 1) * w]
            sp = split if i == 0 else sp + split
            sp = relu20(batch_norm(conv2d(sp, self.convs[i]), self.bns[i]))
            outs.append(sp)
        out = batch_norm(conv2d(torch.cat(outs, dim=1), self.conv3),
                         self.bn3)
        return relu20(out + _residual(self.shortcut, x))


class BasicBlockERes2NetDiffAFF(nn.Module):
    """The Res2 block whose hierarchical adds are AFF fusions."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 base_width: int = 32, scale: int = 2, expansion: int = 2):
        super().__init__()
        width = _split_width(planes, base_width)
        self.width, self.scale = width, scale
        self.conv1 = _conv1x1(in_planes, width * scale, stride)
        self.bn1 = nn.BatchNorm2d(width * scale)
        self.conv2_1 = _conv3x3(width, width)
        self.bn2_1 = nn.BatchNorm2d(width)
        self.convs = nn.ModuleList(_conv3x3(width, width)
                                   for _ in range(scale - 1))
        self.bns = nn.ModuleList(nn.BatchNorm2d(width)
                                 for _ in range(scale - 1))
        self.fuse_models = nn.ModuleList(AFF(width)
                                         for _ in range(scale - 1))
        self.conv3 = _conv1x1(width * scale, planes * expansion)
        self.bn3 = nn.BatchNorm2d(planes * expansion)
        self.shortcut = _shortcut(in_planes, planes * expansion, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = relu20(batch_norm(conv2d(x, self.conv1), self.bn1))
        w = self.width
        sp = relu20(batch_norm(conv2d(out[:, :w], self.conv2_1), self.bn2_1))
        outs = [sp]
        for i in range(1, self.scale):
            sp = self.fuse_models[i - 1](sp, out[:, i * w:(i + 1) * w])
            sp = relu20(batch_norm(conv2d(sp, self.convs[i - 1]),
                                   self.bns[i - 1]))
            outs.append(sp)
        out = batch_norm(conv2d(torch.cat(outs, dim=1), self.conv3),
                         self.bn3)
        return relu20(out + _residual(self.shortcut, x))


class ERes2Net(nn.Module):
    def __init__(self, m_channels: int, num_blocks, base_width: int = 32,
                 scale: int = 2, expansion: int = 2, feat_dim: int = 80,
                 embed_dim: int = 192, pooling_func: str = "TSTP",
                 two_emb_layer: bool = False):
        super().__init__()
        m, e = m_channels, expansion
        self.conv1 = _conv3x3(1, m)
        self.bn1 = nn.BatchNorm2d(m)
        in_planes = m
        blocks = (BasicBlockERes2Net, BasicBlockERes2Net,
                  BasicBlockERes2NetDiffAFF, BasicBlockERes2NetDiffAFF)
        for i, (block, planes, stride) in enumerate(
                zip(blocks, (m, 2 * m, 4 * m, 8 * m), (1, 2, 2, 2))):
            layer = []
            for s in [stride] + [1] * (num_blocks[i] - 1):
                layer.append(block(in_planes, planes, s, base_width, scale,
                                   expansion))
                in_planes = planes * expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        for i, c in enumerate((2 * m * e, 4 * m * e, 8 * m * e)):
            setattr(self, f"layer{i + 1}_downsample",
                    _conv3x3(c // 2, c, stride=2))
        self.fuse_mode12 = AFF(2 * m * e)
        self.fuse_mode123 = AFF(4 * m * e)
        self.fuse_mode1234 = AFF(8 * m * e)
        embedding_head(self, pooling_func, pooled_width(feat_dim, in_planes),
                       embed_dim, two_emb_layer)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_frame_feat: bool = False) -> torch.Tensor:
        """x: (B, T, F) features; mask: optional (B, T). Returns
        (B, embed_dim) in x's dtype, or with return_frame_feat the fused
        frame features (B, T', F' * C)."""
        h = torch.relu(batch_norm(conv2d(stem_input(x), self.conv1),
                                  self.bn1))
        out1 = self.layer1(h)
        out2 = self.layer2(out1)
        fuse = self.fuse_mode12(out2, conv2d(out1, self.layer1_downsample))
        out3 = self.layer3(out2)
        fuse = self.fuse_mode123(out3, conv2d(fuse, self.layer2_downsample))
        out4 = self.layer4(out3)
        fuse = self.fuse_mode1234(out4, conv2d(fuse,
                                               self.layer3_downsample))
        return embed_map(self, fuse, mask, x.dtype, return_frame_feat)


def ERes2Net34_Base(feat_dim, embed_dim, pooling_func="TSTP",
                    two_emb_layer=False):
    return ERes2Net(32, (3, 4, 6, 3), feat_dim=feat_dim, embed_dim=embed_dim,
                    pooling_func=pooling_func, two_emb_layer=two_emb_layer)


def ERes2Net34_Large(feat_dim, embed_dim, pooling_func="TSTP",
                     two_emb_layer=False):
    return ERes2Net(64, (3, 4, 6, 3), feat_dim=feat_dim, embed_dim=embed_dim,
                    pooling_func=pooling_func, two_emb_layer=two_emb_layer)


def ERes2Net34_aug(feat_dim, embed_dim, pooling_func="TSTP",
                   two_emb_layer=False, expansion=4, baseWidth=24, scale=3):
    return ERes2Net(64, (3, 4, 6, 3), base_width=baseWidth, scale=scale,
                    expansion=expansion, feat_dim=feat_dim,
                    embed_dim=embed_dim, pooling_func=pooling_func,
                    two_emb_layer=two_emb_layer)
