"""RepVGG and RepSPK speaker encoders with structural re-parameterisation,
in PyTorch.

Counterpart of wespeaker_tpu/models/repvgg.py; module and parameter names
are the upstream torch ones as the JAX package's flax names give them
(wespeaker/models/repvgg.py: SEBlock_2D, conv_bn, RepVGGBlock,
RepSPKBlock, RepVGG), so a checkpoint of either package loads strictly.
The 2-D map is a logical (B, C, F, T) tensor in `torch.channels_last`
memory format, as in models/resnet.py.

In train form each block sums a 3x3 conv + BN (`rbr_dense`), a 1x1 conv +
BN (`rbr_1x1`; RepSPK: a 3x3 conv of dilation 2 + BN,
`rbr_dense_dilation`) and, where the block keeps its width and stride 1,
a BN of its input (`rbr_identity`), then relu and the optional SE. Under
`conv_dw_mode: packed` in training the 3x3 stride-1 `rbr_dense` convs of
at most 64 channels take the tap-packed filter gradient. In deploy form
(`deploy=True`) each block is one biased conv, `rbr_reparam` (3x3;
RepSPK 5x5), and `convert_repvgg_state_dict` fuses a train-form
state_dict into it, as the JAX package's `convert_repvgg_variables` fuses
its flax tree (BN eps 1e-5). An optional (B, T) frame mask, strided by the
product of the stage strides, reaches only the pooling.
"""

import re
from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from wespeaker_tpu_torch.models.layers import batch_norm, conv2d, wide
from wespeaker_tpu_torch.models.pooling_layers import (get_pooling,
                                                       pooling_out_dim)
from wespeaker_tpu_torch.models.resnet import (frame_features, pool_input,
                                               stem_input)


class SEBlock2D(nn.Module):
    def __init__(self, in_planes: int, ratio: int = 16):
        super().__init__()
        self.fc_1 = nn.Linear(in_planes, in_planes // ratio)
        self.fc_2 = nn.Linear(in_planes // ratio, in_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), dtype=torch.float32)
        s = torch.sigmoid(self.fc_2(torch.relu(self.fc_1(s))))
        return x * s.to(x.dtype)[:, :, None, None]


class ConvBN(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding,
                              dilation=dilation, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(conv2d(x, self.conv), self.bn)


class RepVGGBlock(nn.Module):
    """3x3 + 1x1 + identity in train form, one 3x3 conv deployed."""

    ksize = 3

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 groups: int = 1, deploy: bool = False,
                 use_se: bool = False):
        super().__init__()
        self.deploy = deploy
        k = self.ksize
        if deploy:
            self.rbr_reparam = nn.Conv2d(in_channels, out_channels, k,
                                         stride=stride, padding=k // 2,
                                         groups=groups, bias=True)
        else:
            self.rbr_dense = ConvBN(in_channels, out_channels, 3, stride, 1,
                                    groups=groups)
            self._second_branch(in_channels, out_channels, stride, groups)
            self.rbr_identity = (nn.BatchNorm2d(in_channels)
                                 if out_channels == in_channels
                                 and stride == 1 else None)
        self.se = SEBlock2D(out_channels, 4) if use_se else None

    def _second_branch(self, cin, cout, stride, groups):
        self.rbr_1x1 = ConvBN(cin, cout, 1, stride, 0, groups=groups)

    def _branches(self, x: torch.Tensor) -> torch.Tensor:
        return self.rbr_dense(x) + self.rbr_1x1(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            out = conv2d(x, self.rbr_reparam)
        else:
            out = self._branches(x)
            if self.rbr_identity is not None:
                out = out + batch_norm(x, self.rbr_identity)
        out = torch.relu(out)
        return out if self.se is None else self.se(out)


class RepSPKBlock(RepVGGBlock):
    """RSBB (arXiv:2110.09720): the second branch is a 3x3 conv of
    dilation 2; deploys to one 5x5 conv."""

    ksize = 5

    def _second_branch(self, cin, cout, stride, groups):
        self.rbr_dense_dilation = ConvBN(cin, cout, 3, stride, 2, dilation=2,
                                         groups=groups)

    def _branches(self, x: torch.Tensor) -> torch.Tensor:
        return self.rbr_dense(x) + self.rbr_dense_dilation(x)


OPTIONAL_GROUPWISE_LAYERS = tuple(range(2, 27, 2))
G2_MAP = {k: 2 for k in OPTIONAL_GROUPWISE_LAYERS}
G4_MAP = {k: 4 for k in OPTIONAL_GROUPWISE_LAYERS}


class RepVGG(nn.Module):
    def __init__(self, num_blocks: Sequence[int], strides: Sequence[int],
                 width_multiplier: Sequence[float], block: str = "RepVGG",
                 base_width: int = 64, deploy: bool = False,
                 use_se: bool = False, pooling_func: str = "TSTP",
                 feat_dim: int = 80, embed_dim: int = 256,
                 override_groups_map: Optional[dict] = None):
        super().__init__()
        wm = [w * (base_width / 64.0) for w in width_multiplier]
        block_cls = RepVGGBlock if block == "RepVGG" else RepSPKBlock
        self.block, self.strides = block, tuple(strides)
        in_planes = min(64, int(64 * wm[0]))
        self.stage0 = block_cls(1, in_planes, strides[0], deploy=deploy,
                                use_se=use_se)
        widths = (int(64 * wm[0]), int(128 * wm[1]), int(256 * wm[2]),
                  int(512 * wm[3]))
        groups_map = override_groups_map or {}
        layer_idx = 1
        f = (feat_dim - 1) // strides[0] + 1
        for si, (planes, count, stride) in enumerate(
                zip(widths, num_blocks, strides[1:]), start=1):
            blocks = []
            for s in [stride] + [1] * (count - 1):
                blocks.append(block_cls(in_planes, planes, s,
                                        groups=groups_map.get(layer_idx, 1),
                                        deploy=deploy, use_se=use_se))
                in_planes = planes
                layer_idx += 1
            f = (f - 1) // stride + 1
            setattr(self, f"stage{si}", nn.Sequential(*blocks))
        stats_dim = in_planes * f
        self.pool = get_pooling(pooling_func, stats_dim)
        self.seg = nn.Linear(pooling_out_dim(pooling_func, stats_dim),
                             embed_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_frame_feat: bool = False) -> torch.Tensor:
        """x: (B, T, F) features; mask: optional (B, T). Returns
        (B, embed_dim) in x's dtype, or with return_frame_feat the frame
        features (B, T', F' * C)."""
        h = self.stage0(stem_input(x))
        for si in range(1, 5):
            h = getattr(self, f"stage{si}")(h)
        if return_frame_feat:
            return frame_features(h)
        return self.seg(wide(self.pool(*pool_input(
            h, mask, int(np.prod(self.strides)))))).to(x.dtype)


_BLOCK_KEY = re.compile(r"^(stage\d+(?:\.\d+)?)\.(rbr_dense|rbr_1x1|"
                        r"rbr_dense_dilation|rbr_identity|se)\.")


def _fuse_convbn(sd, prefix: str):
    """(kernel * gamma / std, beta - mean * gamma / std) of a ConvBN."""
    t = sd[prefix + ".bn.weight"] / torch.sqrt(
        sd[prefix + ".bn.running_var"] + 1e-5)
    return (sd[prefix + ".conv.weight"] * t[:, None, None, None],
            sd[prefix + ".bn.bias"] - sd[prefix + ".bn.running_mean"] * t)


def convert_repvgg_state_dict(state_dict: Dict[str, torch.Tensor],
                              block: str = "RepVGG"
                              ) -> "OrderedDict[str, torch.Tensor]":
    """A train-form RepVGG (or, with block="RepSPK", RepSPK) state_dict ->
    the deploy form's: each block's branches and their BN fused into
    `rbr_reparam` (weight, bias), its SE kept, every other key kept. The
    upstream `repvgg_model_convert` and the JAX package's
    `convert_repvgg_variables`, on torch tensors in f32."""
    sd = {k: v.float() if v.is_floating_point() else v
          for k, v in state_dict.items()}
    out = OrderedDict()
    prefixes = []
    for key, value in sd.items():
        m = _BLOCK_KEY.match(key)
        if m is None:
            out[key] = value
            continue
        if m.group(1) not in prefixes:
            prefixes.append(m.group(1))
        if m.group(2) == "se":
            out[key] = value
    for p in prefixes:
        k3, b3 = _fuse_convbn(sd, p + ".rbr_dense")
        if block == "RepVGG":
            k1, b1 = _fuse_convbn(sd, p + ".rbr_1x1")
            kernel = k3 + nn.functional.pad(k1, (1, 1, 1, 1))
            bias = b3 + b1
        else:
            kd, bd = _fuse_convbn(sd, p + ".rbr_dense_dilation")
            k5 = kd.new_zeros(kd.shape[:2] + (5, 5))
            k5[:, :, ::2, ::2] = kd
            kernel = k5 + nn.functional.pad(k3, (1, 1, 1, 1))
            bias = b3 + bd
        if p + ".rbr_identity.weight" in sd:
            idp = p + ".rbr_identity."
            t = sd[idp + "weight"] / torch.sqrt(sd[idp + "running_var"]
                                                + 1e-5)
            ic, c = kernel.shape[1], kernel.shape[-1] // 2
            kid = torch.zeros_like(kernel)
            for i in range(kernel.shape[0]):
                kid[i, i % ic, c, c] = 1.0
            kernel = kernel + kid * t[:, None, None, None]
            bias = bias + sd[idp + "bias"] - sd[idp + "running_mean"] * t
        out[p + ".rbr_reparam.weight"] = kernel
        out[p + ".rbr_reparam.bias"] = bias
    return out


def _make(block, num_blocks, strides, wm, groups_map=None):
    def build(feat_dim, embed_dim, pooling_func="TSTP", deploy=False,
              use_se=block == "D2SE"):
        return RepVGG(num_blocks=num_blocks, strides=strides,
                      width_multiplier=wm,
                      block="RepVGG" if block == "D2SE" else block,
                      deploy=deploy, use_se=use_se,
                      pooling_func=pooling_func, feat_dim=feat_dim,
                      embed_dim=embed_dim, override_groups_map=groups_map)
    return build


_S = (1, 1, 2, 2, 2)
_A = (2, 4, 14, 1)
_B = (4, 6, 16, 1)
REPVGG_TINY_A0 = _make("RepVGG", (3, 4, 23, 3), _S, (0.5, 0.5, 0.5, 0.5))
REPVGG_TINY_RSBB_A0 = _make("RepSPK", (3, 4, 23, 3), _S,
                            (0.5, 0.5, 0.5, 0.5))
REPVGG_A0 = _make("RepVGG", _A, _S, (0.75, 0.75, 0.75, 2.5))
REPVGG_RSBB_A0 = _make("RepSPK", _A, _S, (0.75, 0.75, 0.75, 2.5))
REPVGG_A1 = _make("RepVGG", _A, _S, (1, 1, 1, 2.5))
REPVGG_A2 = _make("RepVGG", _A, _S, (1.5, 1.5, 1.5, 2.75))
REPVGG_RSBB_A2 = _make("RepSPK", _A, _S, (1.5, 1.5, 1.5, 2.75))
REPVGG_B0 = _make("RepVGG", _B, _S, (1, 1, 1, 2.5))
REPVGG_RSBB_B0 = _make("RepSPK", _B, _S, (1, 1, 1, 2.5))
REPVGG_B1 = _make("RepVGG", _B, _S, (2, 2, 2, 4))
REPVGG_B2 = _make("RepVGG", _B, _S, (2.5, 2.5, 2.5, 5))
REPVGG_D2SE = _make("D2SE", (8, 14, 24, 1), _S, (2.5, 2.5, 2.5, 5))
REPVGG_B1g2 = _make("RepVGG", _B, _S, (2, 2, 2, 4), G2_MAP)
REPVGG_B1g4 = _make("RepVGG", _B, _S, (2, 2, 2, 4), G4_MAP)
REPVGG_B2g2 = _make("RepVGG", _B, _S, (2.5, 2.5, 2.5, 5), G2_MAP)
REPVGG_B2g4 = _make("RepVGG", _B, _S, (2.5, 2.5, 2.5, 5), G4_MAP)
REPVGG_B3 = _make("RepVGG", _B, _S, (3, 3, 3, 5))
REPVGG_B3g2 = _make("RepVGG", _B, _S, (3, 3, 3, 5), G2_MAP)
REPVGG_B3g4 = _make("RepVGG", _B, _S, (3, 3, 3, 5), G4_MAP)
