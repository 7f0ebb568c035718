"""ReDimNet2 in PyTorch: ReDimNet whose stages each read a learned softmax
weighting of every earlier stage's 1-D output at full time resolution,
stride it in time and frequency by one strided conv, and return it
upsampled (nearest) to full time.

Counterpart of wespeaker_tpu/models/redimnet2.py; module and parameter
names are the upstream torch ones as the JAX package's flax names give
them (wespeaker/models/redimnet2.py: weigth1d, ConvBlock2d,
TimeContextBlock1d, ReDimNet2, ReDimNet2Wrap), so a checkpoint of either
package loads strictly. Each stage is an `nn.Sequential` whose indices are
upstream's: 0 the stage's `weigth1d` (its parameter `w`, (1, n, C * F,
1)), 1 the parameter-free `to2d` slot, 2 the strided conv (kernel and
stride (sf, cumulative time stride); groups = gcd(C, out) with
`compress_tconvs`), then the 2-D blocks (`conv_block`), the squeeze-back
conv + BN (eps 1e-6) where the stage expands its channels, the `to1d`
slot and the time-context block. The input's T is cut to a multiple of
the largest cumulative time stride. The 2-D and 1-D blocks, `to1d` and
`to2d` are the port's ReDimNet ones (models/redimnet.py), with
the 'conv' time block (four ConvNeXt-like blocks of kernels 7, 15 and 31)
added here.

The pooling is ASTP with global context in every constructor: in eval
with autograd off it runs on the two pooling kernels (`ops.pooling`),
each launched once per forward; `set_pooling_fused(model, False)` keeps
it plain. An optional (B, T) frame mask, cut to the output's T, reaches
only the pooling.
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from wespeaker_tpu_torch.models.layers import (batch_norm, conv1d, conv2d,
                                               wide)
from wespeaker_tpu_torch.models.pooling_layers import (get_pooling,
                                                       pooling_out_dim)
from wespeaker_tpu_torch.models.redimnet import (ConvBlock2d,
                                                 ConvNeXtLikeBlock1d, To1d,
                                                 TimeContextBlock1d, _ln,
                                                 layer_norm2d, to1d, to2d)


class weigth1d(nn.Module):
    """The softmax over `n` of w (1, n, C * F, 1) weights n (B, T, C * F)
    maps; a running sum in f32, in the maps' dtype."""

    def __init__(self, n: int, cf: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(1, n, cf, 1))

    def forward(self, outs) -> torch.Tensor:
        w = torch.softmax(self.w.float(), dim=1)[0, :, :, 0]
        acc = w[0] * outs[0]
        for j in range(1, len(outs)):
            acc = acc + w[j] * outs[j]
        return acc.to(outs[0].dtype)


class To2d(nn.Module):
    """Upstream's parameter-free `to2d` slot of a stage Sequential."""

    def __init__(self, c: int, f: int):
        super().__init__()
        self.c, self.f = c, f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to2d(x, self.c, self.f)


class TimeContextBlock1d2(TimeContextBlock1d):
    """ReDimNet's time-context block, plus the 'conv' type."""

    def __init__(self, C: int, hC: int, pos_ker_sz: int = 59,
                 block_type: str = "conv+att"):
        if block_type != "conv":
            super().__init__(C, hC, pos_ker_sz, block_type)
            return
        nn.Module.__init__(self)
        self.block_type = block_type
        self.red_dim_conv = nn.Sequential(nn.Conv1d(C, hC, 1), _ln(hC))
        self.tcm = nn.Sequential(*(ConvNeXtLikeBlock1d(hC, (7, 15, 31), 1)
                                   for _ in range(4)))
        self.exp_dim_conv = nn.Conv1d(hC, C, 1)


def upsample_time(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsampling along T of a (B, T, D) map."""
    return x if factor == 1 else x.repeat_interleave(factor, dim=1)


class ReDimNet2Backbone(nn.Module):
    def __init__(self, F: int = 72, C: int = 24,
                 out_channels: Optional[int] = None,
                 block_1d_type: str = "conv+att",
                 block_2d_type: str = "basic_resnet",
                 return_2d_output: bool = False,
                 compress_tconvs: bool = True, stages_setup: Sequence = (),
                 group_divisor: Optional[int] = 1):
        super().__init__()
        cf = F * C
        self.return_2d_output = return_2d_output
        self.stem = nn.Sequential(nn.Conv2d(1, C, 3, padding=1), _ln(C))
        self.num_stages = len(stages_setup)
        self.time_strides = []
        cur_c, cur_f, stt = C, F, 1
        for si, ((sf, st), num_blocks, conv_exp, kernel_sizes,
                 att_red) in enumerate(stages_setup):
            stt *= st
            self.time_strides.append(stt)
            tconv_out = int(sf * cur_c * conv_exp)
            groups = math.gcd(int(cur_c), tconv_out) if compress_tconvs else 1
            layers = [weigth1d(si + 1, cf), To2d(cur_c, cur_f),
                      nn.Conv2d(cur_c, tconv_out, (sf, stt), stride=(sf, stt),
                                groups=groups)]
            cur_c, cur_f = sf * cur_c, cur_f // sf
            layers += [ConvBlock2d(tconv_out, cur_f, block_2d_type,
                                   group_divisor, kernel_sizes)
                       for _ in range(num_blocks)]
            if conv_exp != 1:
                layers.append(nn.Sequential(nn.Conv2d(tconv_out, cur_c, 1),
                                            nn.BatchNorm2d(cur_c, eps=1e-6)))
            layers.append(To1d())
            if att_red is not None:
                layers.append(TimeContextBlock1d2(cf, cf // att_red,
                                                  block_type=block_1d_type))
            setattr(self, f"stage{si}", nn.Sequential(*layers))
        self.fin_wght1d = weigth1d(self.num_stages + 1, cf)
        self.out_c, self.out_f = cur_c, cur_f
        self.head = None
        if out_channels is not None:
            self.head = (nn.Conv2d(cur_c, out_channels, 1) if return_2d_output
                         else nn.Conv1d(cf, out_channels, 1))

    @property
    def out_dim(self) -> int:
        """The width of the wrapper's (B, T, D) features."""
        if self.return_2d_output:
            c = self.head.out_channels if self.head is not None else self.out_c
            return c * self.out_f
        if self.head is not None:
            return self.head.out_channels
        return self.out_c * self.out_f

    def _stage(self, si: int, outs) -> torch.Tensor:
        stage = getattr(self, f"stage{si}")
        h = stage[0](outs)
        for m in list(stage)[1:]:
            if isinstance(m, nn.Conv2d):
                h = conv2d(h, m)
            elif isinstance(m, nn.Sequential):  # the squeeze-back
                h = batch_norm(conv2d(h, m[0]), m[1])
            else:
                h = m(h)
        return upsample_time(h, self.time_strides[si])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 1, F, T) channels_last -> (B, T', D) features, or with
        return_2d_output the (B, c, f, T') map (T' = T cut to a multiple
        of the largest cumulative time stride)."""
        stt = max(self.time_strides, default=1)
        x = x[..., :(x.shape[-1] // stt) * stt]
        outs = [to1d(layer_norm2d(conv2d(x, self.stem[0]), self.stem[1]))]
        for si in range(self.num_stages):
            outs.append(self._stage(si, outs))
        out = self.fin_wght1d(outs)
        if self.return_2d_output:
            out = to2d(out, self.out_c, self.out_f)
            return out if self.head is None else conv2d(out, self.head)
        return out if self.head is None else conv1d(out, self.head)


class ReDimNet2Wrap(nn.Module):
    def __init__(self, F: int = 72, C: int = 24,
                 feat_dim: Optional[int] = None, embed_dim: int = 192,
                 pooling_func: str = "ASTP",
                 out_channels: Optional[int] = None,
                 block_1d_type: str = "conv+att",
                 block_2d_type: str = "basic_resnet",
                 compress_tconvs: bool = True,
                 return_2d_output: bool = False, stages_setup: Sequence = (),
                 group_divisor: Optional[int] = 1,
                 global_context_att: bool = True, emb_bn: bool = False):
        super().__init__()
        self.backbone = ReDimNet2Backbone(
            feat_dim if feat_dim is not None else F, C, out_channels,
            block_1d_type, block_2d_type, return_2d_output, compress_tconvs,
            stages_setup, group_divisor)
        in_dim = self.backbone.out_dim
        self.pool = get_pooling(pooling_func, in_dim,
                                global_context_att=global_context_att)
        self.bn = nn.BatchNorm1d(pooling_out_dim(pooling_func, in_dim))
        self.linear = nn.Linear(self.bn.num_features, embed_dim)
        self.bn2 = nn.BatchNorm1d(embed_dim) if emb_bn else None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_frame_feat: bool = False) -> torch.Tensor:
        """x: (B, T, F) features; mask: optional (B, T). Returns
        (B, embed_dim) in x's dtype, or with return_frame_feat the frame
        features (B, T', D), a 2-D output flattened c-major."""
        out = self.backbone(x.transpose(1, 2)[:, None].contiguous(
            memory_format=torch.channels_last))
        if out.dim() == 4:
            b, c, f, t = out.shape
            out = out.permute(0, 3, 1, 2).reshape(b, t, c * f)
        if return_frame_feat:
            return out
        fmask = None if mask is None else mask[:, :out.shape[1]]
        emb = self.linear(batch_norm(wide(self.pool(out, fmask)), self.bn))
        if self.bn2 is not None:
            emb = batch_norm(emb, self.bn2)
        return emb.to(x.dtype)


def _wrap(C, out_channels, stages, feat_dim=72, embed_dim=192,
          pooling_func="ASTP", return_2d_output=False, **kw):
    return ReDimNet2Wrap(F=feat_dim, C=C, feat_dim=feat_dim,
                         embed_dim=embed_dim, pooling_func=pooling_func,
                         out_channels=out_channels,
                         return_2d_output=return_2d_output,
                         stages_setup=tuple(
                             (tuple(s[0]), s[1], s[2],
                              tuple(tuple(k) for k in s[3]), s[4])
                             for s in stages), **kw)


def ReDimNet2B0(feat_dim=72, embed_dim=192, pooling_func="ASTP", **kw):
    stages = [[[1, 1], 2, 2, [[3, 3]], 36], [[2, 1], 3, 1, [[3, 3]], 36],
              [[1, 2], 4, 1, [[3, 3]], 36], [[2, 1], 5, 1, [[3, 3]], 36],
              [[1, 2], 4, 1, [[3, 3]], 18], [[2, 1], 3, 1, [[3, 3]], 18]]
    return _wrap(12, 64, stages, feat_dim, embed_dim, pooling_func, **kw)


def ReDimNet2B1(feat_dim=72, embed_dim=192, pooling_func="ASTP", **kw):
    stages = [[[1, 1], 2, 2, [[3, 3]], 32], [[2, 1], 3, 1, [[3, 3]], 32],
              [[1, 2], 4, 1, [[3, 3]], 32], [[2, 1], 5, 1, [[3, 3]], 32],
              [[1, 2], 4, 1, [[3, 3]], 16], [[2, 1], 3, 1, [[3, 3]], 16]]
    return _wrap(16, 64, stages, feat_dim, embed_dim, pooling_func, **kw)


def ReDimNet2B2(feat_dim=72, embed_dim=192, pooling_func="ASTP", **kw):
    stages = [[[1, 1], 2, 2, [[3, 5]], 40], [[2, 1], 3, 1, [[3, 5]], 30],
              [[1, 2], 4, 1, [[3, 5]], 30], [[3, 1], 5, 1, [[3, 5]], 20],
              [[1, 2], 4, 1, [[3, 7]], 20], [[2, 1], 3, 1, [[3, 7]], 10]]
    return _wrap(20, 64, stages, feat_dim, embed_dim, pooling_func, **kw)


def ReDimNet2B3(feat_dim=72, embed_dim=192, pooling_func="ASTP", **kw):
    stages = [[[1, 1], 2, 2, [[3, 3]], 36], [[2, 1], 3, 1, [[3, 3]], 36],
              [[1, 2], 4, 1, [[3, 3]], 36], [[2, 1], 5, 1, [[3, 3]], 36],
              [[1, 2], 4, 1, [[3, 3]], 18], [[2, 1], 3, 1, [[3, 3]], 18]]
    return _wrap(24, 64, stages, feat_dim, embed_dim, pooling_func, **kw)


def ReDimNet2B4(feat_dim=72, embed_dim=192, pooling_func="ASTP", **kw):
    stages = [[[1, 1], 2, 4, [[3, 3]], 24], [[2, 1], 3, 3, [[3, 3]], 24],
              [[1, 2], 4, 2, [[3, 3]], 24], [[2, 1], 5, 1, [[3, 3]], 24],
              [[1, 2], 4, 1, [[3, 3]], 24], [[2, 1], 3, 1, [[3, 3]], 24]]
    return _wrap(32, None, stages, feat_dim, embed_dim, pooling_func, **kw)


def ReDimNet2B5(feat_dim=72, embed_dim=192, pooling_func="ASTP", **kw):
    stages = [[[1, 1], 2, 4, [[3, 3]], 48], [[2, 1], 3, 3, [[3, 3]], 48],
              [[1, 2], 4, 2, [[3, 3]], 48], [[2, 1], 5, 1, [[3, 3]], 48],
              [[1, 2], 4, 1, [[3, 3]], 32], [[2, 1], 3, 1, [[3, 3]], 32]]
    return _wrap(48, 256, stages, feat_dim, embed_dim, pooling_func, **kw)


def ReDimNet2B6(feat_dim=72, embed_dim=192, pooling_func="ASTP", **kw):
    stages = [[[1, 1], 3, 3, [[3, 3]], 64], [[2, 1], 4, 2, [[3, 3]], 64],
              [[1, 2], 5, 2, [[3, 3]], 48], [[2, 1], 5, 1, [[3, 3]], 48],
              [[1, 2], 4, 0.75, [[3, 3]], 32], [[2, 1], 3, 0.5, [[3, 3]], 24]]
    return _wrap(64, 224, stages, feat_dim, embed_dim, pooling_func,
                 return_2d_output=True, **kw)
