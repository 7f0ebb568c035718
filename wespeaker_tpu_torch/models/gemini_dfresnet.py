"""Gemini DF-ResNet in PyTorch: depth-first inverted bottlenecks with the
Golden-Gemini T14c stride strategy (F strides 2, 2, 2, 2; T strides 1, 2,
1, 1).

Counterpart of wespeaker_tpu/models/gemini_dfresnet.py; module and
parameter names are the upstream torch ones (wespeaker/models/
gemini_dfresnet.py: Inverted_Bottleneck, Gemini_DF_ResNet), so an upstream
state_dict loads with `load_state_dict(strict=True)`. The 2-D map is a
logical (B, C, F, T) tensor in `torch.channels_last` memory format, whose
storage is the JAX package's (B, F, T, C): cuDNN runs the stem, the
downsample 3x3s and the depthwise convs on NHWC, and the stage kernel reads
rows of C. The pooling input is flattened c-major, (B, T, C * F'), and
`return_frame_feat` f-major, (B, T, F' * C), as in the JAX package. An
optional (B, T) frame mask, strided as T, reaches only the pooling (the
convolutions see the padding, as in the JAX package).

In eval mode with `fused_stages` None (the default) or True, each stage
runs as one call of `ops.inv_bottleneck.fused_inv_bottleneck_stage` with BN
folded: on a CUDA tensor that launches the hand-written kernel (which takes
widths that are multiples of 32, as every constructor's are, and raises for
others), on a CPU tensor its plain version. The choice is made from the
configuration before the call, never as a fallback. Training and `fused_stages=False` run block
by block. (The JAX package keeps its Pallas stage opt-in for a TPU compile
cost per shape that a CUDA kernel does not have.)
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn

from wespeaker_tpu_torch.models.layers import batch_norm, conv2d, wide
from wespeaker_tpu_torch.models.pooling_layers import (get_pooling,
                                                       pooling_out_dim)
from wespeaker_tpu_torch.ops.inv_bottleneck import fused_inv_bottleneck_stage

STRIDE_F = (2, 2, 2, 2)
STRIDE_T = (1, 2, 1, 1)


class InvertedBottleneck(nn.Module):
    """1x1 to 4 dim, depthwise 3x3 (groups = 4 dim), 1x1 back to dim, BN
    after each conv, residual and relu (upstream Inverted_Bottleneck)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, 4 * dim, kernel_size=1, bias=False)
        self.bn1 = nn.BatchNorm2d(4 * dim)
        self.conv2 = nn.Conv2d(4 * dim, 4 * dim, kernel_size=3, padding=1,
                               groups=4 * dim, bias=False)
        self.bn2 = nn.BatchNorm2d(4 * dim)
        self.conv3 = nn.Conv2d(4 * dim, dim, kernel_size=1, bias=False)
        self.bn3 = nn.BatchNorm2d(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(batch_norm(conv2d(x, self.conv1), self.bn1))
        out = torch.relu(batch_norm(conv2d(out, self.conv2), self.bn2))
        out = batch_norm(conv2d(out, self.conv3), self.bn3)
        return torch.relu(out + x)


def _folded_bns(bns):
    """Eval BNs of one width, stacked: (scale, shift), each (L, width) f32,
    in a fixed number of launches whatever L is."""
    def stack(name):
        return torch.stack([getattr(bn, name) for bn in bns]).float()

    scale = stack("weight") / torch.sqrt(stack("running_var") + bns[0].eps)
    return scale, stack("bias") - stack("running_mean") * scale


def folded_stage(stage: nn.Sequential):
    """A stage's blocks as the stacked, BN-folded weights of
    fused_inv_bottleneck_stage: (w1 (L, C, 4C), s1, t1, wdw (L, 3, 3, 4C),
    s2, t2, w2 (L, 4C, C), s3, t3). A fixed number of launches: one stack per
    tensor kind (of views in the kernel's layout, so each stack is
    contiguous), then the folding on the stacks."""
    blocks = list(stage)

    def stack(get):
        return torch.stack([get(b) for b in blocks])

    w1 = stack(lambda b: b.conv1.weight[:, :, 0, 0].t())
    wdw = stack(lambda b: b.conv2.weight[:, 0].permute(1, 2, 0))
    w2 = stack(lambda b: b.conv3.weight[:, :, 0, 0].t())
    s1, t1 = _folded_bns([b.bn1 for b in blocks])
    s2, t2 = _folded_bns([b.bn2 for b in blocks])
    s3, t3 = _folded_bns([b.bn3 for b in blocks])
    return [v.detach() for v in (w1, s1, t1, wdw, s2, t2, w2, s3, t3)]


def _conv_bn(in_dim: int, out_dim: int, stride, relu: bool):
    layers = [nn.Conv2d(in_dim, out_dim, kernel_size=3, stride=stride,
                        padding=1, bias=False), nn.BatchNorm2d(out_dim)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


class Gemini_DF_ResNet(nn.Module):
    def __init__(self, depths: Sequence[int], dims: Sequence[int],
                 feat_dim: int = 40, embed_dim: int = 128,
                 pooling_func: str = "TSTP", two_emb_layer: bool = False,
                 fused_stages: Optional[bool] = None):
        super().__init__()
        self.fused_stages = fused_stages
        self.downsample_layers = nn.ModuleList(
            [_conv_bn(1, dims[0], 1, relu=True)]
            + [_conv_bn(dims[i], dims[i + 1], (STRIDE_F[i], STRIDE_T[i]),
                        relu=False) for i in range(4)])
        self.stages = nn.ModuleList(
            nn.Sequential(*(InvertedBottleneck(dims[i + 1])
                            for _ in range(depths[i])))
            for i in range(4))
        f = feat_dim
        for s in STRIDE_F:
            f = (f - 1) // s + 1
        # the true pooled width: upstream's (feat_dim // 16) * dims[-1]
        # wherever that is right (feat 16, 32, 80), and what the JAX
        # package's seg_1 takes at any feat_dim
        stats_dim = f * dims[-1]
        self.pool = get_pooling(pooling_func, stats_dim)
        self.seg_1 = nn.Linear(pooling_out_dim(pooling_func, stats_dim),
                               embed_dim)
        self.two_emb_layer = two_emb_layer
        if two_emb_layer:
            self.seg_bn_1 = nn.BatchNorm1d(embed_dim, affine=False)
            self.seg_2 = nn.Linear(embed_dim, embed_dim)

    def set_fused(self, fused: Optional[bool]) -> "Gemini_DF_ResNet":
        """Route eval through the fused stage calls (None or True) or block
        by block (False)."""
        self.fused_stages = fused
        return self

    def _stage(self, h: torch.Tensor, i: int) -> torch.Tensor:
        stage = self.stages[i]
        if self.fused_stages is not False and not self.training:
            return fused_inv_bottleneck_stage(h, *folded_stage(stage))
        return stage(h)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_frame_feat: bool = False) -> torch.Tensor:
        """x: (B, T, F) features; mask: optional (B, T). Returns
        (B, embed_dim) in x's dtype, or with return_frame_feat the frame
        features (B, T', F' * C)."""
        h = x.transpose(1, 2)[:, None].contiguous(
            memory_format=torch.channels_last)  # (B, 1, F, T)
        for i, layer in enumerate(self.downsample_layers):
            h = batch_norm(conv2d(h, layer[0]), layer[1])
            if i == 0:
                h = torch.relu(h)
            else:
                h = self._stage(h, i - 1)
        b, c, f, t = h.shape
        if return_frame_feat:
            return h.permute(0, 3, 2, 1).reshape(b, t, f * c)
        feat = h.permute(0, 3, 1, 2).reshape(b, t, c * f)
        fmask = None if mask is None else mask[:, ::2][:, :t]
        out = self.seg_1(wide(self.pool(feat, fmask)))
        if self.two_emb_layer:
            out = self.seg_2(batch_norm(torch.relu(out), self.seg_bn_1))
        return out.to(x.dtype)


def _constructor(depths):
    def build(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=False,
              fused_stages=None):
        return Gemini_DF_ResNet(depths, (32, 32, 64, 128, 256),
                                feat_dim=feat_dim, embed_dim=embed_dim,
                                pooling_func=pooling_func,
                                two_emb_layer=two_emb_layer,
                                fused_stages=fused_stages)
    return build


Gemini_DF_ResNet60 = _constructor((3, 3, 9, 3))
Gemini_DF_ResNet114 = _constructor((3, 3, 27, 3))
Gemini_DF_ResNet183 = _constructor((3, 8, 45, 3))
Gemini_DF_ResNet237 = _constructor((3, 8, 63, 3))
