"""CAM++ (context-aware masking densely connected TDNN) in PyTorch.

Counterpart of wespeaker_tpu/models/campplus.py; module and parameter names
are the upstream torch ones (wespeaker/models/campplus.py: CAMLayer,
CAMDenseTDNNLayer, FCM, CAMPPlus), so an upstream state_dict loads with
`load_state_dict(strict=True)`. The FCM head runs its 2-D convs (B, C, F, T)
for cuDNN and flattens to (B, T, C * F') with index c * F' + f, as the JAX
package's (B, F, T, C) head does; the TDNN trunk runs (B, T, C). An optional
(B, T) frame mask, strided with the TDNN, excludes padded frames from the
CAM context means and the pooling, as in the JAX package (the convolutions
still see the padding next to the last real frames).

In eval mode with `fused_blocks` None (the default) or True, each dense
block whose layers grow by 32 channels through a 128-wide bottleneck (the
kernel's shapes) runs as one call of `ops.cam_block.fused_cam_dense_block`
with BN folded: on a CUDA tensor that launches the hand-written kernel, on
a CPU tensor its plain version. The choice is made from the configuration
before the call, never as a fallback. Training and `fused_blocks=False` run
layer by layer. (The JAX package keeps its Pallas block kernel opt-in for a
TPU compile cost per shape that a CUDA kernel does not have.)
`return_frame_feat` returns the trunk's frame features after
`out_nonlinear`, as the JAX package does.
"""

from collections import OrderedDict
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from wespeaker_tpu_torch.models.layers import (batch_norm, conv1d, conv2d,
                                               fold_bn, masked_mean, wide)
from wespeaker_tpu_torch.models.pooling_layers import (get_pooling,
                                                       pooling_out_dim)
from wespeaker_tpu_torch.ops.cam_block import (BOTTLENECK, GROWTH,
                                               fused_cam_dense_block,
                                               segment_means)


class BatchNormRelu(nn.Module):
    """Upstream `get_nonlinear`: 'batchnorm-relu' (and 'batchnorm_', BN
    without affine and without relu); the child is named `batchnorm`."""

    def __init__(self, channels: int, affine: bool = True, relu: bool = True):
        super().__init__()
        self.batchnorm = nn.BatchNorm1d(channels, affine=affine)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = batch_norm(x, self.batchnorm)
        return torch.relu(y) if self.relu else y


class TDNNLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1):
        super().__init__()
        if padding < 0:
            padding = (kernel_size - 1) // 2 * dilation
        self.linear = nn.Conv1d(in_channels, out_channels, kernel_size,
                                stride=stride, padding=padding,
                                dilation=dilation, bias=False)
        self.nonlinear = BatchNormRelu(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.nonlinear(conv1d(x, self.linear))


def seg_pooling(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                seg_len: int = 100) -> torch.Tensor:
    """Non-overlapping masked mean over segments of seg_len frames,
    broadcast back to the frames. x: (B, T, C) -> (B, T, C)."""
    seg = segment_means(x, mask, seg_len)
    return seg.repeat_interleave(seg_len, dim=1)[:, :x.shape[1]]


class CAMLayer(nn.Module):
    """The k=3 conv gated by the context (global + segment means); stride
    1, as CAMPPlus uses it."""

    def __init__(self, bn_channels: int, out_channels: int, kernel_size: int,
                 padding: int, dilation: int, reduction: int = 2):
        super().__init__()
        self.linear_local = nn.Conv1d(bn_channels, out_channels, kernel_size,
                                      padding=padding, dilation=dilation,
                                      bias=False)
        self.linear1 = nn.Conv1d(bn_channels, bn_channels // reduction, 1)
        self.linear2 = nn.Conv1d(bn_channels // reduction, out_channels, 1)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = conv1d(x, self.linear_local)
        m = None if mask is None else mask[..., None].to(x.dtype)
        context = masked_mean(x, m, dim=1, keepdim=True) + seg_pooling(x,
                                                                       mask)
        context = torch.relu(conv1d(context, self.linear1))
        return y * torch.sigmoid(conv1d(context, self.linear2))


class CAMDenseTDNNLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, bn_channels: int,
                 kernel_size: int, dilation: int = 1):
        super().__init__()
        padding = (kernel_size - 1) // 2 * dilation
        self.nonlinear1 = BatchNormRelu(in_channels)
        self.linear1 = nn.Conv1d(in_channels, bn_channels, 1, bias=False)
        self.nonlinear2 = BatchNormRelu(bn_channels)
        self.cam_layer = CAMLayer(bn_channels, out_channels, kernel_size,
                                  padding, dilation)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.nonlinear2(conv1d(self.nonlinear1(x), self.linear1))
        return self.cam_layer(h, mask)

    def folded(self, width: int):
        """(s1, t1, w1 (width, 128), s2, t2, w2 (3, 128, 32), wc1 (128, 64),
        bc1, wc2 (64, 32), bc2) for the fused block; the input rows of s1,
        t1 and w1 zero-padded to `width`."""
        s1, t1 = fold_bn(self.nonlinear1.batchnorm)
        s2, t2 = fold_bn(self.nonlinear2.batchnorm)
        pad = width - s1.shape[0]
        cam = self.cam_layer
        return (F.pad(s1, (0, pad)), F.pad(t1, (0, pad)),
                F.pad(self.linear1.weight[:, :, 0].t(), (0, 0, 0, pad)),
                s2, t2, cam.linear_local.weight.permute(2, 1, 0),
                cam.linear1.weight[:, :, 0].t(), cam.linear1.bias,
                cam.linear2.weight[:, :, 0].t(), cam.linear2.bias)


class CAMDenseTDNNBlock(nn.Module):
    """Upstream's ModuleList of layers `tdnnd1`..`tdnnd<L>`, each appending
    out_channels to the dense map."""

    def __init__(self, num_layers: int, in_channels: int, out_channels: int,
                 bn_channels: int, kernel_size: int, dilation: int = 1,
                 fused: Optional[bool] = None):
        super().__init__()
        self.dilation = dilation
        # the kernel's shapes: decided from the configuration, never by
        # trying the call
        self.fusable = (out_channels == GROWTH and bn_channels == BOTTLENECK
                        and kernel_size == 3)
        self.fused = fused
        for i in range(num_layers):
            self.add_module(f"tdnnd{i + 1}", CAMDenseTDNNLayer(
                in_channels + i * out_channels, out_channels, bn_channels,
                kernel_size, dilation=dilation))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.fused is not False and self.fusable and not self.training:
            layers = list(self.children())
            width = x.shape[-1] + GROWTH * len(layers)
            cols = zip(*(layer.folded(width) for layer in layers))
            return fused_cam_dense_block(
                x, *(torch.stack(c).detach() for c in cols),
                dilation=self.dilation, mask=mask)
        for layer in self.children():
            x = torch.cat([x, layer(x, mask)], dim=-1)
        return x


class TransitLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.nonlinear = BatchNormRelu(in_channels)
        self.linear = nn.Conv1d(in_channels, out_channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(self.nonlinear(x), self.linear)


class DenseLayer(nn.Module):
    """k=1 conv on the pooled statistics, then BN without affine
    ('batchnorm_')."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.linear = nn.Conv1d(in_channels, out_channels, 1, bias=False)
        self.nonlinear = BatchNormRelu(out_channels, affine=False, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.nonlinear(x @ self.linear.weight[:, :, 0].t().to(x.dtype))


class BasicResBlock(nn.Module):
    """2-D residual block with the stride on F only."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, kernel_size=3,
                               stride=(stride, 1), padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, kernel_size=3, stride=1,
                               padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, planes, kernel_size=1,
                          stride=(stride, 1), bias=False),
                nn.BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(batch_norm(conv2d(x, self.conv1), self.bn1))
        out = batch_norm(conv2d(out, self.conv2), self.bn2)
        if len(self.shortcut):
            conv, bn = self.shortcut
            x = batch_norm(conv2d(x, conv), bn)
        return torch.relu(out + x)


class FCM(nn.Module):
    """The 2-D head: conv, two layers of two residual blocks (the first
    with stride 2 on F), a conv with stride 2 on F; F / 8 at the end."""

    def __init__(self, m_channels: int = 32, feat_dim: int = 80):
        super().__init__()
        self.conv1 = nn.Conv2d(1, m_channels, kernel_size=3, stride=1,
                               padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(m_channels)
        self.layer1, self.layer2 = (nn.Sequential(
            BasicResBlock(m_channels, m_channels, 2),
            BasicResBlock(m_channels, m_channels, 1)) for _ in range(2))
        self.conv2 = nn.Conv2d(m_channels, m_channels, kernel_size=3,
                               stride=(2, 1), padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(m_channels)
        self.out_channels = m_channels * (feat_dim // 8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, F) -> (B, T, C * F / 8)."""
        h = x.transpose(1, 2)[:, None]  # (B, 1, F, T)
        h = torch.relu(batch_norm(conv2d(h, self.conv1), self.bn1))
        h = self.layer2(self.layer1(h))
        h = torch.relu(batch_norm(conv2d(h, self.conv2), self.bn2))
        b, c, f, t = h.shape
        return h.reshape(b, c * f, t).transpose(1, 2)  # index c * F' + f


class CAMPPlus(nn.Module):
    def __init__(self, feat_dim: int = 80, embed_dim: int = 512,
                 pooling_func: str = "TSTP", growth_rate: int = 32,
                 bn_size: int = 4, init_channels: int = 128,
                 fused_blocks: Optional[bool] = None):
        super().__init__()
        self.head = FCM(feat_dim=feat_dim)
        channels = self.head.out_channels
        trunk = OrderedDict(tdnn=TDNNLayer(channels, init_channels, 5,
                                           stride=2, dilation=1, padding=-1))
        channels = init_channels
        for i, (num_layers, kernel_size, dilation) in enumerate(
                zip((12, 24, 16), (3, 3, 3), (1, 2, 2))):
            trunk[f"block{i + 1}"] = CAMDenseTDNNBlock(
                num_layers, channels, growth_rate, bn_size * growth_rate,
                kernel_size, dilation, fused=fused_blocks)
            channels += num_layers * growth_rate
            trunk[f"transit{i + 1}"] = TransitLayer(channels, channels // 2)
            channels //= 2
        trunk["out_nonlinear"] = BatchNormRelu(channels)
        trunk["stats"] = get_pooling(pooling_func, channels)
        trunk["dense"] = DenseLayer(pooling_out_dim(pooling_func, channels),
                                    embed_dim)
        self.xvector = nn.Sequential(trunk)

    def set_fused(self, fused: Optional[bool]) -> "CAMPPlus":
        """Route eval through the fused block calls (None or True) or layer
        by layer (False)."""
        for i in range(3):
            getattr(self.xvector, f"block{i + 1}").fused = fused
        return self

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_frame_feat: bool = False) -> torch.Tensor:
        """x: (B, T, F) features; mask: optional (B, T). Returns
        (B, embed_dim) in x's dtype, or with return_frame_feat the trunk's
        frame features after `out_nonlinear`, (B, T', C)."""
        tv = self.xvector
        h = tv.tdnn(self.head(x))
        if mask is not None:
            mask = mask[:, ::2][:, :h.shape[1]]
        for i in range(3):
            h = getattr(tv, f"block{i + 1}")(h, mask)
            h = getattr(tv, f"transit{i + 1}")(h)
        h = tv.out_nonlinear(h)
        if return_frame_feat:
            return h
        return tv.dense(wide(tv.stats(h, mask))).to(x.dtype)
