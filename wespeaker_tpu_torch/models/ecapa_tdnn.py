"""ECAPA-TDNN speaker encoder in PyTorch.

Counterpart of wespeaker_tpu/models/ecapa_tdnn.py; module and parameter
names are the upstream torch ones (wespeaker/models/ecapa_tdnn.py), so an
upstream state_dict loads with `load_state_dict`. Activations are (B, T, C)
channels-last, as in the JAX package. An optional (B, T) frame mask makes
padded batches equal the batch=1 whole-utterance path (masked SE squeeze
and masked pooling).

In eval mode with `fused=True` (the default), each SE_Res2Block of group
width >= 64 (512 channels and up; `SE_Res2Block.eval_route`) runs as one
call of `ops.se_block.fused_se_res2_block` and the MFA conv + ASTP tail as
one call of `ops.mfa_astp.fused_mfa_astp`, with BN folded: on a CUDA tensor
those launch the hand-written kernels, on a CPU tensor their plain
versions. In training with `fused=True` and no mask, the tail is one call
of the differentiable `ops.mfa_astp_vjp.mfa_astp_train` (forward and
backward kernels; the tail has no BatchNorm, so it is exact in training),
and the SE blocks run layer by layer, as in the JAX package, whose block
kernel is inference-only. `fused=False` runs every module layer by layer.
The tail is fused only for ASTP pooling (`pooling_func`, as in the JAX
package); with any other pooling (TAP, TSDP, TSTP, ASP, MHASTP, MQMHASTP
or the xi-vectors' XI) the MFA conv runs as a layer and its output goes
through the pooling module, which in eval takes `ops.pooling`'s masked
statistics (TSDP, TSTP). `return_frame_feat` returns the MFA conv's
output, as the JAX package does.

Narrower blocks (width 32 at 256 channels) run layer by layer in eval,
as the JAX package's width rule routes them, and the tail still takes its
kernel. `fused_res2=True` (the JAX package's opt-in Res2 kernel,
inference only) acts where the whole block is not fused: in eval with
`fused=False`, each block's Res2 chain is one call of
`ops.res2_chain.fused_res2_chain` and the rest of the model runs layer by
layer (the JAX package's `ECAPA_TDNN(fused_res2=True, fused_block=False,
fused_tail=False)`).
"""

from typing import Optional

import torch
import torch.nn as nn

from wespeaker_tpu_torch.models.layers import (batch_norm, conv1d, fold_bn,
                                               masked_mean)
from wespeaker_tpu_torch.models.pooling_layers import (get_pooling,
                                                       pooling_out_dim)
from wespeaker_tpu_torch.ops.mfa_astp import fused_mfa_astp
from wespeaker_tpu_torch.ops.mfa_astp_vjp import mfa_astp_train
from wespeaker_tpu_torch.ops.res2_chain import fused_res2_chain
from wespeaker_tpu_torch.ops.se_block import fused_se_res2_block

_MFA_DIM = 512 * 3  # the MFA conv's output width for every ECAPA size


class Conv1dReluBn(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, stride: int = 1, padding: int = 0,
                 dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding,
                              dilation=dilation)
        self.bn = nn.BatchNorm1d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(torch.relu(conv1d(x, self.conv)), self.bn)

    def folded(self):
        """(weight (C_in, C_out), bias, scale, shift) of the k=1 conv with
        eval BN folded, for the fused block."""
        scale, shift = fold_bn(self.bn)
        return (self.conv.weight[:, :, 0].t(), self.conv.bias.float(),
                scale, shift)


class Res2Conv1dReluBn(nn.Module):
    """Res2Net-style hierarchical split conv: channels split into `scale`
    groups; group i is convolved after adding group i-1's output."""

    def __init__(self, channels: int, kernel_size: int = 1, stride: int = 1,
                 padding: int = 0, dilation: int = 1, scale: int = 4):
        super().__init__()
        assert channels % scale == 0
        self.scale = scale
        self.width = channels // scale
        self.nums = scale if scale == 1 else scale - 1
        self.convs = nn.ModuleList([
            nn.Conv1d(self.width, self.width, kernel_size, stride=stride,
                      padding=padding, dilation=dilation)
            for _ in range(self.nums)])
        self.bns = nn.ModuleList([nn.BatchNorm1d(self.width)
                                  for _ in range(self.nums)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.width
        out = []
        sp = x[..., 0:w]
        for i in range(self.nums):
            if i >= 1:
                sp = sp + x[..., i * w:(i + 1) * w]
            # reference order: conv -> relu -> bn
            sp = batch_norm(torch.relu(conv1d(sp, self.convs[i])),
                            self.bns[i])
            out.append(sp)
        if self.scale != 1:
            out.append(x[..., self.nums * w:])
        return torch.cat(out, dim=-1)

    def folded(self):
        """Chain arrays stacked for the fused block: kernels (nums, 3, W, W)
        taps [t-d, t, t+d] (in, out), biases, BN scales and shifts
        (nums, W)."""
        scales, shifts = zip(*(fold_bn(bn) for bn in self.bns))
        return (torch.stack([c.weight.permute(2, 1, 0) for c in self.convs]),
                torch.stack([c.bias.float() for c in self.convs]),
                torch.stack(scales), torch.stack(shifts))


class SE_Connect(nn.Module):
    def __init__(self, channels: int, se_bottleneck_dim: int = 128):
        super().__init__()
        self.linear1 = nn.Linear(channels, se_bottleneck_dim)
        self.linear2 = nn.Linear(se_bottleneck_dim, channels)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = masked_mean(x, None if mask is None else mask[..., None].to(
            x.dtype), dim=1)
        s = torch.relu(self.linear1(s.float()))
        s = torch.sigmoid(self.linear2(s))
        return x * s[:, None, :].to(x.dtype)

    def folded(self):
        """(sw1 (C, Cb), sb1, sw2 (Cb, C), sb2) for the fused block."""
        return (self.linear1.weight.t(), self.linear1.bias,
                self.linear2.weight.t(), self.linear2.bias)


# the group width from which the block's eval kernels run, as in the JAX
# package (se_block_pallas.block_kernel_fits, res2_pallas.kernel_fits)
KERNEL_MIN_WIDTH = 64


class SE_Res2Block(nn.Module):
    """`eval_route` is fixed here from the group width channels // scale:
    "kernel" from KERNEL_MIN_WIDTH up, where eval takes the block kernel
    (`fused`) or the Res2 chain kernel (`fused_res2`); "layers" below it
    (ECAPA_TDNN with 256 channels), where eval runs layer by layer whatever
    `fused` and `fused_res2` say, as the JAX package's width rule routes
    it. Training runs layer by layer either way."""

    def __init__(self, channels: int, kernel_size: int, stride: int,
                 padding: int, dilation: int, scale: int, fused: bool = True,
                 fused_res2: bool = False):
        super().__init__()
        self.dilation = dilation
        self.fused = fused
        self.fused_res2 = fused_res2
        self.eval_route = ("kernel" if channels // scale >= KERNEL_MIN_WIDTH
                           else "layers")
        self.se_res2block = nn.Sequential(
            Conv1dReluBn(channels, channels, kernel_size=1),
            Res2Conv1dReluBn(channels, kernel_size, stride, padding,
                             dilation, scale=scale),
            Conv1dReluBn(channels, channels, kernel_size=1),
            SE_Connect(channels),
        )

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        pre, res2, post, se = self.se_res2block
        kernels = self.eval_route == "kernel" and not self.training
        if kernels and self.fused:
            return fused_se_res2_block(
                x, *pre.folded(), *res2.folded(), *post.folded(),
                *se.folded(), dilation=self.dilation, mask=mask)
        out = pre(x)
        if kernels and self.fused_res2:
            out = fused_res2_chain(out, *res2.folded(), dilation=self.dilation)
        else:
            out = res2(out)
        return x + se(post(out), mask)


class ECAPA_TDNN(nn.Module):
    def __init__(self, channels: int = 512, feat_dim: int = 80,
                 embed_dim: int = 192, pooling_func: str = "ASTP",
                 global_context_att: bool = False, emb_bn: bool = False,
                 fused: bool = True, fused_res2: bool = False):
        super().__init__()
        self.global_context_att = global_context_att
        self.pooling_func = pooling_func
        self.fused = fused
        self.layer1 = Conv1dReluBn(feat_dim, channels, kernel_size=5,
                                   padding=2)
        self.layer2 = SE_Res2Block(channels, 3, 1, 2, 2, 8, fused, fused_res2)
        self.layer3 = SE_Res2Block(channels, 3, 1, 3, 3, 8, fused, fused_res2)
        self.layer4 = SE_Res2Block(channels, 3, 1, 4, 4, 8, fused, fused_res2)
        self.conv = nn.Conv1d(channels * 3, _MFA_DIM, kernel_size=1)
        self.pool = get_pooling(pooling_func, _MFA_DIM,
                                global_context_att=global_context_att)
        self.bn = nn.BatchNorm1d(pooling_out_dim(pooling_func, _MFA_DIM))
        self.linear = nn.Linear(self.bn.num_features, embed_dim)
        self.bn2 = nn.BatchNorm1d(embed_dim) if emb_bn else None

    def set_fused(self, fused: bool,
                  fused_res2: Optional[bool] = None) -> "ECAPA_TDNN":
        """Route eval through the fused block/tail calls (True) or the
        layer-by-layer modules (False); `fused_res2`, when given, turns the
        Res2 chain kernel of the unfused blocks on or off."""
        self.fused = fused
        for layer in (self.layer2, self.layer3, self.layer4):
            layer.fused = fused
            if fused_res2 is not None:
                layer.fused_res2 = fused_res2
        return self

    def _tail_weights(self):
        """(wm (3C, D), bm, k1 (·, A), b1, k2 (A, D), b2) as views of the
        k=1 conv weights, so gradients reach the parameters."""
        return (self.conv.weight[:, :, 0].t(), self.conv.bias,
                self.pool.linear1.weight[:, :, 0].t(), self.pool.linear1.bias,
                self.pool.linear2.weight[:, :, 0].t(), self.pool.linear2.bias)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_frame_feat: bool = False) -> torch.Tensor:
        """x: (B, T, F) features; mask: optional (B, T). Returns
        (B, embed_dim), in f32 for f32 input and x's dtype otherwise, or
        with return_frame_feat the MFA conv's output (B, T, 1536)."""
        out1 = self.layer1(x)
        out2 = self.layer2(out1, mask)
        out3 = self.layer3(out2, mask)
        out4 = self.layer4(out3, mask)
        if return_frame_feat:
            return conv1d(torch.cat([out2, out3, out4], dim=-1), self.conv)
        # the fused tail is the MFA conv + ASTP; any other pooling runs
        # after the conv, as in the JAX package
        fusable = self.fused and self.pooling_func == "ASTP"
        if fusable and not self.training:
            pooled = fused_mfa_astp(
                out2, out3, out4, *self._tail_weights(), mask=mask,
                glob=self.global_context_att).to(x.dtype)
        elif fusable and mask is None:
            pooled = mfa_astp_train(
                out2, out3, out4, *self._tail_weights(),
                glob=self.global_context_att).to(x.dtype)
        else:
            out = conv1d(torch.cat([out2, out3, out4], dim=-1), self.conv)
            pooled = self.pool(torch.relu(out), mask)
        emb = self.linear(batch_norm(pooled, self.bn).float())
        if self.bn2 is not None:
            emb = batch_norm(emb, self.bn2)
        return emb.to(x.dtype)


def ECAPA_TDNN_c1024(feat_dim, embed_dim, pooling_func="ASTP", emb_bn=False,
                     **kwargs):
    return ECAPA_TDNN(channels=1024, feat_dim=feat_dim, embed_dim=embed_dim,
                      pooling_func=pooling_func, emb_bn=emb_bn, **kwargs)


def ECAPA_TDNN_GLOB_c1024(feat_dim, embed_dim, pooling_func="ASTP",
                          emb_bn=False, **kwargs):
    return ECAPA_TDNN(channels=1024, feat_dim=feat_dim, embed_dim=embed_dim,
                      pooling_func=pooling_func, global_context_att=True,
                      emb_bn=emb_bn, **kwargs)


def ECAPA_TDNN_c512(feat_dim, embed_dim, pooling_func="ASTP", emb_bn=False,
                    **kwargs):
    return ECAPA_TDNN(channels=512, feat_dim=feat_dim, embed_dim=embed_dim,
                      pooling_func=pooling_func, emb_bn=emb_bn, **kwargs)


def ECAPA_TDNN_GLOB_c512(feat_dim, embed_dim, pooling_func="ASTP",
                         emb_bn=False, **kwargs):
    return ECAPA_TDNN(channels=512, feat_dim=feat_dim, embed_dim=embed_dim,
                      pooling_func=pooling_func, global_context_att=True,
                      emb_bn=emb_bn, **kwargs)
