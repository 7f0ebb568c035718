"""ReDimNet in PyTorch: 2-D convolution stages and 1-D time-context
blocks that exchange one (B, T, C * F) representation, with a learned
softmax weighting of every earlier stage's output as each stage's input
(Yakovlev et al., "Reshape Dimensions Network for Speaker Recognition",
Interspeech 2024).

Counterpart of wespeaker_tpu/models/redimnet.py; module and parameter
names are the upstream torch ones (wespeaker/models/redimnet.py: LayerNorm,
PosEncConv, ConvNeXtLikeBlock, MultiHeadAttention,
TransformerEncoderLayer, ResBasicBlock, fwSEBlock, TimeContextBlock1d,
ConvBlock2d, ReDimNetBone, ReDimNet), so an upstream state_dict loads with
`load_state_dict(strict=True)`: each stage is an `nn.Sequential` whose
indices are upstream's, the `to1d` slot is a parameter-free placeholder,
and `inputs_weights` is a ParameterList whose entry 0 is upstream's frozen
all-ones (1, 1, 1, 1) placeholder (the JAX package keeps no such leaf).

Layouts. A 2-D map is a logical (B, C, F, T) tensor in
`torch.channels_last` memory format, whose storage is the JAX package's
(B, F, T, C): the LayerNorm over C is a view permute to (B, F, T, C) and
back. A 1-D map is (B, T, F * C) with d = f * C + c, the JAX package's
order and upstream's (B, C, F, T) -> (B, F * C, T) `to1d`.

The pooling is ASTP with global context in every constructor: in eval
with autograd off it runs on the two pooling kernels (`ops.pooling`,
models/pooling_layers.py), each launched once per forward;
`set_pooling_fused(model, False)` keeps it plain. The convolutions, the attention (plain matmul and
softmax, as the JAX package leaves them to XLA) and the stage weighting
are PyTorch. An optional (B, T) frame mask reaches only the pooling (the
convolutions see the padding, as in the JAX package). The 'gru' time
block, which no released configuration uses, is a bidirectional nn.GRU
(`GRU`) under upstream's names, with the JAX package's `gru_quirk_compat`.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from wespeaker_tpu_torch.models.layers import (batch_norm, conv1d, conv2d,
                                               wide)
from wespeaker_tpu_torch.models.pooling_layers import (get_pooling,
                                                       pooling_out_dim)


def new_gelu(x: torch.Tensor) -> torch.Tensor:
    """HF's 'new' gelu, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _ln(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=1e-6)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """`ln` over the last axis of x, in x's dtype."""
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype),
                        ln.bias.to(x.dtype), ln.eps)


def layer_norm2d(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """`ln` over C of a (B, C, F, T) map: on channels_last storage the
    permute to (B, F, T, C) is a view."""
    return layer_norm(x.permute(0, 2, 3, 1), ln).permute(0, 3, 1, 2)


def linear(x: torch.Tensor, m: nn.Linear) -> torch.Tensor:
    return F.linear(x, m.weight.to(x.dtype), m.bias.to(x.dtype))


def _cat(xs, dim: int) -> torch.Tensor:
    return xs[0] if len(xs) == 1 else torch.cat(xs, dim=dim)


def to1d(x: torch.Tensor) -> torch.Tensor:
    """(B, C, F, T) -> (B, T, F * C) with d = f * C + c."""
    b, c, f, t = x.shape
    return x.permute(0, 3, 2, 1).reshape(b, t, f * c)


def to2d(x: torch.Tensor, c: int, f: int) -> torch.Tensor:
    """(B, T, F * C) -> (B, C, F, T) in channels_last memory format."""
    b, t, _ = x.shape
    return x.reshape(b, t, f, c).permute(0, 3, 2, 1).contiguous(
        memory_format=torch.channels_last)


class PosEncConv(nn.Module):
    """x + LN(depthwise conv(x)) positional encoding on (B, T, C)."""

    def __init__(self, C: int, ks: int):
        super().__init__()
        self.conv = nn.Conv1d(C, C, ks, padding=ks // 2, groups=C)
        self.norm = _ln(C)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + layer_norm(conv1d(x, self.conv), self.norm)


class ConvNeXtLikeBlock1d(nn.Module):
    """x + pwconv1(gelu(BN(concat of grouped convs))) on (B, T, C)."""

    def __init__(self, C: int, kernel_sizes: Sequence[int] = (7,),
                 group_divisor: Optional[int] = 1):
        super().__init__()
        groups = C // group_divisor if group_divisor is not None else 1
        self.dwconvs = nn.ModuleList(
            nn.Conv1d(C, C, ks, padding=ks // 2, groups=groups)
            for ks in kernel_sizes)
        self.norm = nn.BatchNorm1d(C * len(kernel_sizes))
        self.pwconv1 = nn.Conv1d(C * len(kernel_sizes), C, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _cat([conv1d(x, conv) for conv in self.dwconvs], dim=-1)
        h = F.gelu(batch_norm(h, self.norm))
        return x + conv1d(h, self.pwconv1)


class ConvNeXtLikeBlock2d(nn.Module):
    """The same on a (B, C, F, T) map: grouped 3x3 convs with
    groups = C // group_divisor, BN, exact gelu (or relu, ReDimNet2's
    'convnext_like_relu'), a pointwise conv."""

    def __init__(self, C: int, kernel_sizes=((3, 3),),
                 group_divisor: Optional[int] = 1, act: str = "gelu"):
        super().__init__()
        self.act = torch.relu if act == "relu" else F.gelu
        groups = C // group_divisor if group_divisor is not None else 1
        self.dwconvs = nn.ModuleList(
            nn.Conv2d(C, C, ks, padding=(ks[0] // 2, ks[1] // 2),
                      groups=groups) for ks in kernel_sizes)
        self.norm = nn.BatchNorm2d(C * len(kernel_sizes))
        self.pwconv1 = nn.Conv2d(C * len(kernel_sizes), C, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _cat([conv2d(x, conv) for conv in self.dwconvs], dim=1)
        h = self.act(batch_norm(h, self.norm))
        return x + conv2d(h, self.pwconv1)


class fwSEBlock(nn.Module):
    """Frequency-wise squeeze-excitation on a (B, C, F, T) map."""

    def __init__(self, num_freq: int, num_feats: int = 64):
        super().__init__()
        self.squeeze = nn.Linear(num_freq, num_feats)
        self.exitation = nn.Linear(num_feats, num_freq)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(1, 3), dtype=torch.float32)  # (B, F)
        s = torch.sigmoid(self.exitation(torch.relu(self.squeeze(s))))
        return x * s.to(x.dtype)[:, None, :, None]


class ResBasicBlock(nn.Module):
    """Basic residual block; with a group divisor each 3x3 conv is grouped
    (groups = C // group_divisor) and followed by a pointwise conv."""

    def __init__(self, in_planes: int, planes: int, num_freq: int,
                 se_channels: int = 64, group_divisor: Optional[int] = 4,
                 use_fwse: bool = False):
        super().__init__()
        gd = group_divisor
        if gd is not None:
            self.conv1 = nn.Conv2d(in_planes, in_planes, 3, padding=1,
                                   groups=in_planes // gd, bias=False)
            self.conv1pw = nn.Conv2d(in_planes, planes, 1)
            self.conv2 = nn.Conv2d(planes, planes, 3, padding=1,
                                   groups=planes // gd, bias=False)
            self.conv2pw = nn.Conv2d(planes, planes, 1)
        else:
            self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1,
                                   bias=False)
            self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.grouped = gd is not None
        self.bn1 = nn.BatchNorm2d(planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.se = fwSEBlock(num_freq, se_channels) if use_fwse else None
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_planes, planes, 1, bias=False),
            nn.BatchNorm2d(planes)) if planes != in_planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv2d(x, self.conv1)
        if self.grouped:
            h = conv2d(h, self.conv1pw)
        h = batch_norm(torch.relu(h), self.bn1)
        h = conv2d(h, self.conv2)
        if self.grouped:
            h = conv2d(h, self.conv2pw)
        h = batch_norm(h, self.bn2)
        if self.se is not None:
            h = self.se(h)
        sc = x
        if self.downsample is not None:
            sc = batch_norm(conv2d(x, self.downsample[0]), self.downsample[1])
        return torch.relu(h + sc)


class ConvBlock2d(nn.Module):
    """Upstream's wrapper of one 2-D block (its `conv_block`)."""

    def __init__(self, c: int, f: int, block_type: str,
                 group_divisor: Optional[int], kernel_sizes=((3, 3),)):
        super().__init__()
        if block_type in ("convnext_like", "convnext_like_relu"):
            self.conv_block = ConvNeXtLikeBlock2d(
                c, tuple(tuple(k) for k in kernel_sizes), group_divisor,
                "relu" if block_type.endswith("relu") else "gelu")
        elif block_type in ("basic_resnet", "basic_resnet_fwse"):
            self.conv_block = ResBasicBlock(
                c, c, f, se_channels=min(64, max(c, 32)),
                group_divisor=group_divisor,
                use_fwse=block_type == "basic_resnet_fwse")
        else:
            raise NotImplementedError(f"2-D block type {block_type}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_block(x)


class MultiHeadAttention(nn.Module):
    """Self-attention on (B, T, C): q is scaled by d^-0.5 after its
    projection (bias included); scores and softmax as plain products."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        h, d = self.num_heads, self.embed_dim // self.num_heads

        def heads(v):
            return v.reshape(b, t, h, d).transpose(1, 2)  # (B, H, T, d)

        q = heads(linear(x, self.q_proj) * d ** -0.5)
        k, v = heads(linear(x, self.k_proj)), heads(linear(x, self.v_proj))
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1,
                          dtype=torch.float32).to(x.dtype)
        out = (w @ v).transpose(1, 2).reshape(b, t, self.embed_dim)
        return linear(out, self.out_proj)


class FeedForward(nn.Module):
    def __init__(self, n_state: int, n_mlp: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(n_state, n_mlp)
        self.output_dense = nn.Linear(n_mlp, n_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(new_gelu(linear(x, self.intermediate_dense)),
                      self.output_dense)


class TransformerEncoderLayer(nn.Module):
    """Post-LN transformer layer on (B, T, C)."""

    def __init__(self, n_state: int, n_mlp: int, n_head: int = 4):
        super().__init__()
        self.attention = MultiHeadAttention(n_state, n_head)
        self.layer_norm = _ln(n_state)
        self.feed_forward = FeedForward(n_state, n_mlp)
        self.final_layer_norm = _ln(n_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = layer_norm(x + self.attention(x), self.layer_norm)
        return layer_norm(x + self.feed_forward(x), self.final_layer_norm)


class GRU(nn.Module):
    """The 'gru' block's bidirectional one-layer GRU, (B, T, C) -> (B, T,
    2C), under upstream's names (`gru.weight_ih_l0`, ... `_reverse`), so
    an upstream state_dict loads as it is. Counterpart of the JAX package's
    BiGRU (wespeaker_tpu/models/redimnet.py): it recurs over time, and
    with `torch_quirk` over the batch axis, as upstream's
    nn.GRU(batch_first=False) fed (B, T, C) does. torch's nn.GRU computes
    it (no kernel of the JAX package is on this path), in f32."""

    def __init__(self, hidden: int, torch_quirk: bool = False):
        super().__init__()
        self.torch_quirk = torch_quirk
        self.gru = nn.GRU(hidden, hidden, num_layers=1, bias=True,
                          batch_first=False, bidirectional=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = wide(x)
        if self.torch_quirk:
            return self.gru(h)[0].to(x.dtype)
        return self.gru(h.transpose(0, 1))[0].transpose(0, 1).to(x.dtype)


class TimeContextBlock1d(nn.Module):
    """Residual time-context block on (B, T, C): reduce to hC (conv + LN),
    the `tcm` stack of the block type, expand back to C."""

    def __init__(self, C: int, hC: int, pos_ker_sz: int = 59,
                 block_type: str = "att", gru_quirk_compat: bool = False):
        super().__init__()
        self.block_type = block_type
        self.red_dim_conv = nn.Sequential(nn.Conv1d(C, hC, 1), _ln(hC))
        if block_type == "fc":
            self.tcm = nn.Sequential(nn.Conv1d(hC, 2 * hC, 1), _ln(2 * hC),
                                     nn.GELU(), nn.Conv1d(2 * hC, hC, 1))
        elif block_type == "att":
            self.tcm = nn.Sequential(
                PosEncConv(hC, pos_ker_sz),
                TransformerEncoderLayer(hC, 2 * hC, 4))
        elif block_type == "conv+att":
            self.tcm = nn.Sequential(
                *(ConvNeXtLikeBlock1d(hC, (ks,), 1) for ks in (7, 19, 31, 59)),
                TransformerEncoderLayer(hC, hC, 4))
        elif block_type == "gru":
            # used by no released configuration
            self.tcm = nn.Sequential(GRU(hC, gru_quirk_compat),
                                     nn.Conv1d(2 * hC, hC, 1))
        else:
            raise NotImplementedError(
                f"time-context block {block_type!r}")
        self.exp_dim_conv = nn.Conv1d(hC, C, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = layer_norm(conv1d(x, self.red_dim_conv[0]), self.red_dim_conv[1])
        if self.block_type == "fc":
            h = F.gelu(layer_norm(conv1d(h, self.tcm[0]), self.tcm[1]))
            h = conv1d(h, self.tcm[3])
        elif self.block_type == "gru":
            h = conv1d(self.tcm[0](h), self.tcm[1])
        else:
            for m in self.tcm:
                h = m(h)
        return x + conv1d(h, self.exp_dim_conv)


class To1d(nn.Module):
    """Upstream's parameter-free `to1d` slot of a stage Sequential."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to1d(x)


class ReDimNetBone(nn.Module):
    def __init__(self, feat_dim: int = 72, C: int = 16,
                 block_1d_type: str = "conv+att",
                 block_2d_type: str = "basic_resnet",
                 stages_setup: Sequence = (
                     (1, 2, 1, ((3, 3),), None),
                     (2, 3, 1, ((3, 3),), None),
                     (3, 4, 1, ((3, 3),), 8),
                     (2, 5, 1, ((3, 3),), 8),
                     (1, 5, 1, ((7, 1),), 8),
                     (2, 3, 1, ((3, 3),), 8)),
                 group_divisor: Optional[int] = 1,
                 out_channels: Optional[int] = 512,
                 gru_quirk_compat: bool = False):
        super().__init__()
        self.stem = nn.Sequential(nn.Conv2d(1, C, 3, padding=1), _ln(C))
        n = len(stages_setup)
        self.inputs_weights = nn.ParameterList(
            [nn.Parameter(torch.ones(1, 1, 1, 1), requires_grad=False)]
            + [nn.Parameter(torch.zeros(1, i + 1, C * feat_dim, 1))
               for i in range(1, n + 1)])
        self.shapes = []  # (C, F) each stage reads
        cur_c, cur_f = C, feat_dim
        for si, (stride, num_blocks, conv_exp, _ks, att_red) in enumerate(
                stages_setup):
            self.shapes.append((cur_c, cur_f))
            layers = [nn.Conv2d(cur_c, int(stride * cur_c * conv_exp),
                                (stride, 1), stride=(stride, 1))]
            cur_c, cur_f = stride * cur_c, cur_f // stride
            layers += [ConvBlock2d(int(cur_c * conv_exp), cur_f,
                                   block_2d_type, group_divisor)
                       for _ in range(num_blocks)]
            if conv_exp != 1:
                groups = (cur_c // group_divisor
                          if group_divisor is not None else 1)
                layers.append(nn.Sequential(
                    nn.Conv2d(int(cur_c * conv_exp), cur_c, 3, padding=1,
                              groups=groups),
                    nn.BatchNorm2d(cur_c, eps=1e-6), nn.GELU(),
                    nn.Conv2d(cur_c, cur_c, 1)))
            layers.append(To1d())
            if att_red is not None:
                layers.append(TimeContextBlock1d(
                    C * feat_dim, (C * feat_dim) // att_red,
                    block_type=block_1d_type,
                    gru_quirk_compat=gru_quirk_compat))
            setattr(self, f"stage{si}", nn.Sequential(*layers))
        self.num_stages = n
        self.mfa = None
        if out_channels is not None:
            self.mfa = nn.Sequential(nn.Conv1d(C * feat_dim, out_channels, 1),
                                     nn.BatchNorm1d(out_channels))

    def weight1d(self, outs, i: int) -> torch.Tensor:
        """The softmax-weighted sum of the 1-D outputs so far, a running
        sum in f32 (no (B, n, T, C * F) stack), in their dtype."""
        if i == 0:
            return outs[0]
        w = torch.softmax(self.inputs_weights[i].float(), dim=1)[0, :, :, 0]
        acc = w[0] * outs[0]
        for j in range(1, len(outs)):
            acc = acc + w[j] * outs[j]
        return acc.to(outs[0].dtype)

    def _stage(self, si: int, x: torch.Tensor) -> torch.Tensor:
        for m in getattr(self, f"stage{si}"):
            if isinstance(m, nn.Conv2d):
                x = conv2d(x, m)
            elif isinstance(m, nn.Sequential):  # the conv_exp squeeze-back
                h = batch_norm(conv2d(x, m[0]), m[1])
                x = conv2d(F.gelu(h), m[3])
            else:
                x = m(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 1, F, T) channels_last -> (B, T, D)."""
        h = layer_norm2d(conv2d(x, self.stem[0]), self.stem[1])
        outs = [to1d(h)]
        for si in range(self.num_stages):
            c, f = self.shapes[si]
            outs.append(self._stage(si, to2d(self.weight1d(outs, si), c, f)))
        out = self.weight1d(outs, self.num_stages)
        if self.mfa is not None:
            out = batch_norm(conv1d(out, self.mfa[0]), self.mfa[1])
        return out


class ReDimNet(nn.Module):
    def __init__(self, feat_dim: int = 72, C: int = 16,
                 block_1d_type: str = "conv+att",
                 block_2d_type: str = "basic_resnet",
                 stages_setup: Sequence = None,
                 group_divisor: Optional[int] = 4,
                 out_channels: Optional[int] = None, embed_dim: int = 192,
                 pooling_func: str = "ASTP", global_context_att: bool = True,
                 two_emb_layer: bool = False,
                 gru_quirk_compat: bool = False):
        super().__init__()
        bone_kw = {} if stages_setup is None else {
            "stages_setup": stages_setup}
        self.backbone = ReDimNetBone(feat_dim, C, block_1d_type,
                                     block_2d_type,
                                     group_divisor=group_divisor,
                                     out_channels=out_channels,
                                     gru_quirk_compat=gru_quirk_compat,
                                     **bone_kw)
        out_dim = out_channels if out_channels is not None else C * feat_dim
        self.pool = get_pooling(pooling_func, out_dim,
                                global_context_att=global_context_att)
        self.seg_1 = nn.Linear(pooling_out_dim(pooling_func, out_dim),
                               embed_dim)
        self.two_emb_layer = two_emb_layer
        if two_emb_layer:
            self.seg_bn_1 = nn.BatchNorm1d(embed_dim, affine=False)
            self.seg_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_frame_feat: bool = False) -> torch.Tensor:
        """x: (B, T, F) features; mask: optional (B, T). Returns
        (B, embed_dim) in x's dtype, or with return_frame_feat the frame
        features (B, T, D)."""
        h = x.transpose(1, 2)[:, None].contiguous(
            memory_format=torch.channels_last)  # (B, 1, F, T)
        feat = self.backbone(h)
        if return_frame_feat:
            return feat
        out = self.seg_1(wide(self.pool(feat, mask)))
        if self.two_emb_layer:
            out = self.seg_2(batch_norm(torch.relu(out), self.seg_bn_1))
        return out.to(x.dtype)


def _constructor(C, block_2d_type, stages_setup, group_divisor,
                 default_feat=72):
    def build(feat_dim=default_feat, embed_dim=192, pooling_func="ASTP",
              two_emb_layer=False):
        return ReDimNet(feat_dim=feat_dim, C=C, block_1d_type="conv+att",
                        block_2d_type=block_2d_type,
                        stages_setup=stages_setup,
                        group_divisor=group_divisor, out_channels=None,
                        embed_dim=embed_dim, pooling_func=pooling_func,
                        global_context_att=True, two_emb_layer=two_emb_layer)
    return build


_K = ((3, 3),)
ReDimNetB0 = _constructor(10, "basic_resnet", (
    (1, 2, 1, _K, 30), (2, 3, 2, _K, 30), (1, 3, 3, _K, 30),
    (2, 4, 2, _K, 10), (1, 3, 1, _K, 10)), 1, default_feat=60)
ReDimNetB1 = _constructor(12, "convnext_like", (
    (1, 2, 1, _K, None), (2, 3, 1, _K, None), (3, 4, 1, _K, 12),
    (2, 5, 1, _K, 12), (2, 3, 1, _K, 8)), 8)
ReDimNetB2 = _constructor(16, "convnext_like", (
    (1, 2, 1, _K, 12), (2, 2, 1, _K, 12), (1, 3, 1, _K, 12),
    (2, 4, 1, _K, 8), (1, 4, 1, _K, 8), (2, 4, 1, _K, 4)), 8)
ReDimNetB3 = _constructor(16, "basic_resnet_fwse", (
    (1, 6, 4, _K, 32), (2, 6, 2, _K, 32), (1, 8, 2, _K, 32),
    (2, 10, 2, _K, 16), (1, 10, 1, _K, 16), (2, 8, 1, _K, 16)), 1)
_B45 = ((1, 4, 2, _K, 48), (2, 4, 2, _K, 48), (1, 6, 2, _K, 48),
        (2, 6, 1, _K, 32), (1, 8, 1, _K, 24), (2, 4, 1, _K, 16))
ReDimNetB4 = _constructor(32, "basic_resnet_fwse", _B45, 1)
ReDimNetB5 = _constructor(32, "basic_resnet_fwse", _B45, 16)
ReDimNetB6 = _constructor(32, "basic_resnet", (
    (1, 4, 4, _K, 32), (2, 6, 2, _K, 32), (1, 6, 2, _K, 24),
    (3, 8, 1, _K, 24), (1, 8, 1, _K, 16), (2, 8, 1, _K, 16)), 32)
