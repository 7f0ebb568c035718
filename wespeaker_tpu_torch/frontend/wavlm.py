"""WavLM, HuBERT and wav2vec 2.0 encoders: the s3prl upstreams of the
WavLM + ECAPA recipes (`dataset_args.frontend: wavlm`, also `s3prl`,
`hubert`, `wav2vec2`).

Counterpart of wespeaker_tpu/frontend/wavlm.py, which follows HF
transformers' WavLMModel: a 7-conv feature encoder (a group norm after
the first conv in the Base form, a layer norm after every conv in the
Large form), the feature projection, a grouped positional conv (kernel
128, 16 groups, the trailing frame of the even kernel dropped), then
transformer layers with the gated relative-position bias (T5 buckets
embedded in layer 0, re-gated in every layer from the un-projected
heads), post-LN (Base) or pre-LN (Large). HuBERT and wav2vec 2.0 are the
same stack without the bias (`use_rel_pos_bias=False`). Dropout and
layer drop are left out, as in the JAX package.

The parameters carry HF's names (`feature_extractor.conv_layers.<i>.conv`,
`feature_projection.projection`, `encoder.pos_conv_embed.conv`,
`encoder.layers.<i>.attention.q_proj`, ...), the targets of the JAX
package's torch_compat rules, so utils/weights.py carries a JAX variable
tree across one to one and an HF state_dict loads after
`fold_wavlm_weight_norm`. Attention, layer norms and GELU are plain torch
ops, as the JAX package computes them outside any Pallas kernel; the
attention is written as the JAX code writes it (products, a masked f32
softmax), with padded keys at -1e30. Each layer casts its parameters to
the activations' type (models/layers.py).
"""

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from wespeaker_tpu_torch.frontend.ssl_frontends import Featurizer
from wespeaker_tpu_torch.models.layers import conv1d, layer_norm, linear, wide

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"   # 'group' (Base) | 'layer' (Large)
    do_stable_layer_norm: bool = False  # True for Large
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5
    # False: plain scaled-dot attention, the HuBERT / wav2vec 2.0 stack
    use_rel_pos_bias: bool = True

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def hubert_base(cls):
        return cls(use_rel_pos_bias=False)

    @classmethod
    def hubert_large(cls):
        return cls(hidden_size=1024, num_hidden_layers=24,
                   num_attention_heads=16, intermediate_size=4096,
                   feat_extract_norm="layer", do_stable_layer_norm=True,
                   conv_bias=True, use_rel_pos_bias=False)

    @classmethod
    def large(cls):
        return cls(hidden_size=1024, num_hidden_layers=24,
                   num_attention_heads=16, intermediate_size=4096,
                   feat_extract_norm="layer", do_stable_layer_norm=True,
                   conv_bias=True)

    def feat_extract_output_lengths(self, input_length):
        """Frames the conv stack gives for `input_length` samples (an int
        or a float tensor of counts): each conv's (n - k) // s + 1."""
        for k, s in zip(self.conv_kernel, self.conv_stride):
            input_length = (input_length - k) // s + 1
        return input_length


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """T5-style bidirectional buckets (HF modeling_wavlm.py), computed on
    the host in numpy as the JAX package computes them, so that the bucket
    edges round the same way."""
    ctx = np.arange(q_len)[:, None]
    mem = np.arange(k_len)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
    large = large / math.log(max_distance / max_exact) * (nb - max_exact)
    large = np.minimum(max_exact + large.astype(np.int64), nb - 1)
    return buckets + np.where(is_small, rel, large)


@functools.lru_cache(maxsize=64)
def _buckets_on(t: int, num_buckets: int, max_distance: int,
                device: torch.device) -> torch.Tensor:
    """The (T, T) buckets on `device`, uploaded once; made outside
    inference mode, so that a training step after an extraction in the
    same process may save them for its backward."""
    with torch.inference_mode(False):
        return torch.as_tensor(relative_position_buckets(
            t, t, num_buckets, max_distance), device=device)


def rel_pos_gate(proj: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
    """The per-head, per-frame gate of the relative-position bias
    (modeling_wavlm.py): the 8 outputs of gru_rel_pos_linear (B, H, T, 8)
    read as (B, H, T, 2, 4) and summed over the last axis into two
    sigmoid gates a and b; gate = a (b const - 1) + 2, (B, H, T, 1)."""
    b, h, t, _ = proj.shape
    gates = torch.sigmoid(proj.reshape(b, h, t, 2, 4).sum(-1))
    gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]
    return gate_a * (gate_b * const - 1.0) + 2.0


class WavLMAttention(nn.Module):
    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        if cfg.use_rel_pos_bias:
            self.gru_rel_pos_linear = nn.Linear(d // h, 8)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, h, 1, 1))
            if has_relative_position_bias:
                self.rel_attn_embed = nn.Embedding(cfg.num_buckets, h)

    def forward(self, x: torch.Tensor,
                position_bias: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None):
        c = self.cfg
        h, d = c.num_attention_heads, c.hidden_size // c.num_attention_heads
        b, t, _ = x.shape
        bias = None
        if c.use_rel_pos_bias:
            if position_bias is None:
                buckets = _buckets_on(t, c.num_buckets,
                                      c.max_bucket_distance, x.device)
                position_bias = F.embedding(
                    buckets, self.rel_attn_embed.weight.to(x.dtype)
                ).permute(2, 0, 1)  # (H, T, T)
            # the gate comes from the un-projected heads
            gate_in = x.reshape(b, t, h, d).transpose(1, 2)
            gate = rel_pos_gate(linear(gate_in, self.gru_rel_pos_linear),
                                self.gru_rel_pos_const.to(x.dtype))
            bias = gate * position_bias[None]  # (B, H, T, T)
        q = linear(x, self.q_proj).reshape(b, t, h, d).transpose(1, 2)
        k = linear(x, self.k_proj).reshape(b, t, h, d).transpose(1, 2)
        v = linear(x, self.v_proj).reshape(b, t, h, d).transpose(1, 2)
        logits = (q * (d ** -0.5)) @ k.transpose(-1, -2)
        if bias is not None:
            logits = logits + bias
        logits = logits.float()
        if mask is not None:
            logits = logits.masked_fill(mask[:, None, None, :] <= 0, _NEG_INF)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (w @ v).transpose(1, 2).reshape(b, t, c.hidden_size)
        return linear(out, self.out_proj), position_bias


class WavLMFeedForward(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return linear(F.gelu(linear(x, self.intermediate_dense)),
                      self.output_dense)


class WavLMEncoderLayer(nn.Module):
    """Pre-LN with `do_stable_layer_norm` (Large), post-LN otherwise."""

    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        self.stable = cfg.do_stable_layer_norm
        self.attention = WavLMAttention(cfg, has_relative_position_bias)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.feed_forward = WavLMFeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, x, position_bias=None, mask=None):
        if self.stable:
            a, position_bias = self.attention(layer_norm(x, self.layer_norm),
                                              position_bias, mask)
            x = x + a
            x = x + self.feed_forward(layer_norm(x, self.final_layer_norm))
        else:
            a, position_bias = self.attention(x, position_bias, mask)
            x = layer_norm(x + a, self.layer_norm)
            x = x + self.feed_forward(x)
            x = layer_norm(x, self.final_layer_norm)
        return x, position_bias


class MaskedChannelNorm(nn.Module):
    """GroupNorm with one group a channel (instance norm over time, biased
    variance), its statistics over the valid frames of a (B, T) mask so a
    padded batch matches the whole-utterance path. On channels-first
    (B, C, T); statistics in f32."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = wide(x)
        if mask is None:
            var, mu = torch.var_mean(y, dim=-1, keepdim=True, correction=0)
        else:
            m = mask[:, None, :].to(y.dtype)
            n = torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0)
            mu = (y * m).sum(dim=-1, keepdim=True) / n
            var = (((y - mu) * m) ** 2).sum(dim=-1, keepdim=True) / n
        y = ((y - mu) / torch.sqrt(var + self.eps)
             * self.weight.to(y.dtype)[:, None] + self.bias.to(y.dtype)[:, None])
        return y.to(x.dtype)


class _ConvLayer(nn.Module):
    """One conv of the feature encoder (`conv`) and its norm
    (`layer_norm`: MaskedChannelNorm, nn.LayerNorm or none)."""

    def __init__(self, cfg: WavLMConfig, i: int):
        super().__init__()
        cin = 1 if i == 0 else cfg.conv_dim[i - 1]
        self.conv = nn.Conv1d(cin, cfg.conv_dim[i], cfg.conv_kernel[i],
                              stride=cfg.conv_stride[i], bias=cfg.conv_bias)
        if cfg.feat_extract_norm == "group" and i == 0:
            self.layer_norm = MaskedChannelNorm(cfg.conv_dim[i])
        elif cfg.feat_extract_norm == "layer":
            self.layer_norm = nn.LayerNorm(cfg.conv_dim[i], eps=1e-5)
        else:
            self.layer_norm = None


class WavLMFeatureEncoder(nn.Module):
    """(B, N) samples -> (B, T, C) frames. The valid length of a sample
    mask is tracked through the convs exactly, (n - k) // s + 1 each, for
    the first conv's masked group norm."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_layers = nn.ModuleList(_ConvLayer(cfg, i)
                                         for i in range(len(cfg.conv_dim)))

    def forward(self, wav: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = wav[:, None, :]  # channels-first through the convs
        n_valid = None if mask is None else mask.sum(dim=-1, keepdim=True)
        for layer in self.conv_layers:
            conv = layer.conv
            x = F.conv1d(x, conv.weight.to(x.dtype),
                         None if conv.bias is None else conv.bias.to(x.dtype),
                         stride=conv.stride)
            if n_valid is not None:
                n_valid = (n_valid - conv.kernel_size[0]) // conv.stride[0] + 1
            norm = layer.layer_norm
            if isinstance(norm, MaskedChannelNorm):
                lmask = None
                if n_valid is not None:
                    lmask = (torch.arange(x.shape[-1], device=x.device)[None]
                             < n_valid).to(x.dtype)
                x = norm(x, lmask)
            elif norm is not None:
                x = layer_norm(x.transpose(1, 2), norm).transpose(1, 2)
            x = F.gelu(x)
        return x.transpose(1, 2)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1],
                                       eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)


class _PosConvEmbed(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k,
                              padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)


class _Encoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = _PosConvEmbed(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            WavLMEncoderLayer(cfg, has_relative_position_bias=(i == 0))
            for i in range(cfg.num_hidden_layers))


def frame_mask(cfg: WavLMConfig, mask: torch.Tensor,
               t_out: int) -> torch.Tensor:
    """Sample mask (B, N) -> the conv stack's exact frame mask (B, t_out)."""
    t_valid = cfg.feat_extract_output_lengths(mask.sum(dim=-1, keepdim=True))
    return (torch.arange(t_out, device=mask.device)[None]
            < t_valid).to(mask.dtype)


class WavLMFrontend(nn.Module):
    """wav (B, N) in [-1, 1] (+ an optional sample mask) -> (the hidden
    states [(B, T, D)] * (layers + 1), the last), the reference frontend
    contract. `normalize_input` (the Large checkpoints) makes each
    utterance zero-mean and unit-variance over its valid samples
    (biased variance, eps 1e-7)."""

    def __init__(self, cfg: WavLMConfig = WavLMConfig(),
                 normalize_input: bool = False):
        super().__init__()
        self.cfg = cfg
        self.normalize_input = normalize_input
        self.feature_extractor = WavLMFeatureEncoder(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    def downsample_mask(self, mask: torch.Tensor, t_out: int) -> torch.Tensor:
        return frame_mask(self.cfg, mask, t_out)

    def forward(self, wav: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        c = self.cfg
        if self.normalize_input:
            y = wide(wav)
            if mask is None:
                var, mu = torch.var_mean(y, dim=-1, keepdim=True,
                                         correction=0)
            else:
                m = mask.to(y.dtype)
                n = torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0)
                mu = (y * m).sum(dim=-1, keepdim=True) / n
                var = (((y - mu) * m) ** 2).sum(dim=-1, keepdim=True) / n
            y = (y - mu) / torch.sqrt(var + 1e-7)
            if mask is not None:
                y = y * mask.to(y.dtype)
            wav = y.to(wav.dtype)

        x = self.feature_extractor(wav, mask)
        fmask = None
        if mask is not None:
            fmask = frame_mask(c, mask, x.shape[1]).to(x.dtype)
            x = x * fmask[..., None]
        proj = self.feature_projection
        h = linear(layer_norm(x, proj.layer_norm), proj.projection)
        if fmask is not None:
            h = h * fmask[..., None]

        enc = self.encoder
        pos = conv1d(h, enc.pos_conv_embed.conv)
        if c.num_conv_pos_embeddings % 2 == 0:
            pos = pos[:, :-1]  # the even kernel's trailing frame
        h = h + F.gelu(pos)
        if not c.do_stable_layer_norm:
            h = layer_norm(h, enc.layer_norm)

        hidden: List[torch.Tensor] = [h]
        position_bias = None
        for layer in enc.layers:
            h, position_bias = layer(h, position_bias, fmask)
            hidden.append(h)
        if c.do_stable_layer_norm:
            h = layer_norm(h, enc.layer_norm)
            hidden[-1] = h
        return tuple(hidden), h


class WavLMWithFeaturizer(nn.Module):
    """The s3prl-style frontend: WavLM's hidden states mixed by a learned
    Featurizer -> (B, T, hidden_size)."""

    def __init__(self, cfg: WavLMConfig = WavLMConfig(),
                 normalize_input: bool = False):
        super().__init__()
        self.cfg = cfg
        self.upstream = WavLMFrontend(cfg, normalize_input)
        self.featurizer = Featurizer(cfg.num_hidden_layers + 1)

    def downsample_mask(self, mask: torch.Tensor, t_out: int) -> torch.Tensor:
        return frame_mask(self.cfg, mask, t_out)

    def forward(self, wav: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden, _ = self.upstream(wav, mask)
        return self.featurizer(hidden)


def fold_wavlm_weight_norm(state_dict):
    """Fold the positional conv's torch weight norm (original0 = g,
    original1 = v, dim=2; or the older weight_g / weight_v) of an HF
    state_dict into a plain conv weight g v / ||v|| (the norm over the
    output and input axes), computed in f64, so that the port's
    `encoder.pos_conv_embed.conv.weight` loads it."""
    sd = dict(state_dict)
    for base in ("encoder.pos_conv_embed.conv",):
        g_keys = (f"{base}.parametrizations.weight.original0",
                  f"{base}.weight_g")
        v_keys = (f"{base}.parametrizations.weight.original1",
                  f"{base}.weight_v")
        g = next((sd.pop(k) for k in g_keys if k in sd), None)
        v = next((sd.pop(k) for k in v_keys if k in sd), None)
        if g is None or v is None:
            continue
        g = torch.as_tensor(g).to(torch.float64)
        v = torch.as_tensor(v).to(torch.float64)
        norm = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))
        sd[f"{base}.weight"] = (g * v / torch.clamp(norm, min=1e-12)).float()
    return sd
