"""The w2v-bert 2.0 encoder of the adapter-MFA recipes
(`dataset_args.frontend: w2vbert`).

Counterpart of wespeaker_tpu/frontend/w2vbert.py, which follows HF
transformers' Wav2Vec2BertModel: a feature projection of 160-wide stacked
fbank frames, then conformer layers (a half-step SiLU FFN, self-attention
with the relative_key position bias, the conv module, a second half-step
FFN, a final LayerNorm). The input features are the SeamlessM4T
extractor's, computed on the card by `w2vbert_features`. Dropout and
layer drop are left out, as in the JAX package.

Parameter names are HF's (`feature_projection.projection`,
`encoder.layers.<i>.self_attn.linear_q`,
`encoder.layers.<i>.self_attn.distance_embedding`,
`encoder.layers.<i>.conv_module.depthwise_conv`, ...), the targets of the
JAX package's torch_compat rules. Attention, layer norms and the convs
are plain torch ops written as the JAX code writes them.
"""

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from wespeaker_tpu_torch.frontend.fbank import FbankConfig, compute_fbank
from wespeaker_tpu_torch.models.layers import conv1d, layer_norm, linear

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class W2VBertConfig:
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    feature_projection_input_dim: int = 160
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    conv_depthwise_kernel_size: int = 31
    layer_norm_eps: float = 1e-5

    @property
    def head_size(self):
        return self.hidden_size // self.num_attention_heads


_W2VBERT_FBANK = FbankConfig(window_type="povey", dither=0.0)


def w2vbert_features(wav: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     num_mel_bins: int = 80, stride: int = 2
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """wav (B, N) in [-1, 1] -> (features (B, T // 2, 160), frame mask or
    None), as SeamlessM4TFeatureExtractor computes them: a kaldi povey
    fbank of x * 2^15, each mel bin made zero-mean and unit-variance
    (ddof 1, eps 1e-7) over the valid frames, frames stacked in pairs.
    A stacked frame is valid where its second source frame is (the
    extractor keeps attention-mask rows 1::2)."""
    cfg = dataclasses.replace(_W2VBERT_FBANK, num_mel_bins=num_mel_bins)
    feat = compute_fbank(wav.float() * (1 << 15), cfg)
    t = feat.shape[-2]
    fmask = None
    if mask is not None:
        n_valid = mask.sum(dim=-1, keepdim=True)
        t_valid = 1 + (n_valid - cfg.window_size) // cfg.window_shift
        fmask = (torch.arange(t, device=feat.device)[None]
                 < t_valid).to(feat.dtype)
        m = fmask[..., None]
        n = torch.clamp(m.sum(dim=-2, keepdim=True), min=2.0)
        mean = (feat * m).sum(dim=-2, keepdim=True) / n
        var = (((feat - mean) * m) ** 2).sum(dim=-2, keepdim=True) / (n - 1.0)
        feat = (feat - mean) / torch.sqrt(var + 1e-7) * m
    else:
        var, mean = torch.var_mean(feat, dim=-2, keepdim=True, correction=1)
        feat = (feat - mean) / torch.sqrt(var + 1e-7)
    t2 = (t // stride) * stride
    feat = feat[..., :t2, :].reshape(feat.shape[:-2] + (t2 // stride, -1))
    if fmask is None:
        return feat, None
    return feat, fmask[..., :t2][..., 1::stride]


@functools.lru_cache(maxsize=64)
def _distance_index(t: int, left: int, right: int,
                    device: torch.device) -> torch.Tensor:
    """(T, T) index into the distance embedding: key - query clipped to
    [-left, right], shifted by left; on the host in numpy, uploaded once,
    outside inference mode (a later training step saves it)."""
    dist = np.clip(np.arange(t)[None, :] - np.arange(t)[:, None],
                   -left, right)
    with torch.inference_mode(False):
        return torch.as_tensor(dist + left, device=device)


class W2VBertSelfAttention(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.linear_q = nn.Linear(d, d)
        self.linear_k = nn.Linear(d, d)
        self.linear_v = nn.Linear(d, d)
        self.linear_out = nn.Linear(d, d)
        self.distance_embedding = nn.Embedding(
            cfg.left_max_position_embeddings
            + cfg.right_max_position_embeddings + 1, cfg.head_size)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        h, d = c.num_attention_heads, c.head_size
        b, t, _ = x.shape

        def heads(lin):
            return linear(x, lin).reshape(b, t, h, d).transpose(1, 2)

        q, k, v = heads(self.linear_q), heads(self.linear_k), \
            heads(self.linear_v)
        scores = q @ k.transpose(-1, -2)
        # relative_key bias: the query against the embedding of each
        # clipped distance, (T, T, d) -> (B, H, T, T)
        idx = _distance_index(t, c.left_max_position_embeddings,
                              c.right_max_position_embeddings, x.device)
        pos = F.embedding(idx, self.distance_embedding.weight.to(q.dtype))
        rel = torch.einsum("bhld,lrd->bhlr", q, pos)
        scores = ((scores + rel) / float(np.sqrt(d))).float()
        if mask is not None:
            scores = scores.masked_fill(mask[:, None, None, :] <= 0, _NEG_INF)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        out = (w @ v).transpose(1, 2).reshape(b, t, c.hidden_size)
        return linear(out, self.linear_out)


class W2VBertFeedForward(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return linear(F.silu(linear(x, self.intermediate_dense)),
                      self.output_dense)


class W2VBertConvModule(nn.Module):
    """LayerNorm -> (padded frames zeroed) -> pointwise conv to 2D -> GLU
    -> causal depthwise conv (left pad k - 1, no bias) -> LayerNorm -> SiLU
    -> pointwise conv."""

    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        d, k = cfg.hidden_size, cfg.conv_depthwise_kernel_size
        eps = cfg.layer_norm_eps
        self.layer_norm = nn.LayerNorm(d, eps=eps)
        self.pointwise_conv1 = nn.Conv1d(d, 2 * d, 1, bias=False)
        self.depthwise_conv = nn.Conv1d(d, d, k, groups=d, bias=False)
        self.depthwise_layer_norm = nn.LayerNorm(d, eps=eps)
        self.pointwise_conv2 = nn.Conv1d(d, d, 1, bias=False)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = layer_norm(x, self.layer_norm)
        if mask is not None:
            h = h * mask[..., None].to(h.dtype)
        h = conv1d(h, self.pointwise_conv1)
        a, g = h.chunk(2, dim=-1)
        h = a * torch.sigmoid(g)
        k = self.depthwise_conv.kernel_size[0]
        h = F.pad(h, (0, 0, k - 1, 0))  # causal: k - 1 frames on the left
        h = conv1d(h, self.depthwise_conv)
        h = F.silu(layer_norm(h, self.depthwise_layer_norm))
        return conv1d(h, self.pointwise_conv2)


class W2VBertEncoderLayer(nn.Module):
    """The conformer block."""

    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ffn1_layer_norm = nn.LayerNorm(d, eps=eps)
        self.ffn1 = W2VBertFeedForward(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.self_attn = W2VBertSelfAttention(cfg)
        self.conv_module = W2VBertConvModule(cfg)
        self.ffn2_layer_norm = nn.LayerNorm(d, eps=eps)
        self.ffn2 = W2VBertFeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(layer_norm(x, self.ffn1_layer_norm))
        x = x + self.self_attn(layer_norm(x, self.self_attn_layer_norm), mask)
        x = x + self.conv_module(x, mask)
        x = x + 0.5 * self.ffn2(layer_norm(x, self.ffn2_layer_norm))
        return layer_norm(x, self.final_layer_norm)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.feature_projection_input_dim,
                                       eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.feature_projection_input_dim,
                                    cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.layers = nn.ModuleList(W2VBertEncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))


class W2VBertFrontend(nn.Module):
    """Features (B, T, 160) (+ a frame mask) -> (the hidden states
    [(B, T, D)] * (layers + 1), the last), the reference frontend contract
    (its w2vbert.py returns (all hidden states, last))."""

    def __init__(self, cfg: W2VBertConfig = W2VBertConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, feats: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        proj = self.feature_projection
        h = linear(layer_norm(feats, proj.layer_norm), proj.projection)
        if mask is not None:
            h = h * mask[..., None].to(h.dtype)
        hidden: List[torch.Tensor] = [h]
        for layer in self.encoder.layers:
            h = layer(h, mask)
            hidden.append(h)
        return tuple(hidden), h
