"""The Whisper audio encoder of the Whisper-PMFA recipes
(`dataset_args.frontend: whisper_encoder`).

Counterpart of wespeaker_tpu/frontend/whisper_encoder.py (upstream
wespeaker/frontend/whisper_encoder.py): two convs (the second of stride
2, so the frame rate halves), sinusoidal positions, the sequence cut at
`n_ctx`, pre-LN residual blocks with exact GELU, and the hidden states of
blocks `layer_st..layer_ed` concatenated on the feature axis and
normalised by `ln_post2`. Attention scales q and k each by d^-0.25,
`key` has no bias, and padded keys take -1e30 in an f32 softmax. The
JAX package's flax LayerNorms name no eps and so use flax's 1e-6 (torch's
default is 1e-5): every LayerNorm here is built with 1e-6.

Parameter names are the reference's (`encoder.conv1`,
`encoder.blocks.<i>.attn.query`, `encoder.blocks.<i>.mlp.0`, ...), the
targets of the JAX package's torch_compat rules.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from wespeaker_tpu_torch.models.layers import conv1d, layer_norm, linear

_NEG_INF = -1e30
_FLAX_LN_EPS = 1e-6


def sinusoids(length: int, channels: int,
              max_timescale: float = 10000.0) -> np.ndarray:
    """(length, channels) f32: sin of the first half of the timescales,
    cos of the second."""
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, n_state = x.shape
        h = self.n_head
        d = n_state // h

        def heads(lin):
            return linear(x, lin).reshape(b, t, h, d).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        scale = d ** -0.25
        logits = ((q * scale) @ (k * scale).transpose(-1, -2)).float()
        if mask is not None:
            logits = logits.masked_fill(mask[:, None, None, :] <= 0, _NEG_INF)
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        out = (w @ v).transpose(1, 2).reshape(b, t, n_state)
        return linear(out, self.out)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.attn_ln = nn.LayerNorm(n_state, eps=_FLAX_LN_EPS)
        self.attn = MultiHeadAttention(n_state, n_head)
        self.mlp_ln = nn.LayerNorm(n_state, eps=_FLAX_LN_EPS)
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state), nn.GELU(),
                                 nn.Linear(4 * n_state, n_state))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.attn_ln), mask)
        h = F.gelu(linear(layer_norm(x, self.mlp_ln), self.mlp[0]))
        return x + linear(h, self.mlp[2])


class AudioEncoder(nn.Module):
    """(B, T_mel, n_mels) (+ a frame mask) -> the concatenated hidden
    states of blocks [layer_st, layer_ed], (B, ceil(T_mel / 2) cut at
    n_ctx, n_state * (layer_ed - layer_st + 1))."""

    def __init__(self, n_mels: int, n_ctx: int, n_state: int, n_head: int,
                 n_layer: int, layer_st: int, layer_ed: int):
        super().__init__()
        self.n_ctx, self.n_state = n_ctx, n_state
        self.layer_st, self.layer_ed = layer_st, layer_ed
        self.conv1 = nn.Conv1d(n_mels, n_state, 3, padding=1)
        self.conv2 = nn.Conv1d(n_state, n_state, 3, stride=2, padding=1)
        self.blocks = nn.ModuleList(ResidualAttentionBlock(n_state, n_head)
                                    for _ in range(n_layer))
        self.ln_post2 = nn.LayerNorm(n_state * (layer_ed - layer_st + 1),
                                     eps=_FLAX_LN_EPS)
        self._pos = {}

    def positions(self, device: torch.device) -> torch.Tensor:
        """The (n_ctx, n_state) sinusoids, uploaded once per device,
        outside inference mode (a later training step may use them)."""
        if device not in self._pos:
            with torch.inference_mode(False):
                self._pos[device] = torch.as_tensor(
                    sinusoids(self.n_ctx, self.n_state), device=device)
        return self._pos[device]

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is not None:
            # padded mel frames zeroed, so the convs see the zeros a
            # whole-utterance forward pads with
            x = x * mask[..., None].to(x.dtype)
        h = F.gelu(conv1d(x, self.conv1))
        h = F.gelu(conv1d(h, self.conv2))
        t = h.shape[1]
        pos = self.positions(h.device)
        if t > self.n_ctx:
            h = h[:, :self.n_ctx]
        h = h + pos[:h.shape[1]].to(h.dtype)
        out_mask = None
        if mask is not None:
            out_mask = mask[:, ::2][:, :h.shape[1]]
        outs = []
        for i, block in enumerate(self.blocks):
            h = block(h, out_mask)
            if self.layer_st <= i <= self.layer_ed:
                outs.append(h)
        return layer_norm(torch.cat(outs, dim=-1), self.ln_post2)


class WhisperEncoderFrontend(nn.Module):
    """Log-mel features (B, T, n_mels) (+ a frame mask) -> the
    PMFA-ready concatenated hidden states; `time_stride` 2 tells the
    composite to halve frame masks."""

    time_stride = 2

    def __init__(self, n_mels: int = 80, num_blocks: int = 24,
                 output_size: int = 1280, n_head: int = 20,
                 layer_st: int = 16, layer_ed: int = 23, n_ctx: int = 1500):
        super().__init__()
        self.n_mels, self.output_size = n_mels, output_size
        self.layer_st, self.layer_ed = layer_st, layer_ed
        self.encoder = AudioEncoder(n_mels, n_ctx, output_size, n_head,
                                    num_blocks, layer_st, layer_ed)

    def forward(self, feats: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encoder(feats, mask)
