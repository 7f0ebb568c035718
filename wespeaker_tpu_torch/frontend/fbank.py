"""Kaldi-compatible log-mel filterbank in PyTorch.

Counterpart of wespeaker_tpu/frontend/fbank.py, same behaviour
(``torchaudio.compliance.kaldi.fbank`` as the reference pipeline calls it:
hamming window, 80 mels, 25 ms / 10 ms, snip_edges, use_energy=False).
The deterministic hot path folds DC removal, pre-emphasis, window and the
zero-padded real DFT into one float64 host operator, so fbank is a single
strided ``F.conv1d`` (framing included) plus one mel matmul. The JAX
package also leaves this conv to the compiler, outside any Pallas kernel.

Frame math (snip_edges=True): num_frames = 1 + (num_samples - win) // shift.
"""

import contextlib
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

EPSILON = 1.1920928955078125e-07  # float32 machine eps, kaldi/torchaudio floor


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    num_mel_bins: int = 80
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    sample_rate: int = 16000
    dither: float = 0.0
    window_type: str = "hamming"  # hamming | povey | hanning | rectangular
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0 => offset from nyquist
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    round_to_power_of_two: bool = True
    use_log_fbank: bool = True
    use_power: bool = True

    @property
    def window_size(self) -> int:
        return int(self.sample_rate * self.frame_length_ms * 0.001)

    @property
    def window_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms * 0.001)

    @property
    def padded_window_size(self) -> int:
        if self.round_to_power_of_two:
            return 1 << (self.window_size - 1).bit_length()
        return self.window_size

    def num_frames(self, num_samples: int) -> int:
        if num_samples < self.window_size:
            return 0
        return 1 + (num_samples - self.window_size) // self.window_shift


def mel_scale(freq):
    return 1127.0 * np.log1p(np.asarray(freq, np.float64) / 700.0)


def make_window(cfg: FbankConfig) -> np.ndarray:
    """Feature window function (kaldi feature-window.cc semantics)."""
    m = cfg.window_size
    n = np.arange(m, dtype=np.float64)
    a = 2.0 * math.pi / (m - 1)
    if cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * n)
    elif cfg.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * n)
    elif cfg.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    elif cfg.window_type == "rectangular":
        w = np.ones(m)
    else:
        raise ValueError(f"unknown window type {cfg.window_type}")
    return w.astype(np.float32)


def make_mel_banks(cfg: FbankConfig) -> np.ndarray:
    """Triangular mel filterbank, shape (num_fft_bins + 1, num_mel_bins);
    the nyquist bin gets a zero row (kaldi mel-computations.cc)."""
    num_fft_bins = cfg.padded_window_size // 2
    nyquist = 0.5 * cfg.sample_rate
    high_freq = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    if not (0 <= cfg.low_freq < high_freq <= nyquist):
        raise ValueError("bad low/high freq")
    mel_low = mel_scale(cfg.low_freq)
    mel_high = mel_scale(high_freq)
    delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)
    fft_bin_width = cfg.sample_rate / cfg.padded_window_size
    mel_of_bin = mel_scale(fft_bin_width * np.arange(num_fft_bins))

    j = np.arange(cfg.num_mel_bins, dtype=np.float64)[None, :]
    left = mel_low + j * delta
    center = left + delta
    right = center + delta
    mel = mel_of_bin[:, None]
    up = (mel - left) / (center - left)
    down = (right - mel) / (right - center)
    banks = np.maximum(0.0, np.minimum(up, down))
    banks = np.where((mel > left) & (mel < right), banks, 0.0)
    out = np.zeros((num_fft_bins + 1, cfg.num_mel_bins), dtype=np.float32)
    out[:num_fft_bins] = banks.astype(np.float32)
    return out


@functools.lru_cache(maxsize=16)
def _fused_dft_kernel(cfg: FbankConfig) -> np.ndarray:
    """DC removal -> pre-emphasis -> window -> zero-padded real DFT folded
    into one (window, 2*(nfft/2+1)) operator, computed in float64 on the
    host: [cos | -sin] columns."""
    win = cfg.window_size
    nfft = cfg.padded_window_size
    chain = np.eye(win)
    if cfg.remove_dc_offset:
        chain = (np.eye(win) - np.ones((win, win)) / win) @ chain
    if cfg.preemphasis != 0.0:
        p = np.eye(win)
        p[0, 0] = 1.0 - cfg.preemphasis
        for i in range(1, win):
            p[i, i - 1] = -cfg.preemphasis
        chain = p @ chain
    chain = np.diag(make_window(cfg).astype(np.float64)) @ chain
    n = np.arange(win)[:, None]
    k = np.arange(nfft // 2 + 1)[None, :]
    cos_b = np.cos(2 * np.pi * n * k / nfft)
    sin_b = -np.sin(2 * np.pi * n * k / nfft)
    return np.concatenate([chain.T @ cos_b, chain.T @ sin_b],
                          axis=1).astype(np.float32)


@contextlib.contextmanager
def no_tf32(matmul: bool = False, cudnn: bool = True):
    """A float32 cuDNN conv (and, where allowed, a matmul) on the card runs
    in TF32 by default; inside the block the chosen ones are exact f32, as
    in JAX. The f32 fbank turns off cuDNN's TF32 for its DFT conv."""
    flags = [b for b, on in ((torch.backends.cuda.matmul, matmul),
                             (torch.backends.cudnn, cudnn)) if on]
    prev = [b.allow_tf32 for b in flags]
    for b in flags:
        b.allow_tf32 = False
    try:
        yield
    finally:
        for b, p in zip(flags, prev):
            b.allow_tf32 = p


def _mel_log(power, cfg: FbankConfig, conv_dtype):
    if not cfg.use_power:
        power = torch.sqrt(power)
    banks = torch.as_tensor(make_mel_banks(cfg), device=power.device)
    # operands rounded to conv_dtype, f32 accumulation
    mel = torch.matmul(power.to(conv_dtype).float(),
                       banks.to(conv_dtype).float())
    if cfg.use_log_fbank:
        mel = torch.log(torch.clamp(mel, min=EPSILON))
    return mel


def _fbank_fused(wav: torch.Tensor, cfg: FbankConfig,
                 conv_dtype=torch.float32) -> torch.Tensor:
    """Deterministic (dither-free) fbank as one strided conv + mel matmul.
    conv_dtype=bfloat16 runs the DFT conv on bf16 operands (the bf16
    extraction fast path); log-mel output is f32 either way."""
    nbins = cfg.padded_window_size // 2 + 1
    kernel = torch.as_tensor(_fused_dft_kernel(cfg), device=wav.device)
    squeeze = wav.dim() == 1
    x = wav[None] if squeeze else wav
    lead = x.shape[:-1]
    x = x.reshape(-1, 1, x.shape[-1]).to(conv_dtype)
    w = kernel.t().unsqueeze(1).to(conv_dtype)  # (2*nbins, 1, win)
    with no_tf32():
        out = F.conv1d(x, w, stride=cfg.window_shift)
    out = out.float().transpose(1, 2)  # (N, T, 2*nbins)
    re, im = out[..., :nbins], out[..., nbins:]
    mel = _mel_log(re * re + im * im, cfg, conv_dtype)
    mel = mel.reshape(lead + mel.shape[1:])
    return mel[0] if squeeze else mel


def _fbank_impl(wav: torch.Tensor, cfg: FbankConfig,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """Exact per-frame path: framing, optional dither, DC removal,
    pre-emphasis, window, rfft."""
    window = torch.as_tensor(make_window(cfg), device=wav.device)
    frames = wav.float().unfold(-1, cfg.window_size, cfg.window_shift)
    if cfg.dither != 0.0 and generator is not None:
        noise = torch.randn(frames.shape, generator=generator,
                            device=generator.device, dtype=frames.dtype)
        frames = frames + cfg.dither * noise.to(frames.device)
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemphasis * prev
    frames = frames * window
    pad = cfg.padded_window_size - cfg.window_size
    if pad > 0:
        frames = F.pad(frames, (0, pad))
    spec = torch.fft.rfft(frames)
    return _mel_log(spec.real ** 2 + spec.imag ** 2, cfg, torch.float32)


def compute_fbank(wav: torch.Tensor, cfg: FbankConfig = FbankConfig(), *,
                  generator: Optional[torch.Generator] = None,
                  conv_dtype=None) -> torch.Tensor:
    """wav: (..., num_samples) float32, already scaled by 1<<15 to match the
    reference int16 convention. Returns (..., num_frames, num_mel_bins).

    Deterministic unless cfg.dither != 0 and a generator is given (the
    reference disables dither at extraction). conv_dtype=torch.bfloat16
    selects the bf16 DFT conv (dither-free only); None keeps f32."""
    if cfg.num_frames(wav.shape[-1]) == 0:
        raise ValueError(
            f"waveform too short: {wav.shape[-1]} < {cfg.window_size}")
    if cfg.dither != 0.0 and generator is None:
        raise ValueError("dither enabled but no generator given")
    if cfg.dither == 0.0 or generator is None:
        return _fbank_fused(wav, cfg, conv_dtype=conv_dtype or torch.float32)
    return _fbank_impl(wav, cfg, generator)


def apply_cmvn(feat: torch.Tensor, norm_mean: bool = True,
               norm_var: bool = False,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-utterance mean (and optionally variance) normalisation over time.
    feat: (..., T, F); mask: optional (..., T) validity mask."""
    if mask is None:
        if norm_mean:
            feat = feat - feat.mean(dim=-2, keepdim=True)
        if norm_var:
            var = feat.var(dim=-2, keepdim=True, unbiased=False)
            feat = feat / torch.sqrt(var + 1e-8)
        return feat
    m = mask[..., None].to(feat.dtype)
    denom = torch.clamp(m.sum(dim=-2, keepdim=True), min=1.0)
    mean = (feat * m).sum(dim=-2, keepdim=True) / denom
    if norm_mean:
        feat = (feat - mean) * m
    if norm_var:
        var = ((feat * m) ** 2).sum(dim=-2, keepdim=True) / denom
        feat = feat / torch.sqrt(var + 1e-8) * m
    return feat
