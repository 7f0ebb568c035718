"""The TF-style conv-DFT log-mel frontend of the ReDimNet2 recipes
(`dataset_args.frontend: tfmel`).

Counterpart of wespeaker_tpu/frontend/tfmel.py (upstream
wespeaker/frontend/tfmel.py): optional signal normalisation, reflect-padded
pre-emphasis, frames of `win_length` every `hop_length` samples after
padding hop // 2 on each side, a windowed cos/sin DFT of n_fft // 2 bins as
two products, the power clipped to [eps, 1 / eps], HTK-mel filters (the
first bin's row zero), log(mel + eps) and a per-bin mean over time. A
(B, T) frame mask makes the signal normalisation and the mean see only
valid frames, and zeroes the padded ones. In training the JAX package's
time and frequency masks (`fbank_aug`) follow, drawn from a
torch.Generator: the same distributions, not the same numbers. Products
in f32 with TF32 off, as the JAX package computes them.
"""

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from wespeaker_tpu_torch.frontend.fbank import no_tf32


def hz2mel(hz):
    return 2595.0 * np.log10(1 + np.asarray(hz, np.float64) / 700.0)


def get_filterbanks(low_freq=20, high_freq=7600, nfilt=80, nfft=256,
                    samplerate=16000) -> np.ndarray:
    """HTK-mel triangular filters over `nfft` spectrogram bins, (nfft,
    nfilt), the first row zeros."""
    pts = np.linspace(hz2mel(low_freq), hz2mel(high_freq), nfilt + 2)
    lower, center, upper = (pts[:-2][None], pts[1:-1][None], pts[2:][None])
    bins_mel = hz2mel(np.linspace(0, samplerate // 2, nfft))[1:][:, None]
    weights = np.maximum(0.0, np.minimum((bins_mel - lower) / (center - lower),
                                         (upper - bins_mel) / (upper - center)))
    return np.vstack([np.zeros((1, nfilt)), weights]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class TFMelConfig:
    sample_rate: int = 16000
    n_fft: int = 512
    win_length: int = 400
    hop_length: int = 160
    f_min: float = 20.0
    f_max: float = 7600.0
    n_mels: int = 80
    window: str = "hamming"
    norm_signal: bool = False
    do_preemph: bool = True
    eps: float = 1e-8

    def num_frames(self, num_samples: int) -> int:
        pad = self.hop_length // 2
        return (num_samples + 2 * pad - self.win_length) // self.hop_length + 1


def _window(cfg: TFMelConfig) -> np.ndarray:
    n = np.arange(cfg.win_length)
    if cfg.window == "hamming":  # symmetric, as scipy.signal's default
        return np.hamming(cfg.win_length).astype(np.float32)
    if cfg.window in ("hann", "hanning"):
        return (0.5 - 0.5 * np.cos(2 * np.pi * n / (cfg.win_length - 1))
                ).astype(np.float32)
    return np.ones(cfg.win_length, np.float32)


@functools.lru_cache(maxsize=8)
def _kernels(cfg: TFMelConfig):
    """(cos (L, n_fft / 2), sin, mel (n_fft / 2, n_mels)) in numpy f32."""
    grid = 2 * np.pi * np.outer(np.arange(cfg.win_length),
                                np.arange(cfg.n_fft // 2)) / cfg.n_fft
    w = _window(cfg)[:, None]
    return ((np.cos(grid) * w).astype(np.float32),
            (np.sin(grid) * w).astype(np.float32),
            get_filterbanks(cfg.f_min, cfg.f_max, cfg.n_mels, cfg.n_fft // 2,
                            cfg.sample_rate))


def preemphasis(x: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """Reflect-padded pre-emphasis: y[0] = x[0] - coef * x[1]."""
    return x - coef * torch.cat([x[..., 1:2], x[..., :-1]], dim=-1)


def tfmel(wav: torch.Tensor, cfg: TFMelConfig = TFMelConfig(), *,
          train: bool = False, generator: Optional[torch.Generator] = None,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """wav (B, N) -> (B, T, n_mels) f32 log-mel with a per-bin mean over
    time removed, T = cfg.num_frames(N); `mask` (B, T) frame validity for
    padded batches. In training with a generator, fbank_aug follows."""
    x = wav.float()
    if cfg.norm_signal:
        if mask is None:
            mean = x.mean(dim=-1, keepdim=True)
            std = x.std(dim=-1, keepdim=True, correction=0)
        else:
            n_valid = torch.clamp(
                torch.clamp(mask.sum(dim=-1, keepdim=True), min=1.0)
                * cfg.hop_length, max=x.shape[-1])
            smask = (torch.arange(x.shape[-1], device=x.device)[None]
                     < n_valid).float()
            mean = (x * smask).sum(dim=-1, keepdim=True) / n_valid
            std = torch.sqrt((((x - mean) * smask) ** 2).sum(
                dim=-1, keepdim=True) / n_valid)
        x = (x - mean) / (std + 1e-6)
    if cfg.do_preemph:
        x = preemphasis(x)
    pad = cfg.hop_length // 2
    x = torch.nn.functional.pad(x, (pad, pad))
    frames = x.unfold(-1, cfg.win_length, cfg.hop_length)  # (B, T, L)
    cos_k, sin_k, mel_k = (torch.as_tensor(a, device=x.device)
                           for a in _kernels(cfg))
    with no_tf32(matmul=True, cudnn=False):
        power = torch.clamp((frames @ cos_k) ** 2 + (frames @ sin_k) ** 2,
                            cfg.eps, 1.0 / cfg.eps)
        mel = torch.clamp(power @ mel_k, cfg.eps, 1.0 / cfg.eps)
    logmel = torch.log(mel + cfg.eps)
    if mask is None:
        logmel = logmel - logmel.mean(dim=-2, keepdim=True)
    else:
        m = mask[..., :logmel.shape[-2], None].float()
        cmn = (logmel * m).sum(dim=-2, keepdim=True) / torch.clamp(
            m.sum(dim=-2, keepdim=True), min=1.0)
        logmel = (logmel - cmn) * m  # zero padded frames for the convs
    if train and generator is not None:
        logmel = fbank_aug(generator, logmel)
    return logmel


def fbank_aug(generator: torch.Generator, feat: torch.Tensor,
              freq_mask_width: Tuple[int, int] = (0, 8),
              time_mask_width: Tuple[int, int] = (0, 10),
              freq_start_bin: int = 0) -> torch.Tensor:
    """One time mask and one frequency mask an utterance (upstream
    FbankAug): width uniform in [lo, hi), start uniform in [start_bin,
    len - hi); feat (B, T, M)."""
    b, t, m = feat.shape
    dev = feat.device

    def band(axis_len, width_range, start_bin):
        length = torch.randint(width_range[0], max(width_range[1], 1),
                               (b, 1), generator=generator, device=dev)
        pos = torch.randint(start_bin, max(1, axis_len - width_range[1]),
                            (b, 1), generator=generator, device=dev)
        ar = torch.arange(axis_len, device=dev)[None]
        return (pos <= ar) & (ar < pos + length)  # (B, axis)

    hit = (band(t, time_mask_width, 0)[:, :, None]
           | band(m, freq_mask_width, freq_start_bin)[:, None, :])
    return torch.where(hit, torch.zeros_like(feat), feat)
