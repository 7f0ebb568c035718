"""Whisper log-mel spectrogram on the card.

Counterpart of wespeaker_tpu/frontend/whisper_mel.py (upstream
whisper.log_mel_spectrogram, which the reference's whisper frontend calls
per utterance): a hann-windowed STFT (n_fft 400, hop 160, reflect padding
of n_fft // 2 on each side, the last frame dropped) -> power -> slaney
mel filters -> log10 (floor 1e-10) -> a per-utterance clamp at max - 8 ->
(x + 4) / 4. The window and the real DFT are one (2 (n_fft/2 + 1), 1,
n_fft) operator computed in f64 on the host, so the STFT is a single
strided `F.conv1d` and the mel projection one product, both in f32 with
TF32 off. The operator and the filters are uploaded once per device and
dtype (`_operators`), not on every call.
"""

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from wespeaker_tpu_torch.frontend.fbank import no_tf32


@dataclasses.dataclass(frozen=True)
class WhisperMelConfig:
    num_mel_bins: int = 80       # 128 for large-v3
    n_fft: int = 400
    hop_length: int = 160
    sample_rate: int = 16000


_SLANEY_STEP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    min_log_mel = _MIN_LOG_HZ / _SLANEY_STEP
    return np.where(f >= _MIN_LOG_HZ,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ)
                    / _LOGSTEP, f / _SLANEY_STEP)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    min_log_mel = _MIN_LOG_HZ / _SLANEY_STEP
    return np.where(m >= min_log_mel,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - min_log_mel)),
                    m * _SLANEY_STEP)


def make_whisper_mel_banks(cfg: WhisperMelConfig) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels, htk=False, norm='slaney'),
    shape (n_fft // 2 + 1, num_mel_bins), f64 on the host."""
    n_bins = cfg.n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, cfg.sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel_slaney(0.0),
                          _hz_to_mel_slaney(cfg.sample_rate / 2.0),
                          cfg.num_mel_bins + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    lower = (fftfreqs[:, None] - hz_pts[None, :-2]) \
        / np.maximum(hz_pts[1:-1] - hz_pts[:-2], 1e-10)[None, :]
    upper = (hz_pts[None, 2:] - fftfreqs[:, None]) \
        / np.maximum(hz_pts[2:] - hz_pts[1:-1], 1e-10)[None, :]
    banks = np.maximum(0.0, np.minimum(lower, upper))
    banks *= (2.0 / (hz_pts[2:] - hz_pts[:-2]))[None, :]  # slaney area norm
    return banks


def whisper_dft_kernel(cfg: WhisperMelConfig) -> np.ndarray:
    """The periodic hann window times the real-DFT basis [cos | -sin] as
    one (n_fft, 2 (n_fft // 2 + 1)) matrix, computed in f64, f32 out."""
    n = np.arange(cfg.n_fft, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / cfg.n_fft))
    k = np.arange(cfg.n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n[:, None] * k / cfg.n_fft
    return np.concatenate([np.cos(ang) * window[:, None],
                           -np.sin(ang) * window[:, None]],
                          axis=1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _operators(cfg: WhisperMelConfig, device: torch.device,
               dtype: torch.dtype):
    """(the DFT as a conv weight (2 nbins, 1, n_fft), the mel filters
    (nbins, M)) on `device` in `dtype`, uploaded once, outside inference
    mode (a later training step may use them)."""
    with torch.inference_mode(False):
        kernel = torch.as_tensor(
            whisper_dft_kernel(cfg).T[:, None, :].copy(), device=device,
            dtype=dtype)
        banks = torch.as_tensor(
            make_whisper_mel_banks(cfg).astype(np.float32), device=device,
            dtype=dtype)
    return kernel, banks


def whisper_logmel(wav: torch.Tensor,
                   cfg: WhisperMelConfig = WhisperMelConfig()
                   ) -> torch.Tensor:
    """wav (..., num_samples) in [-1, 1] -> (..., T, num_mel_bins) f32 with
    T = num_samples // hop_length; the max - 8 clamp is per utterance."""
    nbins = cfg.n_fft // 2 + 1
    squeeze = wav.dim() == 1
    x = wav.float()
    if squeeze:
        x = x[None]
    lead = x.shape[:-1]
    x = x.reshape(-1, 1, x.shape[-1])
    half = cfg.n_fft // 2
    kernel, banks = _operators(cfg, x.device, torch.float32)
    with no_tf32(matmul=True, cudnn=True):
        x = F.pad(x, (half, half), mode="reflect")
        out = F.conv1d(x, kernel, stride=cfg.hop_length)[..., :-1]
        out = out.transpose(1, 2)  # (N, T, 2 nbins); last frame dropped
        re, im = out[..., :nbins], out[..., nbins:]
        mel = torch.matmul(re * re + im * im, banks)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    peak = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = (torch.maximum(log_spec, peak - 8.0) + 4.0) / 4.0
    log_spec = log_spec.reshape(lead + log_spec.shape[1:])
    return log_spec[0] if squeeze else log_spec
