"""WAV file IO in numpy (RIFF PCM8/PCM16/PCM32); counterpart of
wespeaker_tpu/data/wav_io.py."""

import io
import wave
from typing import Tuple

import numpy as np


def read_wav(path_or_bytes) -> Tuple[np.ndarray, int]:
    """Returns (float32 waveform in [-1, 1] of shape (num_samples,) mono or
    (channels, num_samples), sample_rate)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(path_or_bytes)
    else:
        f = open(path_or_bytes, "rb")
    try:
        with wave.open(f, "rb") as w:
            n = w.getnframes()
            ch = w.getnchannels()
            width = w.getsampwidth()
            sr = w.getframerate()
            raw = w.readframes(n)
        if width == 2:
            data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif width == 4:
            data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        elif width == 1:
            data = (np.frombuffer(raw, "u1").astype(np.float32) - 128) / 128.0
        else:
            raise ValueError(f"unsupported sample width {width}")
        if ch > 1:
            data = data.reshape(-1, ch).T
        return data, sr
    finally:
        f.close()


def write_wav(path, wav: np.ndarray, sample_rate: int):
    """Write mono float32 [-1, 1] (or int16) as PCM16 RIFF."""
    wav = np.asarray(wav)
    if wav.dtype != np.int16:
        wav = np.clip(wav, -1.0, 1.0)
        wav = np.round(wav * 32767.0).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(wav.tobytes())
