"""System SAD: silero-compatible post-processing with pluggable prob models.

Behavioral spec: wespeaker/diar/make_system_sad.py:44-62 runs
silero_vad.get_speech_timestamps(wav, model, threshold) and length-filters
the segments. The silero *package* needs network access to fetch weights,
so this module splits the problem:

- `get_speech_timestamps(probs, ...)` — the silero hysteresis
  post-processing (trigger/neg-threshold, min speech/silence, max-speech
  splitting, boundary padding) over any per-window speech-probability
  array, reimplemented natively.
- `TorchJitVad` — adapter for a user-supplied silero torch.jit model file
  (`model(chunk, sr) -> prob`, optional `reset_states()`): diarize
  `--sad_model /path/to/silero_vad.jit`.
- `energy_probs` — offline fallback prob model (frame RMS mapped through a
  sigmoid around a relative threshold), so the same post-processing drives
  the no-weights path.
- `energy_vad` — the simple energy SAD that diarization and the Speaker
  API use when no segments are given (wespeaker_tpu/diar/pipeline.py:23).

Host code, a copy of wespeaker_tpu/diar/vad.py and of the JAX pipeline's
`energy_vad`.
"""

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


def get_speech_timestamps(probs: np.ndarray, window_samples: int,
                          num_samples: int, sr: int,
                          threshold: float = 0.5,
                          neg_threshold: Optional[float] = None,
                          min_speech_s: float = 0.25,
                          min_silence_s: float = 0.1,
                          pad_s: float = 0.03,
                          max_speech_s: Optional[float] = None
                          ) -> List[Tuple[int, int]]:
    """Silero's hysteresis segmenter over per-window speech probabilities.

    Returns [(start_sample, end_sample)]. Matches the reference package's
    get_speech_timestamps semantics: trigger at `threshold`, release below
    `neg_threshold` (threshold - 0.15) sustained for `min_silence_s`,
    drop segments shorter than `min_speech_s`, split segments longer than
    `max_speech_s` at the last sustained silence, then pad/meet-in-the-
    middle the boundaries by `pad_s`.
    """
    if neg_threshold is None:
        neg_threshold = max(threshold - 0.15, 0.01)
    min_speech = int(min_speech_s * sr)
    min_silence = int(min_silence_s * sr)
    min_silence_at_max = int(0.098 * sr)
    pad = int(pad_s * sr)
    max_speech = (np.inf if max_speech_s is None
                  else int(max_speech_s * sr) - window_samples - 2 * pad)

    triggered = False
    speeches: List[dict] = []
    current: dict = {}
    temp_end = 0  # tentative segment end while silence is accumulating
    prev_end = 0  # last silence long enough to split a max-length segment
    next_start = 0

    for i, p in enumerate(probs):
        pos = window_samples * i
        if p >= threshold and temp_end:
            temp_end = 0
            if next_start < prev_end:
                next_start = pos
        if p >= threshold and not triggered:
            triggered = True
            current["start"] = pos
            continue
        if triggered and pos - current["start"] > max_speech:
            if prev_end:
                current["end"] = prev_end
                speeches.append(current)
                current = {}
                if next_start < prev_end:  # silence continued past split
                    triggered = False
                else:
                    current["start"] = next_start
                prev_end = next_start = temp_end = 0
            else:
                current["end"] = pos
                speeches.append(current)
                current = {}
                prev_end = next_start = temp_end = 0
                triggered = False
                continue
        if p < neg_threshold and triggered:
            if not temp_end:
                temp_end = pos
            if pos - temp_end > min_silence_at_max:
                prev_end = temp_end
            if pos - temp_end < min_silence:
                continue
            current["end"] = temp_end
            if current["end"] - current["start"] > min_speech:
                speeches.append(current)
            current = {}
            prev_end = next_start = temp_end = 0
            triggered = False

    if current and num_samples - current["start"] > min_speech:
        current["end"] = num_samples
        speeches.append(current)

    for i, sp in enumerate(speeches):
        if i == 0:
            sp["start"] = max(0, sp["start"] - pad)
        if i != len(speeches) - 1:
            gap = speeches[i + 1]["start"] - sp["end"]
            if gap < 2 * pad:  # meet in the middle
                sp["end"] += gap // 2
                speeches[i + 1]["start"] = max(
                    0, speeches[i + 1]["start"] - gap // 2)
            else:
                sp["end"] = min(num_samples, sp["end"] + pad)
                speeches[i + 1]["start"] = max(
                    0, speeches[i + 1]["start"] - pad)
        else:
            sp["end"] = min(num_samples, sp["end"] + pad)
    return [(sp["start"], sp["end"]) for sp in speeches]


def _pad_to_windows(wav: np.ndarray, window_samples: int) -> np.ndarray:
    """Zero-pad so the trailing partial window is scored rather than
    dropped (silero pads the last chunk the same way)."""
    rem = len(wav) % window_samples
    if rem:
        wav = np.concatenate(
            [wav, np.zeros(window_samples - rem, wav.dtype)])
    return wav


class TorchJitVad:
    """Adapter for a silero-style torch.jit VAD model file: callable
    `model(chunk_tensor, sr) -> prob` per window, with optional
    reset_states(). Runs on the host CPU, window by window, as the JAX
    package's adapter does."""

    def __init__(self, model_path: str, window_samples: int = 512):
        self.model = torch.jit.load(model_path, map_location="cpu")
        self.model.eval()
        self.window_samples = window_samples

    def speech_probs(self, wav: np.ndarray, sr: int) -> np.ndarray:
        if hasattr(self.model, "reset_states"):
            self.model.reset_states()
        w = self.window_samples
        wav = _pad_to_windows(wav, w)
        n = len(wav) // w
        probs = np.empty(n, np.float32)
        with torch.no_grad():
            for i in range(n):
                chunk = torch.from_numpy(
                    np.ascontiguousarray(wav[i * w:(i + 1) * w],
                                         dtype=np.float32))
                out = self.model(chunk.unsqueeze(0), sr)
                probs[i] = float(out.reshape(-1)[0])
        return probs


def energy_probs(wav: np.ndarray, sr: int,
                 window_samples: int = 512,
                 threshold_db: float = -40.0) -> np.ndarray:
    """Fallback prob model: window RMS in dB relative to the recording
    peak, squashed to (0,1) around `threshold_db` — lets the silero
    post-processing drive the no-weights path."""
    wav = _pad_to_windows(np.asarray(wav), window_samples)
    n = len(wav) // window_samples
    if n == 0:
        return np.zeros(0, np.float32)
    frames = wav.reshape(n, window_samples)
    db = 10 * np.log10(np.mean(frames.astype(np.float64) ** 2, 1) + 1e-12)
    rel = db - (db.max() + threshold_db)
    return (1.0 / (1.0 + np.exp(-rel / 3.0))).astype(np.float32)


def system_sad(wav: np.ndarray, sr: int, model_path: Optional[str] = None,
               threshold: float = 0.5, min_duration: float = 0.0,
               window_samples: int = 512,
               prob_fn: Optional[Callable] = None,
               **kwargs) -> List[Tuple[float, float]]:
    """[(begin_s, end_s)] via silero post-processing; the prob model is a
    torch.jit file (`model_path`), a callable `prob_fn(wav, sr)`, or the
    energy fallback. min_duration filters like make_system_sad.py:58-62."""
    if prob_fn is not None:
        probs = prob_fn(wav, sr)
    elif model_path:
        probs = TorchJitVad(model_path, window_samples).speech_probs(wav, sr)
    else:
        probs = energy_probs(wav, sr, window_samples)
    stamps = get_speech_timestamps(probs, window_samples, len(wav), sr,
                                   threshold=threshold, **kwargs)
    return [(b / sr, e / sr) for b, e in stamps
            if (e - b) / sr >= min_duration]


def energy_vad(wav: np.ndarray, sr: int = 16000, frame_ms: int = 30,
               threshold_db: float = -40.0, min_speech_s: float = 0.25,
               min_gap_s: float = 0.3) -> List[Tuple[float, float]]:
    """Simple energy VAD: frames above `threshold_db` relative to peak are
    speech; segments are merged over short gaps and length-filtered."""
    hop = int(sr * frame_ms / 1000)
    n = len(wav) // hop
    if n == 0:
        return []
    frames = wav[:n * hop].reshape(n, hop)
    energy_db = 10 * np.log10(np.mean(frames ** 2, axis=1) + 1e-12)
    peak = np.max(energy_db)
    speech = energy_db > peak + threshold_db
    segs = []
    start = None
    for i, s in enumerate(speech):
        if s and start is None:
            start = i
        elif not s and start is not None:
            segs.append((start * hop / sr, i * hop / sr))
            start = None
    if start is not None:
        segs.append((start * hop / sr, n * hop / sr))
    merged = []
    for b, e in segs:
        if merged and b - merged[-1][1] < min_gap_s:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((b, e))
    return [(b, e) for b, e in merged if e - b >= min_speech_s]
