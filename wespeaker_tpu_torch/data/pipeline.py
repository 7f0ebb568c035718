"""Host-side audio helpers; counterpart of the parts of
wespeaker_tpu/data/pipeline.py that serving needs."""

import numpy as np


def resample_array(wav: np.ndarray, sr: int,
                   target_rate: int = 16000) -> np.ndarray:
    """Polyphase resampling from `sr` to `target_rate`."""
    from scipy.signal import resample_poly

    if sr == target_rate:
        return wav
    g = int(np.gcd(sr, target_rate))
    return resample_poly(wav, target_rate // g, sr // g).astype(np.float32)
