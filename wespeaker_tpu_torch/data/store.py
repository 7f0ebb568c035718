"""Packed random-access audio store for MUSAN noise and RIR augmentation.

Counterpart of wespeaker_tpu/data/store.py (upstream's LMDB store,
wespeaker/dataset/lmdb_data.py:21-44 and tools/make_lmdb.py): one
contiguous int16 PCM file `<prefix>.bin` and an index `<prefix>.idx.npz`
(keys, offsets, lengths, sample_rate). The layout is the JAX package's,
so a store written by either package loads in the other. Reads go through
a read-only memmap, which forked or spawned data workers open each for
themselves. Numpy only.
"""

from typing import List, Optional, Tuple

import numpy as np

from wespeaker_tpu_torch.data.wav_io import read_wav


class PackedAudioStore:
    def __init__(self, prefix: str):
        idx = np.load(prefix + ".idx.npz", allow_pickle=False)
        self.keys: List[str] = [k.decode() if isinstance(k, bytes) else str(k)
                                for k in idx["keys"]]
        self.offsets = idx["offsets"]
        self.lengths = idx["lengths"]
        self.sample_rate = int(idx["sample_rate"])
        self.data = np.memmap(prefix + ".bin", dtype=np.int16, mode="r")

    def __len__(self):
        return len(self.keys)

    def get(self, i: int) -> np.ndarray:
        """The i-th waveform as f32 in [-1, 1]."""
        o, l = int(self.offsets[i]), int(self.lengths[i])
        return self.data[o:o + l].astype(np.float32) / 32768.0

    def random_one(self, rng: np.random.Generator) -> Tuple[str, np.ndarray]:
        i = int(rng.integers(0, len(self.keys)))
        return self.keys[i], self.get(i)

    def get_raw(self, i: int) -> np.ndarray:
        """The i-th waveform as stored (int16), for the device-side
        augmentation, which converts on the card."""
        o, l = int(self.offsets[i]), int(self.lengths[i])
        return self.data[o:o + l]

    def random_one_raw(self, rng: np.random.Generator
                       ) -> Tuple[str, np.ndarray]:
        i = int(rng.integers(0, len(self.keys)))
        return self.keys[i], self.get_raw(i)


def build_packed_store(wav_list: List[Tuple[str, str]], prefix: str,
                       sample_rate: int = 16000,
                       max_duration_s: Optional[float] = None) -> str:
    """[(key, wav path)] -> <prefix>.bin and <prefix>.idx.npz. Each wav is
    resampled to `sample_rate` (polyphase) where its rate differs, cut to
    `max_duration_s`, and stored as int16 (x 32767, clipped)."""
    from scipy.signal import resample_poly

    keys, offsets, lengths = [], [], []
    offset = 0
    with open(prefix + ".bin", "wb") as out:
        for key, path in wav_list:
            wav, sr = read_wav(path)
            if wav.ndim > 1:
                wav = wav[0]
            if sr != sample_rate:
                g = np.gcd(sr, sample_rate)
                wav = resample_poly(wav, sample_rate // g, sr // g)
            if max_duration_s is not None:
                wav = wav[:int(max_duration_s * sample_rate)]
            pcm = (np.clip(wav, -1, 1) * 32767.0).astype(np.int16)
            out.write(pcm.tobytes())
            keys.append(key)
            offsets.append(offset)
            lengths.append(len(pcm))
            offset += len(pcm)
    np.savez(prefix + ".idx.npz",
             keys=np.asarray(keys),
             offsets=np.asarray(offsets, np.int64),
             lengths=np.asarray(lengths, np.int64),
             sample_rate=sample_rate)
    return prefix
