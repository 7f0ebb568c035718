"""SSL multi-crop data stages, on the host in numpy.

Counterpart of wespeaker_tpu/ssl/dataset.py (upstream
wespeaker/ssl/dataset/processor.py: random_chunk_for_dino:48, N global and
M local random chunks per utterance, each augmented on its own; and
dino_collate_fn:27, the crops stacked view-major). Every random choice
draws from the numpy Generator passed in, so the same seed gives the
JAX package's arrays.
"""

from typing import Iterator, Optional

import numpy as np

from wespeaker_tpu_torch.data.pipeline import get_random_chunk


def multi_crop(data, global_len: int, local_len: int, n_global: int = 2,
               n_local: int = 4, aug_fn=None,
               rng: Optional[np.random.Generator] = None) -> Iterator[dict]:
    """Each sample gains 'global_wavs' (n_global, Lg) and 'local_wavs'
    (n_local, Ll), chunked (and, with aug_fn, augmented) one by one."""
    rng = rng or np.random.default_rng()
    for sample in data:
        wav = sample["wav"]
        crops = []
        for n, length in ((n_global, global_len), (n_local, local_len)):
            views = []
            for _ in range(n):
                c = get_random_chunk(wav, length, rng)
                if aug_fn is not None:
                    c = aug_fn(c, rng)
                views.append(c)
            crops.append(np.stack(views))
        sample["global_wavs"], sample["local_wavs"] = crops
        yield sample


def dino_batch(data, batch_size: int) -> Iterator[dict]:
    """View-major batches: 'global_wav' (n_global * B, Lg) and 'local_wav'
    (n_local * B, Ll) f32, rows [view 0 of every utterance, view 1, ...],
    and 'key'. A partial buffer at the end of `data` is dropped: the
    trainers call this once per epoch, as the JAX trainer does."""
    buf = []
    for sample in data:
        buf.append(sample)
        if len(buf) == batch_size:
            out = {}
            for name in ("global", "local"):
                views = np.stack([s[f"{name}_wavs"] for s in buf])  # (B, n, L)
                out[f"{name}_wav"] = np.concatenate(
                    list(views.transpose(1, 0, 2))).astype(np.float32)
            out["key"] = [s["key"] for s in buf]
            yield out
            buf = []
