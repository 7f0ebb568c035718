"""Training dataset composition and background prefetch.

Counterpart of wespeaker_tpu/data/dataset.py (upstream
wespeaker/dataset/dataset.py:136-273): the processor chain of
data/pipeline.py for `raw` and `shard` lists, repeated without end with a
reshuffle per epoch, yielding fixed-shape numpy batches for the train
step, and a one-thread prefetcher. With `defer_chunk_aug` (the SSL
trainers' setting) an epoch is the stream of whole utterances, neither
chunked nor augmented, which ssl/dataset.py crops into views. Not ported
yet, and refused: the `feat` data type and the host half of device-side
augmentation. Reverb/noise augmentation (the packed audio stores), the
per-rank and per-worker split and the multi-process prefetcher are not
ported either (the trainers refuse their options).

`eval_batches` and `eval_feat_batches` are the extraction side: whole
utterances or feature matrices sorted by length into padded buckets with
validity masks, bit-identical to the JAX package's.
"""

import queue
import threading
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from wespeaker_tpu_torch.data import pipeline as P


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet")


class SpeakerDataset:
    """Iterable over fixed-shape training batches, for one process: the
    trainer refuses distributed and multi-worker runs, so every list is
    this process's."""

    def __init__(self, data_type: str, data_list_file: str, configs: Dict,
                 spk2id: Dict[str, int], seed: int = 42):
        if data_type == "feat":
            raise _not_ported("data_type feat")
        if data_type not in ("shard", "raw"):
            raise ValueError(f"unknown data_type {data_type}")
        if configs.get("device_aug", False):
            raise _not_ported("device_aug")
        if configs.get("speed_perturb_mode", "random") != "random":
            raise _not_ported("speed_perturb_mode "
                              f"{configs['speed_perturb_mode']}")
        self.data_type = data_type
        self.lists = P.read_lists(data_list_file)
        self.configs = configs
        self.spk2id = spk2id
        self.seed = seed

    def _epoch_iter(self, epoch: int) -> Iterator[dict]:
        cfg = self.configs
        rng = np.random.default_rng(self.seed + 1000 * epoch)
        lists = P.distributed_shard(self.lists, epoch=epoch,
                                    shuffle=cfg.get("shuffle", True),
                                    seed=self.seed)
        data = (P.parse_shard(lists) if self.data_type == "shard"
                else P.parse_raw(lists))
        fbank_args = cfg.get("fbank_args", {})
        if cfg.get("filter", True):
            # upstream order: filter right after parse, before speed
            # perturb; thresholds scale with the sample's own rate
            data = P.filter_and_cap(
                data, cfg.get("filter_args", {}).get("min_num_frames", 100),
                cfg.get("filter_args", {}).get("max_num_frames", 800),
                fbank_args.get("frame_shift", 10), rng)
        data = P.resample(data, cfg.get("resample_rate", 16000))
        if cfg.get("shuffle", True):
            data = P.local_shuffle(
                data, cfg.get("shuffle_args", {}).get("shuffle_size", 2500),
                rng)
        data = P.spk_to_id(data, self.spk2id)
        if cfg.get("speed_perturb", True):
            data = P.speed_perturb(data, len(self.spk2id), rng)
        if cfg.get("defer_chunk_aug", False):
            # SSL multi-crop: the trainer crops each utterance into views
            # and augments each view on its own (ssl/dataset.py)
            return data
        num_frms = cfg.get("num_frms", 200)
        sr = cfg.get("resample_rate", 16000)
        chunk_len = ((num_frms - 1) * fbank_args.get("frame_shift", 10)
                     + fbank_args.get("frame_length", 25)) * sr // 1000
        return P.random_chunk(data, chunk_len, rng)

    def batches(self, batch_size: int) -> Iterator[dict]:
        """Batches from one endless sample stream spanning epochs, so a
        partial batch at an epoch boundary carries over instead of being
        dropped."""

        def stream():
            epoch = 0
            while True:
                yield from self._epoch_iter(epoch)
                epoch += 1

        yield from P.batch_samples(stream(), batch_size)

    def num_classes(self) -> int:
        n = len(self.spk2id)
        if self.configs.get("speed_perturb", True):
            return n * 3  # perturbed speeds are new classes
        return n


class Prefetcher:
    """Background-thread batch prefetch with a bounded queue; an error in
    the producer is raised in the consumer."""

    def __init__(self, iterator, depth: int = 4):
        self.q = queue.Queue(maxsize=depth)
        self._done = object()
        self._err = None

        def worker():
            try:
                for item in iterator:
                    self.q.put(item)
            except BaseException as e:  # propagate to consumer
                self._err = e
            finally:
                self.q.put(self._done)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._done:
                if self._err is not None:
                    raise self._err
                return
            yield item


def _bucket_len(longest: int, quantum: int, cap: Optional[int],
                pow2: bool) -> Tuple[int, int]:
    """(padded length, valid-length cap) of a bucket whose longest item is
    `longest`: the cap bounds it, then the linear grid of `quantum` or the
    ladder quantum, 2 quantum, 4 quantum, ... rounds it up. The cap bounds
    the valid part even where the ladder pads past it."""
    if cap is not None:
        longest = min(longest, cap)
    if not pow2:
        return -(-longest // quantum) * quantum, longest
    padded = quantum
    while padded < longest:
        padded *= 2
    return padded, longest


def _sorted_buckets(items: Iterable[Tuple[str, np.ndarray]], batch_size: int,
                    quantum: int, cap: Optional[int],
                    sort_window: Optional[int], pow2: bool, data_key: str
                    ) -> Iterator[dict]:
    """Windows of `sort_window` items (the whole stream for None), each
    sorted by length (axis 0) and cut into batches right-padded to their
    bucket, with a (B, padded) validity mask."""

    def emit(window):
        window.sort(key=lambda kv: kv[1].shape[0])
        for i in range(0, len(window), batch_size):
            group = window[i:i + batch_size]
            padded, valid = _bucket_len(max(v.shape[0] for _, v in group),
                                        quantum, cap, pow2)
            out = np.zeros((len(group), padded) + group[0][1].shape[1:],
                           np.float32)
            mask = np.zeros((len(group), padded), np.float32)
            for j, (_, v) in enumerate(group):
                v = v[:valid]
                out[j, :v.shape[0]] = v
                mask[j, :v.shape[0]] = 1.0
            yield {data_key: out, "mask": mask,
                   "key": [k for k, _ in group]}

    window = []
    for item in items:
        window.append(item)
        if sort_window is not None and len(window) >= sort_window:
            yield from emit(window)
            window = []
    if window:
        yield from emit(window)


def eval_batches(utt_wavs: Iterable[Tuple[str, np.ndarray]],
                 batch_size: int = 8, quantum_samples: int = 16000,
                 max_samples: Optional[int] = None,
                 sort_window: Optional[int] = 4096,
                 pow2_buckets: bool = False) -> Iterator[dict]:
    """Extraction batches of whole utterances (key, f32 wav): sorted by
    length in windows of `sort_window` (None: the whole list), grouped by
    `batch_size`, right-padded to the group's longest rounded up to a
    multiple of `quantum_samples` (or, with `pow2_buckets`, up the ladder
    quantum, 2 quantum, 4 quantum, ...), with a per-sample validity mask,
    so that masked CMVN and pooling give the unpadded batch=1 result
    (upstream extract.py:112-135). `max_samples` caps the valid samples
    of every utterance. Yields {"wav": (B, N), "mask": (B, N), "key":
    [B keys]}, as the JAX package's eval_batches does, bit for bit."""
    return _sorted_buckets(utt_wavs, batch_size, quantum_samples,
                           max_samples, sort_window, pow2_buckets, "wav")


def eval_feat_batches(utt_feats: Iterable[Tuple[str, np.ndarray]],
                      batch_size: int = 8, quantum_frames: int = 100,
                      max_frames: Optional[int] = None,
                      sort_window: Optional[int] = 4096,
                      pow2_buckets: bool = False) -> Iterator[dict]:
    """eval_batches for precomputed (T, F) feature matrices (the `feat`
    data type): buckets of `quantum_frames` (100 = 1 s at a 10 ms hop),
    `max_frames` capping the valid frames, and a (B, T) frame mask.
    Yields {"feat": (B, T, F), "mask": (B, T), "key": [B keys]}."""
    return _sorted_buckets(utt_feats, batch_size, quantum_frames,
                           max_frames, sort_window, pow2_buckets, "feat")
