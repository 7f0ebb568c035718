"""Training dataset composition and background prefetch.

Counterpart of wespeaker_tpu/data/dataset.py (upstream
wespeaker/dataset/dataset.py:136-273): the processor chain of
data/pipeline.py for `raw`, `shard` and `feat` lists, repeated without
end with a reshuffle per epoch, yielding fixed-shape numpy batches for the
train step. MUSAN noise and RIR stores (data/store.py) feed the reverb and
noise augmentation, on the host or, with `device_aug`, picked on the host
and applied on the card. `rank` / `world_size` and `worker_id` /
`num_workers` stripe the list as the JAX package does, with its seeds.
With `defer_chunk_aug` (the SSL trainers' setting) an epoch is the stream
of whole utterances, neither chunked nor augmented, which ssl/dataset.py
crops into views.

Two prefetchers feed the trainer: `Prefetcher`, one thread over one
dataset, and `MPPrefetcher`, spawned worker processes that each run the
whole host pipeline on their stripe of the list. The workers import only
numpy modules of this package (data/, no torch), and a worker that fails
or dies raises in the consumer.

`eval_batches` and `eval_feat_batches` are the extraction side: whole
utterances or feature matrices sorted by length into padded buckets with
validity masks, bit-identical to the JAX package's.
"""

import contextlib
import queue
import sys
import threading
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from wespeaker_tpu_torch.data import pipeline as P
from wespeaker_tpu_torch.data.store import PackedAudioStore


class SpeakerDataset:
    """Iterable over fixed-shape training batches."""

    def __init__(self, data_type: str, data_list_file: str, configs: Dict,
                 spk2id: Dict[str, int], reverb_store_prefix: str = None,
                 noise_store_prefix: str = None, rank: int = 0,
                 world_size: int = 1, seed: int = 42, worker_id: int = 0,
                 num_workers: int = 1):
        if data_type not in ("shard", "raw", "feat"):
            raise ValueError(f"unknown data_type {data_type}")
        mode = configs.get("speed_perturb_mode", "random")
        if mode not in ("random", "expanded"):
            raise ValueError(f"unknown speed_perturb_mode {mode}")
        self.data_type = data_type
        self.data_list_file = data_list_file
        self.lists = P.read_lists(data_list_file)
        self.configs = configs
        self.spk2id = spk2id
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.worker_id = worker_id
        self.num_workers = num_workers
        self.reverb = (PackedAudioStore(reverb_store_prefix)
                       if reverb_store_prefix else None)
        self.noise = (PackedAudioStore(noise_store_prefix)
                      if noise_store_prefix else None)

    def _epoch_iter(self, epoch: int) -> Iterator[dict]:
        cfg = self.configs
        rng = np.random.default_rng(self.seed + 1000 * epoch + self.rank
                                    + 7919 * self.worker_id)
        lists = P.distributed_shard(self.lists, epoch=epoch,
                                    shuffle=cfg.get("shuffle", True),
                                    seed=self.seed, rank=self.rank,
                                    world_size=self.world_size)
        if self.num_workers > 1:
            # the worker's stripe of the rank's (upstream dataset.py:94-100)
            lists = lists[self.worker_id::self.num_workers]
        feat_mode = self.data_type == "feat"
        if self.data_type == "shard":
            data = P.parse_shard(lists)
        elif self.data_type == "raw":
            data = P.parse_raw(lists)
        else:
            utt2spk = {}
            with open(cfg["utt2spk"]) as f:
                for line in f:
                    u, s = line.split()
                    utt2spk[u] = s
            data = P.parse_feat(lists, utt2spk)
        fbank_args = cfg.get("fbank_args", {})
        if cfg.get("filter", True):
            # upstream order: filter right after parse, before speed
            # perturb; thresholds scale with the sample's own rate
            data = P.filter_and_cap(
                data, cfg.get("filter_args", {}).get("min_num_frames", 100),
                cfg.get("filter_args", {}).get("max_num_frames", 800),
                fbank_args.get("frame_shift", 10), rng, feat_mode)
        if not feat_mode:
            data = P.resample(data, cfg.get("resample_rate", 16000))
        if cfg.get("shuffle", True):
            data = P.local_shuffle(
                data, cfg.get("shuffle_args", {}).get("shuffle_size", 2500),
                rng)
        data = P.spk_to_id(data, self.spk2id)
        if not feat_mode and cfg.get("speed_perturb", True):
            if cfg.get("speed_perturb_mode", "random") == "expanded":
                data = P.speed_perturb_expand(data, len(self.spk2id))
            else:
                data = P.speed_perturb(data, len(self.spk2id), rng)
        if cfg.get("defer_chunk_aug", False):
            # SSL multi-crop: the trainer crops each utterance into views
            # and augments each view on its own (ssl/dataset.py)
            return data
        num_frms = cfg.get("num_frms", 200)
        if feat_mode:
            chunk_len = num_frms
        else:
            sr = cfg.get("resample_rate", 16000)
            chunk_len = ((num_frms - 1) * fbank_args.get("frame_shift", 10)
                         + fbank_args.get("frame_length", 25)) * sr // 1000
        data = P.random_chunk(data, chunk_len, rng, feat_mode)
        aug_prob = cfg.get("aug_prob", 0.6)
        if not feat_mode and aug_prob > 0 and (self.reverb or self.noise):
            if cfg.get("device_aug", False):
                # the host picks; the card convolves and mixes
                data = P.attach_device_aug(
                    data, self.reverb, self.noise, aug_prob,
                    cfg.get("device_aug_rir_samples", 16000), rng)
            else:
                data = P.add_reverb_noise(data, self.reverb, self.noise,
                                          aug_prob, rng)
        return data

    def batches(self, batch_size: int, max_epochs: Optional[int] = None
                ) -> Iterator[dict]:
        """Batches from one sample stream spanning epochs (endless unless
        max_epochs is reached), so a partial batch at an epoch boundary
        carries over instead of being dropped: a worker's stripe may hold
        fewer utterances than a batch. An epoch that yields no sample (an
        empty stripe, or every utterance filtered out) raises ValueError;
        the JAX package spins there for ever."""

        def stream():
            epoch = 0
            while True:
                n = 0
                for sample in self._epoch_iter(epoch):
                    n += 1
                    yield sample
                if n == 0:
                    raise ValueError(
                        f"epoch {epoch} of rank {self.rank} (world size "
                        f"{self.world_size}), worker {self.worker_id} of "
                        f"{self.num_workers}, yields no sample from "
                        f"{self.data_list_file}: its stripe of the list is "
                        "empty or every utterance was filtered out")
                epoch += 1
                if max_epochs and epoch >= max_epochs:
                    return

        yield from P.batch_samples(stream(), batch_size,
                                   self.data_type == "feat")

    def num_classes(self) -> int:
        n = len(self.spk2id)
        if self.configs.get("speed_perturb", True) \
                and self.data_type != "feat":
            return n * 3  # perturbed speeds are new classes
        return n


def _mp_worker(q, ds_args, ds_kwargs, batch_size, max_epochs):
    """A spawned worker: the whole host pipeline on its stripe, whole
    batches to the queue, then "done"; an exception goes to the consumer
    as its traceback before the worker exits with it. It imports the numpy
    modules of data/ only."""
    try:
        ds = SpeakerDataset(*ds_args, **ds_kwargs)
        for b in ds.batches(batch_size, max_epochs):
            q.put(("batch", b))
    except BaseException:
        import traceback
        q.put(("error", traceback.format_exc()))
        raise
    q.put(("done", None))


@contextlib.contextmanager
def _main_hidden():
    """Hide the parent's __main__ from multiprocessing while workers are
    spawned: a spawned child re-imports it (by its __spec__, else its
    __file__), which for a trainer means torch and the models, seconds a
    worker. The workers need only data/, so they start without it."""
    main = sys.modules["__main__"]
    saved = {k: main.__dict__[k] for k in ("__spec__", "__file__")
             if k in main.__dict__}
    main.__spec__ = None
    main.__dict__.pop("__file__", None)
    try:
        yield
    finally:
        main.__dict__.pop("__spec__", None)
        main.__dict__.update(saved)


class MPPrefetcher:
    """Multi-process batch prefetch: `num_workers` spawned processes, each
    a SpeakerDataset(*ds_args, **ds_kwargs) on its stripe
    lists[worker_id::num_workers] of the rank's list (upstream's
    DataLoader workers, dataset.py:94-100), each with its own stores and
    file handles, each shipping whole fixed-shape batches. Batches arrive
    in no fixed order across workers. A worker's exception is raised here
    as RuntimeError with its traceback; a worker that dies without a word
    (killed by the OS) is found by a poll every 60 s and raised the same
    way. The workers import this module and its numpy code only, not the
    parent's __main__. close() ends the workers."""

    POLL_S = 60

    def __init__(self, ds_args, ds_kwargs, batch_size, num_workers: int = 4,
                 depth: int = 4, max_epochs=None):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue(maxsize=max(2, depth) * num_workers)
        self.procs = []
        with _main_hidden():
            for w in range(num_workers):
                kw = dict(ds_kwargs, worker_id=w, num_workers=num_workers)
                p = ctx.Process(target=_mp_worker,
                                args=(self.q, ds_args, kw, batch_size,
                                      max_epochs),
                                daemon=True)
                p.start()
                self.procs.append(p)

    def __iter__(self):
        live = len(self.procs)
        while live:
            try:
                kind, payload = self.q.get(timeout=self.POLL_S)
            except queue.Empty:
                dead = [p.exitcode for p in self.procs
                        if not p.is_alive() and p.exitcode != 0]
                if dead and self.q.empty():
                    self.close()
                    raise RuntimeError(
                        f"data worker(s) died with exit codes {dead}")
                continue
            if kind == "done":
                live -= 1
            elif kind == "error":
                self.close()
                raise RuntimeError(f"data worker failed:\n{payload}")
            else:
                yield payload
        self.close()

    def close(self):
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(timeout=5)


class Prefetcher:
    """Background-thread batch prefetch with a bounded queue; an error in
    the producer is raised in the consumer. close() (or leaving a `with`
    block) stops the producer after the item in hand, closes its iterator
    and joins the thread: a thread still inside a torch op when the
    interpreter exits aborts the process ("terminate called without an
    active exception")."""

    def __init__(self, iterator, depth: int = 4):
        self.q = queue.Queue(maxsize=depth)
        self._done = object()
        self._err = None
        self._stop = threading.Event()

        def worker():
            try:
                for item in iterator:
                    self.q.put(item)
                    if self._stop.is_set():
                        if hasattr(iterator, "close"):
                            iterator.close()
                        break
            except BaseException as e:  # propagate to consumer
                self._err = e
            finally:
                self.q.put(self._done)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def close(self):
        """Stop the producer and wait for it, draining what it puts."""
        self._stop.set()
        while self.thread.is_alive():
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass
        self.thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

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
