"""Offline diarization pipeline: SAD -> segment fbank -> sliding-window
embeddings -> clustering -> RTTM.

Counterpart of wespeaker_tpu/diar/pipeline.py (upstream: the voxconverse
recipe stages, examples/voxconverse/v2/run.sh:34-150, and the one-shot
path of wespeaker/cli/speaker.py:213-289). SAD comes from the caller
(oracle RTTM, a torch.jit VAD) or `vad.energy_vad`.

On the card: the recording goes to the device once; each SAD segment's
fbank (no CMVN, dither 0) is computed there; the windows of all segments
are one gather of the concatenated fbank (`subsegment.gather_windows`),
mean-normalized per window (or per segment) and embedded in fixed-size
batches, the last zero-padded. The embeddings stay on the device for
the spectral affinity and the UMAP layout; the host gets what its steps
need (the spectral embeddings for k-means, the embeddings for the UMAP
graph, HDBSCAN and PAHC). The JAX package pads each segment to a power
of two seconds to bound its compile count; the port computes each
segment at its length, which gives the same frames.
"""

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.diar import rttm as rttm_mod
from wespeaker_tpu_torch.diar import spectral_clusterer, umap_clusterer
from wespeaker_tpu_torch.diar.subsegment import (gather_windows, plan,
                                                 segment_id)
from wespeaker_tpu_torch.diar.vad import energy_vad
from wespeaker_tpu_torch.frontend.fbank import FbankConfig, compute_fbank

CLUSTERERS = ("spectral", "umap")


def model_embedder(model: nn.Module, compute_dtype=torch.float32
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """(B, T, F) windows -> (B, D) float32 embeddings: the model's forward
    in `compute_dtype`, with no CMVN and no mask (the JAX CLI's `fwd`,
    wespeaker_tpu/bin/diarize.py:51-53)."""

    def embed_batch(banks: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(banks.to(compute_dtype)).float()

    return embed_batch


def segment_windows(utt: str, wav: np.ndarray, sr: int,
                    sad_segments: List[Tuple[float, float]],
                    fbank_cfg: FbankConfig = FbankConfig(),
                    window_fs: int = 150, period_fs: int = 75,
                    subseg_cmn: bool = True, device: DeviceLike = None
                    ) -> Tuple[List[str], Optional[torch.Tensor]]:
    """Subsegment ids and their (n, window_fs, F) fbank windows on
    `device` (None when no segment holds a frame). Segments shorter than
    one fbank window are skipped."""
    dev = resolve_device(device)
    audio = torch.as_tensor(np.asarray(wav, np.float32), device=dev)
    audio = audio * (1 << 15)
    frame_shift = int(fbank_cfg.frame_shift_ms)
    ids, starts, lengths, fbanks = [], [], [], []
    offset = 0
    for (b, e) in sad_segments:
        seg = audio[int(b * sr):int(e * sr)]
        if seg.shape[0] < fbank_cfg.window_size:
            continue
        fbank = compute_fbank(seg, fbank_cfg)
        if not subseg_cmn:
            fbank = fbank - fbank.mean(dim=0)  # per-SAD-segment CMN
        i, s, n = plan(fbank.shape[0], segment_id(utt, b, e), window_fs,
                       period_fs, frame_shift)
        ids += i
        starts += [offset + x for x in s]
        lengths += n
        fbanks.append(fbank)
        offset += fbank.shape[0]
    if not ids:
        return [], None
    windows = gather_windows(torch.cat(fbanks), starts, lengths, window_fs)
    if subseg_cmn:
        windows = windows - windows.mean(dim=1, keepdim=True)
    return ids, windows


def embed_windows(windows: torch.Tensor, embed_batch_fn: Callable,
                  batch_size: int = 64) -> torch.Tensor:
    """(n, T, F) -> (n, D): batches of `batch_size`, the last zero-padded
    and its padded rows' embeddings dropped."""
    embs = []
    for i in range(0, len(windows), batch_size):
        chunk = windows[i:i + batch_size]
        real = chunk.shape[0]
        if real < batch_size:
            chunk = torch.cat([chunk, chunk.new_zeros(
                (batch_size - real,) + chunk.shape[1:])])
        embs.append(torch.as_tensor(embed_batch_fn(chunk))[:real])
    return torch.cat(embs)


def cluster_embeddings(embeddings, clusterer: str = "spectral",
                       num_spks: Optional[int] = None,
                       mark: Optional[Callable[[str], None]] = None
                       ) -> List[int]:
    if clusterer == "umap":
        return umap_clusterer.cluster(embeddings, mark=mark)
    if clusterer == "spectral":
        return spectral_clusterer.cluster(embeddings, num_spks=num_spks,
                                          mark=mark)
    raise ValueError(f"unknown clusterer '{clusterer}' (choices: "
                     f"{', '.join(CLUSTERERS)})")


def diarize_wav(utt: str, wav: np.ndarray, sr: int, embed_batch_fn: Callable,
                sad_segments: Optional[List[Tuple[float, float]]] = None,
                fbank_cfg: FbankConfig = FbankConfig(),
                window_fs: int = 150, period_fs: int = 75,
                clusterer: str = "spectral", num_spks: Optional[int] = None,
                batch_size: int = 64, subseg_cmn: bool = True,
                device: DeviceLike = None,
                mark: Optional[Callable[[str], None]] = None
                ) -> Tuple[list, Dict[str, int]]:
    """embed_batch_fn: (B, window_fs, F) fbank tensor on `device` -> (B,
    D) embeddings (a tensor, or an array). Returns (merged segments
    [(utt, begin, end, label)], subseg labels). subseg_cmn=True (the
    reference default, diar/make_fbank.py:74-88 + cli/speaker.py:108-112)
    mean-normalizes each sliding window; False normalizes once per SAD
    segment. Runs on the card unless the caller passes device="cpu".
    `mark(stage)`, where given, is called as each stage ends: "fbank",
    "embedding", the clusterer's own stages, "merge"."""
    if sad_segments is None:
        sad_segments = energy_vad(wav, sr)
    if not sad_segments:
        return [], {}
    subsegs, windows = segment_windows(utt, wav, sr, sad_segments,
                                       fbank_cfg, window_fs, period_fs,
                                       subseg_cmn, device)
    if not subsegs:
        return [], {}
    mark = mark or (lambda stage: None)
    mark("fbank")
    embeddings = embed_windows(windows, embed_batch_fn, batch_size)
    mark("embedding")
    labels = cluster_embeddings(embeddings, clusterer, num_spks, mark)
    frame_shift = int(fbank_cfg.frame_shift_ms)
    merged = rttm_mod.merge_segments(
        {utt: list(_subseg_tuples(subsegs, labels, frame_shift))})
    mark("merge")
    return merged, dict(zip(subsegs, labels))


def _subseg_tuples(subsegs, labels, frame_shift):
    for subseg, label in zip(subsegs, labels):
        utt, begin_ms, end_ms, bf, ef = subseg.rsplit("-", 4)
        begin = (int(begin_ms) + int(bf) * frame_shift) / 1000.0
        end = (int(begin_ms) + int(ef) * frame_shift) / 1000.0
        yield (begin, end, str(label))
