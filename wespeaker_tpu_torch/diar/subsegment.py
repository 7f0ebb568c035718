"""VAD segments -> sliding-window subsegments over fbank frames.

Counterpart of wespeaker_tpu/diar/subsegment.py (upstream
wespeaker/diar/extract_emb.py:55-84): 1.5 s windows every 0.75 s over
each SAD segment's fbank, a window shorter than `window_fs` repeat-padded
as np.resize pads it, and the subsegment id format
`utt-begin_ms-end_ms-beginfr-endfr` that make_rttm reads.

The host keeps the ids and the frame bookkeeping (`plan`); the windows
themselves are one gather on the fbank's device (`gather_windows`): row
i of a window starting at frame `start` with `length` valid frames is
frame `start + i % length`, which is np.resize's repeat.
"""

from typing import List, Tuple

import numpy as np
import torch


def plan(num_frames: int, seg_id: str, window_fs: int = 150,
         period_fs: int = 75, frame_shift: int = 10
         ) -> Tuple[List[str], List[int], List[int]]:
    """The windows of one SAD segment whose fbank has `num_frames` rows:
    (subsegment ids, first frame of each, valid frames of each). The ids
    count frames from the segment's duration in ms, as the reference's do;
    a window's valid frames are those of the fbank it covers (numpy's
    slice `fbank[begin:end]`)."""
    seg_begin, seg_end = seg_id.split("-")[-2:]
    seg_length = (int(seg_end) - int(seg_begin)) // frame_shift
    if seg_length <= window_fs:
        return ([seg_id + f"-{0:08d}-{seg_length:08d}"], [0], [num_frames])
    ids, starts, lengths = [], [], []
    max_subseg_begin = seg_length - window_fs + period_fs
    for begin in range(0, max_subseg_begin, period_fs):
        end = min(begin + window_fs, seg_length)
        ids.append(seg_id + f"-{begin:08d}-{end:08d}")
        starts.append(begin)
        lengths.append(len(range(num_frames)[begin:end]))
    return ids, starts, lengths


def gather_windows(frames: torch.Tensor, starts, lengths,
                   window_fs: int = 150) -> torch.Tensor:
    """(N, F) frames -> (n, window_fs, F) windows: window j is rows
    starts[j] + (i % lengths[j]), i < window_fs, in one gather."""
    dev = frames.device
    lengths = np.asarray(lengths, np.int64)
    if (lengths <= 0).any():
        raise ValueError("a window with no frame to repeat")
    starts = torch.as_tensor(np.asarray(starts, np.int64), device=dev)
    lengths = torch.as_tensor(lengths, device=dev)
    idx = (starts[:, None]
           + torch.arange(window_fs, device=dev)[None] % lengths[:, None])
    return frames[idx]


def segment_id(utt: str, begin_s: float, end_s: float) -> str:
    return f"{utt}-{int(begin_s * 1000):08d}-{int(end_s * 1000):08d}"
