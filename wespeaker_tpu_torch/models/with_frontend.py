"""A neural frontend and a speaker model as one module.

Counterpart of wespeaker_tpu/models/with_frontend.py (upstream
wespeaker/bin/train.py:116-124 and utils/executor.py:42-54): the frontend
runs in front of the speaker model inside the train step, and CMVN
applies to the frontend's output. With `frozen_frontend` (stage 1 of the
SSL recipes) the frontend runs under torch.no_grad() and its parameters
have requires_grad=False, so they take no gradient, no update and no
weight decay: the JAX package stops the gradient there and masks the
frontend's leaves out of the optimizer.

Under a frame or sample `mask` (padded extraction buckets) the frontend
masks its own input and attention, and the mask, brought to the
frontend's frame rate by its `downsample_mask` (WavLM's exact conv-stack
lengths) or else its `time_stride`, flows into CMVN and the pooling, so a
bucket gives each utterance's whole-utterance embedding.
"""

import contextlib
from typing import Optional

import torch
import torch.nn as nn

from wespeaker_tpu_torch.frontend.fbank import apply_cmvn


class FrontendSpeakerModel(nn.Module):
    """frontend: wav or features -> frame features, or (hidden states,
    last) for the adapter-MFA heads (`feed_all_hidden`), whose hidden
    states they take; speaker_model: frame features (+ mask) ->
    embedding. `normalize`: CMVN on the frontend's output."""

    def __init__(self, frontend: nn.Module, speaker_model: nn.Module,
                 frozen_frontend: bool = False, feed_all_hidden: bool = False,
                 normalize: bool = True):
        super().__init__()
        self.frontend = frontend
        self.speaker_model = speaker_model
        self.frozen_frontend = frozen_frontend
        self.feed_all_hidden = feed_all_hidden
        self.normalize = normalize
        if frozen_frontend:
            frontend.requires_grad_(False)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        no_grad = (torch.no_grad() if self.frozen_frontend
                   else contextlib.nullcontext())
        out_mask = None
        with no_grad:
            if mask is None:
                feats = self.frontend(x)
            else:
                feats = self.frontend(x, mask)
        if mask is not None:
            ref = feats[-1] if isinstance(feats, (tuple, list)) else feats
            if hasattr(self.frontend, "downsample_mask"):
                out_mask = self.frontend.downsample_mask(mask, ref.shape[1])
            else:
                stride = getattr(self.frontend, "time_stride", 1)
                out_mask = mask[:, ::stride] if stride > 1 else mask
        if self.feed_all_hidden:
            if (isinstance(feats, tuple) and len(feats) == 2
                    and isinstance(feats[0], (tuple, list))):
                feats = feats[0]
            if out_mask is not None and len(feats):
                out_mask = out_mask[:, :feats[0].shape[1]]
            return self.speaker_model(feats, out_mask)
        if isinstance(feats, (tuple, list)):
            feats = feats[-1]
        if out_mask is not None:
            out_mask = out_mask[:, :feats.shape[1]]
        if self.normalize:
            feats = apply_cmvn(feats, mask=out_mask)
        return self.speaker_model(feats, out_mask)
