"""The embedding-extraction forward.

Counterpart of wespeaker_tpu/train/train_step.py::make_eval_embed_fn; the
training step is not ported yet.
"""

from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn as nn

from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.frontend.fbank import (FbankConfig, apply_cmvn,
                                                compute_fbank)
from wespeaker_tpu_torch.train.composite import _sample_to_frame_mask


def _on(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device=device, dtype=torch.float32)


def make_eval_embed_fn(model: nn.Module,
                       fbank_cfg: FbankConfig = FbankConfig(),
                       compute_dtype=torch.float32, fbank_conv_dtype=None,
                       device: DeviceLike = None
                       ) -> Callable[[Dict[str, Any]], torch.Tensor]:
    """wav batch + optional sample mask -> (B, D) f32 embeddings, as
    wespeaker/bin/extract.py computes them: no augmentation, no dither,
    CMVN on. `model` is moved to `device` (the card unless the caller
    passes device="cpu") and put in eval mode; its parameters stay f32,
    activations run in compute_dtype.

    batch: {"wav": (B, N) in [-1, 1], optional "mask": (B, N) sample
    validity}, numpy arrays or tensors. (The JAX version's feature input
    and featurize_fn for other frontends are not ported yet.)"""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def embed_fn(batch: Dict[str, Any]) -> torch.Tensor:
        with torch.inference_mode():
            wav = _on(batch["wav"], dev) * (1 << 15)
            feat = compute_fbank(wav, fbank_cfg, conv_dtype=fbank_conv_dtype)
            mask = batch.get("mask")
            fmask = None if mask is None else _sample_to_frame_mask(
                _on(mask, dev), feat.shape[-2], fbank_cfg.window_shift,
                fbank_cfg.window_size)
            feat = apply_cmvn(feat, mask=fmask).to(compute_dtype)
            return model(feat, fmask).float()

    return embed_fn
