"""Config-driven model build for the extractor and server.

Counterpart of wespeaker_tpu/train/composite.py. Only the fbank frontend
is ported: `dataset_args.frontend` must be "fbank" (the default); the
neural and DSP frontends of the JAX package come in later slices.
"""

from typing import Any, Dict

import torch
import torch.nn as nn

from wespeaker_tpu_torch.models import get_speaker_model


def _sample_to_frame_mask(mask: torch.Tensor, num_frames: int, hop: int,
                          win: int) -> torch.Tensor:
    """(B, N) sample-validity mask -> (B, T) frame mask: frame t is valid
    iff its window lies within the valid samples."""
    valid = mask.sum(dim=-1, keepdim=True)
    idx = torch.arange(num_frames, device=mask.device)[None, :] * hop
    return (idx + win <= valid + 1e-3).to(mask.dtype)


def build_model(configs: Dict[str, Any]) -> nn.Module:
    """The speaker model of `configs` (fbank frontend: feat (B, T, F) + mask
    -> embedding). The JAX version's BuiltModel carries frontend hooks that
    only the neural frontends need."""
    frontend_type = configs.get("dataset_args", {}).get("frontend", "fbank")
    if frontend_type != "fbank":
        raise KeyError(f"frontend {frontend_type} is not ported yet; the "
                       "port supports fbank")
    return get_speaker_model(configs["model"])(**configs["model_args"])
