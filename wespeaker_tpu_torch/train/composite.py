"""Config-driven model build for the trainers, the extractor and the
server.

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


# std of a unit normal cut at +-2 (flax's variance_scaling divides by it)
_TRUNC_STD = 0.87962566103423978


def jax_init_(model: nn.Module) -> nn.Module:
    """Initialise every Conv and Linear of `model` as the JAX package's
    flax modules are: the weight from lecun_normal (a normal of std
    1/sqrt(fan_in), cut at 2 std and rescaled to keep that std), the bias
    zero; torch's default draws them uniform with std 1/sqrt(3 fan_in)
    and non-zero biases. Draws from torch's global generator. The SSL
    trainers learn from this start as the JAX package's do and not from
    torch's (PERF.md §6, the quality smokes)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            std = m.weight[0].numel() ** -0.5 / _TRUNC_STD
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std)
                if m.bias is not None:
                    m.bias.zero_()
    return model



def build_model(configs: Dict[str, Any]) -> nn.Module:
    """The speaker model of `configs` (fbank frontend: feat (B, T, F) + mask
    -> embedding), initialised as the JAX package's (`jax_init_`). The JAX
    version's BuiltModel carries frontend hooks that only the neural
    frontends need."""
    frontend_type = configs.get("dataset_args", {}).get("frontend", "fbank")
    if frontend_type != "fbank":
        raise KeyError(f"frontend {frontend_type} is not ported yet; the "
                       "port supports fbank")
    return jax_init_(get_speaker_model(configs["model"])(
        **configs["model_args"]))
