"""Config-driven model build for the trainers, the extractor and the
server.

Counterpart of wespeaker_tpu/train/composite.py. Two frontends are
ported: `dataset_args.frontend` "fbank" (the default; the trainer and the
extractor compute it themselves) and "tfmel" (the DSP frontend of the
ReDimNet2 recipes, frontend/tfmel.py), whose hooks `featurizers` returns
as the JAX package's BuiltModel carries them. The neural frontends come in
later slices.
"""

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from wespeaker_tpu_torch.frontend.tfmel import TFMelConfig, tfmel
from wespeaker_tpu_torch.models import get_speaker_model

_FRONTENDS = ("fbank", "tfmel")


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



def frontend_type(configs: Dict[str, Any]) -> str:
    """The config's frontend; one that is not ported raises."""
    name = configs.get("dataset_args", {}).get("frontend", "fbank")
    if name not in _FRONTENDS:
        raise KeyError(f"frontend {name} is not ported yet; the port "
                       f"supports {', '.join(_FRONTENDS)}")
    return name


def _tfmel_config(configs: Dict[str, Any]) -> TFMelConfig:
    return TFMelConfig(**configs["dataset_args"].get("tfmel_args", {}))


def build_model(configs: Dict[str, Any]) -> nn.Module:
    """The speaker model of `configs` (features (B, T, F) + mask ->
    embedding), initialised as the JAX package's (`jax_init_`); under the
    tfmel frontend its feat_dim is the frontend's n_mels, as in the JAX
    package."""
    model_args = dict(configs["model_args"])
    if frontend_type(configs) == "tfmel":
        model_args["feat_dim"] = _tfmel_config(configs).n_mels
    return jax_init_(get_speaker_model(configs["model"])(**model_args))


def featurizers(configs: Dict[str, Any]) -> Tuple[Optional[Callable],
                                                  Optional[Callable]]:
    """The frontend's hooks, the JAX BuiltModel's featurize_train and
    featurize_eval: (None, None) for fbank, which the trainer and the
    extractor compute themselves; for tfmel
    train(wav (B, N), generator) -> feat (B, T, F) with its time and
    frequency masks, and eval(wav, sample mask or None) -> (feat, frame
    mask or None)."""
    if frontend_type(configs) == "fbank":
        return None, None
    cfg = _tfmel_config(configs)

    def featurize_train(wav, generator):
        return tfmel(wav, cfg, train=True, generator=generator)

    def featurize_eval(wav, mask=None):
        fmask = None
        if mask is not None:
            fmask = _sample_to_frame_mask(
                mask, cfg.num_frames(wav.shape[-1]), cfg.hop_length,
                cfg.win_length - cfg.hop_length)
        return tfmel(wav, cfg, mask=fmask), fmask

    return featurize_train, featurize_eval
