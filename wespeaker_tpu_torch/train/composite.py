"""Config-driven model build for the trainers, the extractor and the
server.

Counterpart of wespeaker_tpu/train/composite.py (upstream
wespeaker/bin/train.py:110-124): `dataset_args.frontend` picks the
frontend and `<name>_args` configures it. "fbank" (the default) is
computed by the trainer and the extractor themselves; "tfmel" (the
ReDimNet2 recipes) replaces it with another DSP function. The neural
frontends put a module in front of the speaker model
(models/with_frontend.py), whose feat_dim becomes the frontend's output
width:

  - "whisper_encoder": the Whisper encoder on whisper log-mels
    (frontend/whisper_encoder.py, whisper_mel.py), for whisper_PMFA;
  - "wavlm", "s3prl", "hubert", "wav2vec2": WavLM, or the same stack
    without the relative-position bias, on the waveform, with a learned
    layer mix (frontend/wavlm.py); the s3prl configs' `upstream_args.name`
    chooses the size;
  - "feat_stack": a learned mix of precomputed hidden states
    (`bin/precompute_feats.py --layer all`, `data_type: feat`);
  - "w2vbert": w2v-bert 2.0 on stacked fbank features
    (frontend/w2vbert.py), for W2VBert_Adapter_MFA, which takes all its
    hidden states.

`build_model` returns the model, `featurizers` the frontend's hooks as
the JAX package's BuiltModel carries them (featurize_train,
featurize_eval). Both parse the config as the JAX package does and
raise where it raises.
"""

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from wespeaker_tpu_torch.frontend.tfmel import TFMelConfig, tfmel
from wespeaker_tpu_torch.models import get_speaker_model

# frontends whose model input is the waveform itself
WAV_FRONTENDS = ("wavlm", "s3prl", "hubert", "wav2vec2")
NEURAL_FRONTENDS = ("whisper_encoder",) + WAV_FRONTENDS + ("feat_stack",
                                                           "w2vbert")
_FRONTENDS = ("fbank", "tfmel") + NEURAL_FRONTENDS


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
    """The config's frontend; a name the JAX package does not take
    raises, as its build_model does."""
    name = configs.get("dataset_args", {}).get("frontend", "fbank")
    if name not in _FRONTENDS:
        raise KeyError(
            f"unknown frontend {name}; supported: fbank, tfmel, wavlm (also "
            "s3prl and the hubert/wav2vec2 modes), w2vbert, whisper_encoder, "
            "feat_stack (precomputed multi-layer feats)")
    return name


def _tfmel_config(configs: Dict[str, Any]) -> TFMelConfig:
    return TFMelConfig(**configs["dataset_args"].get("tfmel_args", {}))


def whisper_args(configs: Dict[str, Any]) -> Tuple[Dict[str, Any], bool]:
    """(WhisperEncoderFrontend's keyword arguments, frozen) of
    `whisper_encoder_args`; `model_path` is dropped (weights come from
    checkpoints)."""
    fe_args = dict(configs["dataset_args"].get("whisper_encoder_args", {}))
    fe_args.pop("model_path", None)
    return fe_args, bool(fe_args.pop("frozen", False))


def wavlm_args(configs: Dict[str, Any]):
    """(WavLMConfig, frozen, normalize_input) of `<frontend>_args` (or
    `s3prl_args`). The s3prl configs carry the model in
    `upstream_args.name` ("large" in it picks the Large stack and input
    normalisation) and knobs that mean nothing here (download_dir,
    multilayer_feature, layer, frame_length); frame_shift must be the
    stack's 20 ms; any other key must be a WavLMConfig field."""
    from wespeaker_tpu_torch.frontend.wavlm import WavLMConfig

    name = frontend_type(configs)
    dataset_args = configs["dataset_args"]
    fe_args = dict(dataset_args.get(f"{name}_args",
                                    dataset_args.get("s3prl_args", {})))
    upstream = dict(fe_args.pop("upstream_args", None) or {})
    up_name = str(upstream.get("name", ""))
    for k in ("download_dir", "multilayer_feature", "layer", "frame_length"):
        fe_args.pop(k, None)
    fs = fe_args.pop("frame_shift", None)
    if fs not in (None, 20):
        raise ValueError("wavlm-family frontends produce 20 ms frames; "
                         f"s3prl frame_shift={fs} is unsupported")
    frozen = bool(fe_args.pop("frozen", False))
    normalize_input = fe_args.pop("normalize_input", "large" in up_name)
    size = fe_args.pop("size", "large" if "large" in up_name else "base")
    if name in ("hubert", "wav2vec2"):
        cfg = (WavLMConfig.hubert_large() if size == "large"
               else WavLMConfig.hubert_base())
    else:
        cfg = WavLMConfig.large() if size == "large" else WavLMConfig.base()
    if fe_args:
        known = {f.name for f in dataclasses.fields(WavLMConfig)}
        unknown = sorted(set(fe_args) - known)
        if unknown:
            raise ValueError(f"unknown {name}_args keys {unknown}")
        fe_args = {k: tuple(v) if isinstance(v, list) else v
                   for k, v in fe_args.items()}
        cfg = dataclasses.replace(cfg, **fe_args)
    return cfg, frozen, normalize_input


def w2vbert_args(configs: Dict[str, Any]):
    """(W2VBertConfig, frozen) of `w2vbert_args`; model_path, use_lora,
    lora_config_args and bnb_config_args are dropped, as in the JAX
    package (its trainer wires no LoRA in)."""
    from wespeaker_tpu_torch.frontend.w2vbert import W2VBertConfig

    fe_args = dict(configs["dataset_args"].get("w2vbert_args", {}))
    for k in ("model_path", "use_lora", "lora_config_args",
              "bnb_config_args"):
        fe_args.pop(k, None)
    frozen = bool(fe_args.pop("frozen", False))
    return W2VBertConfig(**fe_args), frozen


def feat_stack_layers(configs: Dict[str, Any]) -> int:
    fe_args = dict(configs["dataset_args"].get("feat_stack_args", {}))
    num_layers = int(fe_args.pop("num_layers"))
    if fe_args:
        raise ValueError(f"unknown feat_stack_args keys {sorted(fe_args)}")
    return num_layers


def _composite(configs: Dict[str, Any], name: str,
               model_args: Dict[str, Any]) -> nn.Module:
    from wespeaker_tpu_torch.models.with_frontend import FrontendSpeakerModel

    dataset_args = configs["dataset_args"]
    head = configs["model"]
    if name == "whisper_encoder":
        from wespeaker_tpu_torch.frontend.whisper_encoder import (
            WhisperEncoderFrontend)
        fe_args, frozen = whisper_args(configs)
        frontend = WhisperEncoderFrontend(**fe_args)
        # the head reads the selected encoder layers side by side
        model_args["feat_dim"] = frontend.output_size * (
            frontend.layer_ed - frontend.layer_st + 1)
        return FrontendSpeakerModel(
            frontend, get_speaker_model(head)(**model_args),
            frozen_frontend=frozen, normalize=dataset_args.get("cmvn", True))
    if name in WAV_FRONTENDS:
        from wespeaker_tpu_torch.frontend.wavlm import WavLMWithFeaturizer
        cfg, frozen, normalize_input = wavlm_args(configs)
        frontend = WavLMWithFeaturizer(cfg, normalize_input=normalize_input)
        model_args["feat_dim"] = cfg.hidden_size
        return FrontendSpeakerModel(
            frontend, get_speaker_model(head)(**model_args),
            frozen_frontend=frozen, normalize=dataset_args.get("cmvn", True))
    if name == "feat_stack":
        from wespeaker_tpu_torch.frontend.ssl_frontends import (
            StackedFeatFrontend)
        frontend = StackedFeatFrontend(feat_stack_layers(configs))
        # feat_dim stays the per-layer width, the head's input
        return FrontendSpeakerModel(
            frontend, get_speaker_model(head)(**model_args),
            normalize=dataset_args.get("cmvn", True))
    from wespeaker_tpu_torch.frontend.w2vbert import W2VBertFrontend
    cfg, frozen = w2vbert_args(configs)
    frontend = W2VBertFrontend(cfg)
    model_args["feat_dim"] = cfg.hidden_size
    feed_all = head.startswith("W2VBert")
    if feed_all:
        model_args.setdefault("num_frontend_hidden_layers",
                              cfg.num_hidden_layers)
    return FrontendSpeakerModel(
        frontend, get_speaker_model(head)(**model_args),
        frozen_frontend=frozen, feed_all_hidden=feed_all,
        normalize=dataset_args.get("cmvn", False))


def build_model(configs: Dict[str, Any], device=None) -> nn.Module:
    """The model of `configs` (features (B, T, F), or the waveform for the
    wav frontends, + mask -> embedding), initialised as the JAX package's
    (`jax_init_`), on `device` (the CPU if None). A neural frontend's
    composite (models/with_frontend.py, as the JAX package's build_model
    makes it) is drawn on `device` itself, since at full width it is slow
    to draw on the host; the other families are drawn on the CPU and
    moved, so that a seed gives them one start on every device. Under
    tfmel the speaker model's feat_dim is the frontend's n_mels."""
    name = frontend_type(configs)
    model_args = dict(configs["model_args"])
    if name in NEURAL_FRONTENDS:
        where = (torch.device(device) if device is not None
                 else contextlib.nullcontext())
        with where:
            return jax_init_(_composite(configs, name, model_args))
    if name == "tfmel":
        model_args["feat_dim"] = _tfmel_config(configs).n_mels
    model = jax_init_(get_speaker_model(configs["model"])(**model_args))
    return model if device is None else model.to(device)


def featurizers(configs: Dict[str, Any]) -> Tuple[Optional[Callable],
                                                  Optional[Callable]]:
    """The frontend's hooks, the JAX BuiltModel's featurize_train and
    featurize_eval: (None, None) for fbank, which the trainer and the
    extractor compute themselves; otherwise
    train(x, generator) -> the model's input and
    eval(x, mask or None) -> (the model's input, its mask or None), where
    x is the batch's "wav" (B, N) or, for feat_stack, its "feat"
    (B, T, L * D). tfmel draws its time and frequency masks from the
    generator; whisper_encoder gives log-mels (the sample mask becomes a
    frame mask); the wav frontends pass the waveform and the sample mask
    through (the model brings the mask to its frame rate); w2vbert gives
    the stacked fbank features and their mask; feat_stack passes the
    stacked hidden states and the frame mask through."""
    name = frontend_type(configs)
    if name == "fbank":
        return None, None
    if name == "tfmel":
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
    if name == "whisper_encoder":
        from wespeaker_tpu_torch.frontend.whisper_mel import (
            WhisperMelConfig, whisper_logmel)
        mel_cfg = WhisperMelConfig(
            num_mel_bins=whisper_args(configs)[0].get("n_mels", 80))

        def featurize_train(wav, generator):
            return whisper_logmel(wav, mel_cfg)

        def featurize_eval(wav, mask=None):
            feat = whisper_logmel(wav, mel_cfg)
            if mask is not None:
                mask = _sample_to_frame_mask(mask, feat.shape[-2],
                                             mel_cfg.hop_length,
                                             mel_cfg.hop_length)
            return feat, mask

        return featurize_train, featurize_eval
    if name == "w2vbert":
        from wespeaker_tpu_torch.frontend.w2vbert import w2vbert_features
        n_mels = w2vbert_args(configs)[0].feature_projection_input_dim // 2

        def featurize_train(wav, generator):
            return w2vbert_features(wav, num_mel_bins=n_mels)[0]

        def featurize_eval(wav, mask=None):
            return w2vbert_features(wav, mask, num_mel_bins=n_mels)

        return featurize_train, featurize_eval

    # the wav frontends and feat_stack: the model's input is the batch's
    def featurize_train(x, generator):
        return x

    def featurize_eval(x, mask=None):
        return x, mask

    return featurize_train, featurize_eval


# rows x T^2 of one attention-frontend forward in extraction: 2 GB of f32
# (B, 16, T, T) scores at the limit
_EVAL_SCORES_BUDGET = 1 << 25


def eval_rows_cap(configs: Dict[str, Any],
                  num_samples: int) -> Optional[int]:
    """Rows a forward of one padded extraction bucket may take for the
    attention frontends, whose (B, H, T, T) scores (and w2v-bert's
    (T, T, d) position table) grow as T^2: the rows r with r * T^2 within
    _EVAL_SCORES_BUDGET, at least 1 (T: the frontend's frames for
    `num_samples`). None (no cap) for the other frontends."""
    name = frontend_type(configs)
    if name in WAV_FRONTENDS:
        t = wavlm_args(configs)[0].feat_extract_output_lengths(num_samples)
    elif name == "whisper_encoder":
        t = min(num_samples // 320, 1500)
    elif name == "w2vbert":
        t = num_samples // 320
    else:
        return None
    return max(1, _EVAL_SCORES_BUDGET // max(t * t, 1))
