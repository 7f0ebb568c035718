"""Feature frontends. Counterpart of wespeaker_tpu/frontend/__init__.py:
the Kaldi fbank and tfmel are DSP functions; the neural frontends
(whisper_encoder, wavlm / s3prl, w2vbert) are torch modules that the
composite (models/with_frontend.py) runs in front of the speaker model."""

from wespeaker_tpu_torch.frontend.fbank import (  # noqa: F401
    EPSILON,
    FbankConfig,
    apply_cmvn,
    compute_fbank,
    make_mel_banks,
    make_window,
)
from wespeaker_tpu_torch.frontend.tfmel import TFMelConfig, tfmel  # noqa: F401


def get_frontend(name: str):
    """The frontend `name`, with the JAX package's names: the DSP
    functions for fbank and tfmel, the module classes for the neural
    frontends."""
    if name == "fbank":
        return compute_fbank
    if name == "tfmel":
        return tfmel
    if name == "whisper_encoder":
        from wespeaker_tpu_torch.frontend.whisper_encoder import (
            WhisperEncoderFrontend)
        return WhisperEncoderFrontend
    if name in ("wavlm", "s3prl"):
        from wespeaker_tpu_torch.frontend.wavlm import WavLMWithFeaturizer
        return WavLMWithFeaturizer
    if name == "w2vbert":
        from wespeaker_tpu_torch.frontend.w2vbert import W2VBertFrontend
        return W2VBertFrontend
    raise KeyError(f"unknown frontend {name}")
