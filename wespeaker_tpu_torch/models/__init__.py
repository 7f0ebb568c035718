"""Speaker-model registry: `get_speaker_model(name)` returns a constructor
`f(feat_dim=..., embed_dim=..., **kwargs) -> nn.Module`, as in
wespeaker_tpu/models/__init__.py. Ported so far: the ECAPA family,
CAMPPlus, the Gemini DF-ResNet family, the ResNet family and the ReDimNet
family (B0-B6)."""

from wespeaker_tpu_torch.models import (campplus, ecapa_tdnn,
                                        gemini_dfresnet, redimnet, resnet)

_MODULES = [ecapa_tdnn, campplus, gemini_dfresnet, resnet, redimnet]


def get_speaker_model(model_name: str):
    for mod in _MODULES:
        fn = getattr(mod, model_name, None)
        if fn is not None:
            return fn
    raise KeyError(f"unknown or not yet ported speaker model: {model_name}")
