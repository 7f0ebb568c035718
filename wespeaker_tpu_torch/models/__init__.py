"""Speaker-model registry: `get_speaker_model(name)` returns a constructor
`f(feat_dim=..., embed_dim=..., **kwargs) -> nn.Module`, as in
wespeaker_tpu/models/__init__.py. Every family that fbank features feed
is ported: ECAPA-TDNN, ResNet, the x-vector, CAM++, ERes2Net, Res2Net,
Gemini DF-ResNet, SimAM-ResNet, the xi-vector, RepVGG, ReDimNet2 and
ReDimNet; so are the heads of the neural frontends, whisper_PMFA
(`whisper_PMFA_large_v2`) and W2VBert_Adapter_MFA, which
train/composite.py puts behind their frontends."""

from wespeaker_tpu_torch.models import (campplus, ecapa_tdnn, eres2net,
                                        gemini_dfresnet, redimnet, redimnet2,
                                        repvgg, res2net, resnet, samresnet,
                                        tdnn, w2vbert_adapter_mfa,
                                        whisper_PMFA, xi_vector)

_MODULES = [ecapa_tdnn, resnet, tdnn, campplus, eres2net, res2net,
            gemini_dfresnet, samresnet, xi_vector, repvgg, redimnet2,
            redimnet, whisper_PMFA, w2vbert_adapter_mfa]


def get_speaker_model(model_name: str):
    for mod in _MODULES:
        fn = getattr(mod, model_name, None)
        if fn is not None:
            return fn
    raise KeyError(f"unknown or not yet ported speaker model: {model_name}")
