"""The pieces the self-supervised frontends share, and the registry's
s3prl and w2v-bert entries.

Counterpart of wespeaker_tpu/frontend/ssl_frontends.py. The upstreams the
recipes use have native ports: WavLM (and HuBERT / wav2vec 2.0, its modes
without the gated relative-position bias) in frontend/wavlm.py, w2v-bert
2.0 in frontend/w2vbert.py and the Whisper encoder in
frontend/whisper_encoder.py. Any other upstream runs once through
`bin/precompute_feats.py`, whose `--layer all` output the
`StackedFeatFrontend` below mixes with learned layer weights
(`dataset_args.frontend: feat_stack`).

`Wav2Vec2Frontend` wraps transformers' Flax model in the JAX package;
neither a Flax model nor transformers is part of the port, so it raises
and names the native path, the `wavlm` frontend's `wav2vec2` mode.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn


class Featurizer(nn.Module):
    """Learned softmax-weighted sum over hidden states (the s3prl
    Featurizer role); the weights start at zero, an even mix."""

    def __init__(self, num_layers: int):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(num_layers))

    def forward(self, hidden_states: Sequence[torch.Tensor]) -> torch.Tensor:
        stacked = torch.stack(list(hidden_states), dim=0)  # (L, B, T, D)
        ws = torch.softmax(self.weights.float(), dim=0).to(stacked.dtype)
        return torch.tensordot(ws, stacked, dims=1)


class StackedFeatFrontend(nn.Module):
    """Trainable layer mixing over precomputed hidden states:
    `bin/precompute_feats.py --layer all` writes every hidden layer side by
    side, (T, L * D); this splits the L layers back out and mixes them
    with a Featurizer. (B, T, L * D) -> (B, T, D); the frame rate is kept,
    so frame masks pass through unchanged."""

    time_stride = 1

    def __init__(self, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        self.featurizer = Featurizer(num_layers)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        ld = x.shape[-1]
        if ld % self.num_layers:
            raise ValueError(f"feature width {ld} is not a multiple of "
                             f"num_layers {self.num_layers}")
        return self.featurizer(x.split(ld // self.num_layers, dim=-1))


class Wav2Vec2Frontend:
    """The JAX package wraps transformers' FlaxWav2Vec2Model here. The
    port has no Flax model and does not depend on transformers: the
    wav2vec 2.0 architecture is the `wavlm` frontend's `wav2vec2` mode
    (`dataset_args.frontend: wav2vec2`, frontend/wavlm.py with
    use_rel_pos_bias=False)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "Wav2Vec2Frontend wraps transformers' Flax model, which the port "
            "does not use; set dataset_args.frontend: wav2vec2 (the native "
            "frontend/wavlm.py stack without the relative-position bias)")


def s3prl_frontend(*args, **kwargs):
    """The s3prl upstream the recipes use, WavLM, as the native
    WavLMWithFeaturizer; other upstreams go through bin/precompute_feats
    and `feat_stack`."""
    from wespeaker_tpu_torch.frontend.wavlm import WavLMWithFeaturizer

    return WavLMWithFeaturizer(*args, **kwargs)


def w2vbert_frontend(*args, **kwargs):
    """w2v-bert 2.0 as the native W2VBertFrontend."""
    from wespeaker_tpu_torch.frontend.w2vbert import W2VBertFrontend

    return W2VBertFrontend(*args, **kwargs)
