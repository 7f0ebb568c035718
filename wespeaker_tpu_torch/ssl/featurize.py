"""Per-view features for the SSL trainers, on the device.

Counterpart of wespeaker_tpu/ssl/featurize.py (upstream
ssl/dataset/dataset.py:140-163, which applies fbank -> CMVN -> spec-aug per
crop on the host): (B, N) waveforms in [-1, 1] -> x 2^15 -> fbank -> CMVN
-> spec-aug when `dataset_args.spec_aug` is set, with the pieces of
train/train_step.py. The spec-aug draws come from the featurizer's own
generator on the device, seeded from seed ^ 0x5EED and advancing per
call, so the views of one batch get independent masks.
"""

from typing import Any, Callable, Dict

import torch

from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.frontend.fbank import (FbankConfig, apply_cmvn,
                                                compute_fbank)
from wespeaker_tpu_torch.train.train_step import (AugConfig, _on,
                                                  spec_aug_batch)


def make_ssl_featurize(fbank_cfg: FbankConfig, dataset_args: Dict[str, Any],
                       seed: int, device: DeviceLike = None
                       ) -> Callable[[Any], torch.Tensor]:
    """(B, N) wav (numpy or tensor) -> (B, T, F) f32 features on `device`
    (the card unless the caller passes device="cpu")."""
    dev = resolve_device(device)
    aug = None
    if dataset_args.get("spec_aug", False):
        aug = AugConfig.from_spec_aug_args(
            dataset_args.get("spec_aug_args", {}))
    generator = torch.Generator(device=dev).manual_seed(seed ^ 0x5EED)

    def featurize(wav) -> torch.Tensor:
        feat = apply_cmvn(compute_fbank(_on(wav, dev) * (1 << 15),
                                        fbank_cfg))
        if aug is not None:
            feat = spec_aug_batch(generator, feat, aug)
        return feat

    return featurize
