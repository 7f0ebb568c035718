"""Device-time breakdown of one train step on the card.

    python -m wespeaker_tpu_torch.bin.profile_train [--batch 256] [--plain]

The train step of bench.py: ECAPA_TDNN_GLOB_c512 with ArcMargin over
17,982 classes (5,994 VoxCeleb2 speakers x 3 speed-perturb classes), SGD
with momentum 0.9, bf16 AMP, waveform dither and spec-aug, 2 s chunks
(32,240 samples) of random audio, weights from seed 0. Prints, for one
step after warm-up, the device time of every CUDA kernel name
(torch.profiler), its share and launch count, then the step's time from
CUDA events and the share of it the device was busy. --plain runs the
tail layer by layer (fused=False) instead of through its train kernels.
"""

import argparse

import numpy as np
import torch

from wespeaker_tpu_torch.bin.profile_extract import CHUNK_SAMPLES, breakdown
from wespeaker_tpu_torch.device import resolve_device
from wespeaker_tpu_torch.frontend.fbank import FbankConfig
from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN_GLOB_c512
from wespeaker_tpu_torch.models.projections import ArcMarginProduct
from wespeaker_tpu_torch.train import (AugConfig, build_train_state,
                                       make_train_step)
from wespeaker_tpu_torch.utils.schedulers import (ExponentialDecrease,
                                                  MarginScheduler)

NUM_CLASS = 17982
SGD = {"optimizer": "SGD", "optimizer_args": {
    "momentum": 0.9, "nesterov": False, "weight_decay": 0.0}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    model, proj, opt, gen = build_train_state(
        lambda: (ECAPA_TDNN_GLOB_c512(80, 192),
                 ArcMarginProduct(192, NUM_CLASS)), SGD, seed=0, device=dev)
    epoch_iter = 1092009 // args.batch
    step = make_train_step(
        model.set_fused(not args.plain), proj, opt,
        ExponentialDecrease(150, epoch_iter, 0.1, 5e-5, warm_up_epoch=6),
        MarginScheduler(epoch_iter, 20, 40, 0.0, 0.2), FbankConfig(dither=1.0),
        AugConfig(), compute_dtype=torch.bfloat16, device=dev, generator=gen)
    rng = np.random.default_rng(0)
    batch = {"wav": torch.as_tensor(rng.uniform(
        -0.5, 0.5, (args.batch, CHUNK_SAMPLES)).astype(np.float32),
        device=dev), "label": torch.as_tensor(
        rng.integers(0, NUM_CLASS, args.batch), device=dev)}
    breakdown(lambda: step(batch),
              f"{'plain' if args.plain else 'kernel'} path train step, "
              f"B={args.batch}")


if __name__ == "__main__":
    main()
