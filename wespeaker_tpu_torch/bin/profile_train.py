"""Device-time breakdown of one train step on the card.

    python -m wespeaker_tpu_torch.bin.profile_train [--batch N] [--plain]
        [--model ECAPA_TDNN_GLOB_c512|ResNet34] [--conv_dw_mode native|packed]

The default is the train step of bench.py: ECAPA_TDNN_GLOB_c512 with
ArcMargin over 17,982 classes (5,994 VoxCeleb2 speakers x 3 speed-perturb
classes), SGD with momentum 0.9, bf16 AMP, waveform dither and spec-aug,
B=256 chunks of 2 s (32,240 samples) of random audio, weights from seed 0;
--plain runs the tail layer by layer (fused=False) instead of through its
train kernels. `--model ResNet34` is resnet.yaml's step instead (feat 80,
embed 256, TSTP, ArcMargin over the same classes, SGD with nesterov
momentum 0.9 and weight decay 1e-4, no spec-aug, B=128), with the filter
gradients of its 3x3 convs from the tap-packed kernel under
`--conv_dw_mode packed` or from cuDNN under native. Prints, for one step
after warm-up, the device time of every CUDA kernel name
(torch.profiler), its share and launch count, then the step's time from
CUDA events and the share of it the device was busy.
"""

import argparse

import numpy as np
import torch

from wespeaker_tpu_torch.bin.profile_extract import CHUNK_SAMPLES, breakdown
from wespeaker_tpu_torch.device import resolve_device
from wespeaker_tpu_torch.frontend.fbank import FbankConfig
from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN_GLOB_c512
from wespeaker_tpu_torch.models.projections import ArcMarginProduct
from wespeaker_tpu_torch.models.resnet import ResNet34
from wespeaker_tpu_torch.ops.conv_dw_pack import set_conv_dw_mode
from wespeaker_tpu_torch.train import (AugConfig, build_train_state,
                                       make_train_step)
from wespeaker_tpu_torch.utils.schedulers import (ExponentialDecrease,
                                                  MarginScheduler)

NUM_CLASS = 17982
SGD = {"optimizer": "SGD", "optimizer_args": {
    "momentum": 0.9, "nesterov": False, "weight_decay": 0.0}}
# examples/voxceleb/v2/conf/resnet.yaml
RESNET_SGD = {"optimizer": "SGD", "optimizer_args": {
    "momentum": 0.9, "nesterov": True, "weight_decay": 1e-4}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=None,
                    help="256 for ECAPA, 128 for ResNet34")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--model", choices=["ECAPA_TDNN_GLOB_c512", "ResNet34"],
                    default="ECAPA_TDNN_GLOB_c512")
    ap.add_argument("--conv_dw_mode", choices=["native", "packed"],
                    default="native")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    resnet = args.model == "ResNet34"
    if args.plain and resnet:
        ap.error("ResNet34 has no tail kernel to leave out; compare "
                 "--conv_dw_mode native and packed")
    batch_size = args.batch or (128 if resnet else 256)

    def modules():
        if resnet:
            return ResNet34(80, 256), ArcMarginProduct(256, NUM_CLASS)
        return (ECAPA_TDNN_GLOB_c512(80, 192),
                ArcMarginProduct(192, NUM_CLASS))

    model, proj, opt, gen = build_train_state(
        modules, RESNET_SGD if resnet else SGD, seed=0, device=dev)
    if not resnet:
        model.set_fused(not args.plain)
    set_conv_dw_mode(args.conv_dw_mode)
    epoch_iter = 1092009 // batch_size
    step = make_train_step(
        model, proj, opt,
        ExponentialDecrease(150, epoch_iter, 0.1, 5e-5, warm_up_epoch=6),
        MarginScheduler(epoch_iter, 20, 40, 0.0, 0.2), FbankConfig(dither=1.0),
        AugConfig(spec_aug=not resnet), compute_dtype=torch.bfloat16,
        device=dev, generator=gen)
    rng = np.random.default_rng(0)
    batch = {"wav": torch.as_tensor(rng.uniform(
        -0.5, 0.5, (batch_size, CHUNK_SAMPLES)).astype(np.float32),
        device=dev), "label": torch.as_tensor(
        rng.integers(0, NUM_CLASS, batch_size), device=dev)}
    what = ("plain" if args.plain else "kernel") + " path"
    if resnet:
        what = f"conv_dw_mode {args.conv_dw_mode}"
    breakdown(lambda: step(batch),
              f"{args.model} {what} train step, B={batch_size}")


if __name__ == "__main__":
    main()
