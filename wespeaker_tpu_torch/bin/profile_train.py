"""Device-time breakdown of one train step on the card.

    python -m wespeaker_tpu_torch.bin.profile_train [--batch N] [--plain]
        [--model ECAPA_TDNN_GLOB_c512|ResNet34|DINO]
        [--conv_dw_mode native|packed]

The default is the train step of bench.py: ECAPA_TDNN_GLOB_c512 with
ArcMargin over 17,982 classes (5,994 VoxCeleb2 speakers x 3 speed-perturb
classes), SGD with momentum 0.9, bf16 AMP, waveform dither and spec-aug,
B=256 chunks of 2 s (32,240 samples) of random audio, weights from seed 0;
--plain runs the tail layer by layer (fused=False) instead of through its
train kernels. `--model ResNet34` is resnet.yaml's step instead (feat 80,
embed 256, TSTP, ArcMargin over the same classes, SGD with nesterov
momentum 0.9 and weight decay 1e-4, no spec-aug, B=128), with the filter
gradients of its 3x3 convs from the tap-packed kernel under
`--conv_dw_mode packed` or from cuDNN under native. `--model DINO` is
bench.py's DINO step (`dino_step`: ECAPA_TDNN_GLOB_c512 and a 65,536-d BN
head, B=64 utterances as 2 global 3 s and 4 local 2 s crops, features
precomputed as scripts/bench_dino_step.py does); --plain runs its student
and teacher layer by layer with plain pooling. Prints, for one step
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
from wespeaker_tpu_torch.models.pooling_layers import set_pooling_fused
from wespeaker_tpu_torch.ops.conv_dw_pack import set_conv_dw_mode
from wespeaker_tpu_torch.ssl import dino as ssl_dino
from wespeaker_tpu_torch.ssl.featurize import make_ssl_featurize
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


# bench.py's DINO config (examples/voxceleb/v3/dino/conf/ecapa_dino.yaml):
# B utterances a step, each as (views, samples) crops: 2 of 3 s (298
# frames) and 4 of 2 s (198); the schedules over VoxCeleb2's epoch
DINO_BATCH = 64
DINO_CROPS = ((2, 48000), (4, 32000))
DINO_OUT = 65536
DINO_EPOCH_ITER = 1092009 // DINO_BATCH


def dino_features(dev, seed: int = 41):
    """Uniform noise crops of DINO_BATCH utterances through the SSL
    featurizer (fbank, CMVN) on the card: global (2B, 298, 80), local
    (4B, 198, 80) f32, view-major."""
    rng = np.random.default_rng(seed)
    featurize = make_ssl_featurize(FbankConfig(dither=0.0),
                                   {"spec_aug": False}, seed, device=dev)
    return {f"{name}_feat": featurize(rng.uniform(
        -0.5, 0.5, (n * DINO_BATCH, samples)).astype(np.float32))
        for name, (n, samples) in zip(("global", "local"), DINO_CROPS)}


def dino_step(dev, dtype=torch.bfloat16, fused: bool = True,
              freeze: int = DINO_EPOCH_ITER, lr_fn=None, seed: int = 0
              ) -> ssl_dino.DINOTrainStep:
    """bench.py's DINO step: ECAPA_TDNN_GLOB_c512 + a DINO_OUT-d BN head
    (2048 / 256), torch's default init from `seed`, SGD with momentum 0.9,
    the recipe's schedules (its LR warms up from 0, unless lr_fn is
    given), the last layer frozen for `freeze` steps, clip 3. fused=False
    runs student and teacher layer by layer with plain pooling."""
    torch.manual_seed(seed)
    head = ssl_dino.DINOHead(192, DINO_OUT, use_bn=True, hidden_dim=2048,
                             bottleneck_dim=256)
    state = ssl_dino.init_dino_state(
        ECAPA_TDNN_GLOB_c512(80, 192), head, lambda m: torch.optim.SGD(
            [p for p in m.parameters() if p.requires_grad], lr=0.0,
            momentum=0.9), dev)
    if not fused:
        for net in (state.student, state.teacher):
            set_pooling_fused(net.backbone.set_fused(False), False)
    b, it = DINO_BATCH, DINO_EPOCH_ITER
    return ssl_dino.DINOTrainStep(
        state,
        lr_fn or ssl_dino.cosine_scheduler(0.2 * b / 256, 5e-5, 150, it,
                                           warmup_epochs=20),
        ssl_dino.cosine_scheduler(0.996, 1.0, 150, it),
        ssl_dino.teacher_temp_schedule(0.04, 0.07, 150, it),
        ssl_dino.DINOConfig(out_dim=DINO_OUT, n_global=2, n_local=4,
                            freeze_last_layer_iters=freeze, clip_grad=3.0),
        compute_dtype=dtype)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=None,
                    help="256 for ECAPA, 128 for ResNet34")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--model",
                    choices=["ECAPA_TDNN_GLOB_c512", "ResNet34", "DINO"],
                    default="ECAPA_TDNN_GLOB_c512")
    ap.add_argument("--conv_dw_mode", choices=["native", "packed"],
                    default="native")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    if args.model == "DINO":
        step, feats = dino_step(dev, fused=not args.plain), dino_features(dev)
        breakdown(lambda: step(feats),
                  f"DINO {'plain' if args.plain else 'kernel'} path step, "
                  f"B={DINO_BATCH} x (2 x 3 s + 4 x 2 s)")
        return
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
