"""Device-time breakdown of the extraction forward on the card.

    python -m wespeaker_tpu_torch.bin.profile_extract [--batch 512] [--plain]
        [--model ECAPA_TDNN_GLOB_c512|CAMPPlus|Gemini_DF_ResNet114|ResNet34|
                 ReDimNetB2]

Builds the model (ECAPA_TDNN_GLOB_c512, embed 192, by default; CAMPPlus at
campplus.yaml's width: feat 80, embed 512, TSTP; Gemini_DF_ResNet114 at
gemini_dfresnet_adam.yaml's: feat 80, embed 256, TSTP; ResNet34 at
resnet.yaml's: feat 80, embed 256, TSTP; ReDimNetB2 at redimnet.yaml's:
feat 72 (72-bin fbank), embed 192, ASTP) with random
weights, runs make_eval_embed_fn in bf16 over 2 s chunks (32,240 samples)
and prints, for one forward after warm-up, the device time of every CUDA
kernel name (torch.profiler), its share of the total and its launch
count, then the forward's wall time from
CUDA events and the share of it the device was busy, and the device
time by kernel family (the port's kernels, cuDNN/cuBLAS, PyTorch's own,
copies). --plain profiles the plain path instead of the kernel path: the
model's `set_fused(False)` where it has one, and plain statistics pooling
(`set_pooling_fused(model, False)`) in every model; ResNet34's only kernel
in extraction is its TSTP's masked stats.
"""

import argparse

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from wespeaker_tpu_torch.device import resolve_device
from wespeaker_tpu_torch.frontend.fbank import FbankConfig
from wespeaker_tpu_torch.models import get_speaker_model
from wespeaker_tpu_torch.models.pooling_layers import set_pooling_fused
from wespeaker_tpu_torch.train import make_eval_embed_fn

CHUNK_SAMPLES = (200 - 1) * 160 + 400
# feat_dim (the fbank's bins), embed_dim of each model profiled: bench.py's
# ECAPA, examples/voxceleb/v2/conf/campplus.yaml, gemini_dfresnet_adam.yaml,
# resnet.yaml and redimnet.yaml
MODEL_ARGS = {"ECAPA_TDNN_GLOB_c512": (80, 192), "CAMPPlus": (80, 512),
              "Gemini_DF_ResNet114": (80, 256), "ResNet34": (80, 256),
              "ReDimNetB2": (72, 192)}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


# kernel families by name, first match wins: the port's own CUDA kernels,
# the vendor libraries' convs and matmuls, PyTorch's own kernels, copies
FAMILIES = (("port (ws::)", ("ws::",)),
            ("cuDNN/cuBLAS", ("xmma", "cudnn", "cutlass", "nvjet", "sgemm",
                              "convolve", "gemm")),
            ("PyTorch at::native", ("at::native",)),
            ("copies", ("Memcpy", "Memset")))


def family(key: str) -> str:
    for name, marks in FAMILIES:
        if any(m in key for m in marks):
            return name
    return "other"


def breakdown(fn, what: str, warmup: int = 3):
    """Print, for one call of fn after warm-up, the device time of every
    CUDA kernel name (torch.profiler), its share and launch count, then the
    call's time between two CUDA events and the share of it the device
    was busy, and the device time by kernel family."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(_device_us(e), e.count, e.key) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    total = sum(r[0] for r in rows)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    print(f"{what}, {torch.cuda.get_device_name(0)}: device total "
          f"{total / 1e3:.3f} ms over {sum(r[1] for r in rows)} launches; "
          f"call {wall_ms:.3f} ms (CUDA events), device busy "
          f"{100 * total / 1e3 / max(wall_ms, 1e-9):.1f}%")
    fams = {}
    for us, count, key in rows:
        print(f"{us / 1e3:9.3f} ms {100 * us / max(total, 1e-9):5.1f}% "
              f"x{count:<4d} {key[:110]}")
        acc = fams.setdefault(family(key), [0.0, 0])
        acc[0] += us
        acc[1] += count
    print("by family: " + "; ".join(
        f"{k} {us / 1e3:.3f} ms ({100 * us / max(total, 1e-9):.1f}%) x{n}"
        for k, (us, n) in sorted(fams.items(), key=lambda kv: -kv[1][0])))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--model", choices=sorted(MODEL_ARGS),
                    default="ECAPA_TDNN_GLOB_c512")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.manual_seed(0)
    feat_dim, embed_dim = MODEL_ARGS[args.model]
    model = get_speaker_model(args.model)(feat_dim, embed_dim)
    if hasattr(model, "set_fused"):
        model.set_fused(not args.plain)
    set_pooling_fused(model, not args.plain)
    embed = make_eval_embed_fn(model, FbankConfig(num_mel_bins=feat_dim),
                               compute_dtype=torch.bfloat16,
                               fbank_conv_dtype=torch.bfloat16, device=dev)
    wav = torch.as_tensor(np.random.default_rng(0).uniform(
        -0.5, 0.5, (args.batch, CHUNK_SAMPLES)).astype(np.float32),
        device=dev)
    breakdown(lambda: embed({"wav": wav}),
              f"{args.model} {'plain' if args.plain else 'kernel'} path "
              f"forward, B={args.batch}")


if __name__ == "__main__":
    main()
