"""Device-time breakdown of the extraction forward on the card.

    python -m wespeaker_tpu_torch.bin.profile_extract [--batch 512] [--plain]

Builds ECAPA_TDNN_GLOB_c512 with random weights, runs make_eval_embed_fn
in bf16 over 2 s chunks (32,240 samples) and prints, for one forward after
warm-up, the device time of every CUDA kernel name (torch.profiler), its
share of the total and its launch count, then the forward's wall time from
CUDA events. --plain profiles the layer-by-layer path instead of the
kernel path.
"""

import argparse

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from wespeaker_tpu_torch.device import resolve_device
from wespeaker_tpu_torch.frontend.fbank import FbankConfig
from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN_GLOB_c512
from wespeaker_tpu_torch.train import make_eval_embed_fn

CHUNK_SAMPLES = (200 - 1) * 160 + 400


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.manual_seed(0)
    model = ECAPA_TDNN_GLOB_c512(80, 192).set_fused(not args.plain)
    embed = make_eval_embed_fn(model, FbankConfig(),
                               compute_dtype=torch.bfloat16,
                               fbank_conv_dtype=torch.bfloat16, device=dev)
    wav = torch.as_tensor(np.random.default_rng(0).uniform(
        -0.5, 0.5, (args.batch, CHUNK_SAMPLES)).astype(np.float32),
        device=dev)
    for _ in range(3):
        embed({"wav": wav})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        embed({"wav": wav})
        torch.cuda.synchronize()
    rows = [(_device_us(e), e.count, e.key) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    total = sum(r[0] for r in rows)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    embed({"wav": wav})
    end.record()
    torch.cuda.synchronize()
    print(f"{'kernel' if not args.plain else 'plain'} path, B={args.batch}, "
          f"{torch.cuda.get_device_name(0)}: device total "
          f"{total / 1e3:.3f} ms over {sum(r[1] for r in rows)} launches; "
          f"forward {start.elapsed_time(end):.3f} ms (CUDA events)")
    for us, count, key in rows:
        print(f"{us / 1e3:9.3f} ms {100 * us / max(total, 1e-9):5.1f}% "
              f"x{count:<4d} {key[:110]}")


if __name__ == "__main__":
    main()
