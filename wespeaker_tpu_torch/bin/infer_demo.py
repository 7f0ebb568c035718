"""One wav through an exported `.pt2` (wespeaker/bin/infer_onnx.py).

    python -m wespeaker_tpu_torch.bin.infer_demo --model_path model.pt2 \
        --wav_path a.wav [--feat_dim 80] [--device cpu]

Counterpart of wespeaker_tpu/bin/infer_demo.py: the program is loaded on
the card (`--device cpu` when asked; bin/export_model.py::load_exported),
the fbank is the port's frontend/fbank.py on the same device (dither 0,
the wav's own rate), each bin's mean over time is subtracted (CMN), and
the embedding is printed, six decimals a value.
"""

import argparse

import numpy as np
import torch

from wespeaker_tpu_torch.bin.export_model import load_exported
from wespeaker_tpu_torch.data.wav_io import read_wav
from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.frontend.fbank import (FbankConfig, apply_cmvn,
                                                compute_fbank)


def infer(model_path: str, wav_path: str, feat_dim: int = 80,
          device: DeviceLike = None) -> np.ndarray:
    """The (D,) embedding of the wav's first channel."""
    dev = resolve_device(device)
    fn = load_exported(model_path, dev)
    wav, sr = read_wav(wav_path)
    if wav.ndim > 1:
        wav = wav[0]
    with torch.no_grad():
        feats = compute_fbank(
            torch.as_tensor(wav[None] * (1 << 15), device=dev),
            FbankConfig(num_mel_bins=feat_dim, sample_rate=sr))
        emb = fn(apply_cmvn(feats))[0]
    return emb.float().cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--wav_path", required=True)
    ap.add_argument("--feat_dim", type=int, default=80)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    emb = infer(args.model_path, args.wav_path, args.feat_dim, args.device)
    print(" ".join(f"{v:.6f}" for v in emb))


if __name__ == "__main__":
    main()
