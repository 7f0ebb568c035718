"""Average the last N epoch checkpoints.

    python -m wespeaker_tpu_torch.bin.average_model --src_path exp/models \
        --dst_model exp/models/avg_model.pt|avg_model.ckpt [--num 5]

Counterpart of wespeaker_tpu/bin/average_model.py (upstream
wespeaker/bin/average_model.py:48-76) over the port's `model_<n>.pt`
files (utils/checkpoint.py::find_epoch_checkpoints: by epoch, the
final, averaged and preempt files left out). Each floating tensor of the
model part is averaged in f32, the sum in f32 in epoch order; an integer
buffer (BatchNorm's `num_batches_tracked`) is taken from the last file.
The result is a model state_dict, which bin/extract.py loads. For the SSL
trainers `model_<n>.pt` already holds the teacher's backbone
(bin/train_dino.py, bin/train_contrastive.py), so their recipe averages
these files too.

Given a `--dst_model` ending in `.ckpt`, it averages the JAX package's
`model_<n>.ckpt` files instead, as wespeaker_tpu/bin/average_model.py
does (utils/checkpoint.py::average_checkpoints: every leaf summed in f64,
then f32), and writes the same bytes.
"""

import argparse
from typing import Dict, List

import torch

from wespeaker_tpu_torch.utils.checkpoint import (average_checkpoints,
                                                  find_epoch_checkpoints,
                                                  save_msgpack_checkpoint)
from wespeaker_tpu_torch.utils.weights import _unwrap


def average_state_dicts(paths: List[str]) -> Dict[str, torch.Tensor]:
    """The model parts of `paths` averaged: floating tensors in f32 (cast
    back to their type), every other tensor from the last file."""
    if not paths:
        raise ValueError("no checkpoints to average")
    sds = [_unwrap(torch.load(p, map_location="cpu", weights_only=True))
           for p in paths]
    out = {}
    for key, last in sds[-1].items():
        if not last.is_floating_point():
            out[key] = last.clone()
            continue
        acc = torch.zeros(last.shape, dtype=torch.float32)
        for sd in sds:
            acc += sd[key].float()
        out[key] = (acc / len(sds)).to(last.dtype)
    return out


def average_model(src_dir, dst_model, num: int = 5):
    ext = "ckpt" if dst_model.endswith(".ckpt") else "pt"
    paths = find_epoch_checkpoints(src_dir, ext)[-num:]
    if not paths:
        raise FileNotFoundError(f"no model_<n>.{ext} in {src_dir}")
    if ext == "ckpt":
        save_msgpack_checkpoint(dst_model, average_checkpoints(paths))
    else:
        torch.save(average_state_dicts(paths), dst_model)
    print(f"averaged {len(paths)} checkpoints -> {dst_model}")
    return dst_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src_path", required=True)
    ap.add_argument("--dst_model", required=True)
    ap.add_argument("--num", type=int, default=5)
    args = ap.parse_args(argv)
    average_model(args.src_path, args.dst_model, args.num)


if __name__ == "__main__":
    main()
