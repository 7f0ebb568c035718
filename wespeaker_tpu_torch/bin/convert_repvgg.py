"""Fuse a train-form RepVGG or RepSPK checkpoint into its deploy form.

    python -m wespeaker_tpu_torch.bin.convert_repvgg \
        --checkpoint exp/models/final_model.pt \
        --save_path exp/models/deploy.pt [--block RepVGG|RepSPK]

Counterpart of wespeaker_tpu/bin/convert_repvgg.py (upstream
wespeaker/models/convert_repvgg.py): each block's branches and their BN
become one biased conv, `rbr_reparam` (models/repvgg.py::
convert_repvgg_state_dict). The checkpoint is a port `.pt` file (a
trainer's, an averaged model or a state_dict), whose model part is
converted and written as `{"state_dict": ...}`, or the JAX package's
msgpack `.ckpt`, written back as a flax tree {"params", "batch_stats"}
(empty for a TSTP model, as the JAX tool writes it). The margin head is
dropped in both formats, as the JAX tool drops it. Extract
with the training config and `model_args.deploy: true`.
"""

import argparse

import torch

from wespeaker_tpu_torch.models.repvgg import convert_repvgg_state_dict
from wespeaker_tpu_torch.utils.checkpoint import (checkpoint_format,
                                                  read_checkpoint,
                                                  save_msgpack_checkpoint)
from wespeaker_tpu_torch.utils.weights import to_jax_variables


def convert(checkpoint_path: str, save_path: str,
            block: str = "RepVGG") -> str:
    sd, _ = read_checkpoint(checkpoint_path, "RepVGG")
    deploy = convert_repvgg_state_dict(sd, block)
    if checkpoint_format(checkpoint_path) == "msgpack":
        save_msgpack_checkpoint(save_path, to_jax_variables(deploy,
                                                            "RepVGG"))
    else:
        torch.save({"state_dict": deploy}, save_path)
    print(f"fused deploy checkpoint -> {save_path}")
    return save_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="accepted for the JAX tool's command line; unused")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--save_path", required=True)
    ap.add_argument("--block", default="RepVGG",
                    choices=["RepVGG", "RepSPK"])
    args = ap.parse_args(argv)
    convert(args.checkpoint, args.save_path, args.block)


if __name__ == "__main__":
    main()
