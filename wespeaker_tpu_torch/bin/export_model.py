"""Model export for deployment (the reference's export_{onnx,jit,mnn}).

    python -m wespeaker_tpu_torch.bin.export_model --config conf.yaml \
        --checkpoint model.pt --output_model model.pt2 \
        [--format pt2|onnx|mnn] [--mean_vec mean.npy] [--num_frames N] \
        [k=v overrides]

Counterpart of wespeaker_tpu/bin/export_model.py. Every format holds the
eval forward with the reference's contract (wespeaker/bin/export_onnx.py:
92-99): input feats (B, T, F) float32 -> embs (B, D), B and T dynamic, and
the mean of `--mean_vec` subtracted inside the graph when given. Export
runs on the CPU in f32.

- `pt2` (the JAX package's StableHLO artifact's counterpart):
  `torch.export.save` of the forward on the model's own routes.
  `load_exported(path, device)` loads it and moves it to the card with
  `move_to_device_pass`. Every eval kernel is a custom op (CPU: its plain
  version; CUDA: the kernel), so the program holds one node a kernel
  call and on the card launches what the eager model launches:
  `wespeaker_tpu_torch::fused_se_res2_block` and `::fused_mfa_astp`
  (ECAPA c512 and c1024: 3 and 1 a call), `::fused_res2_chain` (ECAPA
  with `fused: false, fused_res2: true`: 3), `::fused_cam_dense_block`
  (CAM++: 3), `::fused_inv_bottleneck_stage` (Gemini: 4),
  `::fused_softmax_stats` (ASTP: ReDimNet, the `fused_res2` ECAPA) and
  `::fused_masked_stats` (TSTP, TSDP and ASTP's global context: ResNet,
  CAM++, Gemini, ReDimNet and the zoo), from ops/se_block.py,
  ops/mfa_astp.py, ops/res2_chain.py, ops/cam_block.py,
  ops/inv_bottleneck.py and ops/pooling.py.
- `onnx`: export/fx_to_onnx.py on the plain route, opset 14; check it
  with export/onnx_numpy.py (neither `onnx` nor onnxruntime is needed).
- `mnn`: the ONNX file, then MNNConvert if it is on PATH; otherwise the
  exact command is printed and returned (wespeaker/bin/export_mnn.py).
"""

import argparse
import shutil
import subprocess

import numpy as np
import torch

from wespeaker_tpu_torch.bin.extract import load_model_for_eval
from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.export import fx_to_onnx
from wespeaker_tpu_torch.utils.config import parse_config_or_kwargs


def _load(config, checkpoint_path, mean_vec_path, overrides, **kwargs):
    """(model on the CPU in eval, feat_dim, mean vector or None)."""
    configs = parse_config_or_kwargs(config, overrides, **kwargs)
    model = load_model_for_eval(configs, checkpoint_path, device="cpu")
    mean = (np.load(mean_vec_path).astype(np.float32) if mean_vec_path
            else None)
    return model, configs["model_args"].get("feat_dim", 80), mean


def export_pt2(config, checkpoint_path, out_path, mean_vec_path=None,
               overrides=None, **kwargs):
    """Save the eval forward as a torch.export program (.pt2) with
    dynamic B and T; returns out_path."""
    model, feat_dim, mean = _load(config, checkpoint_path, mean_vec_path,
                                  overrides, **kwargs)
    ep = fx_to_onnx.export_program(model, feat_dim, mean, plain=False)
    torch.export.save(ep, out_path)
    return out_path


def load_exported(path: str, device: DeviceLike = None):
    """A `.pt2` as a callable feats -> embs on `device` (the card unless
    the caller passes device="cpu"). Importing the ops modules registers
    the custom ops the program may hold."""
    from wespeaker_tpu_torch.ops import (  # noqa: F401
        cam_block, inv_bottleneck, mfa_astp, pooling, res2_chain, se_block)

    dev = resolve_device(device)
    ep = torch.export.load(path)
    if dev.type != "cpu":
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, dev)
    return ep.module()


def export_onnx(config, checkpoint_path, out_path, mean_vec_path=None,
                overrides=None, **kwargs):
    """Write the eval forward as a dynamic-shape ONNX model (opset 14,
    feats (B, T, F) -> embs (B, D)); returns out_path."""
    model, feat_dim, mean = _load(config, checkpoint_path, mean_vec_path,
                                  overrides, **kwargs)
    blob = fx_to_onnx.convert(model, feat_dim, mean)
    with open(out_path, "wb") as f:
        f.write(blob)
    return out_path


def export_mnn(config, checkpoint_path, out_path, mean_vec_path=None,
               overrides=None, num_frames: int = 0, **kwargs):
    """The ONNX model beside `out_path`, then MNNConvert over it
    (wespeaker/bin/export_mnn.py:66-77; --saveStaticModel for a fixed
    num_frames). Without MNNConvert on PATH the exact command is printed.
    Returns (the path written last, the command)."""
    onnx_path = (out_path[:-4] if out_path.endswith(".mnn")
                 else out_path) + ".onnx"
    export_onnx(config, checkpoint_path, onnx_path, mean_vec_path,
                overrides, **kwargs)
    cmd = ["MNNConvert", "-f", "ONNX", "--modelFile", onnx_path,
           "--MNNModel", out_path, "--bizCode", "MNN"]
    if num_frames > 0:
        cmd.append("--saveStaticModel")
    if shutil.which("MNNConvert") is None:
        print(f"MNNConvert not found; ONNX written to {onnx_path}. "
              "Convert with:\n  " + " ".join(cmd))
        return onnx_path, cmd
    subprocess.run(cmd, check=True)
    subprocess.run(["MNNConvert", "-f", "MNN", "--modelFile", out_path,
                    "--info"], check=False)
    print("Exported MNN model to", out_path)
    return out_path, cmd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--output_model", required=True)
    ap.add_argument("--mean_vec", default=None)
    ap.add_argument("--format", default="pt2",
                    choices=["pt2", "onnx", "mnn"])
    ap.add_argument("--num_frames", type=int, default=0,
                    help="mnn: fix T and pass --saveStaticModel")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args(argv)
    if args.format == "onnx":
        export_onnx(args.config, args.checkpoint, args.output_model,
                    args.mean_vec, args.overrides)
    elif args.format == "mnn":
        export_mnn(args.config, args.checkpoint, args.output_model,
                   args.mean_vec, args.overrides, num_frames=args.num_frames)
    else:
        export_pt2(args.config, args.checkpoint, args.output_model,
                   args.mean_vec, args.overrides)


if __name__ == "__main__":
    main()
