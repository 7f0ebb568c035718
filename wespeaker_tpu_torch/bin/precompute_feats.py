"""Precompute a frontend's features once and write kaldi 'FM' arks.

    python -m wespeaker_tpu_torch.bin.precompute_feats --data_list raw.list \
        --backend torchjit --model_path frontend.pt --out_prefix exp/feats \
        [--layer last|avg|all|N] [--device cuda|cpu]

Counterpart of wespeaker_tpu/bin/precompute_feats.py. The reference's
s3prl frontend takes any upstream inside the training loop
(wespeaker/frontend/s3prl.py:23-93); the port has native WavLM / HuBERT /
wav2vec 2.0, w2v-bert and Whisper frontends, and any other upstream runs
here once. The `<out_prefix>.ark/.scp` feed `data_type: feat` (training
and bin/extract.py), and `--layer all` output feeds
`dataset_args.frontend: feat_stack` with `feat_stack_args.num_layers: L`,
whose Featurizer learns the layer mix with the speaker model.

Backends:
  torchjit  --model_path model.pt    torch.jit.load onto the device (the
            card unless --device cpu); called as module(wav (1, N)), it
            returns (T, F), (1, T, F), or a tuple or list of such states
            (--layer all stacks them; otherwise the first is used).
  hf        --model_path /local/dir  transformers' AutoModel from a local
            checkpoint directory; transformers is imported inside this
            backend only and its absence raises, naming the package (the
            card's machine lacks it).
  s3prl     --model_path name        the s3prl hub, gated: the package is
            not part of the port's environment.

--layer: 'last' (default), 'avg' (a static mean of the hidden states),
'all' (every hidden state side by side, (T, L * D)) or an index N.
"""

import argparse
import logging

import numpy as np
import torch

from wespeaker_tpu_torch.device import DeviceLike, resolve_device


def _to_tf(out, layer: str) -> np.ndarray:
    """A backend's output -> a (T, F) f32 numpy matrix; layer 'all' puts
    every hidden state side by side, (T, L * D)."""
    if isinstance(out, (tuple, list)):
        if layer == "all":
            out = torch.cat([t[0] if t.dim() == 3 else t for t in out],
                            dim=-1)
        else:
            out = out[0]
    if getattr(out, "hidden_states", None) is not None:
        hs = out.hidden_states
        if layer == "all":
            out = torch.cat(list(hs), dim=-1)
        elif layer == "avg":
            out = torch.stack(list(hs)).mean(0)
        elif layer == "last":
            out = hs[-1]
        else:
            out = hs[int(layer)]
    elif hasattr(out, "last_hidden_state"):
        out = out.last_hidden_state
    mat = out.detach().float().cpu().numpy()
    if mat.ndim == 3:
        if mat.shape[0] != 1:
            raise ValueError(f"batch of {mat.shape[0]} from a one-utterance "
                             "call")
        mat = mat[0]
    if mat.ndim != 2:
        raise ValueError(f"want a (T, F) matrix, got {mat.shape}")
    return np.asarray(mat, np.float32)


def _hf_model(model_path: str):
    """transformers' AutoModel from a local directory; the one place the
    port imports transformers."""
    try:
        from transformers import AutoModel
    except ImportError as e:
        raise ImportError("backend=hf needs the transformers package, which "
                          "is not installed; use backend=torchjit with a "
                          "scripted upstream") from e
    return AutoModel.from_pretrained(model_path, output_hidden_states=True)


def make_frontend_fn(backend: str, model_path: str, layer: str = "last",
                     device: DeviceLike = None):
    """wav (N,) f32 numpy -> (T, F) f32 numpy, by `backend` on `device`
    (the card unless the caller passes device="cpu")."""
    dev = resolve_device(device)
    if backend == "torchjit":
        model = torch.jit.load(model_path, map_location=dev).eval()
    elif backend == "hf":
        model = _hf_model(model_path).to(dev).eval()
    elif backend == "s3prl":
        raise SystemExit("backend=s3prl needs the s3prl package, which is "
                         "not part of the port's environment; use "
                         "backend=torchjit with a scripted upstream")
    else:
        raise SystemExit(f"unknown backend {backend!r}")

    def fn(wav):
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(wav, np.float32)[None],
                                device=dev)
            return _to_tf(model(x), layer)

    return fn


def precompute(data_list: str, out_prefix: str, backend: str,
               model_path: str, layer: str = "last", resample_rate=16000,
               num_splits: int = 1, split_index: int = 0,
               read_threads: int = 2, device: DeviceLike = None):
    """Run the frontend over `data_list` (a jsonl wav list) and write
    `<out_prefix>.ark/.scp`; returns (ark, scp)."""
    from wespeaker_tpu_torch.bin.extract import iter_wavs_from_list
    from wespeaker_tpu_torch.utils.kaldi_io import write_mat_ark_scp

    fn = make_frontend_fn(backend, model_path, layer, device)
    n = 0

    def items():
        nonlocal n
        for key, wav in iter_wavs_from_list(data_list, resample_rate,
                                            num_splits, split_index,
                                            read_threads):
            yield key, fn(wav)
            n += 1
            if n % 100 == 0:
                logging.info("precompute_feats: %d utts", n)

    ark, scp = write_mat_ark_scp(out_prefix, items())
    logging.info("precompute_feats: wrote %d utts -> %s / %s", n, ark, scp)
    return ark, scp


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--data_list", required=True,
                    help="jsonl raw list ({key, wav, spk} per line)")
    ap.add_argument("--out_prefix", required=True)
    ap.add_argument("--backend", choices=["torchjit", "hf", "s3prl"],
                    required=True)
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--layer", default="last",
                    help="'last', 'avg', 'all' (every layer side by side, "
                         "for feat_stack) or a hidden-state index")
    ap.add_argument("--resample_rate", type=int, default=16000)
    ap.add_argument("--num_splits", type=int, default=1)
    ap.add_argument("--split_index", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    precompute(args.data_list, args.out_prefix, args.backend,
               args.model_path, args.layer, args.resample_rate,
               args.num_splits, args.split_index, device=args.device)


if __name__ == "__main__":
    main()
