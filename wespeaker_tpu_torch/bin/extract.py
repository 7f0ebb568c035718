"""Embedding extraction CLI: a list of utterances -> kaldi ark/scp
embeddings, on the card.

    python -m wespeaker_tpu_torch.bin.extract --config exp/config.yaml \
        --checkpoint exp/models/final_model.pt --data_list eval.list \
        --out_prefix out/xvector [--batch_size 8] [--bf16] \
        [--pow2_buckets] [--num_splits N --split_index i] \
        [--data_parallel [--devices cuda:0,cuda:1]] \
        [--device cuda|cpu] [k=v overrides]

Counterpart of wespeaker_tpu/bin/extract.py (upstream
wespeaker/bin/extract.py:33-143): test-mode data (no augmentation, dither
0, whole utterances), variable-length utterances sorted into padded
buckets with validity masks (data/dataset.py::eval_batches; masked CMVN
and pooling give the batch=1 result), one forward a bucket, and
`<out_prefix>.ark/.scp` written in bucket order. A jsonl list ({"key",
"wav"(, "vad")}) is read by `read_threads` threads, which touch numpy
only; with `data_type: feat` the list holds kaldi feature matrices
(scp lines `key ark:offset` or jsonl {"key", "feat"}) and the buckets are
frame buckets. The checkpoint is a port `.pt` file (a trainer's
`model_<n>.pt`, `final_model.pt`, an averaged model or a state_dict) or
the JAX package's msgpack `.ckpt` (its trainers' `model_<n>.ckpt`,
`avg_model.ckpt`), told apart by content. A config with another
`dataset_args.frontend` embeds through that frontend
(train/composite.py::featurizers) instead of the fbank: tfmel, the
Whisper encoder, WavLM / HuBERT / wav2vec 2.0 and w2v-bert read the wav
list, `feat_stack` a feature list of `bin/precompute_feats.py --layer
all` output. The attention frontends split a bucket into row groups of
at most `train/composite.py::eval_rows_cap` rows, whose (B, H, T, T)
scores grow as T^2; each group keeps the bucket's padded length.
`--data_parallel` splits each batch over one model replica a card (or the
`--devices` given, which may repeat one device) as the JAX package splits
it over its local devices (utils/eval_device.py); the ark/scp is the one
replica's, in the same order.
"""

import argparse
import collections
import concurrent.futures
import contextlib
import functools
import json
import logging
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from wespeaker_tpu_torch.data.dataset import eval_batches, eval_feat_batches
from wespeaker_tpu_torch.data.pipeline import (read_audio_any,
                                               read_vec_scp_iterlines,
                                               resample_array)
from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.frontend.fbank import FbankConfig, no_tf32
from wespeaker_tpu_torch.train.composite import (build_model, eval_rows_cap,
                                                 featurizers, frontend_type)
from wespeaker_tpu_torch.train.train_step import make_eval_embed_fn
from wespeaker_tpu_torch.utils.config import parse_config_or_kwargs
from wespeaker_tpu_torch.utils.eval_device import (prepare_eval_placement,
                                                   replica_devices,
                                                   replicate, round_batch,
                                                   split_over)
from wespeaker_tpu_torch.utils.kaldi_io import write_vec_ark_scp
from wespeaker_tpu_torch.utils.checkpoint import load_checkpoint


def load_model_for_eval(configs: Dict[str, Any], checkpoint_path: str,
                        device: DeviceLike = None) -> nn.Module:
    """config + checkpoint -> the model on `device`, in eval mode. The
    checkpoint is a model state_dict (port or upstream), a file the
    trainer (bin/train.py) wrote, whose model part is read, or a JAX
    `.ckpt` (its "params" and "batch_stats"), loaded strictly."""
    dev = resolve_device(device)
    model = load_checkpoint(checkpoint_path, build_model(configs, device=dev))
    return model.to(dev).eval()


def fbank_config(configs: Dict[str, Any]) -> FbankConfig:
    """The evaluation fbank of a training config: its fbank_args and
    resample_rate, dither 0."""
    dataset_args = configs.get("dataset_args", {})
    fbank_args = dataset_args.get("fbank_args", {})
    return FbankConfig(
        num_mel_bins=fbank_args.get(
            "num_mel_bins", configs["model_args"].get("feat_dim", 80)),
        frame_length_ms=fbank_args.get("frame_length", 25),
        frame_shift_ms=fbank_args.get("frame_shift", 10),
        sample_rate=dataset_args.get("resample_rate", 16000), dither=0.0)


def _load_entry(obj, target_rate):
    """(key, mono f32 wav at target_rate) of one list entry; its "vad"
    segments [[start, end], ...] in seconds are cut and joined."""
    wav, sr = read_audio_any(obj["wav"])
    if wav.ndim > 1:
        wav = wav[0]
    if obj.get("vad"):
        wav = np.concatenate([wav[int(s * sr):int(e * sr)]
                              for s, e in obj["vad"]])
    if sr != target_rate:
        wav = resample_array(wav, sr, target_rate)
    return obj["key"], wav


def _threaded_map(fn, items, num_threads, depth=64):
    """fn over items in order, `depth` ahead on `num_threads` threads (wav
    reading and resampling overlap the device forward)."""
    if num_threads <= 1:
        yield from map(fn, items)
        return
    with concurrent.futures.ThreadPoolExecutor(num_threads) as ex:
        pending = collections.deque()
        it = iter(items)
        exhausted = False
        while True:
            while not exhausted and len(pending) < depth:
                try:
                    pending.append(ex.submit(fn, next(it)))
                except StopIteration:
                    exhausted = True
            if not pending:
                return
            yield pending.popleft().result()


def _striped_lines(data_list, num_splits, split_index):
    """The non-empty lines of `data_list` whose line number falls in this
    split's stripe, before anything they name is read."""
    with open(data_list) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if line and i % num_splits == split_index:
                yield line


def iter_wavs_from_list(data_list, target_rate=16000, num_splits=1,
                        split_index=0, read_threads=4):
    """(key, wav) from a jsonl list, the num_splits/split_index stripe
    applied to list lines before any audio is read."""
    entries = (json.loads(ln) for ln in _striped_lines(data_list, num_splits,
                                                       split_index))
    yield from _threaded_map(functools.partial(_load_entry,
                                               target_rate=target_rate),
                             entries, read_threads)


def iter_feats_from_list(data_list, num_splits=1, split_index=0):
    """(key, (T, F) feat) from a feat list: kaldi scp lines ('key
    ark:offset') or jsonl ({"key", "feat": "ark:offset"}), striped as
    iter_wavs_from_list."""

    def scp_lines():
        for line in _striped_lines(data_list, num_splits, split_index):
            if line.startswith("{"):
                obj = json.loads(line)
                line = f"{obj['key']} {obj['feat']}"
            yield line

    yield from read_vec_scp_iterlines(scp_lines())


@contextlib.contextmanager
def matmul_precision(precision: str):
    """`default` leaves torch's TF32 settings; `high` and `float32` turn
    TF32 off for matmuls and cuDNN convolutions (exact f32 contractions)
    inside the block."""
    if precision not in ("default", "high", "float32"):
        raise ValueError(f"precision {precision!r}: default, high or "
                         "float32")
    if precision == "default":
        yield
        return
    with no_tf32(matmul=True, cudnn=True):
        yield


def extract(config, checkpoint_path, data_list, out_prefix, batch_size=8,
            overrides=None, num_splits=1, split_index=0, bf16=False,
            read_threads=4, precision="default", data_parallel=False,
            pow2_buckets=False, device: DeviceLike = None, devices=None,
            **kwargs):
    """Embed every utterance of `data_list` on `device` (the card unless
    the caller passes device="cpu") and write `<out_prefix>.ark/.scp`;
    returns the scp path. num_splits/split_index stripe the list across
    independent processes (upstream tools/extract_embedding.sh:40-75).
    bf16 runs the activations in bfloat16 (the parameters stay f32, cast
    per call). read_threads overlap wav reading with the forward.
    precision: see matmul_precision. pow2_buckets: the geometric
    length ladder instead of the linear 1 s grid. data_parallel: each
    batch split over one replica a device of `devices` (every visible card
    by default; utils/eval_device.py), batch_size rounded up to a multiple
    of them."""
    configs = parse_config_or_kwargs(config, overrides, **kwargs)
    dev = resolve_device(device)
    with matmul_precision(precision):
        return _extract_inner(configs, checkpoint_path, data_list,
                              out_prefix, batch_size, num_splits,
                              split_index, bf16, read_threads,
                              replica_devices(data_parallel, dev, devices),
                              pow2_buckets, dev)


def _extract_inner(configs, checkpoint_path, data_list, out_prefix,
                   batch_size, num_splits, split_index, bf16, read_threads,
                   devices, pow2_buckets, dev):
    feat_mode = configs.get("data_type") == "feat"
    featurize_eval = featurizers(configs)[1]
    name = frontend_type(configs)
    if feat_mode and featurize_eval is not None and name != "feat_stack":
        raise ValueError("data_type feat holds feature matrices; the "
                         f"{name} frontend reads wavs")
    if name == "feat_stack" and not feat_mode:
        raise ValueError("the feat_stack frontend reads data_type feat "
                         "(bin/precompute_feats.py --layer all output)")
    model = load_model_for_eval(configs, checkpoint_path, device=dev)
    model, compute_dtype = prepare_eval_placement(model, bf16, device=dev)
    fbank_cfg = fbank_config(configs)
    rate = fbank_cfg.sample_rate
    batch_size = round_batch(batch_size, len(devices))
    embed_fn = split_over([
        make_eval_embed_fn(replica, fbank_cfg, compute_dtype=compute_dtype,
                           device=d, from_wav=not feat_mode,
                           featurize_fn=featurize_eval)
        for replica, d in zip(replicate(model, devices), devices)])
    if feat_mode:
        batches = eval_feat_batches(
            iter_feats_from_list(data_list, num_splits, split_index),
            batch_size=batch_size, pow2_buckets=pow2_buckets)
        data_key = "feat"
    else:
        batches = eval_batches(
            iter_wavs_from_list(data_list, rate, num_splits, split_index,
                                read_threads),
            batch_size=batch_size, quantum_samples=rate,
            pow2_buckets=pow2_buckets)
        data_key = "wav"

    def items():
        for batch in batches:
            data, mask = batch[data_key], batch["mask"]
            rows = eval_rows_cap(configs, data.shape[1]) or len(data)
            emb = np.concatenate([
                embed_fn({data_key: data[i:i + rows],
                          "mask": mask[i:i + rows]}).cpu().numpy()
                for i in range(0, len(data), rows)])
            yield from zip(batch["key"], emb)

    ark, scp = write_vec_ark_scp(out_prefix, items())
    logging.info(f"wrote {ark} / {scp}")
    return scp


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data_list", required=True)
    ap.add_argument("--out_prefix", required=True)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_splits", type=int, default=1)
    ap.add_argument("--split_index", type=int, default=0)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 activations (parameters stay f32, cast per "
                         "call)")
    ap.add_argument("--data_parallel", action="store_true",
                    help="split each batch over one replica a card")
    ap.add_argument("--devices", default=None,
                    help="with --data_parallel, the replicas' devices, "
                         "comma-separated (one may repeat)")
    ap.add_argument("--precision", choices=["default", "high", "float32"],
                    default="default",
                    help="high or float32 turn TF32 off for f32 matmuls "
                         "and convolutions; default leaves torch's setting")
    ap.add_argument("--read_threads", type=int, default=4,
                    help="wav-reading threads overlapping the forward")
    ap.add_argument("--pow2_buckets", action="store_true",
                    help="geometric (power-of-2) length buckets instead of "
                         "the linear 1 s grid")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    extract(args.config, args.checkpoint, args.data_list, args.out_prefix,
            args.batch_size, args.overrides, args.num_splits,
            args.split_index, bf16=args.bf16, read_threads=args.read_threads,
            precision=args.precision, data_parallel=args.data_parallel,
            pow2_buckets=args.pow2_buckets, device=args.device,
            devices=args.devices.split(",") if args.devices else None)


if __name__ == "__main__":
    main()
