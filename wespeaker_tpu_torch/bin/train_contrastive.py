"""MoCo / SimCLR pretraining CLI on the card.

    python -m wespeaker_tpu_torch.bin.train_contrastive --config conf.yaml \
        [--device cuda|cpu] [k=v overrides]

Counterpart of wespeaker_tpu/bin/train_contrastive.py (upstream
wespeaker/ssl/bin/train_contrastive.py): two views of `chunk_sec` cut
from each whole utterance (and augmented each on its own), fbank (dither
0) + CMVN (+ spec-aug) on the device, `ssl_method` moco (a momentum key
encoder and a queue of `queue_size` negatives, drawn from the seed and
L2-normalised; queue_size % batch_size == 0) or simclr (both views
through one encoder, q and k stacked); lr = base_lr * batch / 256 on a
cosine to final_lr after warmup_epochs; SGD with momentum 0.9; bf16 AMP
with `enable_amp`. The config is dumped to exp_dir/config.yaml and each
epoch writes `models/model_<epoch>.pt` ({"state_dict": the query / SimCLR
encoder}), which bin/extract.py::load_model_for_eval loads.

`reverb_data` / `noise_data` augment each view on its own, as in
bin/train_dino.py, which also joins the ranks for both trainers
(`join_ranks`: `batch_size` is each rank's, the LR scale, the epoch's
steps and MoCo's queue_size % batch check take the global batch; rank 0
alone writes) and refuses what they do not run (`refuse_unported`:
`dataloader_args.num_workers` > 0).
"""

import argparse
import os
import time

import numpy as np
import torch

from wespeaker_tpu_torch.bin.train import setup_logger
from wespeaker_tpu_torch.bin.train_dino import (epoch_iters, join_ranks,
                                                refuse_unported,
                                                ssl_dataset)
from wespeaker_tpu_torch.data.dataset import Prefetcher
from wespeaker_tpu_torch.data.pipeline import get_random_chunk
from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.frontend.fbank import FbankConfig
from wespeaker_tpu_torch.parallel.mesh import barrier
from wespeaker_tpu_torch.ssl import contrastive as C
from wespeaker_tpu_torch.ssl.dino import cosine_scheduler
from wespeaker_tpu_torch.ssl.featurize import make_ssl_featurize
from wespeaker_tpu_torch.train.composite import build_model
from wespeaker_tpu_torch.utils import checkpoint as ckpt
from wespeaker_tpu_torch.utils.config import dump_yaml, parse_config_or_kwargs


def _two_view_batches(dataset, batch: int, chunk_len: int, seed: int,
                      aug_fn=None):
    """Endless {"q", "k"} (B, chunk_len) f32 batches: two views chunked
    (and augmented) independently from each whole utterance; a partial
    batch at an epoch's end is dropped."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while True:
        buf = []
        for sample in dataset._epoch_iter(epoch):
            q = get_random_chunk(sample["wav"], chunk_len, rng)
            k = get_random_chunk(sample["wav"], chunk_len, rng)
            if aug_fn is not None:
                q, k = aug_fn(q, rng), aug_fn(k, rng)
            buf.append((q, k))
            if len(buf) == batch:
                yield {"q": np.stack([v[0] for v in buf]).astype(np.float32),
                       "k": np.stack([v[1] for v in buf]).astype(np.float32)}
                buf = []
        epoch += 1


def train_contrastive(config: str, overrides=None, device: DeviceLike = None,
                      backend: str = None, **kwargs):
    """Run the MoCo or SimCLR pretraining of `config` on `device` (the card
    unless the caller passes device="cpu"). Returns the MoCoTrainStep or
    SimCLRTrainStep. `backend`: see bin/train.py::train."""
    configs = parse_config_or_kwargs(config, overrides, **kwargs)
    refuse_unported(configs)
    method = configs.get("ssl_method", "moco")
    if method not in ("moco", "simclr"):
        raise ValueError(f"unknown ssl_method {method}")
    dev = resolve_device(device)
    mesh, stripe, num_stripes = join_ranks(configs, dev, backend)
    exp_dir = configs["exp_dir"]
    model_dir = os.path.join(exp_dir, "models")
    os.makedirs(model_dir, exist_ok=True)
    logger = setup_logger(exp_dir, mesh.rank)
    if mesh.rank == 0:
        dump_yaml(configs, os.path.join(exp_dir, "config.yaml"))

    seed = configs.get("seed", 42)
    feat_dim = configs["model_args"].get("feat_dim", 80)
    embed_dim = configs["model_args"]["embed_dim"]
    local_batch = configs["dataset_args"].get("batch_size", 32)
    batch = local_batch * mesh.data  # the global batch
    num_epochs = configs.get("num_epochs", 10)
    epoch_iter = epoch_iters(configs, batch)
    ssl_args = configs.get("ssl_args", {})
    compute_dtype = (torch.bfloat16 if configs.get("enable_amp")
                     else torch.float32)
    lr_fn = cosine_scheduler(ssl_args.get("base_lr", 0.06) * batch / 256,
                             ssl_args.get("final_lr", 1e-5), num_epochs,
                             epoch_iter,
                             warmup_epochs=ssl_args.get("warmup_epochs", 0))

    torch.manual_seed(seed)
    encoder = build_model(configs).to(dev)
    optimizer = torch.optim.SGD(encoder.parameters(), lr=0.0, momentum=0.9)
    temperature = ssl_args.get("temperature", 0.07)
    if method == "moco":
        K = ssl_args.get("queue_size", 4096)
        if K % batch:
            raise ValueError(f"queue size {K} is no multiple of the batch "
                             f"{batch}")
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        queue = C.l2norm(torch.randn((K, embed_dim), generator=gen,
                                     device=dev))
        step = C.MoCoTrainStep(encoder, optimizer, lr_fn, queue,
                               m=ssl_args.get("momentum", 0.999),
                               T=temperature, compute_dtype=compute_dtype,
                               mesh=mesh)
    else:
        step = C.SimCLRTrainStep(encoder, optimizer, lr_fn, n_views=2,
                                 T=temperature, compute_dtype=compute_dtype,
                                 mesh=mesh)

    dataset, crop_aug = ssl_dataset(configs, stripe, num_stripes)
    sr = configs["dataset_args"].get("resample_rate", 16000)
    chunk_len = int(ssl_args.get("chunk_sec", 2.0) * sr)
    featurize = make_ssl_featurize(FbankConfig(num_mel_bins=feat_dim,
                                               dither=0.0),
                                   configs["dataset_args"],
                                   seed + 1_000_003 * stripe, device=dev)
    with Prefetcher(_two_view_batches(dataset, local_batch, chunk_len,
                                      seed, crop_aug)) as prefetch:
        batches = iter(prefetch)
        log_interval = configs.get("log_batch_interval", 50)
        for epoch in range(num_epochs):
            t0 = time.time()
            for _ in range(epoch_iter):
                b = next(batches)
                it = step.step
                if method == "moco":
                    metrics = step({"q_feat": featurize(b["q"]),
                                    "k_feat": featurize(b["k"])})
                else:
                    metrics = step({"feat": featurize(np.concatenate(
                        [b["q"], b["k"]]))})
                if it % log_interval == 0:
                    logger.info(f"epoch {epoch} it {it} loss "
                                f"{float(metrics['loss']):.4f} lr "
                                f"{metrics['lr']:.5f}")
            logger.info(f"epoch {epoch} done in {time.time() - t0:.1f}s")
            if mesh.rank == 0:
                ckpt.save_checkpoint(os.path.join(model_dir,
                                                  f"model_{epoch}.pt"),
                                     step.encoder)
            barrier(mesh, dev)
    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    train_contrastive(args.config, args.overrides, device=args.device)


if __name__ == "__main__":
    main()
