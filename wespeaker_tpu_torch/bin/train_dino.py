"""DINO pretraining CLI on the card.

    python -m wespeaker_tpu_torch.bin.train_dino --config conf.yaml \
        [--device cuda|cpu] [k=v overrides]

Counterpart of wespeaker_tpu/bin/train_dino.py (upstream
wespeaker/ssl/bin/train_dino.py:43-255): the config and its overrides,
dumped to exp_dir/config.yaml; the raw/shard dataset as whole utterances
(`defer_chunk_aug`), each cut into `global_chunk_num` crops of
`global_chunk_sec` and `local_chunk_num` of `local_chunk_sec`, stacked
view-major in batches of `batch_size` (one card), the crops reseeded with
seed + 7717 * start_epoch; fbank (num_mel_bins = feat_dim, dither 0, as
the JAX trainer sets it whatever `fbank_args` says) + CMVN (+ spec-aug) on
the device; the student and an EMA teacher (ssl/dino.py) with the DINO
head of `dino_args`; lr = base_lr * batch / 256 on a cosine to final_lr
after warmup_epochs, the teacher momentum on a cosine from
momentum_teacher to 1, the teacher temperature warmed up, the last layer
frozen for freeze_last_layer_epochs; SGD with momentum 0.9 and no weight
decay; bf16 AMP with `enable_amp`. Each epoch writes
`models/model_<epoch>.pt` ({"state_dict": the teacher's backbone}, which
bin/extract.py::load_model_for_eval loads) and `models/trainer_state.pt`
(student, teacher, optimizer, center, step, next epoch); `resume: true`
continues from it, and `stop_epoch` (exclusive) ends the run early
without compressing the schedules.

`reverb_data` / `noise_data` (packed stores, `bin/prep_data.py
aug_store`) augment each view on its own with probability `aug_prob`
(data/pipeline.py::make_crop_aug); without a store the views go
unaugmented, as in the JAX package.

Several ranks train one global batch as bin/train.py's do
(`distributed_args`, or a torchrun launch; backend="gloo" for two
ranks on one card): `batch_size` is each rank's, the LR scale and the
epoch's steps come from the global batch, each rank loads its stripe of
the list, and the step is the global batch's (ssl/dino.py). Rank 0 alone
dumps config.yaml and writes the checkpoints; every rank resumes from
them. `dataloader_args.num_workers`
> 0 is refused: the JAX package's SSL trainers take no worker processes
either.
"""

import argparse
import os
import time

import numpy as np
import torch

from wespeaker_tpu_torch.bin.train import setup_logger
from wespeaker_tpu_torch.data.dataset import Prefetcher, SpeakerDataset
from wespeaker_tpu_torch.data.pipeline import (make_crop_aug,
                                               spk2id_from_utt2spk)
from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.frontend.fbank import FbankConfig
from wespeaker_tpu_torch.parallel.mesh import (barrier, init_distributed,
                                               make_mesh,
                                               process_data_stripe)
from wespeaker_tpu_torch.ssl import dataset as ssl_data
from wespeaker_tpu_torch.ssl import dino as D
from wespeaker_tpu_torch.ssl.featurize import make_ssl_featurize
from wespeaker_tpu_torch.train.composite import build_model
from wespeaker_tpu_torch.utils import checkpoint as ckpt
from wespeaker_tpu_torch.utils.config import dump_yaml, parse_config_or_kwargs


def refuse_unported(configs):
    """The options of the SSL trainers that the port does not run."""
    if configs.get("dataloader_args", {}).get("num_workers", 0) > 0:
        raise NotImplementedError(
            "not ported yet: dataloader_args.num_workers > 0 (the SSL "
            "trainers prefetch in one thread, as the JAX package's do)")


def join_ranks(configs, device: torch.device, backend=None):
    """The SSL trainers' ranks (parallel/mesh.py): (mesh, stripe, number
    of stripes), all data ranks."""
    dist_args = configs.get("distributed_args") or {}
    init_distributed(dist_args.get("coordinator"),
                     dist_args.get("num_processes"),
                     dist_args.get("process_id"), backend=backend,
                     device=device.type)
    mesh = make_mesh()
    return (mesh,) + process_data_stripe(mesh)


def ssl_dataset(configs, stripe: int = 0, num_stripes: int = 1):
    """The trainers' dataset (this rank's stripe of the list): whole
    utterances (each view is cropped from the whole and augmented on its
    own), no speed perturb; and the per-view aug_fn over the config's
    stores (None without one)."""
    ds_args = dict(configs["dataset_args"])
    ds_args["speed_perturb"] = False
    ds_args["defer_chunk_aug"] = True
    dataset = SpeakerDataset(configs["data_type"], configs["train_data"],
                             ds_args, spk2id_from_utt2spk(configs["utt2spk"]),
                             reverb_store_prefix=configs.get("reverb_data"),
                             noise_store_prefix=configs.get("noise_data"),
                             rank=stripe, world_size=num_stripes,
                             seed=configs.get("seed", 42))
    return dataset, make_crop_aug(dataset.reverb, dataset.noise,
                                  ds_args.get("aug_prob", 0.6))


def epoch_iters(configs, batch: int) -> int:
    with open(configs["train_data"]) as f:
        num_samples = sum(1 for _ in f)
    return max(num_samples // batch, 1)


def train_dino(config: str, overrides=None, device: DeviceLike = None,
               backend: str = None, **kwargs) -> D.DINOTrainStep:
    """Run the DINO pretraining of `config` on `device` (the card unless
    the caller passes device="cpu"). Returns the DINOTrainStep. `backend`:
    see bin/train.py::train."""
    configs = parse_config_or_kwargs(config, overrides, **kwargs)
    refuse_unported(configs)
    dev = resolve_device(device)
    mesh, stripe, num_stripes = join_ranks(configs, dev, backend)
    exp_dir = configs["exp_dir"]
    model_dir = os.path.join(exp_dir, "models")
    os.makedirs(model_dir, exist_ok=True)
    logger = setup_logger(exp_dir, mesh.rank)
    if mesh.rank == 0:
        dump_yaml(configs, os.path.join(exp_dir, "config.yaml"))

    seed = configs.get("seed", 42)
    dino_args = configs.get("dino_args", {})
    n_global = dino_args.get("global_chunk_num", 2)
    n_local = dino_args.get("local_chunk_num", 4)
    feat_dim = configs["model_args"].get("feat_dim", 80)
    local_batch = configs["dataset_args"].get("batch_size", 32)
    batch = local_batch * mesh.data  # the global batch
    num_epochs = configs.get("num_epochs", 10)
    epoch_iter = epoch_iters(configs, batch)

    lr_fn = D.cosine_scheduler(
        dino_args.get("base_lr", 0.2) * batch / 256,
        dino_args.get("final_lr", 1e-5), num_epochs, epoch_iter,
        warmup_epochs=dino_args.get("warmup_epochs", 2))
    mom_fn = D.cosine_scheduler(dino_args.get("momentum_teacher", 0.996),
                                1.0, num_epochs, epoch_iter)
    temp_fn = D.teacher_temp_schedule(
        dino_args.get("warmup_teacher_temp", 0.04),
        dino_args.get("teacher_temp", 0.07), num_epochs, epoch_iter)
    cfg = D.DINOConfig(
        out_dim=dino_args.get("head_out_dim", 65536), n_global=n_global,
        n_local=n_local,
        freeze_last_layer_iters=dino_args.get("freeze_last_layer_epochs", 1)
        * epoch_iter,
        clip_grad=dino_args.get("clip_grad", 3.0))

    torch.manual_seed(seed)
    backbone = build_model(configs)
    head = D.DINOHead(configs["model_args"]["embed_dim"], cfg.out_dim,
                      hidden_dim=dino_args.get("head_hidden_dim", 2048),
                      bottleneck_dim=dino_args.get("bottleneck_dim", 256),
                      use_bn=dino_args.get("head_use_bn", False))
    # the JAX trainer's optimizer: plain SGD, no weight decay
    state = D.init_dino_state(
        backbone, head, lambda m: torch.optim.SGD(
            [p for p in m.parameters() if p.requires_grad], lr=0.0,
            momentum=0.9), dev)
    step = D.DINOTrainStep(state, lr_fn, mom_fn, temp_fn, cfg,
                           compute_dtype=(torch.bfloat16
                                          if configs.get("enable_amp")
                                          else torch.float32), mesh=mesh)

    start_epoch = 0
    trainer_ckpt = os.path.join(model_dir, "trainer_state.pt")
    if configs.get("resume") and os.path.exists(trainer_ckpt):
        saved = torch.load(trainer_ckpt, map_location="cpu",
                           weights_only=True)
        step.load_state_dict(saved)
        start_epoch = int(saved["epoch"])
        logger.info(f"resumed trainer state at epoch {start_epoch} (step "
                    f"{step.step})")

    featurize = make_ssl_featurize(FbankConfig(num_mel_bins=feat_dim,
                                               dither=0.0),
                                   configs["dataset_args"],
                                   seed + 1_000_003 * stripe, device=dev)
    dataset, crop_aug = ssl_dataset(configs, stripe, num_stripes)
    sr = configs["dataset_args"].get("resample_rate", 16000)
    g_len = int(dino_args.get("global_chunk_sec", 2.0) * sr)
    l_len = int(dino_args.get("local_chunk_sec", 1.0) * sr)

    def crops():
        rng = np.random.default_rng(seed + 7717 * start_epoch)
        epoch = start_epoch
        while True:
            data = ssl_data.multi_crop(dataset._epoch_iter(epoch), g_len,
                                       l_len, n_global, n_local,
                                       aug_fn=crop_aug, rng=rng)
            yield from ssl_data.dino_batch(data, local_batch)
            epoch += 1

    log_interval = configs.get("log_batch_interval", 50)
    stop_epoch = min(num_epochs, configs.get("stop_epoch") or num_epochs)
    with Prefetcher(crops()) as prefetch:
        batches = iter(prefetch)
        for epoch in range(start_epoch, stop_epoch):
            t0 = time.time()
            for _ in range(epoch_iter):
                b = next(batches)
                it = step.step
                metrics = step({"global_feat": featurize(b["global_wav"]),
                                "local_feat": featurize(b["local_wav"])})
                if it % log_interval == 0:
                    logger.info(
                        f"epoch {epoch} it {it} loss "
                        f"{float(metrics['loss']):.4f} lr {metrics['lr']:.5f} "
                        f"m {metrics['momentum']:.4f} temp "
                        f"{metrics['teacher_temp']:.3f}")
            logger.info(f"epoch {epoch} done in {time.time() - t0:.1f}s")
            if mesh.rank == 0:
                ckpt.save_checkpoint(os.path.join(model_dir,
                                                  f"model_{epoch}.pt"),
                                     step.teacher.backbone)
                tmp = f"{trainer_ckpt}.tmp"
                torch.save({**step.state_dict(), "epoch": epoch + 1}, tmp)
                os.replace(tmp, trainer_ckpt)
            barrier(mesh, dev)
    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    train_dino(args.config, args.overrides, device=args.device)


if __name__ == "__main__":
    main()
