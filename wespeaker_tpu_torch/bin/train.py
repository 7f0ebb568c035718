"""Supervised trainer CLI on the card.

    python -m wespeaker_tpu_torch.bin.train --config conf.yaml \
        [--device cuda|cpu] [k=v overrides]

Counterpart of wespeaker_tpu/bin/train.py (upstream
wespeaker/bin/train.py:39-266): config and overrides, spk2id from
utt2spk, the raw/shard/feat dataset with the recipes' MUSAN/RIR stores
(`noise_data`, `reverb_data`: packed stores from `bin/prep_data.py
aug_store`; `aug_prob` of the chunks augmented on the host or, with
`dataset_args.device_aug`, on the card), `dataloader_args.num_workers`
spawned worker processes (data/dataset.py::MPPrefetcher; 0 is one
thread), the model and any head of models/projections.py (3x classes
under speed perturb; `do_lm` keeps them), iteration-granular LR and
margin schedules with
scale_ratio = batch / 64, fbank and spec-aug on the device (or the tfmel
frontend with its own masks, train/composite.py::featurizers), bf16 AMP with
`enable_amp`, a `checkpoint` (resume) or `model_init` (weights only) load, from the
port's `.pt` or the JAX package's `.ckpt` (a JAX DINO checkpoint's teacher
backbone for `model_init`, the cnceleb v3_finetune entry),
a log line every `log_batch_interval` steps, `models/model_<epoch>.pt`
every `save_epoch_interval` epochs (and the last `num_avg`), the
`final_model.pt` symlink, and on SIGTERM `preempt_model_<epoch>.pt` after
the step in flight. A resumed run continues the schedules at
start_epoch * epoch_iter, as upstream does. `conv_dw_mode` (native, the
default, or packed) sets the process-wide mode of `ops.conv_dw_pack`, as
the JAX trainer does: packed computes the filter gradient of every
eligible 3x3 conv (stride 1, Ci and Co <= 64) with the tap-packed kernel.

The neural frontends (`dataset_args.frontend` whisper_encoder, wavlm /
s3prl / hubert / wav2vec2, w2vbert, feat_stack; train/composite.py) run
inside the step through their train hook; the model is built on the
card. A frozen frontend (`<frontend>_args.frozen`) runs under no_grad and
its parameters stay out of the optimizer, as the JAX trainer masks them.
The wav frontends' chunk length comes from `fbank_args.frame_shift` and
`frame_length` (20 ms for WavLM), as in the JAX trainer.

`profile_args: {start_step, num_steps, log_dir}` writes a torch.profiler
trace of global steps [start, start + num) of this process, by default to
`exp_dir/profile/steps_<start>-<stop>.json` (utils/profiling.py), as the
JAX trainer captures a jax.profiler timeline of them.

Several ranks (parallel/mesh.py) train one global batch as the JAX
trainer does over its mesh: `distributed_args` {coordinator: host:port,
num_processes, process_id} (the JAX package's keys), or a `torchrun
--nproc_per_node N` launch; one rank a card, NCCL between cards, or gloo
when the caller passes backend="gloo" (two ranks on one card).
`dataset_args.batch_size` is each data rank's and the global batch that
times the data ranks; the epoch's steps and the LR scale come
from the global batch; each data rank loads its stripe of the list (the
ranks of one model group the same one); BatchNorm statistics, gradients,
loss and accuracy are the global batch's (train/train_step.py).
`parallel_args.model` > 1 pads the classes to a multiple of it and
splits the margin head's rows over each model group
(models/projections.py::shard_rows). Rank 0 alone logs, dumps
config.yaml and writes checkpoints (the whole head gathered); every rank
resumes from them; the SIGTERM save is a collective.
"""

import argparse
import contextlib
import logging
import os
import signal
import threading
import time

import torch

from wespeaker_tpu_torch.data.dataset import (MPPrefetcher, Prefetcher,
                                              SpeakerDataset)
from wespeaker_tpu_torch.data.pipeline import spk2id_from_utt2spk
from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.frontend.fbank import FbankConfig
from wespeaker_tpu_torch.models.projections import get_projection, shard_rows
from wespeaker_tpu_torch.ops.conv_dw_pack import set_conv_dw_mode
from wespeaker_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                               process_data_stripe)
from wespeaker_tpu_torch.train.composite import (build_model, featurizers,
                                                 jax_init_)
from wespeaker_tpu_torch.train.optim import lr_scale_ratio
from wespeaker_tpu_torch.train.train_step import (AugConfig,
                                                  build_train_state,
                                                  make_train_step)
from wespeaker_tpu_torch.utils import checkpoint as ckpt
from wespeaker_tpu_torch.utils import profiling
from wespeaker_tpu_torch.utils.config import dump_yaml, parse_config_or_kwargs
from wespeaker_tpu_torch.utils.schedulers import (MarginScheduler,
                                                  get_lr_scheduler)


def setup_logger(exp_dir, rank: int = 0):
    """The trainer's logger: to exp_dir/train.log and the console on rank
    0; other ranks log warnings to the console only."""
    os.makedirs(exp_dir, exist_ok=True)
    logger = logging.getLogger("wespeaker_tpu_torch")
    if rank != 0:
        logger.setLevel(logging.WARNING)
        return logger
    logger.setLevel(logging.INFO)
    log_file = os.path.join(exp_dir, "train.log")
    if not any(getattr(h, "baseFilename", None) == os.path.abspath(log_file)
               for h in logger.handlers):
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        handlers = [logging.FileHandler(log_file)]
        if not logger.handlers:
            handlers.append(logging.StreamHandler())
        for h in handlers:
            h.setFormatter(fmt)
            logger.addHandler(h)
    return logger


def build_projection(configs, num_class):
    proj_conf = dict(configs.get("projection_args", {}))
    proj_conf.setdefault("project_type", "arc_margin")
    proj_conf["embed_dim"] = configs["model_args"]["embed_dim"]
    proj_conf["num_class"] = num_class
    proj_conf.setdefault("scale", 32.0)
    proj_conf.setdefault("easy_margin", False)
    proj_conf.setdefault("do_lm", configs.get("do_lm", False))
    # the Linear head's Dense starts as flax's; the margin heads hold no
    # Linear and keep their own draws
    return jax_init_(get_projection(proj_conf))


def train(config: str, overrides=None, device: DeviceLike = None,
          backend: str = None, **kwargs):
    """Run the training of `config` on `device` (the card unless the caller
    passes device="cpu"). Returns the TrainStep (modules, optimizer, step
    count). `backend` chooses the ranks' collective backend (NCCL on the
    card, gloo on the CPU by default; "gloo" puts two ranks on one card)."""
    configs = parse_config_or_kwargs(config, overrides, **kwargs)
    dev = resolve_device(device)
    dist_args = configs.get("distributed_args") or {}
    rank, _ = init_distributed(dist_args.get("coordinator"),
                               dist_args.get("num_processes"),
                               dist_args.get("process_id"),
                               backend=backend, device=dev.type)
    mesh = make_mesh(configs.get("parallel_args", {}).get("model", 1))
    set_conv_dw_mode(configs.get("conv_dw_mode", "native"))
    exp_dir = configs["exp_dir"]
    model_dir = os.path.join(exp_dir, "models")
    os.makedirs(model_dir, exist_ok=True)
    logger = setup_logger(exp_dir, rank)

    spk2id = spk2id_from_utt2spk(configs["spk2id"] if "spk2id" in configs
                                 else configs["utt2spk"])
    dataset_args = configs["dataset_args"]
    lm_keep_3x = False
    if configs.get("do_lm") and configs["data_type"] != "feat" \
            and dataset_args.get("speed_perturb", True):
        # large-margin fine-tune from a speed-perturbed checkpoint: keep the
        # 3x classifier rows, train without speed perturb
        logger.info("do_lm: speed perturb disabled, classifier keeps 3x rows")
        dataset_args = {**dataset_args, "speed_perturb": False}
        lm_keep_3x = True
    if configs["data_type"] == "feat":
        # the feat parser joins scp rows to speakers itself
        dataset_args = {**dataset_args, "utt2spk": configs["utt2spk"]}
    ds_args = (configs["data_type"], configs["train_data"], dataset_args,
               spk2id)
    stripe, num_stripes = process_data_stripe(mesh)
    ds_kwargs = dict(reverb_store_prefix=configs.get("reverb_data"),
                     noise_store_prefix=configs.get("noise_data"),
                     rank=stripe, world_size=num_stripes,
                     seed=configs.get("seed", 42))
    dataset = SpeakerDataset(*ds_args, **ds_kwargs)
    num_class = dataset.num_classes() * (3 if lm_keep_3x else 1)
    if num_class % mesh.model:
        # the head's rows split evenly over the model axis; padded rows are
        # never targets and train as always-negative classes (JAX's)
        num_class = -(-num_class // mesh.model) * mesh.model
    logger.info(f"speakers: {len(spk2id)} classes: {num_class} device: "
                f"{dev} ranks: {mesh.world} (data {mesh.data} x model "
                f"{mesh.model})")

    start_epoch = 0

    def prepare(model, projection):
        # loads before the head is split, so a checkpoint holds all rows
        if configs.get("model_init"):
            # weights only, fresh head and schedules (the SSL fine-tune
            # entry)
            ckpt.load_checkpoint(configs["model_init"], model)
            logger.info(f"initialized model from {configs['model_init']}")
        if configs.get("checkpoint"):
            ckpt.load_checkpoint(configs["checkpoint"], model, projection)
        shard_rows(projection, mesh.model_group)

    seed = configs.get("seed", 42)
    model, projection, optimizer, generator = build_train_state(
        lambda: (build_model(configs, device=dev),
                 build_projection(configs, num_class)),
        configs, seed=seed, device=dev, stripe=stripe, prepare=prepare)

    batch_size = dataset_args.get(
        "batch_size", configs.get("dataloader_args", {}).get("batch_size",
                                                             64))
    # the batch splits over the data axis only; a model group shares rows
    global_batch = batch_size * mesh.data
    num_epochs = configs.get("num_epochs", 10)
    num_samples = configs.get("samples_per_epoch")
    if num_samples is None:
        with open(configs["train_data"]) as f:
            num_samples = sum(1 for _ in f)
        if configs["data_type"] == "shard":
            num_samples *= 1000
    epoch_iter = max(num_samples // global_batch, 1)

    sched_args = dict(configs.get("scheduler_args", {}))
    sched_args.setdefault("initial_lr", 0.1)
    sched_args.setdefault("final_lr", 5e-5)
    sched_args.setdefault("warm_up_epoch", 6)
    sched_args["num_epochs"] = num_epochs
    sched_args["epoch_iter"] = epoch_iter
    sched_args["scale_ratio"] = lr_scale_ratio(1, global_batch)
    lr_fn = get_lr_scheduler(configs.get("scheduler", "ExponentialDecrease"),
                             **sched_args)
    margin_args = dict(configs.get("margin_scheduler_args",
                                   configs.get("margin_update", {})))
    margin_fn = MarginScheduler(
        epoch_iter=epoch_iter,
        increase_start_epoch=margin_args.get("increase_start_epoch", 20),
        fix_start_epoch=margin_args.get("fix_start_epoch", 40),
        initial_margin=margin_args.get("initial_margin", 0.0),
        final_margin=margin_args.get("final_margin", 0.2),
        increase_type=margin_args.get("increase_type", "exp"))

    fbank_args = dataset_args.get("fbank_args", {})
    fbank_cfg = FbankConfig(
        num_mel_bins=fbank_args.get("num_mel_bins",
                                    configs["model_args"].get("feat_dim",
                                                              80)),
        frame_length_ms=fbank_args.get("frame_length", 25),
        frame_shift_ms=fbank_args.get("frame_shift", 10),
        sample_rate=dataset_args.get("resample_rate", 16000),
        dither=fbank_args.get("dither", 1.0))
    aug = AugConfig.from_spec_aug_args(
        dataset_args.get("spec_aug_args", {}),
        enabled=dataset_args.get("spec_aug", True))
    step = make_train_step(
        model, projection, optimizer, lr_fn, margin_fn, fbank_cfg, aug,
        compute_dtype=(torch.bfloat16 if configs.get("enable_amp")
                       else torch.float32),
        device=dev, generator=generator,
        featurize_fn=featurizers(configs)[0], mesh=mesh)

    if configs.get("checkpoint"):
        start_epoch = ckpt.parse_start_epoch(configs["checkpoint"])
        step.step = start_epoch * epoch_iter
        logger.info(f"resumed from {configs['checkpoint']} at epoch "
                    f"{start_epoch}")

    if rank == 0:
        dump_yaml({**configs, "num_class": num_class,
                   "epoch_iter": epoch_iter},
                  os.path.join(exp_dir, "config.yaml"))

    def save(path):
        # every rank joins (the head's rows are gathered); rank 0 writes
        ckpt.save_checkpoint_collective(path, model, projection, mesh, dev)

    log_interval = configs.get("log_batch_interval", 100)
    save_interval = configs.get("save_epoch_interval", 1)
    num_avg = configs.get("num_avg", 1)
    gstep = 0
    with _sigterm_event() as event, _any_rank(event, mesh) as preempted, \
            _batches(ds_args, ds_kwargs, dataset, batch_size,
                     configs.get("dataloader_args", {})) as batches, \
            profiling.StepWindow(configs.get("profile_args") if rank == 0
                                 else None, exp_dir, dev) as window:
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            for it in range(epoch_iter):
                window.before(gstep)
                metrics = step(next(batches))
                gstep += 1
                if it % log_interval == 0:
                    logger.info(
                        f"epoch {epoch} it {it}/{epoch_iter} "
                        f"loss {float(metrics['loss']):.4f} "
                        f"acc {float(metrics['acc']):.4f} "
                        f"lr {metrics['lr']:.6f} "
                        f"margin {metrics['margin']:.3f}")
                if preempted():
                    path = os.path.join(model_dir,
                                        f"preempt_model_{epoch}.pt")
                    save(path)
                    logger.info(f"SIGTERM: saved {path} at epoch {epoch} "
                                f"it {it}; resume with checkpoint={path}")
                    return step
            logger.info(f"epoch {epoch} done in {time.time() - t0:.1f}s")
            # every save_interval epochs plus the last num_avg (upstream
            # counts epochs from 1, this loop from 0)
            if ((epoch + 1) % save_interval == 0
                    or epoch + 1 > num_epochs - num_avg):
                save(os.path.join(model_dir, f"model_{epoch}.pt"))
    last = os.path.join(model_dir, f"model_{num_epochs - 1}.pt")
    if rank == 0 and num_epochs > start_epoch and os.path.exists(last):
        final = os.path.join(model_dir, "final_model.pt")
        if os.path.lexists(final):
            os.remove(final)
        os.symlink(os.path.basename(last), final)
    return step


@contextlib.contextmanager
def _any_rank(event: threading.Event, mesh):
    """-> poll(): whether `event` (SIGTERM) was set on any rank, so that
    every rank joins the save at the same step. One process reads its
    event. Over several ranks each poll starts an all_reduce of this
    rank's flag over a gloo group of host tensors and returns the one
    that the poll before started: the host never waits for the device,
    and every rank reads the same answer one step after the signal."""
    if mesh.world == 1:
        yield event.is_set
        return
    group = torch.distributed.new_group(backend="gloo")
    pending = []

    def poll() -> bool:
        seen = False
        if pending:
            work, flag = pending.pop()
            work.wait()
            seen = flag.item() > 0
        flag = torch.tensor([float(event.is_set())])
        pending.append((torch.distributed.all_reduce(
            flag, group=group, async_op=True), flag))
        return seen

    try:
        yield poll
    finally:
        for work, _ in pending:
            work.wait()


@contextlib.contextmanager
def _batches(ds_args, ds_kwargs, dataset, batch_size, loader_args):
    """The trainer's batch iterator: `num_workers` spawned worker processes
    (MPPrefetcher) or, with none, one thread over `dataset` (Prefetcher);
    either is ended on exit."""
    workers = loader_args.get("num_workers", 0)
    if workers <= 0:
        with Prefetcher(dataset.batches(batch_size)) as prefetch:
            yield iter(prefetch)
        return
    prefetch = MPPrefetcher(ds_args, ds_kwargs, batch_size,
                            num_workers=workers,
                            depth=loader_args.get("prefetch", 4))
    try:
        yield iter(prefetch)
    finally:
        prefetch.close()


@contextlib.contextmanager
def _sigterm_event():
    """An event that SIGTERM (maintenance, rescheduling) sets: the trainer
    finishes the step in flight, saves preempt_model_<epoch>.pt and
    returns; resume with that checkpoint. The caller's handler is restored
    on exit. Off the main thread no handler can be installed, and the event
    stays clear."""
    event = threading.Event()
    if threading.current_thread() is not threading.main_thread():
        yield event
        return
    old = signal.signal(signal.SIGTERM, lambda s, f: event.set())
    try:
        yield event
    finally:
        signal.signal(signal.SIGTERM, old)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    train(args.config, args.overrides, device=args.device)


if __name__ == "__main__":
    main()
