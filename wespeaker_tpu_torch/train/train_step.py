"""The supervised training step and the embedding-extraction forward.

Counterpart of wespeaker_tpu/train/train_step.py. One step is

    wav chunk (-> reverb/noise on the card) -> x 2^15 + dither -> fbank
    -> CMVN -> spec-aug -> speaker model -> head -> loss -> backward ->
    optimizer step

with the LR and margin schedules evaluated on the host from the step
counter. AMP is the JAX package's (`amp_cast`): parameters stay f32, the
modules cast them to the activation type (models/layers.py), and their
gradients come back f32; features are computed in f32 and only then cast
to the compute type, so no autocast region is needed. Random numbers
(dither, spec-aug) come from an explicit torch.Generator on the device;
they are not JAX's numbers, only the same distributions. A `feat` batch
(precomputed features) skips the fbank: CMVN and spec-aug only. A batch
with the device-aug fields of data/pipeline.py::attach_device_aug is
augmented on its device first (train/device_aug.py). The loss is the
head's own where it returns (logits, loss) (SphereFace2), else softmax
cross-entropy; a head with BatchNorm (the Linear head) runs in train mode
and keeps its running statistics.

Across ranks (parallel/mesh.py) the step follows the JAX package's
global batch: the BatchNorms normalise by the statistics over the data
group, and after the backward one all_reduce averages the gradients, the
loss and the accuracy over it (parallel/collect.py::mean_gradients). That
is chosen over torch's DistributedDataParallel because the step's
parameters are two modules, one of which (a model-axis head) must not be
averaged over the model group, DINO clips the averaged gradients, and
one explicit collective, with no bucketing and no buffer broadcast,
keeps the ranks' parameters and buffers bit-identical by construction.
"""

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from wespeaker_tpu_torch.device import DeviceLike, resolve_device
from wespeaker_tpu_torch.frontend.fbank import (FbankConfig, apply_cmvn,
                                                compute_fbank)
from wespeaker_tpu_torch.train.composite import _sample_to_frame_mask
from wespeaker_tpu_torch.train.device_aug import device_augment
from wespeaker_tpu_torch.parallel.collect import mean_gradients
from wespeaker_tpu_torch.parallel.mesh import Mesh, global_batch_stats
from wespeaker_tpu_torch.train.optim import make_optimizer


def _on(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class AugConfig:
    """Spec-aug on the device (upstream processor.py:550-587)."""
    spec_aug: bool = True
    spec_aug_prob: float = 0.6
    num_t_mask: int = 1
    num_f_mask: int = 1
    max_t: int = 10
    max_f: int = 8

    @classmethod
    def from_spec_aug_args(cls, args, enabled: bool = True) -> "AugConfig":
        """Build from a config dict, accepting the upstream YAML key `prob`
        for spec_aug_prob. Unknown keys raise."""
        args = dict(args or {})
        if "prob" in args:
            args["spec_aug_prob"] = args.pop("prob")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(args) - known)
        if unknown:
            raise ValueError(f"unknown spec_aug_args keys {unknown}; "
                             f"supported: {sorted(known)}")
        return cls(spec_aug=enabled, **args)


def spec_aug_batch(generator: torch.Generator, feat: torch.Tensor,
                   cfg: AugConfig) -> torch.Tensor:
    """Random time and frequency masking with the per-utterance semantics
    of the reference: with probability spec_aug_prob an utterance gets
    num_t_mask time masks and num_f_mask frequency masks, each starting at
    U[0, dim - 1] with width U[1, max]."""
    b, t, f = feat.shape
    dev = feat.device

    def rand_int(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    apply = torch.rand((b, 1, 1), generator=generator,
                       device=dev) < cfg.spec_aug_prob

    def keep_axis(dim, max_w, count):
        start = rand_int(0, dim, (b, count, 1))
        width = rand_int(1, max_w + 1, (b, count, 1))
        pos = torch.arange(dim, device=dev)[None, None, :]
        hit = (pos >= start) & (pos < start + width)     # (b, count, dim)
        return ~hit.any(dim=1)                           # (b, dim)

    keep = (keep_axis(t, cfg.max_t, cfg.num_t_mask)[:, :, None]
            & keep_axis(f, cfg.max_f, cfg.num_f_mask)[:, None, :])
    return torch.where(apply & ~keep, torch.zeros_like(feat), feat)


def dither_wav(wav: torch.Tensor, amount: float,
               generator: torch.Generator) -> torch.Tensor:
    """wav + amount * N(0, 1) per sample, on the waveform (x 2^15) rather
    than per kaldi frame, so overlapping windows see the same noise; a
    regulariser either way, and evaluation runs without it."""
    return wav + amount * torch.randn(wav.shape, generator=generator,
                                      device=wav.device)


def features_from_batch(batch: Dict[str, Any], fbank_cfg: FbankConfig,
                        aug: Optional[AugConfig],
                        generator: Optional[torch.Generator], train: bool,
                        device: torch.device,
                        featurize_fn: Optional[Callable] = None
                        ) -> torch.Tensor:
    """{'wav': (B, N) in [-1, 1]} or {'feat': (B, T, F)} -> (B, T, F) f32
    normalised features. In training a wav batch with the device-aug
    fields (`aug_mode`, `aug_rir`, `aug_noise`, `aug_snr`) is augmented
    first (device_augment, one block), then dither is added to the
    waveform (after x 2^15) so the fused DFT-conv fbank stays usable;
    spec-aug follows CMVN. A `featurize_fn(wav, generator)` (a non-fbank
    frontend's train hook, train/composite.py::featurizers) replaces the
    whole chain, as the JAX package's featurize_fn does; it takes the
    batch's "feat" where there is one (feat_stack), else its "wav"."""
    if featurize_fn is not None:
        return featurize_fn(_on(batch["feat"] if "feat" in batch
                                else batch["wav"], device), generator)
    if "feat" in batch:
        feat = _on(batch["feat"], device)
    else:
        wav = _on(batch["wav"], device)
        if train and "aug_mode" in batch:
            # the store's int16 stays int16 until the card converts it
            wav = device_augment(
                wav, *(_on(batch[k], device, dtype=None)
                       for k in ("aug_mode", "aug_rir", "aug_noise")),
                _on(batch["aug_snr"], device))
        wav = wav * (1 << 15)
        if train and fbank_cfg.dither != 0.0:
            wav = dither_wav(wav, fbank_cfg.dither, generator)
            fbank_cfg = dataclasses.replace(fbank_cfg, dither=0.0)
        feat = compute_fbank(wav, fbank_cfg)
    feat = apply_cmvn(feat)
    if train and aug is not None and aug.spec_aug:
        feat = spec_aug_batch(generator, feat, aug)
    return feat


class TrainStep:
    """batch -> metrics {loss, acc, lr, margin}; updates the modules and
    the optimizer in place and counts steps in `step`. loss and acc are
    device tensors (reading them synchronises), lr and margin floats; over
    a `mesh` of more than one data rank, the means over the global batch.
    `global_stats=False` keeps each rank's BatchNorm statistics its own,
    which the JAX package never does: tests use it to show the
    difference."""

    def __init__(self, model: nn.Module, projection: nn.Module,
                 optimizer: torch.optim.Optimizer, lr_fn: Callable,
                 margin_fn: Callable, fbank_cfg: FbankConfig,
                 aug: Optional[AugConfig], compute_dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator,
                 step: int = 0, featurize_fn: Optional[Callable] = None,
                 mesh: Optional[Mesh] = None, global_stats: bool = True):
        self.mesh = mesh or Mesh()
        if global_stats:
            global_batch_stats([model, projection], self.mesh.data_group)
        self.params = [p for group in optimizer.param_groups
                       for p in group["params"]]
        self.model, self.projection = model, projection
        self.optimizer = optimizer
        self.lr_fn, self.margin_fn = lr_fn, margin_fn
        self.fbank_cfg, self.aug = fbank_cfg, aug
        self.featurize_fn = featurize_fn
        self.compute_dtype, self.device = compute_dtype, device
        self.generator = generator
        self.step = step

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        lr, margin = float(self.lr_fn(self.step)), float(
            self.margin_fn(self.step))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.model.train()
        self.projection.train()
        label = _on(batch["label"], self.device, torch.long)
        feat = features_from_batch(batch, self.fbank_cfg, self.aug,
                                   self.generator, True, self.device,
                                   self.featurize_fn)
        embed = self.model(feat.to(self.compute_dtype)).float()
        out = self.projection(embed, label, margin)
        if isinstance(out, tuple):
            logits, loss = out
        else:
            logits, loss = out, F.cross_entropy(out, label)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        acc = (logits.detach().argmax(dim=-1) == label).float().mean()
        loss, acc = mean_gradients(self.params, self.mesh.data_group,
                                   loss.detach(), acc)
        self.optimizer.step()
        self.step += 1
        return {"loss": loss, "acc": acc, "lr": lr, "margin": margin}


def make_train_step(model: nn.Module, projection: nn.Module,
                    optimizer: torch.optim.Optimizer, lr_fn: Callable,
                    margin_fn: Callable,
                    fbank_cfg: FbankConfig = FbankConfig(dither=1.0),
                    aug: Optional[AugConfig] = AugConfig(),
                    compute_dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None,
                    featurize_fn: Optional[Callable] = None,
                    mesh: Optional[Mesh] = None,
                    global_stats: bool = True) -> TrainStep:
    """The train step on `device` (the card unless the caller passes
    device="cpu"); the modules are moved there. `generator` (on that
    device) drives dither and spec-aug (or the frontend's masks); a fresh
    unseeded one if None. `featurize_fn(wav, generator)` replaces the
    fbank chain (features_from_batch). `mesh` and `global_stats`: see
    TrainStep."""
    dev = resolve_device(device)
    model.to(dev)
    projection.to(dev)
    if generator is None:
        generator = torch.Generator(device=dev)
    return TrainStep(model, projection, optimizer, lr_fn, margin_fn,
                     fbank_cfg, aug, compute_dtype, dev, generator,
                     featurize_fn=featurize_fn, mesh=mesh,
                     global_stats=global_stats)


def build_train_state(build_modules: Callable[[], Tuple[nn.Module,
                                                        nn.Module]],
                      optimizer_conf: Dict[str, Any], seed: int = 42,
                      device: DeviceLike = None, stripe: int = 0,
                      prepare: Optional[Callable] = None):
    """The role of the JAX init_train_state: seed torch from `seed`, build
    (model, projection) with build_modules() (on the CPU, unless it
    builds them elsewhere), `prepare(model, projection)` them if given
    (a resume's load, the model-axis head's rows), move them to `device`,
    make the optimizer over their parameters that require gradients (a
    frozen frontend's do not), and a generator on the device seeded from
    (`seed`, `stripe`): the ranks of one data stripe (parallel/mesh.py)
    draw the same dither and masks, other stripes others. Returns (model,
    projection, optimizer, generator)."""
    dev = resolve_device(device)
    torch.manual_seed(seed)
    model, projection = build_modules()
    if prepare is not None:
        prepare(model, projection)
    model.to(dev)
    projection.to(dev)
    # a frozen frontend's parameters (requires_grad=False) stay out
    optimizer = make_optimizer(optimizer_conf, [
        p for p in list(model.parameters()) + list(projection.parameters())
        if p.requires_grad])
    generator = torch.Generator(device=dev).manual_seed(
        seed + 1_000_003 * stripe)
    return model, projection, optimizer, generator


def make_eval_embed_fn(model: nn.Module,
                       fbank_cfg: FbankConfig = FbankConfig(),
                       compute_dtype=torch.float32, fbank_conv_dtype=None,
                       device: DeviceLike = None, from_wav: bool = True,
                       featurize_fn: Optional[Callable] = None
                       ) -> Callable[[Dict[str, Any]], torch.Tensor]:
    """Batch -> (B, D) f32 embeddings, as wespeaker/bin/extract.py computes
    them: no augmentation, no dither, CMVN on. `model` is moved to
    `device` (the card unless the caller passes device="cpu") and put in
    eval mode; its parameters stay f32 (each layer casts them to the
    activations' type per call), activations run in compute_dtype.

    from_wav=True: {"wav": (B, N) in [-1, 1], optional "mask": (B, N)
    sample validity} -> fbank (the sample mask becomes a frame mask).
    from_wav=False: {"feat": (B, T, F) features, optional "mask": (B, T)
    frame validity}, as the `feat` data type's extraction passes them.
    Either way masked CMVN, then the model. Numpy arrays or tensors.
    `featurize_fn(wav, sample mask or None) -> (feat, frame mask or None)`
    (a non-fbank frontend's eval hook, train/composite.py::featurizers)
    replaces the fbank and CMVN, as the JAX version's does; it takes the
    batch's "wav", or its "feat" with from_wav=False (feat_stack)."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def embed_fn(batch: Dict[str, Any]) -> torch.Tensor:
        with torch.inference_mode():
            mask = batch.get("mask")
            if featurize_fn is not None:
                feat, fmask = featurize_fn(
                    _on(batch["wav" if from_wav else "feat"], dev),
                    None if mask is None else _on(mask, dev))
                return model(feat.to(compute_dtype), fmask).float()
            if from_wav:
                wav = _on(batch["wav"], dev) * (1 << 15)
                feat = compute_fbank(wav, fbank_cfg,
                                     conv_dtype=fbank_conv_dtype)
                fmask = None if mask is None else _sample_to_frame_mask(
                    _on(mask, dev), feat.shape[-2], fbank_cfg.window_shift,
                    fbank_cfg.window_size)
            else:
                feat = _on(batch["feat"], dev)
                fmask = None if mask is None else _on(mask, dev)
            feat = apply_cmvn(feat, mask=fmask).to(compute_dtype)
            return model(feat, fmask).float()

    return embed_fn
