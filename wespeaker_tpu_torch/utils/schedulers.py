"""Iteration-granular LR and margin schedules as step -> float functions.

Counterpart of wespeaker_tpu/utils/schedulers.py (upstream
wespeaker/utils/schedulers.py: MarginScheduler:20,
WarmupLR_withStepDecay:96, WarmupCosineScheduler:171, BaseClass:247,
ExponentialDecrease:317, TriAngular2:339), including the world-size-aware
warm-up coefficient (:275-284). The trainer evaluates them on the host
each step and writes the values into the optimizer and the margin head.
"""

import dataclasses
import math


def multi_process_coeff(step: float, warm_up_iter: int, scale_ratio: float,
                        warm_from_zero: bool = False) -> float:
    """LR scaling warm-up for a large global batch: ramp the scale_ratio
    multiplier in over warm_up_iter iterations. From warm_up_iter on
    (every step when it is 0, as in a recipe with warm_up_epoch 0) the
    multiplier is scale_ratio, as the JAX package's jnp.where selects it
    past its ramp's division by zero."""
    if step >= warm_up_iter:
        return float(scale_ratio)
    if warm_from_zero:
        warm = scale_ratio * step / warm_up_iter
    elif scale_ratio > 1:
        warm = (scale_ratio - 1) * step / warm_up_iter + 1.0
    else:
        return float(scale_ratio)
    return warm


@dataclasses.dataclass(frozen=True)
class ExponentialDecrease:
    num_epochs: int
    epoch_iter: int
    initial_lr: float
    final_lr: float
    warm_up_epoch: int = 6
    scale_ratio: float = 1.0
    warm_from_zero: bool = False

    def __call__(self, step) -> float:
        step = float(step)
        max_iter = self.num_epochs * self.epoch_iter
        coeff = multi_process_coeff(step, self.warm_up_epoch * self.epoch_iter,
                                    self.scale_ratio, self.warm_from_zero)
        return coeff * self.initial_lr * math.exp(
            (step / max_iter) * math.log(self.final_lr / self.initial_lr))


@dataclasses.dataclass(frozen=True)
class TriAngular2:
    """Cyclic LR (arXiv:1506.01186) with per-cycle amplitude decay."""
    num_epochs: int
    epoch_iter: int
    initial_lr: float
    final_lr: float
    warm_up_epoch: int = 6
    scale_ratio: float = 1.0
    cycle_step: int = 2
    reduce_lr_diff_ratio: float = 0.5

    def __call__(self, step) -> float:
        step = float(step)
        cycle_iter = self.cycle_step * self.epoch_iter
        step_size = cycle_iter // 2
        max_lr0, min_lr = self.initial_lr, self.final_lr
        gap = max_lr0 - min_lr
        point = step % cycle_iter
        cycle_index = step // cycle_iter
        max_lr = min_lr + gap * self.reduce_lr_diff_ratio ** cycle_index
        if point <= step_size:
            lr = min_lr + (max_lr - min_lr) * point / step_size
        else:
            lr = max_lr - (max_lr - min_lr) * (point - step_size) / step_size
        coeff = multi_process_coeff(step, self.warm_up_epoch * self.epoch_iter,
                                    self.scale_ratio)
        return coeff * lr


@dataclasses.dataclass(frozen=True)
class WarmupLRStepDecay:
    """Linear warm-up then gamma^k staircase decay."""
    num_epochs: int
    epoch_iter: int
    initial_lr: float
    warmup_epoch: int = 1
    decay_epoch: int = 0
    gamma: float = 0.1
    scale_ratio: float = 1.0

    def __call__(self, step) -> float:
        step = float(step)
        warmup = self.warmup_epoch * self.epoch_iter
        decay = self.decay_epoch * self.epoch_iter
        if step < warmup:
            return self.initial_lr * (step + 1) / (warmup + 1)
        if decay > 0:
            return self.initial_lr * self.gamma ** math.floor(
                (step - warmup) / decay)
        return self.initial_lr


@dataclasses.dataclass(frozen=True)
class WarmupCosineScheduler:
    """Linear warm-up -> cosine to min_lr -> fixed."""
    num_epochs: int
    epoch_iter: int
    min_lr: float
    max_lr: float
    warmup_epoch: int = 1
    fix_epoch: int = 1000
    scale_ratio: float = 1.0

    def __call__(self, step) -> float:
        step = float(step)
        warmup = self.warmup_epoch * self.epoch_iter
        fix = self.fix_epoch * self.epoch_iter
        if step < warmup:
            return self.max_lr * step / max(warmup, 1)
        if step < fix:
            denom = max(fix - warmup, 1)
            return self.min_lr + 0.5 * (self.max_lr - self.min_lr) * (
                1 + math.cos(math.pi * (step - warmup) / denom))
        return self.min_lr


@dataclasses.dataclass(frozen=True)
class MarginScheduler:
    """Margin fixed -> (exp|linear) ramp -> fixed."""
    epoch_iter: int
    increase_start_epoch: int
    fix_start_epoch: int
    initial_margin: float
    final_margin: float
    increase_type: str = "exp"

    def __call__(self, step) -> float:
        step = float(step)
        inc_start = (self.increase_start_epoch - 1) * self.epoch_iter
        fix_start = (self.fix_start_epoch - 1) * self.epoch_iter
        if step < inc_start:
            return self.initial_margin
        if step >= fix_start:
            return self.final_margin
        inc_iter = max(fix_start - inc_start, 1)
        cur = step - inc_start
        if self.increase_type == "exp":
            initial_val, final_val = 1.0, 1e-3
            ratio = 1.0 - math.exp(
                (cur / inc_iter) * math.log(final_val / (initial_val + 1e-6))
            ) * initial_val
        else:
            ratio = cur / inc_iter
        return self.initial_margin + (
            self.final_margin - self.initial_margin) * ratio


SCHEDULERS = {
    "ExponentialDecrease": ExponentialDecrease,
    "TriAngular2": TriAngular2,
    "WarmupLR_withStepDecay": WarmupLRStepDecay,
    "WarmupCosineScheduler": WarmupCosineScheduler,
}


def get_lr_scheduler(name: str, **kwargs):
    """The trainer passes generic defaults (initial_lr, final_lr,
    warm_up_epoch) that not every scheduler declares; keep only the
    declared fields."""
    cls = SCHEDULERS[name]
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in kwargs.items() if k in fields})
