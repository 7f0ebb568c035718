"""Profiling and speed-of-light accounting on torch.profiler.

Counterpart of wespeaker_tpu/utils/profiling.py, which captures a
jax.profiler timeline and takes FLOP and byte counts from XLA's cost
analysis. Here:

- `trace(log_dir)` captures a torch.profiler timeline (host and, with a
  card, CUDA activity) and writes it as a Chrome trace JSON that
  chrome://tracing and Perfetto open;
- `cost_analysis(fn, *args)` is the port's own count, not XLA's: FLOPs by
  `torch.utils.flop_counter.FlopCounterMode` (matrix products and
  convolutions only; elementwise work and the port's own CUDA kernels,
  which PyTorch does not see, are not counted) and bytes as the tensors
  the call reads (its arguments, once) and writes (its outputs, once);
- `sol_report(fn, *args)` times the call on the card with CUDA events
  after warm-up and divides by the H100 peaks of bin/kernel_bounds.py;
- `StepWindow` is the trainer's `profile_args: {start_step, num_steps,
  log_dir}`: a trace of global steps [start, start + num) into
  `exp_dir/profile`, as the JAX trainer captures one.
"""

import contextlib
import os
from typing import Callable, Dict, Optional

import torch

from wespeaker_tpu_torch.bin.kernel_bounds import (PEAK_BF16_FLOPS,
                                                   PEAK_BYTES,
                                                   PEAK_F32_FLOPS)


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace"):
    """Profile the block; on exit write `<log_dir>/<name>.json` (Chrome
    trace format). Yields the torch.profiler.profile object."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """{"flops", "bytes_accessed"} of one call of fn(*args), under
    no_grad: FlopCounterMode's count and the bytes of the arguments and
    outputs (see the module docstring for what is left out)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        out = fn(*args)
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": float(_nbytes(args) + _nbytes(out))}


def sol_report(fn: Callable, *args, iters: int = 20,
               warmup: int = 3) -> Dict[str, float]:
    """Time fn(*args) on the card (CUDA events over `iters` calls after
    `warmup`) and report the achieved rates and their fractions of the
    H100's peaks (bf16 or f32 by the first floating argument, and HBM).
    Raises unless the arguments lie on a CUDA device: there is no CPU
    timing under these names."""
    tensors = list(_tensors(args))
    if not tensors or any(t.device.type != "cuda" for t in tensors):
        raise ValueError("sol_report times on the card: pass CUDA tensors")
    costs = cost_analysis(fn, *args)
    with torch.no_grad():
        for _ in range(warmup):
            fn(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
    dt = start.elapsed_time(end) / 1e3 / iters
    low = any(t.dtype in (torch.bfloat16, torch.float16) for t in tensors
              if t.is_floating_point())
    peak = PEAK_BF16_FLOPS if low else PEAK_F32_FLOPS
    return {"device": torch.cuda.get_device_name(tensors[0].device),
            "seconds_per_call": dt,
            "achieved_tflops": costs["flops"] / dt / 1e12,
            "achieved_gbps": costs["bytes_accessed"] / dt / 1e9,
            "sol_compute_fraction": costs["flops"] / dt / peak,
            "sol_memory_fraction": costs["bytes_accessed"] / dt / PEAK_BYTES}


class StepWindow:
    """The trainer's `profile_args`, as a context manager around the step
    loop: call `before(gstep)` before each step (gstep counts the steps
    this process runs, from 0). The profiler starts before step
    `start_step` and stops before step `start_step + num_steps` (or when
    the loop ends), each time after the card has finished its queued
    work, and writes `<log_dir>/steps_<start>-<stop>.json`. No
    `start_step`: it does nothing."""

    def __init__(self, profile_args: Optional[dict], exp_dir: str,
                 device: Optional[torch.device] = None):
        args = profile_args or {}
        self.start = args.get("start_step")
        self.stop = (None if self.start is None
                     else self.start + args.get("num_steps", 5))
        self.log_dir = args.get("log_dir", os.path.join(exp_dir, "profile"))
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.prof = None
        self.path = None
        self.next = 0

    def __enter__(self) -> "StepWindow":
        return self

    def __exit__(self, *exc) -> None:
        if self.prof is not None:
            self._finish(self.next)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def before(self, gstep: int) -> None:
        self.next = gstep + 1
        if self.prof is None and self.path is None and gstep == self.start:
            self._sync()
            os.makedirs(self.log_dir, exist_ok=True)
            self.prof = torch.profiler.profile(activities=_activities())
            self.prof.__enter__()
        elif self.prof is not None and gstep == self.stop:
            self._finish(gstep)

    def _finish(self, gstep: int) -> None:
        self._sync()
        self.prof.__exit__(None, None, None)
        self.path = os.path.join(self.log_dir,
                                 f"steps_{self.start}-{gstep}.json")
        self.prof.export_chrome_trace(self.path)
        self.prof = None
