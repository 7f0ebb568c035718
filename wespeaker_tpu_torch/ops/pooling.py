"""Statistics pooling over T as CUDA kernels: ASTP's softmax-weighted mean
and std, and the masked mean and std of TSTP, TSDP and ASTP's global
context.

Replaces the Pallas kernels wespeaker_tpu/ops/pooling_pallas.py
(`fused_softmax_stats`, pallas_call at :62, `_softmax_stats_kernel`; and
`fused_masked_stats`, pallas_call at :113, `_masked_stats_kernel`). With
x (B, T, D), an optional (B, T) frame mask m, all math in f32:

    fused_softmax_stats(logits, x, mask):
        a = logits, -1e30 where m <= 0      (ASTP's torch.where, folded in)
        w = softmax over T of a
        mean = sum(w x);  std = sqrt(max(sum(w x^2) - mean^2, 1e-7))
    fused_masked_stats(x, mask, ddof):
        count = sum(m)                      (T when unmasked)
        mean = sum(x m) / max(count, 1)
        std = sqrt(sum((x - mean)^2 m) / max(count - ddof, 1) + 1e-7)

Both return mean and std (B, D) f32 as views of one (B, 2D) buffer
[mean | std], the concatenated layout of TSTP's and ASTP's output, or with
`concat=True` the buffer itself, so the pooling layers need no concat. An
utterance with no valid frame gets uniform softmax weights, as in JAX.

Row 6 is csrc/common.cuh's `softmax_stats_kernel`, the one the ECAPA tail
kernels run inside, reached through its own C entry point in
csrc/pooling.cu. It reads the logits and x once: a thread owns 8 bytes of
logits a frame (4 bf16 or 2 f32 channels of one utterance) and the same
channels of x, streamed past L1, 8 frames in flight, and keeps an online
softmax (a running max, and the sums of e, e x and e x^2 rescaled by
exp(m_old - m_new) where a batch of frames raises the max); T is split
across warps only where the (utterance, 32-column) items alone do not fill
the card, and the warps' parts merge by the same rescaling in warp order
(`softmax_plan`). Its grid is 1-D, so any B and D work, where the TPU
kernel asked for D % 128 == 0 and padded B to 8. Row 7 is
csrc/pooling.cu's `masked_stats_kernel`, which reads x once: a thread owns
4 bf16 (2 f32) channels of one utterance and reads them with 8-byte loads
streamed past L1, 16 frames in flight; T is split across warps only where
the (utterance, 128-channel) items alone do not fill the card; each part
keeps shifted sums of m (x - K) and m (x - K)^2 about K = x at the first
valid frame, and the parts combine by Chan's formula in a fixed order (raw
sums of x and x^2 would cancel where |mean| >> std). Its grid is 1-D, so
any B with B * ceil(D / 128) < 2^31 (bf16) launches. Neither has a
backward (nor had the TPU kernels): a CUDA input that requires grad
raises, and the layers take them only with autograd off. Each is the
custom op `wespeaker_tpu_torch::fused_softmax_stats` or `::
fused_masked_stats` (CPU: the plain version; CUDA: the kernel), so a
torch.export program of a model holds one node a call and launches the
kernel on the card.

Bound on an H100 at ReDimNetB2's pooling shape (B=512, T=200, D=1152,
bf16 logits and x): row 6 reads 472 MB and writes 4.7 MB, 0.142 ms at
3.35 TB/s against 0.014 ms of f32 arithmetic (0.213 ms with f32 logits);
row 7 reads 236 MB, 0.072 ms, and at ResNet34's TSTP shape (T' = 25,
D = 2560) 0.023 ms. Both are bound by bytes, and each reads its inputs
once.
"""

import ctypes
import functools
from typing import Optional

import torch

from wespeaker_tpu_torch.device import sm_count
from wespeaker_tpu_torch.ops import _build

_NEG_INF = -1e30
# row 6's launch (csrc/common.cuh): warps a block, frames a batch (the
# vector path; the scalar path takes 4), warps an SM
SOFTMAX_WARPS, SOFTMAX_FRAMES, SM_WARPS = 8, 8, 32


def softmax_plan(b: int, t: int, d: int, logit_bytes: int,
                 sms: Optional[int] = None):
    """Row 6's split of the work, as csrc/common.cuh's softmax_stats
    launcher makes it: (kc, chunks, tw) with kc = 8 // logit_bytes channels
    a thread, chunks = the 32-thread column groups of an utterance (items
    are (utterance, chunk)), and tw the warps an item's frames are split
    over: 1 where the items fill the card (sms SMs of SM_WARPS warps,
    by default the card's, as the launcher reads it) twice over, else
    doubled until they do, up to SOFTMAX_WARPS, while a warp keeps more
    than one batch of SOFTMAX_FRAMES frames. Warp j of an item takes frames
    j, j + tw, ... in batches of SOFTMAX_FRAMES."""
    sms = sm_count() if sms is None else sms
    kc = 8 // logit_bytes
    chunks = -(-(-(-d // kc)) // 32)
    tw = 1
    while (tw < SOFTMAX_WARPS and b * chunks * tw < 2 * sms * SM_WARPS
           and t > SOFTMAX_FRAMES * tw):
        tw *= 2
    return kc, chunks, tw


def softmax_stats_reference(logits, x, mask=None):
    """Plain PyTorch fused_softmax_stats in the JAX kernel's order of
    operations, in f32. -> (mean, std) (B, D) f32."""
    a = logits.float()
    if mask is not None:
        a = torch.where(mask[..., None] > 0, a,
                        torch.full_like(a, _NEG_INF))
    xf = x.float()
    e = torch.exp(a - a.amax(dim=1, keepdim=True))
    w = e / e.sum(dim=1, keepdim=True)
    mean = (w * xf).sum(dim=1)
    var = (w * xf * xf).sum(dim=1) - mean * mean
    return mean, torch.sqrt(torch.clamp(var, min=1e-7))


def masked_stats_reference(x, mask=None, ddof: int = 1):
    """Plain PyTorch fused_masked_stats in the JAX kernel's order of
    operations, in f32. -> (mean, std) (B, D) f32."""
    xf = x.float()
    m = (torch.ones(x.shape[:2] + (1,), device=x.device) if mask is None
         else mask[..., None].float())
    count = m.sum(dim=1)
    mean = (xf * m).sum(dim=1) / torch.clamp(count, min=1.0)
    centered = (xf - mean[:, None, :]) * m
    var = (centered * centered).sum(dim=1) / torch.clamp(count - ddof,
                                                         min=1.0)
    return mean, torch.sqrt(var + 1e-7)


def _check_args(what, x, mask, logits=None):
    """The contract, on every device."""
    if x.dim() != 3:
        raise ValueError(f"{what} takes x (B, T, D); got {tuple(x.shape)}")
    if logits is not None and logits.shape != x.shape:
        raise ValueError(f"{what}: logits {tuple(logits.shape)} != x "
                         f"{tuple(x.shape)}")
    if mask is not None and tuple(mask.shape) != tuple(x.shape[:2]):
        raise ValueError(f"{what}: mask {tuple(mask.shape)} is not (B, T) "
                         f"= {tuple(x.shape[:2])}")


def _check_cuda_args(what, tensors, mask):
    """x and logits as the kernel reads them; the (B, T) mask, small, is
    taken in any type and layout on the card and copied to f32."""
    if mask is not None and mask.device != tensors[0].device:
        raise ValueError(f"{what}: mask on {mask.device}, x on "
                         f"{tensors[0].device}")
    for v in tensors:
        if v.device.type != "cuda":
            raise ValueError(f"{what}: operands on {v.device}, not the card")
        if v.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{what} takes f32 or bf16, not {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{what} takes contiguous operands")
        if v.requires_grad:
            raise RuntimeError(f"{what} has no backward: call it with "
                               "autograd off (the pooling layers route "
                               "training through the plain path)")


def _split(out, d, concat):
    return out if concat else (out[:, :d], out[:, d:])


def _mask_arg(mask):
    return None if mask is None else mask.to(torch.float32).contiguous()


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        v.requires_grad for v in tensors if v is not None)


def _on_cpu_or_cuda(what, x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for {x.device}")


def fused_softmax_stats(logits: torch.Tensor, x: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        concat: bool = False):
    """Softmax over T of logits (B, T, D), masked frames at -1e30, then the
    weighted mean and std of x (B, T, D). Returns (mean, std) (B, D) f32,
    views of one (B, 2D) buffer, or with concat the buffer [mean | std].

    The call goes through the custom op `wespeaker_tpu_torch::
    fused_softmax_stats` (the split stays outside it: an op's output may
    alias nothing), so a torch.export program holds it as one node. Its
    CPU implementation is the plain version; its CUDA one launches the
    kernel, or raises for a type other than f32/bf16, a non-contiguous
    logits or x, or an operand that requires grad. A mask that is not
    (B, T) raises on every device. The op has no autograd formula, so on
    the CPU with gradients wanted the plain version runs directly."""
    what = "fused_softmax_stats"
    _check_args(what, x, mask, logits)
    _on_cpu_or_cuda(what, x)
    if x.device.type == "cpu" and _wants_grad(logits, x, mask):
        out = torch.cat(softmax_stats_reference(logits, x, mask), -1)
    else:
        out = torch.ops.wespeaker_tpu_torch.fused_softmax_stats(logits, x,
                                                                mask)
    return _split(out, x.shape[-1], concat)


fused_softmax_stats.launches = 0


def fused_masked_stats(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                       ddof: int = 1, concat: bool = False):
    """Masked mean and ddof-adjusted std (+1e-7 inside the sqrt) over T of
    x (B, T, D). Returns (mean, std) (B, D) f32, views of one (B, 2D)
    buffer, or with concat the buffer [mean | std].

    Goes through the custom op `wespeaker_tpu_torch::fused_masked_stats`
    and raises as fused_softmax_stats does."""
    what = "fused_masked_stats"
    _check_args(what, x, mask)
    _on_cpu_or_cuda(what, x)
    if x.device.type == "cpu" and _wants_grad(x, mask):
        out = torch.cat(masked_stats_reference(x, mask, ddof), -1)
    else:
        out = torch.ops.wespeaker_tpu_torch.fused_masked_stats(x, mask, ddof)
    return _split(out, x.shape[-1], concat)


fused_masked_stats.launches = 0

_T = torch.Tensor


def _stats_fake(x):
    return x.new_empty((x.shape[0], 2 * x.shape[-1]), dtype=torch.float32)


@torch.library.custom_op("wespeaker_tpu_torch::fused_softmax_stats",
                         mutates_args=(), device_types="cpu")
def _softmax_op(logits: _T, x: _T, mask: Optional[_T]) -> _T:
    return torch.cat(softmax_stats_reference(logits, x, mask), -1)


@_softmax_op.register_fake
def _softmax_op_fake(logits, x, mask):
    return _stats_fake(x)


@_softmax_op.register_kernel("cuda")
@_build.on_device
def _softmax_op_cuda(logits, x, mask):
    what = "fused_softmax_stats"
    _check_cuda_args(what, [x, logits], mask)
    b, t, d = x.shape
    mask = _mask_arg(mask)
    out = torch.empty(b, 2 * d, device=x.device, dtype=torch.float32)
    lib = _lib()
    ptr = _build.pointers([logits, x] + ([] if mask is None else [mask])
                          + [out])
    if mask is None:
        ptr.insert(2, None)
    rc = lib.ws_softmax_stats(*ptr, b, t, d,
                              int(logits.dtype == torch.bfloat16),
                              int(x.dtype == torch.bfloat16),
                              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, what)
    fused_softmax_stats.launches += 1
    return out


@torch.library.custom_op("wespeaker_tpu_torch::fused_masked_stats",
                         mutates_args=(), device_types="cpu")
def _masked_op(x: _T, mask: Optional[_T], ddof: int) -> _T:
    return torch.cat(masked_stats_reference(x, mask, ddof), -1)


@_masked_op.register_fake
def _masked_op_fake(x, mask, ddof):
    return _stats_fake(x)


@_masked_op.register_kernel("cuda")
@_build.on_device
def _masked_op_cuda(x, mask, ddof):
    what = "fused_masked_stats"
    _check_cuda_args(what, [x], mask)
    b, t, d = x.shape
    mask = _mask_arg(mask)
    out = torch.empty(b, 2 * d, device=x.device, dtype=torch.float32)
    lib = _lib()
    ptr = _build.pointers([x] + ([] if mask is None else [mask]) + [out])
    if mask is None:
        ptr.insert(1, None)
    rc = lib.ws_masked_stats(*ptr, b, t, d, int(ddof),
                             int(x.dtype == torch.bfloat16),
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, what)
    fused_masked_stats.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("pooling")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ws_softmax_stats.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.ws_softmax_stats.restype = i
    lib.ws_masked_stats.argtypes = [p] * 3 + [i] * 5 + [p]
    lib.ws_masked_stats.restype = i
    return lib
