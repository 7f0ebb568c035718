"""ECAPA's MFA conv + attentive statistics pooling tail as a CUDA kernel.

Replaces the Pallas kernel wespeaker_tpu/ops/mfa_astp_pallas.py
(`fused_mfa_astp`, pallas_call at :191; `_tail_kernel`, `_tail_math`). It
computes, per utterance:

    h      = relu(concat(x2, x3, x4) @ wm + bm)     (T, D), D = 1536
    ctx    = mean_T(h) @ k1m + std_T(h) @ k1s + b1   global context (glob)
    logits = tanh(h @ k1x + ctx) @ k2 + b2           (T, D)
    w      = softmax over T of logits (masked frames at -1e30)
    out    = [sum_T w h | sqrt(max(sum_T w h^2 - mean^2, 1e-7))]   (2D,)

with f32 accumulation; h and the tanh activations are stored in the input
type, as the JAX kernel rounds them.

Bound on an H100 at the flagship shape (B=512, T=200, C=512, bf16): about
564 GFLOP (the MFA GEMM alone is 483) and 315 MB of x2, x3, x4 read, so
about 0.57 ms at 989 TFLOP/s: compute-bound. The design: h is
(200, 1536) per utterance, 600 KB in bf16, and the logits depend on the
context statistics of h over all T, so h cannot stay on chip as it did in
the TPU's VMEM. The tail is split into launches with h, the tanh
activations and the f32 logits in device memory:
  1. the MFA GEMM reads x2, x3, x4 as three K-slices of one product (the
     concat never exists), + bias + relu;
  2. context mean and unbiased std over T, one thread per channel;
  3. the context rows of linear1 as a small GEMM giving a per-utterance
     bias (glob only);
  4. h @ k1x + that bias, tanh;
  5. @ k2 + b2 -> f32 logits;
  6. softmax over T and the weighted mean and std, one thread per
     (utterance, channel), two passes over T.
Both types run the chain of csrc/mfa_astp_fwd.cuh, which the training
forward shares: in bf16 the four products on the TMA + wgmma GEMM of
csrc/gemm_sm90.cuh (three A maps; the f32 form for the context product
and the logits; the tanh form with a per-utterance row bias), in f32 on
common.cuh's CUDA-core FMA GEMM, exact f32 (TF32 would miss 1e-4). The
chain's floor, the sum of each launch's own bound, is ~1.17 ms
(bin/kernel_bounds.py::mfa_astp_tail_floor).
Keeping h on chip (T tiles, online softmax) is later work.
"""

import ctypes
import functools
from typing import Optional

import torch

from wespeaker_tpu_torch.ops import _build

_NEG_INF = -1e30
_C_MULTIPLE = 128  # as the training tail (ops/mfa_astp_vjp.py) takes C
_MFA_DIM = 1536
_ATT_DIM = 128


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with w rounded to a's type and f32 accumulation."""
    return torch.matmul(a.float(), w.to(a.dtype).float())


def _tail_math(parts, mask, wm, bm, k1x, k1m, k1s, b1, k2, b2, *,
               glob: bool, io_dtype):
    """parts = [x2, x3, x4] (B, T, C); mask (B, T) f32 or None. Returns
    (B, 2D) f32 pooled [mean | std]."""
    c = parts[0].shape[-1]
    t = parts[0].shape[1]
    acc = bm.float()
    for i, p in enumerate(parts):
        acc = acc + _dot(p, wm[i * c:(i + 1) * c])
    h = torch.relu(acc).to(io_dtype)
    hf = h.float()
    if mask is not None:
        m3 = mask[..., None]
        cnt = torch.clamp(m3.sum(dim=1, keepdim=True), min=1.0)
    if glob:
        # unbiased context stats over valid frames (pooling_layers._std)
        if mask is not None:
            cmean = (hf * m3).sum(dim=1, keepdim=True) / cnt
            sq = ((hf - cmean) ** 2) * m3
            cvar = sq.sum(dim=1) / torch.clamp(cnt.squeeze(1) - 1.0,
                                               min=1.0)
        else:
            cmean = hf.mean(dim=1, keepdim=True)
            cvar = ((hf - cmean) ** 2).sum(dim=1) / max(t - 1, 1)
        cstd = torch.sqrt(cvar + 1e-7)
        ctx = (_dot(cmean.squeeze(1).to(io_dtype), k1m)
               + _dot(cstd.to(io_dtype), k1s) + b1.float())
        alpha = torch.tanh(_dot(h, k1x) + ctx[:, None, :])
    else:
        alpha = torch.tanh(_dot(h, k1x) + b1.float())
    alpha = _dot(alpha.to(io_dtype), k2) + b2.float()  # f32 logits
    if mask is not None:
        alpha = torch.where(m3 > 0, alpha, torch.full_like(alpha, _NEG_INF))
    alpha = alpha - alpha.amax(dim=1, keepdim=True)
    e = torch.exp(alpha)
    w = e / e.sum(dim=1, keepdim=True)
    mean = (w * hf).sum(dim=1)
    var = (w * hf * hf).sum(dim=1) - mean * mean
    std = torch.sqrt(torch.clamp(var, min=1e-7))
    return torch.cat([mean, std], dim=-1)


def mfa_astp_reference(x2, x3, x4, wm, bm, k1, b1, k2, b2,
                       mask: Optional[torch.Tensor] = None,
                       glob: bool = True):
    """Plain PyTorch tail with the contract of fused_mfa_astp."""
    d = wm.shape[-1]
    if glob:
        k1x, k1m, k1s = k1[:d], k1[d:2 * d], k1[2 * d:]
    else:
        k1x, k1m, k1s = k1, None, None
    m = None if mask is None else mask.float()
    return _tail_math([x2, x3, x4], m, wm, bm, k1x, k1m, k1s, b1, k2, b2,
                      glob=glob, io_dtype=x2.dtype)


def _check_cuda_args(x2, x3, x4, wm, k1, k2, mask, glob):
    """Raises for what the kernels do not take. C a multiple of 128 (256,
    512, 1024: the widths the training tail takes), D = 1536 and A = 128
    are also what gemm_sm90 takes in bf16 (C a multiple of its 64-column K
    tile, N a multiple of 128) and the f32 FMA GEMM (K slices of a
    multiple of 32): no shape falls back."""
    b, t, c = x2.shape
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_mfa_astp takes f32 or bf16, not {x2.dtype}")
    if x3.shape != x2.shape or x4.shape != x2.shape or len({
            x2.dtype, x3.dtype, x4.dtype}) != 1:
        raise ValueError("x2, x3, x4 must share shape and dtype")
    want_k1 = ((3 if glob else 1) * _MFA_DIM, _ATT_DIM)
    if (c <= 0 or c % _C_MULTIPLE or tuple(wm.shape) != (3 * c, _MFA_DIM)
            or tuple(k1.shape) != want_k1
            or tuple(k2.shape) != (_ATT_DIM, _MFA_DIM)):
        raise ValueError(
            f"fused_mfa_astp takes C % {_C_MULTIPLE} == 0, wm (3C, "
            f"{_MFA_DIM}), k1 {want_k1}, k2 ({_ATT_DIM}, {_MFA_DIM}); got x "
            f"{tuple(x2.shape)}, wm {tuple(wm.shape)}, k1 {tuple(k1.shape)},"
            f" k2 {tuple(k2.shape)}")
    if mask is not None and tuple(mask.shape) != (b, t):
        raise ValueError(f"mask {tuple(mask.shape)} != {(b, t)}")


def fused_mfa_astp(x2, x3, x4, wm, bm, k1, b1, k2, b2,
                   mask: Optional[torch.Tensor] = None, glob: bool = True):
    """x2/x3/x4: (B, T, C) SE-Res2 block outputs. wm: (3C, D) MFA conv
    weight, bm: (D,). k1: ASTP linear1 kernel, (3D, A) when glob (row
    slices [x, ctx_mean, ctx_std]) else (D, A); b1: (A,). k2: (A, D),
    b2: (D,). mask: optional (B, T) frame validity. Returns (B, 2D) f32
    pooled [mean | std].

    The call goes through the custom op `wespeaker_tpu_torch::
    fused_mfa_astp`, so a torch.export program of the model holds it as
    one node: its CPU implementation is the plain version, its CUDA one
    the kernel (or raises for a shape or type the kernel does not take).
    The op has no autograd formula, so on the CPU with gradients wanted
    the plain version runs directly."""
    args = (x2, x3, x4, wm, bm, k1, b1, k2, b2)
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mfa_astp: no kernel for {x2.device}")
    if (x2.device.type == "cpu" and torch.is_grad_enabled()
            and any(v.requires_grad for v in args + (mask,)
                    if v is not None)):
        return mfa_astp_reference(*args, mask=mask, glob=glob).float()
    return torch.ops.wespeaker_tpu_torch.fused_mfa_astp(*args, mask, glob)


fused_mfa_astp.launches = 0

_T = torch.Tensor


@torch.library.custom_op("wespeaker_tpu_torch::fused_mfa_astp",
                         mutates_args=(), device_types="cpu")
def _tail_op(x2: _T, x3: _T, x4: _T, wm: _T, bm: _T, k1: _T, b1: _T,
             k2: _T, b2: _T, mask: Optional[_T], glob: bool) -> _T:
    return mfa_astp_reference(x2, x3, x4, wm, bm, k1, b1, k2, b2, mask=mask,
                              glob=glob).float()


@_tail_op.register_fake
def _tail_op_fake(x2, x3, x4, wm, *rest):
    return x2.new_empty((x2.shape[0], 2 * wm.shape[-1]),
                        dtype=torch.float32)


@_tail_op.register_kernel("cuda")
@_build.on_device
def _tail_op_cuda(x2, x3, x4, wm, bm, k1, b1, k2, b2, mask, glob):
    _check_cuda_args(x2, x3, x4, wm, k1, k2, mask, glob)
    b, t, c = x2.shape
    d, a = _MFA_DIM, _ATT_DIM
    io = x2.dtype
    dev = x2.device
    bf16 = io == torch.bfloat16

    def io_(v):
        return v.to(device=dev, dtype=io).contiguous()

    def f32(v):
        return v.to(device=dev, dtype=torch.float32).contiguous()

    xs = [v.contiguous() for v in (x2, x3, x4)]
    wmk, k1xk, ldk1, k2k = kmajor_weights(wm, k1, k2, d, glob, io_, bf16)
    # glob: k1 rows [x | ctx_mean | ctx_std]; in f32 the last two are one
    # (2D, A) operand of the context GEMM (bf16 reads them in k1.t())
    k1ms = io_(k1[d:]) if glob and not bf16 else None
    aff = torch.cat([f32(bm).reshape(1, d), unit_affine(d, dev)])
    b1f, b2f = f32(b1), f32(b2)
    m = None if mask is None else f32(mask)
    h = torch.empty((b, t, d), device=dev, dtype=io)
    cstats = torch.empty((2 * b * d,), device=dev, dtype=io)
    ctx = torch.empty((b, a), device=dev, dtype=torch.float32)
    att = torch.empty((b, t, a), device=dev, dtype=io)
    logits = torch.empty((b, t, d), device=dev, dtype=torch.float32)
    out = torch.empty((b, 2 * d), device=dev, dtype=torch.float32)

    lib = _lib()
    ptr = _build.pointers
    rc = lib.ws_mfa_astp(
        *ptr(xs), None if m is None else m.data_ptr(), *ptr([wmk, aff, k1xk]),
        ldk1, None if k1ms is None else ptr([k1ms])[0],
        *ptr([b1f, k2k, b2f, h, cstats, ctx, att, logits, out]),
        b, t, c, d, a, int(glob), int(bf16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "fused_mfa_astp")
    fused_mfa_astp.launches += 1
    return out


def kmajor_weights(wm, k1, k2, d, glob, io_, bf16):
    """The tail's weights as the kernels read them: (wm, k1x, ldk1, k2).
    bf16 (gemm_sm90 reads W K-major): wm.t() (D, 3C), k1.t() (A, 3D or D)
    with k1x its first D columns at row stride ldk1 (and the context rows
    the next 2D), k2.t() (D, A); the model's k=1 conv weights are these
    already, so no transpose is made.
    f32 (common.cuh's FMA GEMM): wm (3C, D), k1x (D, A), k2 (A, D)."""
    if bf16:
        return io_(wm.t()), io_(k1.t()), k1.shape[0], io_(k2.t())
    return io_(wm), io_(k1[:d]), k1.shape[-1], io_(k2)


@functools.lru_cache(maxsize=None)
def unit_affine(d: int, device) -> torch.Tensor:
    """(2, d) f32 ones and zeros: the MFA GEMM's scale and shift in
    gemm_sm90's post form (relu(acc + bm) * 1 + 0, exact)."""
    return torch.cat([torch.ones(1, d), torch.zeros(1, d)]).to(device)




@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("mfa_astp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ws_mfa_astp.argtypes = [p] * 7 + [i] + [p] * 10 + [i] * 7 + [p]
    lib.ws_mfa_astp.restype = i
    return lib
