"""The bf16 GEMM of rows 1 and 8 on Hopper (`csrc/gemm_sm90.cuh`), alone.

The SE-Res2 block (`ops/se_block.py`) and the CAM++ dense block
(`ops/cam_block.py`) call it from their own C entry points; this wrapper
reaches the same device code through `ws_gemm_sm90` (built into the
se_block library), so that the card tests and `bin/time_kernels.py` can
hold it against its plain version at any shape. It computes, with f32
accumulation and the result rounded to bf16,

    post:    out = relu(a[:, :k] @ wt.T + bias) * scale + shift
    bn_relu: out = relu(bf16(relu(a[:, :k] * a_scale + a_shift)) @ wt.T
                        * scale + shift)

where a is (M, lda) with its first k columns live (the rest are never
read, whatever bits they hold) and wt (N, k) the weights K-major; and,
where `seg_len` is given, the masked partial column sums of the stored
out over each segment of seg_len frames of utterances of t frames (rows
utterance-major) and each 64-row unit of M (`cam_block.segment_units`),
as a (B * nseg, slots, N) f32 workspace.
"""

import ctypes
import functools
from typing import Optional

import torch

from wespeaker_tpu_torch.ops import _build
from wespeaker_tpu_torch.ops.cam_block import partial_slots, segment_units


def gemm_sm90_reference(a, k, wt, scale, shift, bias=None, a_scale=None,
                        a_shift=None):
    """Plain PyTorch version: the post form where bias is given, else the
    bn_relu form."""
    x = a[:, :k].float()
    if bias is None:
        x = torch.relu(x * a_scale.float() + a_shift.float()).to(a.dtype)
        acc = x.float() @ wt.float().t()
        return torch.relu(acc * scale.float() + shift.float()).to(a.dtype)
    acc = x @ wt.float().t()
    return (torch.relu(acc + bias.float()) * scale.float()
            + shift.float()).to(a.dtype)


def partial_sums_reference(out, t, seg_len, mask=None):
    """Plain version of the workspace: for each segment and each unit it
    touches, the f32 sum of out's rows (times the mask) in that unit."""
    m, n = out.shape
    b = m // t
    rows = out.float() * (1.0 if mask is None
                          else mask.float().reshape(m, 1))
    slots = partial_slots(t, seg_len)
    ref = torch.zeros(len(segment_units(b, t, seg_len)), slots, n,
                      device=out.device)
    for g, (r0, r1, u0, units) in enumerate(segment_units(b, t, seg_len)):
        for i in range(units):
            lo, hi = max(r0, (u0 + i) * 64), min(r1, (u0 + i + 1) * 64)
            ref[g, i] = rows[lo:hi].sum(0)
    return ref


def gemm_sm90(a, k, wt, scale, shift, bias=None, a_scale=None, a_shift=None,
              t: Optional[int] = None, seg_len: Optional[int] = None,
              mask=None):
    """a (M, lda) bf16 CUDA tensor, k <= lda live columns; wt (N, k) bf16;
    scale, shift (N) f32; bias (N) for the post form, or a_scale, a_shift
    (k) for the bn_relu form. With seg_len (and t frames an utterance, M =
    B t, mask (B, t) or None) also returns the partial sums. Raises for a
    shape the kernel does not take; no fallback."""
    if a.device.type != "cuda":
        raise ValueError("gemm_sm90 runs on the card only; the plain "
                         "version is gemm_sm90_reference")
    if a.dtype != torch.bfloat16 or wt.dtype != torch.bfloat16:
        raise TypeError("gemm_sm90 takes bf16 operands")
    m, lda = a.shape
    n = wt.shape[0]
    if wt.shape[1] != k or k > lda or n % 128 or k % 8 or lda % 8:
        raise ValueError(f"gemm_sm90: a {tuple(a.shape)}, k {k}, wt "
                         f"{tuple(wt.shape)}: needs N % 128 == 0, k and "
                         "lda multiples of 8, k <= lda")
    dev = a.device

    def f32(v):
        return None if v is None else v.to(device=dev,
                                           dtype=torch.float32).contiguous()

    vecs = [f32(v) for v in (bias, scale, shift, a_scale, a_shift)]
    out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
    part, slots = None, 0
    if seg_len is not None:
        slots = partial_slots(t, seg_len)
        part = torch.empty((m // t * -(-t // seg_len), slots, n), device=dev,
                           dtype=torch.float32)
    m_ = None if mask is None else f32(mask)
    ptrs = _build.pointers([a.contiguous(), wt.contiguous(), out])
    lib = _lib()
    rc = lib.ws_gemm_sm90(
        ptrs[0], lda, ptrs[1], k,
        *[None if v is None else v.data_ptr() for v in vecs], ptrs[2],
        None if part is None else part.data_ptr(),
        None if m_ is None else m_.data_ptr(), m, n, k, t or 0,
        seg_len or 0, slots, int(bias is None),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "gemm_sm90")
    gemm_sm90.launches += 1
    return out if part is None else (out, part)


gemm_sm90.launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("se_block")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ws_gemm_sm90.argtypes = [p, i, p, i] + [p] * 8 + [i] * 7 + [p]
    lib.ws_gemm_sm90.restype = i
    return lib
