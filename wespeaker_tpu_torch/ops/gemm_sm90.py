"""The bf16 GEMM of rows 1, 2, 4 and 8 on Hopper (`csrc/gemm_sm90.cuh`),
alone.

The SE-Res2 block (`ops/se_block.py`), the CAM++ dense block
(`ops/cam_block.py`) and the MFA+ASTP tail's forward chain
(`ops/mfa_astp.py`, `ops/mfa_astp_vjp.py`) call it from their own C entry
points; these wrappers reach the same device code through `ws_gemm_sm90`
(built into the se_block library) and `ws_gemm_sm90_tail` (the mfa_astp
library), so that the card tests and `bin/time_kernels.py` can hold it
against its plain version at any shape. `gemm_sm90` computes, with f32
accumulation and the result rounded to bf16,

    post:    out = relu(a[:, :k] @ wt.T + bias) * scale + shift
    bn_relu: out = relu(bf16(relu(a[:, :k] * a_scale + a_shift)) @ wt.T
                        * scale + shift)

where a is (M, lda) with its first k columns live (the rest are never
read, whatever bits they hold) and wt (N, k) the weights K-major; and,
where `seg_len` is given, the masked partial column sums of the stored
out over each segment of seg_len frames of utterances of t frames (rows
utterance-major) and each 64-row unit of M (`segment_units`),
as a (B * nseg, slots, N) f32 workspace. `gemm_sm90_tail` computes the
tail's forms (`gemm_sm90_tail_reference`): the post form over three A
tensors as K-slices of one product (`k_walk`), the tanh form with a
per-utterance row bias (`tile_utterances`) or a column bias, and the f32
form acc + bias. `gemm_tn_sm90` reaches the weight-gradient kernel of
the training tail's bf16 backward (`csrc/gemm_tn_sm90.cuh`, built into the
mfa_astp_train library) for one A^T B product, against
`gemm_tn_sm90_reference`; `tn_splits` and `tn_units` mirror that kernel's
split of K and walk of its work units. `partial_slots` and `segment_units`
give the layout of the partial-sum workspace.
"""

import ctypes
import functools
from typing import Optional

import torch

from wespeaker_tpu_torch.device import sm_count
from wespeaker_tpu_torch.ops import _build

UNIT = 64  # rows of M a GEMM warpgroup sums into one partial


def partial_slots(t: int, seg_len: int) -> int:
    """Workspace slots a segment needs for the GEMM's partial sums: the
    64-row units of M a segment of at most min(seg_len, T) rows can touch
    (csrc/gemm_sm90.cuh::seg_slots)."""
    return (min(seg_len, t) + UNIT - 2) // UNIT + 1


def segment_units(b: int, t: int, seg_len: int):
    """For each segment g = utterance * nseg + s, in order: (first row,
    end row, first unit, units) over M = B*T rows, utterance-major; the
    GEMM writes segment g's sum over unit u0 + i into slot i."""
    nseg = -(-t // seg_len)
    out = []
    for bi in range(b):
        for s in range(nseg):
            r0 = bi * t + s * seg_len
            r1 = bi * t + min((s + 1) * seg_len, t)
            u0 = r0 // UNIT
            out.append((r0, r1, u0, (r1 - 1) // UNIT - u0 + 1))
    return out


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


K_TILE, M_TILE = 64, 128  # gemm_sm90's K stage and output-tile rows
FORMS = {"post": 0, "tanh": 4, "f32": 5}  # ws_gemm_sm90_tail's form codes


def k_walk(k: int, parts: int = 1):
    """The K walk of gemm_sm90's producer warp: for each 64-column K tile
    kt of a product with K = k, the A tensor (part) it reads and the column
    there. With three parts each has k / 3 columns, a whole number of K
    tiles (the launcher refuses anything else): tile kt reads part
    kt // (k / 192) at column (kt % (k / 192)) * 64."""
    if parts == 1:
        return [(0, kt * K_TILE) for kt in range(-(-k // K_TILE))]
    if parts != 3 or k % (parts * K_TILE):
        raise ValueError(f"gemm_sm90 takes 1 or 3 A tensors of a multiple "
                         f"of {K_TILE} columns each; got K {k} over "
                         f"{parts}")
    kpt = k // (parts * K_TILE)
    return [(kt // kpt, (kt % kpt) * K_TILE) for kt in range(parts * kpt)]


def tile_utterances(m: int, t: int):
    """For each 128-row output tile of M = B t rows, its first row and the
    utterance of each of its rows (row // t), as the tanh form looks up its
    row bias (rows past m are not stored)."""
    return [(m0, torch.arange(m0, min(m0 + M_TILE, m)) // t)
            for m0 in range(0, m, M_TILE)]


def gemm_sm90_tail_reference(parts, wt, form, bias=None, scale=None,
                             shift=None, row_bias=None, t=None):
    """Plain PyTorch version of gemm_sm90_tail: acc = concat(parts) @ wt.T
    in f32, then the post form relu(acc + bias) * scale + shift, the tanh
    form tanh(acc + row_bias[r // t]) (or + bias), both rounded to bf16, or
    the f32 form acc + bias."""
    a = torch.cat([p.float() for p in parts], dim=-1)
    acc = a @ wt[:, :a.shape[1]].float().t()
    if form == "f32":
        return acc + bias.float()
    if form == "tanh":
        m = acc.shape[0]
        add = (bias.float() if row_bias is None else
               row_bias.float()[torch.arange(m, device=acc.device) // t])
        return torch.tanh(acc + add).to(torch.bfloat16)
    return (torch.relu(acc + bias.float()) * scale.float()
            + shift.float()).to(torch.bfloat16)


@_build.on_device
def gemm_sm90_tail(parts, wt, form, bias=None, scale=None, shift=None,
                   row_bias=None, t=None):
    """parts: three (M, kp) bf16 CUDA tensors, the K-slices of A, for the
    post form, one for the others;
    wt (N, ldw) bf16, W K-major, its first K = len(parts) kp columns live
    (the rest are never read); form "post" (bias, scale, shift
    (N) f32), "tanh" (row_bias (M / t, N) f32 with t, or bias) or "f32"
    (bias). Returns (M, N), bf16 or f32 for the f32 form. Raises for a
    shape the kernel does not take; no fallback."""
    a0 = parts[0]
    if a0.device.type != "cuda":
        raise ValueError("gemm_sm90_tail runs on the card only; the plain "
                         "version is gemm_sm90_tail_reference")
    if any(p.dtype != torch.bfloat16 for p in parts) or (
            wt.dtype != torch.bfloat16):
        raise TypeError("gemm_sm90_tail takes bf16 operands")
    m, kp = a0.shape
    (n, ldw), k = wt.shape, kp * len(parts)
    if len(parts) != (3 if form == "post" else 1):
        raise ValueError("the post form takes three A tensors, the tanh "
                         "and f32 forms one")
    k_walk(k, len(parts))
    if (ldw < k or n % 128 or kp % 8 or ldw % 8
            or any(tuple(p.shape) != (m, kp) for p in parts)):
        raise ValueError(f"gemm_sm90_tail: parts "
                         f"{[tuple(p.shape) for p in parts]}, wt "
                         f"{tuple(wt.shape)}: needs N % 128 == 0, K and "
                         "ldw multiples of 8, K <= ldw")
    dev = a0.device

    def f32(v):
        return None if v is None else v.to(device=dev,
                                           dtype=torch.float32).contiguous()

    vecs = [f32(v) for v in (bias, scale, shift, row_bias)]
    out = torch.empty((m, n), device=dev, dtype=torch.float32
                      if form == "f32" else torch.bfloat16)
    ins = [p.contiguous() for p in parts]
    ins += [ins[0]] * (3 - len(ins))
    ptrs = _build.pointers(ins + [wt.contiguous(), out])
    lib = _tail_lib()
    rc = lib.ws_gemm_sm90_tail(
        *ptrs[:3], kp, ptrs[3], ldw,
        *[None if v is None else v.data_ptr() for v in vecs], ptrs[4],
        m, n, k, t or 0, FORMS[form], len(parts),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "gemm_sm90_tail")
    gemm_sm90_tail.launches += 1
    return out


gemm_sm90_tail.launches = 0


@_build.on_device
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


def tn_splits(tiles: int, ktiles: int, sms: Optional[int] = None):
    """The split count of the weight-gradient launch's K (ktiles 64-row
    tiles) over `tiles` output tiles on `sms` SMs, and the K tiles a split:
    the s of 1..32 with the least modelled time, the waves of units over
    the SMs times a unit's ceil(ktiles / s) K tiles plus four tiles' worth
    of epilogue, the smallest on a tie; empty splits dropped
    (csrc/gemm_tn_sm90.cuh::gemm_tn_sm90_splits). sms defaults to the
    card's, as the launcher reads it."""
    sms = sm_count() if sms is None else sms
    best, best_cost = 1, None
    for s in range(1, min(32, ktiles) + 1):
        cost = -(-tiles * s // sms) * (-(-ktiles // s) + 4)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    per = -(-ktiles // best)
    return -(-ktiles // per), per


def tn_units(products, k: int, sms: Optional[int] = None):
    """The work units of one gemm_tn_sm90 launch, in the order a CTA's
    index walks them: products is [(a_parts, a_cols, n)], each an A^T B
    with A a_parts tensors of a_cols columns side by side (M = a_parts
    a_cols) and B n columns, in 128 x 128 output tiles. Yields dicts with the product q, the split,
    the output tile (m0, n0), the A tensor and its column for the tile
    (`part`, `col`: row tile m0 of three side-by-side tensors reads tensor
    m0 // a_cols at column m0 % a_cols) and the K rows [k0, k1)."""
    tiles = []
    for q, (parts, a_cols, n) in enumerate(products):
        m = parts * a_cols
        tiles += [(q, m0, n0) for m0 in range(0, m, M_TILE)
                  for n0 in range(0, n, M_TILE)]
    ktiles = -(-k // K_TILE)
    splits, per = tn_splits(len(tiles), ktiles, sms)
    for u in range(len(tiles) * splits):
        q, m0, n0 = tiles[u % len(tiles)]
        split = u // len(tiles)
        parts, a_cols, _ = products[q]
        width = a_cols if parts > 1 else parts * a_cols
        yield dict(q=q, split=split, m0=m0, n0=n0, part=m0 // width,
                   col=m0 % width, k0=split * per * K_TILE,
                   k1=min((split + 1) * per, ktiles) * K_TILE)


def gemm_tn_sm90_reference(a, b):
    """Plain version of gemm_tn_sm90: a^T b in f32."""
    return a.float().t() @ b.float()


@_build.on_device
def gemm_tn_sm90(a, b):
    """a (K, M), b (K, N) bf16 CUDA tensors, M and N multiples of 128 ->
    a^T b (M, N) f32, split over K with a fixed-order sum. Raises for a
    shape the kernel does not take; no fallback."""
    if a.device.type != "cuda":
        raise ValueError("gemm_tn_sm90 runs on the card only; the plain "
                         "version is gemm_tn_sm90_reference")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError("gemm_tn_sm90 takes bf16 operands")
    (k, m), (kb, n) = a.shape, b.shape
    if k != kb or m % 128 or n % 128 or k == 0:
        raise ValueError(f"gemm_tn_sm90: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}: needs one K and M, N multiples "
                         "of 128")
    lib = _tn_lib()
    dev = a.device
    out = torch.empty((m, n), device=dev, dtype=torch.float32)
    n_work = lib.ws_gemm_tn_sm90_workspace(m, n, k)
    work = torch.empty(n_work, device=dev, dtype=torch.float32)
    ptrs = _build.pointers([a.contiguous(), b.contiguous(), out, work])
    rc = lib.ws_gemm_tn_sm90(*ptrs[:3], m, n, k, ptrs[3], n_work,
                             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "gemm_tn_sm90")
    gemm_tn_sm90.launches += 1
    return out


gemm_tn_sm90.launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("se_block")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ws_gemm_sm90.argtypes = [p, i, p, i] + [p] * 8 + [i] * 7 + [p]
    lib.ws_gemm_sm90.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _tail_lib():
    lib = _build.load("mfa_astp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ws_gemm_sm90_tail.argtypes = ([p] * 3 + [i] + [p] + [i] + [p] * 5
                                      + [i] * 6 + [p])
    lib.ws_gemm_sm90_tail.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _tn_lib():
    lib = _build.load("mfa_astp_train")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ws_gemm_tn_sm90_workspace.argtypes = [i] * 3
    lib.ws_gemm_tn_sm90_workspace.restype = ll
    lib.ws_gemm_tn_sm90.argtypes = [p] * 3 + [i] * 3 + [p, ll, p]
    lib.ws_gemm_tn_sm90.restype = i
    return lib
