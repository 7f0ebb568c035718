"""The whole ECAPA SE-Res2 block (inference, BN folded) as a CUDA kernel.

Replaces the Pallas kernel wespeaker_tpu/ops/se_block_pallas.py
(`fused_se_res2_block`, pallas_call at :204; `_block_kernel`, `_chain`,
and `_tap` from res2_pallas.py). It computes

    h1 = bn(relu(x @ w1 + b1))               1x1 conv, BN folded
    y  = Res2 chain of 7 k3 dilated convs    each step adds the previous
                                             group's output first
    h2 = bn(relu(y @ w2 + b2))
    g  = sigmoid(relu(mean_T(h2) @ sw1 + sb1) @ sw2 + sb2)   SE gate
    out = x + h2 * g

with f32 accumulation and x's type (bf16 or f32) for every stored
activation, rounding where the JAX kernel rounds.

Bound on an H100 at the flagship shape (B=512, T=200, C=512, bf16): about
125 GFLOP (two 512x512 pointwise GEMMs are 107 of them, the chain 18) and
210 MB of x read and out written, so about 0.127 ms at 989 TFLOP/s:
compute-bound. The TPU kernel kept 16 utterances whole in VMEM; a (200,
512) bf16 tile alone is 200 KB of the H100's 227 KB of shared memory, and
the SE gate needs the mean of h2 over all valid T before any output is
written. So h1, y and h2 (each 105 MB at that shape) go through device
memory: each written once and read once more, and x read twice, about
1.05 GB a call, at least 0.31 ms at 3.35 TB/s (the design's floor;
`bin/kernel_bounds.py` prints it beside the bound). The launches (bf16):
  1. pointwise GEMM + bias, relu, BN on `csrc/gemm_sm90.cuh` (TMA ring,
     wgmma, the epilogue from registers as 16-byte stores);
  2. the Res2 chain on the tensor cores (`chain_plan`): a CTA per
     utterance (or frame tile, with the whole chain's halo) runs the 7
     steps with the step's input held in shared memory, each step 3 x 4
     wgmma m64n64k16 per 64 frames, bf16 operands, f32 sums, rounded where
     the JAX kernel rounds;
  3. the second GEMM, whose epilogue also writes the masked column sums
     of the stored h2 over each 64-row unit of M (fixed order, no atomics);
  4. squeeze: the mean from those sums;
  5./6. the excitation MLP as two small GEMMs (M = B; `common.cuh::gemm`);
  7. the residual x + h2 * g, 16 bytes a thread.
f32 runs the same seven launches on the CUDA cores (exact f32; TF32
misses 1e-4): `common.cuh::gemm`'s FMA form, the FMA chain, `col_stats`.
"""

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from wespeaker_tpu_torch.device import smem_budget_bytes
from wespeaker_tpu_torch.ops import _build

_SE_BOTTLENECK = 128
_CHANNELS = (512, 1024)


def _tap(sp: torch.Tensor, off: int) -> torch.Tensor:
    """Shift (B, T, W) by `off` frames along T, zero-padded (SAME conv):
    out[:, t] = sp[:, t + off]."""
    if off == 0:
        return sp
    t = sp.shape[1]
    zeros = sp.new_zeros(sp.shape[:1] + (abs(off),) + sp.shape[2:])
    if off < 0:
        return torch.cat([zeros, sp], dim=1)[:, :t]
    return torch.cat([sp, zeros], dim=1)[:, off:]


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Product of two io-typed operands with f32 accumulation (the JAX
    kernels' preferred_element_type=f32): both are exact in f32."""
    return torch.matmul(a.float(), w.float())


def _chain(h1, cw, cb, cs, ch, *, nums: int, width: int, dilation: int,
           io_dtype):
    """Res2 chain; returns the concatenated (groups + passthrough)
    activation. cw: (nums, 3, W, W) in io_dtype, taps ordered
    [t-d, t, t+d]; cb/cs/ch: (nums, W) f32."""
    sp = h1[..., 0:width]
    groups = []
    for i in range(nums):
        if i >= 1:
            sp = sp + h1[..., i * width:(i + 1) * width]
        acc = (_dot(_tap(sp, -dilation), cw[i, 0]) + _dot(sp, cw[i, 1])
               + _dot(_tap(sp, dilation), cw[i, 2])) + cb[i]
        sp = (torch.relu(acc) * cs[i] + ch[i]).to(io_dtype)
        groups.append(sp)
    groups.append(h1[..., nums * width:])
    return torch.cat(groups, dim=-1)


def se_res2_block_reference(x, w1, b1, s1, h1, cw, cb, cs, ch,
                            w2, b2, s2, h2, sw1, sb1, sw2, sb2,
                            dilation: int, mask: Optional[torch.Tensor] = None):
    """Plain PyTorch SE-Res2 block with the contract of
    fused_se_res2_block."""
    nums, _, width, _ = cw.shape
    io = x.dtype

    def pw(h, w, bias, scale, shift):
        acc = _dot(h, w.to(io)) + bias.float()
        return (torch.relu(acc) * scale.float() + shift.float()).to(io)

    h1v = pw(x, w1, b1, s1, h1)
    yv = _chain(h1v, cw.to(io), cb.float(), cs.float(), ch.float(),
                nums=nums, width=width, dilation=dilation, io_dtype=io)
    h2v = pw(yv, w2, b2, s2, h2)
    if mask is not None:
        mm = mask.float()[..., None]
        cnt = torch.clamp(mm.sum(dim=1), min=1.0)
        m = (h2v.float() * mm).sum(dim=1) / cnt
    else:
        m = h2v.float().mean(dim=1)
    z = torch.relu(_dot(m.to(io), sw1.to(io)) + sb1.float())
    g = torch.sigmoid(_dot(z.to(io), sw2.to(io)) + sb2.float())
    return (x.float() + h2v.float() * g[:, None, :]).to(io)


def _chain_smem_bytes(width: int, dilation: int) -> int:
    """Shared memory of csrc/se_block.cu::res2_chain_kernel (f32): the
    step's (3, W, W) weights and a (tile + 2d, W + 1) f32 tile; the tile is
    64 rows for width 64 and 32 for width 128 (256 threads, 4x4 outputs
    each)."""
    tile = 256 // (width // 4) * 4
    return 4 * (3 * width * width + (tile + 2 * dilation) * (width + 1))


class ChainPlan(NamedTuple):
    rows: int     # frames of the region a CTA computes each step
    frames: int   # output frames a CTA writes
    tiles: int    # CTAs an utterance
    sp_rows: int  # rows of the step's input in shared memory
    smem: int     # bytes of shared memory


def chain_plan(t: int, width: int, nums: int, dilation: int) -> ChainPlan:
    """The tile plan of csrc/se_block.cu::res2_chain_tc_kernel (bf16): a
    CTA runs all `nums` steps over a region of 256 frames (width 64, four
    warpgroups) or 128 (width 128) from t0 - (nums - 1) d, and writes the
    frames [t0, t0 + F) whose every step it computed right, F = rows -
    2 (nums - 1) d; step 0's input is h1 over the region and a d-frame halo
    (whole 128-row TMA boxes). Raises where no frame is left."""
    if width not in (64, 128):
        raise ValueError(f"the bf16 chain takes group widths 64 and 128; "
                         f"got {width}")
    rows = 256 if width == 64 else 128
    frames = rows - 2 * (nums - 1) * dilation
    if frames < 1 or t < 1:
        raise ValueError(f"the bf16 Res2 chain's {rows}-frame region leaves "
                         f"no frame at {nums} steps of dilation {dilation}")
    sp_rows = -(-(rows + 2 * dilation) // 128) * 128
    slabs = width // 64
    smem = 1024 + slabs * 128 * (sp_rows + 3 * width + rows) + 3 * 8
    return ChainPlan(rows, frames, -(-t // frames), sp_rows, smem)


def squeeze_slots(t: int) -> int:
    """Workspace slots of the squeeze's partial sums: the 64-row units of
    M an utterance of T frames touches (one segment an utterance)."""
    return (t + 62) // 64 + 1


def check_chain_smem(x, width: int, nums: int, dilation: int) -> None:
    """Raise where the chain kernel of x's type does not fit the card's
    shared memory (or, in bf16, leaves no frame a tile)."""
    if x.dtype == torch.bfloat16:
        need = chain_plan(x.shape[1], width, nums, dilation).smem
    else:
        need = _chain_smem_bytes(width, dilation)
    if need > smem_budget_bytes(x.device):
        raise ValueError(f"Res2 chain of width {width} at dilation "
                         f"{dilation} needs {need} bytes of shared memory, "
                         f"more than {smem_budget_bytes(x.device)}")


def _check_cuda_args(x, cw, sw1, mask, dilation):
    b, t, c = x.shape
    nums, k, width, _ = cw.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_se_res2_block takes f32 or bf16, not "
                        f"{x.dtype}")
    if c not in _CHANNELS or k != 3 or nums != 7 or width * 8 != c:
        raise ValueError(f"fused_se_res2_block takes C in {_CHANNELS} with "
                         f"7 k3 groups of C/8; got x {tuple(x.shape)}, cw "
                         f"{tuple(cw.shape)}")
    if tuple(sw1.shape) != (c, _SE_BOTTLENECK):
        raise ValueError(f"SE bottleneck must be {_SE_BOTTLENECK}; got "
                         f"sw1 {tuple(sw1.shape)}")
    if mask is not None and tuple(mask.shape) != (b, t):
        raise ValueError(f"mask {tuple(mask.shape)} != {(b, t)}")
    check_chain_smem(x, width, nums, dilation)


def fused_se_res2_block(x, w1, b1, s1, h1, cw, cb, cs, ch,
                        w2, b2, s2, h2, sw1, sb1, sw2, sb2,
                        dilation: int, mask: Optional[torch.Tensor] = None):
    """x: (B, T, C). w1/w2: (C, C) pointwise weights (in, out); b*/s*/h*:
    conv bias and eval BN folded to (scale, shift), all (C,). cw: (nums, 3,
    W, W) chain kernels, taps [t-d, t, t+d]; cb/cs/ch: (nums, W). sw1:
    (C, 128), sb1: (128,), sw2: (128, C), sb2: (C,) excitation. mask:
    optional (B, T) frame validity; it gates only the SE squeeze. Returns
    x + gate * block(x) in x's dtype.

    The call goes through the custom op `wespeaker_tpu_torch::
    fused_se_res2_block`, so a torch.export program of the model holds it
    as one node: its CPU implementation is the plain version, its CUDA
    one the kernel (or raises for a shape or type the kernel does not
    take). The op has no autograd formula, so on the CPU with gradients
    wanted the plain version runs directly."""
    args = (x, w1, b1, s1, h1, cw, cb, cs, ch, w2, b2, s2, h2, sw1, sb1,
            sw2, sb2)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_se_res2_block: no kernel for {x.device}")
    if (x.device.type == "cpu" and torch.is_grad_enabled()
            and any(v.requires_grad for v in args + (mask,)
                    if v is not None)):
        return se_res2_block_reference(*args, dilation, mask)
    return torch.ops.wespeaker_tpu_torch.fused_se_res2_block(
        *args, dilation, mask)


fused_se_res2_block.launches = 0

_T = torch.Tensor


@torch.library.custom_op("wespeaker_tpu_torch::fused_se_res2_block",
                         mutates_args=(), device_types="cpu")
def _se_op(x: _T, w1: _T, b1: _T, s1: _T, h1: _T, cw: _T, cb: _T, cs: _T,
           ch: _T, w2: _T, b2: _T, s2: _T, h2: _T, sw1: _T, sb1: _T,
           sw2: _T, sb2: _T, dilation: int, mask: Optional[_T]) -> _T:
    return se_res2_block_reference(x, w1, b1, s1, h1, cw, cb, cs, ch, w2,
                                   b2, s2, h2, sw1, sb1, sw2, sb2, dilation,
                                   mask)


@_se_op.register_fake
def _se_op_fake(x, *rest):
    return torch.empty_like(x)


@_se_op.register_kernel("cuda")
@_build.on_device
def _se_op_cuda(x, w1, b1, s1, h1, cw, cb, cs, ch, w2, b2, s2, h2, sw1, sb1,
                sw2, sb2, dilation, mask):
    _check_cuda_args(x, cw, sw1, mask, dilation)
    b, t, c = x.shape
    nums, _, width, _ = cw.shape
    io = x.dtype
    dev = x.device

    def io_(v):
        return v.to(device=dev, dtype=io).contiguous()

    def f32(*vs):
        return torch.stack([v.to(device=dev, dtype=torch.float32)
                            for v in vs]).contiguous()

    x = x.contiguous()
    bf16 = io == torch.bfloat16
    if bf16:  # the weights K-major, as the wgmma kernels read them
        w1k, w2k, cwk = io_(w1.t()), io_(w2.t()), io_(cw.transpose(2, 3))
    else:
        w1k, w2k, cwk = io_(w1), io_(w2), io_(cw)
    wts = [w1k, f32(b1, s1, h1), cwk, f32(cb, cs, ch), w2k,
           f32(b2, s2, h2), io_(sw1), f32(sb1), io_(sw2), f32(sb2)]
    m = None if mask is None else mask.to(device=dev,
                                          dtype=torch.float32).contiguous()
    h1b, yb, h2b, out = (torch.empty_like(x) for _ in range(4))
    mean = torch.empty((b, c), device=dev, dtype=io)
    z = torch.empty((b, _SE_BOTTLENECK), device=dev, dtype=io)
    g = torch.empty((b, c), device=dev, dtype=torch.float32)
    slots = squeeze_slots(t)
    part = torch.empty((b, slots, c) if bf16 else (1,), device=dev,
                       dtype=torch.float32)

    lib = _lib()
    ptr = _build.pointers([x] + wts + [h1b, yb, h2b, mean, z, g, part, out])
    rc = lib.ws_se_res2_block(
        ptr[0], None if m is None else m.data_ptr(), *ptr[1:],
        b, t, c, width, nums, _SE_BOTTLENECK, dilation, slots, int(bf16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "fused_se_res2_block")
    fused_se_res2_block.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("se_block")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ws_se_res2_block.argtypes = [p] * 20 + [i] * 9 + [p]
    lib.ws_se_res2_block.restype = i
    return lib
