"""A whole CAM++ dense TDNN block (inference, BN folded) as a CUDA kernel.

Replaces the Pallas kernel wespeaker_tpu/ops/cam_block_pallas.py
(`fused_cam_dense_block`, pallas_call at :204; `_block_kernel`,
`_layer_math`). Layer i of L, on the ci = C0 + 32 i live channels of the
dense map, computes

    h    = relu(bn2(relu(bn1(x[..., :ci])) @ w1))       1x1 to 128
    ctx  = mean_T(h) + mean over the frame's 100-frame segment of h
    gate = sigmoid(relu(ctx @ wc1 + bc1) @ wc2 + bc2)   CAM gate, 128->64->32
    y    = (h[t-d] @ w2[0] + h[t] @ w2[1] + h[t+d] @ w2[2]) * gate

and appends y as channels ci..ci+32. The means are masked (the mask gates
only the context, not y); f32 accumulation everywhere, and x's type (bf16
or f32) wherever `_layer_math` rounds: h, ctx, the gate's hidden layer and
y.

Bound on an H100 at CAMPPlus's extraction shape (B=512 x 200 frames, so
T' = 100 after the stride-2 TDNN): 63, 227 and 178 GFLOP for the three
blocks of 12, 24 and 16 layers, 0.064 + 0.229 + 0.180 ms at 989 TFLOP/s
(`bin/kernel_bounds.py`): compute-bound, almost all of it the 1x1 products
whose K grows with the block. That bound counts the dense map as read
once, as the TPU kernel kept 16 utterances' whole (T, C_end) map in VMEM.
One utterance's (100, 1024) bf16 map is already 200 KB of the H100's 227
KB of shared memory, served utterances run to minutes, and Hopper blocks
run in no order, so the dense map `out` (B, T, C_end) lives in device
memory and every layer reads its live channels again: sum over layers of
M ci 2 bytes, 3.14 GB a B=512 forward, at least 0.94 ms at 3.35 TB/s (the
design's floor; `bin/kernel_bounds.py` prints it beside the bound).

The design (bf16): x is copied into the dense map's first C0 channels,
then each layer is two launches:
  1. `csrc/gemm_sm90.cuh`'s GEMM over the live channels only (M = B*T,
     K = ci, N = 128): TMA loads A from the map (row stride C_end, K extent
     ci exactly, so the unwritten channels past ci are never read) and the
     K-major weights into a 4-stage ring, two consumer warpgroups apply
     BN1-relu to their A rows in shared memory and run wgmma; the epilogue
     applies BN2-relu, stores h (M, 128) as 16-byte vectors, and writes the
     masked column sums of the stored (rounded) h over each 64-row unit of
     M and each segment it holds (`partial_slots`, `segment_units`): the
     context means' sums, with no atomics and in a fixed order;
  2. `cam_tap_gate_kernel`, a CTA per two work items of 128 frames of one
     utterance (`tap_items`): the gate of each segment an item touches
     (the utterance's and the segment's sums from the partials, over their
     masked counts; ctx rounded; the MLP), and the k=3 dilated conv on
     wgmma (N = 32, K = 3 x 128: the three taps are row offsets into one
     TMA-loaded h tile with a d-frame halo; the taps loaded once a CTA),
     times the gate, rounded into out[..., ci:ci+32].
That is 2 L launches and one copy a call (104 and 3 for CAMPPlus's three
blocks). f32 stays on the CUDA cores, three launches a layer (an FMA GEMM,
a gate kernel per utterance, an FMA conv): TF32 misses 1e-4.
"""

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from wespeaker_tpu_torch.ops import _build
from wespeaker_tpu_torch.ops.gemm_sm90 import (  # noqa: F401
    partial_slots, segment_units)
from wespeaker_tpu_torch.ops.se_block import _dot, _tap

GROWTH = 32
BOTTLENECK = 128
TAP_ROWS = 128   # frames a work item of the bf16 conv kernel
TAP_ITEMS = 2    # work items a CTA


def segment_means(x: torch.Tensor, mask: Optional[torch.Tensor],
                  seg_len: int) -> torch.Tensor:
    """Masked means of x (B, T, C) over non-overlapping segments of seg_len
    frames (the last one partial): (B, ceil(T / seg_len), C), in x's
    dtype. mask: (B, T) frame validity or None."""
    b, t, c = x.shape
    m = x.new_ones(b, t) if mask is None else mask.to(x.dtype)
    nseg = -(-t // seg_len)
    pad = nseg * seg_len - t
    xs = F.pad(x * m[..., None], (0, 0, 0, pad)).view(b, nseg, seg_len, c)
    cnt = F.pad(m, (0, pad)).view(b, nseg, seg_len, 1).sum(2)
    return xs.sum(2) / cnt.clamp(min=1.0)


def tap_smem_bytes(dilation: int, seg_len: int, t: int) -> int:
    """Shared memory of csrc/cam_block.cu::cam_tap_gate_kernel: the taps
    (two 12 KB slabs), for each of a CTA's TAP_ITEMS items the h tile with
    its halo (two 1 KB-aligned slabs) and the gates of the segments 128
    frames touch, ctx, the hidden layer, the MLP's partial sums and the
    mbarrier."""
    slab = -(-(TAP_ROWS + 2 * dilation) * 128 // 1024) * 1024
    segs = min((TAP_ROWS - 1) // seg_len + 2, -(-t // seg_len))
    return (1024 + 2 * 3 * GROWTH * 128 + 2 * TAP_ITEMS * slab
            + (BOTTLENECK + 64 + 2 * BOTTLENECK + 2) * 4
            + TAP_ITEMS * segs * GROWTH * 4)


def tap_items(b: int, t: int):
    """The conv kernel's work items in order, (utterance, first frame), and
    the CTA that takes each: TAP_ITEMS consecutive items a CTA."""
    items = [(bi, t0) for bi in range(b) for t0 in range(0, t, TAP_ROWS)]
    return [(cta // TAP_ITEMS, bi, t0) for cta, (bi, t0) in
            enumerate(items)]


def _context_gate(h, mask, wc1, bc1, wc2, bc2, seg_len: int, io_dtype):
    """The CAM gate per segment: (B, nseg, 32) f32. h: (B, T, 128) in the
    io type; mask (B, T) f32 or None. The means are f32 over the rounded h
    and the context is rounded, as in `_layer_math`."""
    hf = h.float()
    gmean = segment_means(hf, mask, hf.shape[1])
    ctx = (gmean + segment_means(hf, mask, seg_len)).to(io_dtype)
    g = torch.relu(_dot(ctx, wc1.to(io_dtype)) + bc1.float()).to(io_dtype)
    return torch.sigmoid(_dot(g, wc2.to(io_dtype)) + bc2.float())


def cam_dense_block_reference(x, s1, t1, w1, s2, t2, w2, wc1, bc1, wc2, bc2,
                              dilation: int, seg_len: int = 100,
                              mask: Optional[torch.Tensor] = None):
    """Plain PyTorch CAM++ dense block with the contract of
    fused_cam_dense_block; rounds where JAX `_layer_math` rounds."""
    io = x.dtype
    b, t, c0 = x.shape
    num_layers = w1.shape[0]
    m = None if mask is None else mask.float()
    xc = x
    for i in range(num_layers):
        ci = c0 + GROWTH * i
        h = torch.relu(xc.float() * s1[i, :ci].float()
                       + t1[i, :ci].float()).to(io)
        h = _dot(h, w1[i, :ci].to(io))
        h = torch.relu(h * s2[i].float() + t2[i].float()).to(io)
        k = w2[i].to(io)
        y = (_dot(_tap(h, -dilation), k[0]) + _dot(h, k[1])
             + _dot(_tap(h, dilation), k[2]))
        gate = _context_gate(h, m, wc1[i], bc1[i], wc2[i], bc2[i], seg_len,
                             io)
        gate = gate.repeat_interleave(seg_len, dim=1)[:, :t]
        xc = torch.cat([xc, (y * gate).to(io)], dim=-1)
    return xc


def _check_cuda_args(x, s1, w1, w2, wc1, wc2, mask, seg_len, dilation=1):
    b, t, c0 = x.shape
    num_layers = w1.shape[0]
    cend = c0 + GROWTH * num_layers
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_cam_dense_block takes f32 or bf16, not "
                        f"{x.dtype}")
    if tuple(w2.shape[1:]) != (3, BOTTLENECK, GROWTH):
        raise ValueError(f"fused_cam_dense_block takes k=3 convs of "
                         f"bottleneck {BOTTLENECK} to growth {GROWTH}; got "
                         f"w2 {tuple(w2.shape)}")
    if tuple(w1.shape) != (num_layers, cend, BOTTLENECK):
        raise ValueError(f"w1 {tuple(w1.shape)} != "
                         f"{(num_layers, cend, BOTTLENECK)}")
    if tuple(s1.shape) != (num_layers, cend):
        raise ValueError(f"s1 {tuple(s1.shape)} != {(num_layers, cend)}")
    if (tuple(wc1.shape) != (num_layers, BOTTLENECK, BOTTLENECK // 2)
            or tuple(wc2.shape) != (num_layers, BOTTLENECK // 2, GROWTH)):
        raise ValueError(f"CAM gate weights {tuple(wc1.shape)}, "
                         f"{tuple(wc2.shape)} are not 128 -> 64 -> 32")
    if c0 % 32:
        raise ValueError(f"the block's input width {c0} must be a multiple "
                         "of 32")
    if mask is not None and tuple(mask.shape) != (b, t):
        raise ValueError(f"mask {tuple(mask.shape)} != {(b, t)}")
    if seg_len < 1 or t < 1 or b < 1:
        raise ValueError(f"empty block input {tuple(x.shape)} or seg_len "
                         f"{seg_len}")
    if x.dtype == torch.bfloat16 and TAP_ROWS + 2 * dilation > 256:
        raise ValueError(f"dilation {dilation} is past the bf16 conv's "
                         f"halo (a TMA box of {TAP_ROWS} + 2 d <= 256 rows)")


def fused_cam_dense_block(x, s1, t1, w1, s2, t2, w2, wc1, bc1, wc2, bc2,
                          dilation: int, seg_len: int = 100,
                          mask: Optional[torch.Tensor] = None):
    """x: (B, T, C0). Stacked per-layer weights, the input width zero-padded
    to C_end = C0 + 32 L:
      s1/t1 (L, C_end)        folded bn1 scale/shift
      w1    (L, C_end, 128)   1x1 bottleneck (in, out), no bias
      s2/t2 (L, 128)          folded bn2
      w2    (L, 3, 128, 32)   k=3 taps [t-d, t, t+d] (in, out), no bias
      wc1 (L, 128, 64), bc1 (L, 64), wc2 (L, 64, 32), bc2 (L, 32)  CAM gate
    mask: optional (B, T) frame validity; it gates only the context means.
    Returns the dense-concatenated (B, T, C_end) in x's dtype.

    The call goes through the custom op `wespeaker_tpu_torch::
    fused_cam_dense_block`, so a torch.export program holds it as one node:
    its CPU implementation is the plain version, its CUDA one the kernel
    (or raises for a shape or type it does not take; those checks read B
    and T, so they run there and not on an export's symbolic shapes). The
    op has no autograd formula, so on the CPU with gradients wanted the
    plain version runs directly."""
    args = (x, s1, t1, w1, s2, t2, w2, wc1, bc1, wc2, bc2)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_cam_dense_block: no kernel for {x.device}")
    if w1.dim() != 3 or w1.shape[0] < 1:
        raise ValueError(f"fused_cam_dense_block takes w1 (L, C_end, 128) "
                         f"with L >= 1; got {tuple(w1.shape)}")
    if (x.device.type == "cpu" and torch.is_grad_enabled()
            and any(v.requires_grad for v in args + (mask,)
                    if v is not None)):
        return cam_dense_block_reference(*args, dilation, seg_len, mask)
    return torch.ops.wespeaker_tpu_torch.fused_cam_dense_block(
        *args, dilation, seg_len, mask)


fused_cam_dense_block.launches = 0

_T = torch.Tensor


@torch.library.custom_op("wespeaker_tpu_torch::fused_cam_dense_block",
                         mutates_args=(), device_types="cpu")
def _block_op(x: _T, s1: _T, t1: _T, w1: _T, s2: _T, t2: _T, w2: _T,
              wc1: _T, bc1: _T, wc2: _T, bc2: _T, dilation: int,
              seg_len: int, mask: Optional[_T]) -> _T:
    return cam_dense_block_reference(x, s1, t1, w1, s2, t2, w2, wc1, bc1,
                                     wc2, bc2, dilation, seg_len, mask)


@_block_op.register_fake
def _block_op_fake(x, s1, t1, w1, *rest):
    b, t, c0 = x.shape
    return x.new_empty((b, t, c0 + GROWTH * w1.shape[0]))


@_block_op.register_kernel("cuda")
def _block_op_cuda(x, s1, t1, w1, s2, t2, w2, wc1, bc1, wc2, bc2, dilation,
                   seg_len, mask):
    _check_cuda_args(x, s1, w1, w2, wc1, wc2, mask, seg_len, dilation)
    b, t, c0 = x.shape
    out = torch.empty((b, t, c0 + GROWTH * w1.shape[0]), device=x.device,
                      dtype=x.dtype)
    _launch(x, s1, t1, w1, s2, t2, w2, wc1, bc1, wc2, bc2, dilation,
            seg_len, mask, out)
    fused_cam_dense_block.launches += 1
    return out


@_build.on_device
def _launch(x, s1, t1, w1, s2, t2, w2, wc1, bc1, wc2, bc2, dilation,
            seg_len, mask, out):
    """The C entry on checked CUDA operands, into `out` (B, T, C_end), a
    contiguous buffer whose bits the kernel overwrites channel block by
    channel block (the card tests pass one filled with NaN)."""
    b, t, c0 = x.shape
    num_layers = w1.shape[0]
    nseg = -(-t // seg_len)
    io = x.dtype
    dev = x.device

    def io_(v):
        return v.to(device=dev, dtype=io).contiguous()

    def f32(v):
        return v.to(device=dev, dtype=torch.float32).contiguous()

    x = x.contiguous()
    bf16 = io == torch.bfloat16
    if bf16:  # the weights K-major, as the wgmma kernels read them
        w1k, w2k = io_(w1.transpose(1, 2)), io_(w2.transpose(2, 3))
    else:
        w1k, w2k = io_(w1), io_(w2)
    wts = [f32(s1), f32(t1), w1k, f32(s2), f32(t2), w2k, io_(wc1),
           f32(bc1), io_(wc2), f32(bc2)]
    m = None if mask is None else f32(mask)
    h = torch.empty((b * t, BOTTLENECK), device=dev, dtype=io)
    slots = partial_slots(t, seg_len)
    if bf16:
        work = torch.empty((b * nseg, slots, BOTTLENECK), device=dev,
                           dtype=torch.float32)
    else:
        work = torch.empty((b, nseg, GROWTH), device=dev,
                           dtype=torch.float32)

    lib = _lib()
    ptr = _build.pointers([x] + wts + [h, work, out])
    gate, part = (None, ptr[12]) if bf16 else (ptr[12], None)
    rc = lib.ws_cam_dense_block(
        ptr[0], None if m is None else m.data_ptr(), *ptr[1:12], gate, part,
        ptr[13], b, t, c0, num_layers, dilation, seg_len, slots, int(bf16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "fused_cam_dense_block")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("cam_block")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ws_cam_dense_block.argtypes = [p] * 16 + [i] * 8 + [p]
    lib.ws_cam_dense_block.restype = i
    return lib
