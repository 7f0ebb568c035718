"""A whole Gemini DF-ResNet stage (inference, BN folded) as a CUDA kernel.

Replaces the Pallas kernel wespeaker_tpu/ops/inv_bottleneck_pallas.py
(`fused_inv_bottleneck_stage`, pallas_call at :167; `_stage_kernel`,
`_shift2d`, `_tap_roll`). Block i of L, on every position (f, t) of the
map x (B, F, T, C), computes

    h = relu((x @ w1[i]) * s1[i] + t1[i])                 1x1 to 4C
    g = relu(dw3x3(h; wdw[i]) * s2[i] + t2[i])            depthwise 3x3
    x = relu((g @ w2[i]) * s3[i] + t3[i] + x)             1x1 back to C

with zeros beyond the real ends of F and T (the convs' SAME padding), f32
accumulation, and x's type (bf16 or f32) wherever `_stage_kernel` rounds:
h, g and each block's output. Weights are rounded to x's type, as the TPU
kernel receives them.

Bound on an H100 at Gemini_DF_ResNet114's extraction shape (B=512 x 200
frames, feat 80; stage maps (F, T, C) = (40, 200, 32), (20, 100, 64),
(10, 100, 128), (5, 100, 256) with 3, 3, 27, 3 blocks): 4.8 TFLOP, 5.07
ms at 989 TFLOP/s, 3.79 of it stage 2 (`bin/kernel_bounds.py`): compute-
bound, almost all of it the two 1x1 products. The TPU kernel kept a batch
tile's whole stage in VMEM, with the 4x-expanded map h never leaving it;
one utterance's stage-0 h, (40, 200, 128) bf16, is 2 MB, nine times the
H100's 227 KB of shared memory. So this first design keeps h and g in
device memory (about 1 GB each per block at B=512, ~29 ms of traffic per
forward at 3.35 TB/s), and each block is three launches:
  1. the expand GEMM (M = B*F*T, K = C, N = 4C) on `common.cuh::gemm`,
     with a BN1-relu epilogue (bf16 on WMMA tensor cores, f32 on CUDA-core
     FMA: TF32 misses 1e-4);
  2. the depthwise 3x3, BN2 and relu: a thread owns 4 channels of one
     (b, f) row and walks T with a 3 x 3 window of h and the nine taps in
     registers, loading one new column (rows f-1, f, f+1) a frame, two
     frames ahead; zeros beyond the real ends (any F and T, nothing
     padded);
  3. the project GEMM (K = 4C, N = C: a 32- or 64-column tile for stages 0
     and 1), with a BN3 + residual + relu epilogue that writes the block's
     output in place of the residual.
That is 3 L launches per call (108 for Gemini_DF_ResNet114's four calls);
keeping h and g out of device memory (the depthwise fused into the project
GEMM's A-load, channel-chunked fusion of all three steps), wgmma and TMA
are the later redesign.

The map is a logical (B, C, F, T) tensor in `torch.channels_last` memory
format, whose storage is exactly the JAX package's (B, F, T, C).
"""

import ctypes
import functools

import torch

from wespeaker_tpu_torch.ops import _build
from wespeaker_tpu_torch.ops.se_block import _dot


def _dw3x3(h: torch.Tensor, wdw: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 of h (B, F, T, D) with zero padding, f32, the taps
    summed in the order of JAX `_stage_kernel` (F offset outer, T offset
    inner). wdw: (3, 3, D)."""
    hp = torch.nn.functional.pad(h.float(), (0, 0, 1, 1, 1, 1))
    f, t = h.shape[1], h.shape[2]
    y = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for df in range(3):
        for dt in range(3):
            y = y + hp[:, df:df + f, dt:dt + t] * wdw[df, dt].float()
    return y


def inv_bottleneck_stage_reference(x, w1, s1, t1, wdw, s2, t2, w2, s3, t3):
    """Plain PyTorch Gemini stage with the contract of
    fused_inv_bottleneck_stage; rounds where JAX `_stage_kernel` rounds."""
    io = x.dtype
    xs = x.permute(0, 2, 3, 1)  # (B, F, T, C)
    for i in range(w1.shape[0]):
        h = _dot(xs, w1[i].to(io))
        h = torch.relu(h * s1[i].float() + t1[i].float()).to(io)
        y = _dw3x3(h, wdw[i].to(io))
        g = torch.relu(y * s2[i].float() + t2[i].float()).to(io)
        p = _dot(g, w2[i].to(io)) * s3[i].float() + t3[i].float()
        xs = torch.relu(p + xs.float()).to(io)
    return xs.permute(0, 3, 1, 2)  # channels-last: the storage of xs


def _check_args(x, w1, s1, t1, wdw, s2, t2, w2, s3, t3):
    """The contract, on every device: x a channels-last (B, C, F, T) map
    and the stacked per-block weights of its width."""
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"fused_inv_bottleneck_stage takes x as a "
                         f"channels-last (B, C, F, T) map; got shape "
                         f"{tuple(x.shape)}, strides {x.stride()}")
    c = x.shape[1]
    num_blocks = w1.shape[0]
    want = {"w1": (w1, (num_blocks, c, 4 * c)),
            "s1": (s1, (num_blocks, 4 * c)), "t1": (t1, (num_blocks, 4 * c)),
            "wdw": (wdw, (num_blocks, 3, 3, 4 * c)),
            "s2": (s2, (num_blocks, 4 * c)), "t2": (t2, (num_blocks, 4 * c)),
            "w2": (w2, (num_blocks, 4 * c, c)),
            "s3": (s3, (num_blocks, c)), "t3": (t3, (num_blocks, c))}
    for name, (v, shape) in want.items():
        if tuple(v.shape) != shape:
            raise ValueError(f"{name} {tuple(v.shape)} != {shape} for a "
                             f"stage of {num_blocks} blocks at width {c}")
    if num_blocks < 1 or x.numel() == 0:
        raise ValueError(f"empty stage: {num_blocks} blocks, x "
                         f"{tuple(x.shape)}")


def _check_cuda_args(x):
    b, c, f, t = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_inv_bottleneck_stage takes f32 or bf16, not "
                        f"{x.dtype}")
    if c % 32:
        raise ValueError(f"the stage width {c} must be a multiple of 32")
    if b * f * t >= 2 ** 31:
        raise ValueError(f"B*F*T = {b * f * t} positions do not fit the "
                         "kernel's 32-bit row count")


def fused_inv_bottleneck_stage(x, w1, s1, t1, wdw, s2, t2, w2, s3, t3):
    """x: (B, C, F, T) in channels-last memory format. Stacked per-block
    weights, BN folded:
      w1 (L, C, 4C)        1x1 expand (in, out), no bias
      s1/t1 (L, 4C)        folded bn1 scale/shift
      wdw (L, 3, 3, 4C)    depthwise taps [f offset, t offset, channel]
      s2/t2 (L, 4C)        folded bn2
      w2 (L, 4C, C)        1x1 project (in, out), no bias
      s3/t3 (L, C)         folded bn3
    Returns the stage output, (B, C, F, T) channels-last in x's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel, or raises for a shape or type it does not take."""
    _check_args(x, w1, s1, t1, wdw, s2, t2, w2, s3, t3)
    if x.device.type == "cpu":
        return inv_bottleneck_stage_reference(x, w1, s1, t1, wdw, s2, t2,
                                              w2, s3, t3)
    if x.device.type != "cuda":
        raise ValueError(f"fused_inv_bottleneck_stage: no kernel for "
                         f"{x.device}")
    _check_cuda_args(x)
    b, c, f, t = x.shape
    num_blocks = w1.shape[0]
    io = x.dtype
    dev = x.device

    def io_(v):
        return v.to(device=dev, dtype=io).contiguous()

    def f32(v):
        return v.to(device=dev, dtype=torch.float32).contiguous()

    xs = x.permute(0, 2, 3, 1)  # contiguous (B, F, T, C): the same storage
    wts = [io_(w1), f32(s1), f32(t1), io_(wdw), f32(s2), f32(t2), io_(w2),
           f32(s3), f32(t3)]
    h = torch.empty((b, f, t, 4 * c), device=dev, dtype=io)
    g = torch.empty_like(h)
    out = torch.empty_like(xs)

    lib = _lib()
    ptr = _build.pointers([xs] + wts + [h, g, out])
    rc = lib.ws_inv_bottleneck_stage(
        *ptr, b, f, t, c, num_blocks, int(io == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "fused_inv_bottleneck_stage")
    fused_inv_bottleneck_stage.launches += 1
    return out.permute(0, 3, 1, 2)


fused_inv_bottleneck_stage.launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("inv_bottleneck")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ws_inv_bottleneck_stage.argtypes = [p] * 13 + [i] * 6 + [p]
    lib.ws_inv_bottleneck_stage.restype = i
    return lib
