"""The ECAPA Res2 chain alone (inference, BN folded) as a CUDA kernel.

Replaces the Pallas kernel wespeaker_tpu/ops/res2_pallas.py
(`fused_res2_chain`, pallas_call at :137; `_chain_kernel_f32`,
`_chain_kernel_bf16`). With x split into nums + 1 groups of width W,

    sp = x[group 0]; then for i < nums:
        sp = sp + x[group i]              (from i = 1, rounded to x's type)
        sp = bn(relu(conv_k3_d(sp)))      taps [t-d, t, t+d], f32 accumulate
        y[group i] = sp                   (x's type)
    y[group nums] = x[group nums]         (the passthrough group)

The kernel is csrc/se_block.cu's chain, the chain step of the whole-block
kernel (ops/se_block.py), reached through its own C entry point
`ws_res2_chain`. bf16 runs `res2_chain_tc_kernel` on the tensor cores (a
CTA per utterance, or per frame tile with the whole chain's halo; the
step's input held in shared memory; `se_block.chain_plan`); f32 runs the
CUDA-core FMA chain (exact f32). Bound on an H100 at ECAPA_TDNN_GLOB_c512's
extraction shape (B=512, T=200, C=512, bf16): 18 GFLOP and 210 MB (x read,
y written), about 0.063 ms at 3.35 TB/s against 0.018 at 989 TFLOP/s:
bytes bound it.
"""

import ctypes
import functools

import torch

from wespeaker_tpu_torch.ops import _build
from wespeaker_tpu_torch.ops.se_block import _chain, check_chain_smem

_WIDTHS = (64, 128)


def res2_chain_reference(x, kernels, biases, bn_scale, bn_shift,
                         dilation: int):
    """Plain PyTorch Res2 chain with the contract of fused_res2_chain,
    rounding where the JAX kernels round."""
    nums, _, width, _ = kernels.shape
    io = x.dtype
    return _chain(x, kernels.to(io), biases.float(), bn_scale.float(),
                  bn_shift.float(), nums=nums, width=width,
                  dilation=dilation, io_dtype=io)


def _check_args(x, kernels, biases, bn_scale, bn_shift):
    """The contract, on every device."""
    if x.dim() != 3 or kernels.dim() != 4:
        raise ValueError(f"fused_res2_chain takes x (B, T, C) and kernels "
                         f"(nums, 3, W, W); got {tuple(x.shape)} and "
                         f"{tuple(kernels.shape)}")
    nums, k, width, width2 = kernels.shape
    if k != 3 or width2 != width or nums * width + width != x.shape[-1]:
        raise ValueError(f"kernels {tuple(kernels.shape)} do not split C = "
                         f"{x.shape[-1]} into nums + 1 groups of a k=3 "
                         "chain")
    for name, v in (("biases", biases), ("bn_scale", bn_scale),
                    ("bn_shift", bn_shift)):
        if tuple(v.shape) != (nums, width):
            raise ValueError(f"{name} {tuple(v.shape)} != {(nums, width)}")


def _check_cuda_args(x, width, dilation, nums=7):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_res2_chain takes f32 or bf16, not {x.dtype}")
    if width not in _WIDTHS:
        raise ValueError(f"fused_res2_chain takes group widths {_WIDTHS}; "
                         f"got {width}")
    check_chain_smem(x, width, nums, dilation)


def fused_res2_chain(x, kernels, biases, bn_scale, bn_shift, dilation: int):
    """x: (B, T, C); kernels: (nums, 3, W, W) taps [t-d, t, t+d] (in, out),
    C = (nums + 1) W; biases, bn_scale, bn_shift: (nums, W), the conv bias
    and eval BN folded to an affine. Returns the chain outputs concatenated
    with the passthrough group, (B, T, C) in x's dtype.

    The call goes through the custom op `wespeaker_tpu_torch::
    fused_res2_chain`, so a torch.export program holds it as one node: its
    CPU implementation is the plain version, its CUDA one the kernel (or
    raises for a width or type it does not take). The op has no autograd
    formula, so on the CPU with gradients wanted the plain version runs
    directly."""
    _check_args(x, kernels, biases, bn_scale, bn_shift)
    args = (x, kernels, biases, bn_scale, bn_shift)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_res2_chain: no kernel for {x.device}")
    if (x.device.type == "cpu" and torch.is_grad_enabled()
            and any(v.requires_grad for v in args)):
        return res2_chain_reference(*args, dilation)
    return torch.ops.wespeaker_tpu_torch.fused_res2_chain(*args, dilation)


fused_res2_chain.launches = 0

_T = torch.Tensor


@torch.library.custom_op("wespeaker_tpu_torch::fused_res2_chain",
                         mutates_args=(), device_types="cpu")
def _chain_op(x: _T, kernels: _T, biases: _T, bn_scale: _T, bn_shift: _T,
              dilation: int) -> _T:
    return res2_chain_reference(x, kernels, biases, bn_scale, bn_shift,
                                dilation)


@_chain_op.register_fake
def _chain_op_fake(x, *rest):
    return x.new_empty(x.shape)


@_chain_op.register_kernel("cuda")
@_build.on_device
def _chain_op_cuda(x, kernels, biases, bn_scale, bn_shift, dilation):
    nums, _, width, _ = kernels.shape
    _check_cuda_args(x, width, dilation, nums)
    b, t, c = x.shape
    dev, io = x.device, x.dtype
    x = x.contiguous()
    cw = kernels.to(device=dev, dtype=io)
    if io == torch.bfloat16:  # K-major, as the wgmma chain reads them
        cw = cw.transpose(2, 3)
    cw = cw.contiguous()
    caff = torch.stack([v.to(device=dev, dtype=torch.float32)
                        for v in (biases, bn_scale, bn_shift)]).contiguous()
    out = x.new_empty(x.shape)
    lib = _lib()
    ptr = _build.pointers([x, cw, caff, out])
    rc = lib.ws_res2_chain(*ptr, b, t, c, width, nums, dilation,
                           int(io == torch.bfloat16),
                           torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "fused_res2_chain")
    fused_res2_chain.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("se_block")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ws_res2_chain.argtypes = [p] * 4 + [i] * 7 + [p]
    lib.ws_res2_chain.restype = i
    return lib
