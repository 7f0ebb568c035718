"""Tap-packed filter gradient (dW) of a small-channel 3x3 conv as a CUDA
kernel, and the conv whose backward uses it.

Replaces the Pallas kernel wespeaker_tpu/ops/conv_dw_pack.py (`dw_pack`,
pallas_call at :119; `_dw_pack_kernel` :71; the custom-vjp
`conv2d_packed_dw` :179). Substituting h' = h + kh - 1 in

    dW[o, i, kh, kw] = sum_{b,h,w} x[b, h+kh-1, w+kw-1, i] * dy[b, h, w, o]

lets the kh shift ride on dy's rows and the kw shift on x's columns, so
with A (K, 3 Co) the three h-shifted copies of dy and B (K, 3 Ci) the three
w-shifted copies of x (K = B*H*W) all nine taps are one product A^T B of
(3 Co, 3 Ci), and dW[o, i, kh, kw] = (A^T B)[kh*Co + o, kw*Ci + i].

Bound on an H100 at ResNet34's train shapes (B=128 x 200 frames, feat 80,
bf16): a layer1 conv (80 x 200, 32 -> 32) reads 262 MB of x and dy for
37.7 GFLOP, about 0.078 ms at 3.35 TB/s against 0.038 at 989 TFLOP/s, so
bytes bound it (`bin/kernel_bounds.py`); layer2's (40 x 100, 64 -> 64)
reads 131 MB for the same 37.7 GFLOP, 0.039 ms against 0.038: it sits on
the ridge, where only wgmma's rate keeps the tensor cores off the
critical path. The TPU kernel carried one (3 Co, 3 Ci) f32 accumulator
across a sequential batch grid. Here K is split across a fixed number of
blocks per shape, each of which walks a contiguous range of (w-chunk,
row) units, and a second pass sums the blocks' partials in a fixed order,
so the same inputs give the same bits (no atomics). Three kernels
(csrc/conv_dw_pack.cu):

- bf16 with Ci and Co multiples of 8 (ResNet34's layer1 and layer2): one
  producer thread streams the rows as TMA boxes (Cp = 16/32/64 channels,
  out-of-range rows, positions and channels arriving as zeros) into a ring
  of stages under the 32/64/128-byte swizzle, completing on mbarriers;
  consumer warpgroups run wgmma on them: M is (kw, Ci) and each kw tap is
  the x box read one row further on (the kw shift costs no copy), N is
  (kh, Co), dy's rows h'+1, h', h'-1 lying in consecutive slots of a ring
  of row buffers (the kh shift costs no copy either);
- bf16 with Ci = 1 (the stem): CUDA-core FMA over 16-byte loads of dy,
  four rows' loads in flight a thread, 72 f32 accumulators;
- f32 (exact, no TF32), and bf16 at widths that are not multiples of 8:
  the first design, one row staged at a time into shared memory, WMMA in
  bf16 and CUDA-core FMA in f32.

The map is the models' logical (B, C, H, W) tensor in `torch.channels_last`
memory format, whose storage is the (B, H, W, C) the kernel reads.
"""

import ctypes
import functools

import torch

from wespeaker_tpu_torch.ops import _build

_MAX_C = 64

# "native" or "packed", process-wide, as the JAX package's
# set_conv_dw_mode; read when a model's conv runs (models/layers.py)
_CONV_DW_MODE = "native"


def set_conv_dw_mode(mode: str) -> None:
    if mode not in ("native", "packed"):
        raise ValueError(f"conv dw mode must be native|packed, got {mode}")
    global _CONV_DW_MODE
    _CONV_DW_MODE = mode


def conv_dw_mode() -> str:
    return _CONV_DW_MODE


def eligible(x_shape, conv: torch.nn.Conv2d) -> bool:
    """The shapes the packed dW takes, those of the JAX package's `_conv`
    and `_eligible`: a 3x3 kernel, stride 1, padding 1, dilation 1, groups
    1, Ci <= 64 and Co <= 64. x_shape is the logical (B, Ci, H, W)."""
    return (len(x_shape) == 4 and tuple(conv.kernel_size) == (3, 3)
            and tuple(conv.stride) == (1, 1)
            and tuple(conv.padding) == (1, 1)
            and tuple(conv.dilation) == (1, 1) and conv.groups == 1
            and x_shape[1] <= _MAX_C and conv.out_channels <= _MAX_C)


def dw_pack_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch dw_pack: A (K, 3 Co) from the three h-shifted copies of
    dy and B (K, 3 Ci) from the three w-shifted copies of x, as
    `_dw_pack_kernel` builds them; returns A^T B in f32, permuted to
    (Co, Ci, 3, 3)."""
    b, h, w, ci = x.shape
    co = dy.shape[-1]
    x, dy = x.float(), dy.float()
    zrow = dy.new_zeros(b, 1, w, co)
    a = torch.cat([torch.cat([dy[:, 1:], zrow], dim=1),    # kh=0: dy[h'+1]
                   dy,                                     # kh=1
                   torch.cat([zrow, dy[:, :-1]], dim=1)],  # kh=2: dy[h'-1]
                  dim=-1)
    zcol = x.new_zeros(b, h, 1, ci)
    bm = torch.cat([torch.cat([zcol, x[:, :, :-1]], dim=2),  # kw=0: x[w-1]
                    x,                                       # kw=1
                    torch.cat([x[:, :, 1:], zcol], dim=2)],  # kw=2: x[w+1]
                   dim=-1)
    packed = a.reshape(-1, 3 * co).t() @ bm.reshape(-1, 3 * ci)
    # packed[kh*Co + o, kw*Ci + i] -> dW[o, i, kh, kw]
    return packed.reshape(3, co, 3, ci).permute(1, 3, 0, 2).contiguous()


def _check_args(x, dy):
    if x.dim() != 4 or dy.dim() != 4 or x.shape[:3] != dy.shape[:3]:
        raise ValueError(f"dw_pack takes x (B, H, W, Ci) and dy (B, H, W, Co)"
                         f"; got {tuple(x.shape)} and {tuple(dy.shape)}")
    if x.shape[-1] > _MAX_C or dy.shape[-1] > _MAX_C:
        raise ValueError(f"dw_pack takes Ci and Co <= {_MAX_C}; got "
                         f"{x.shape[-1]} and {dy.shape[-1]}")
    if x.dtype != dy.dtype:
        raise TypeError(f"x is {x.dtype} and dy {dy.dtype}")


@_build.on_device
def dw_pack(x: torch.Tensor, dy: torch.Tensor,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Filter gradient of a 3x3, stride-1, pad-1 conv. x: (B, H, W, Ci), dy:
    (B, H, W, Co), contiguous, f32 or bf16. Returns dW in torch's weight
    layout (Co, Ci, 3, 3), accumulated in f32 and stored as out_dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel, or raises for a shape, type or layout it does not take."""
    _check_args(x, dy)
    if x.device.type == "cpu":
        return dw_pack_reference(x, dy).to(out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"dw_pack: no kernel for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dw_pack takes f32 or bf16, not {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dw_pack writes f32 or bf16, not {out_dtype}")
    b, h, w, ci = x.shape
    co = dy.shape[-1]
    if b * h * w >= 2 ** 31 or x.numel() == 0:
        raise ValueError(f"dw_pack: B*H*W = {b * h * w} positions")
    lib = _lib()
    bf16 = int(x.dtype == torch.bfloat16)
    elems = lib.ws_dw_pack_workspace(b, h, w, ci, co, bf16)
    work = torch.empty(elems, device=x.device, dtype=torch.float32)
    out = torch.empty((co, ci, 3, 3), device=x.device, dtype=out_dtype)
    ptr = _build.pointers([x, dy, work, out])
    rc = lib.ws_dw_pack(ptr[0], ptr[1], ptr[2], elems, ptr[3], b, h, w, ci,
                        co, bf16, int(out_dtype == torch.bfloat16),
                        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "dw_pack")
    dw_pack.launches += 1
    return out


dw_pack.launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("conv_dw_pack")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ws_dw_pack_workspace.argtypes = [i] * 6
    lib.ws_dw_pack_workspace.restype = ll
    lib.ws_dw_pack.argtypes = [p, p, p, ll, p] + [i] * 7 + [p]
    lib.ws_dw_pack.restype = i
    return lib


def _nhwc(v: torch.Tensor) -> torch.Tensor:
    """The (B, H, W, C) view of a (B, C, H, W) map's channels-last storage,
    copying the map into that format first if it is not in it."""
    if not v.is_contiguous(memory_format=torch.channels_last):
        Conv2dPackedDW.relayouts += 1
        v = v.contiguous(memory_format=torch.channels_last)
    return v.permute(0, 2, 3, 1)


class Conv2dPackedDW(torch.autograd.Function):
    """conv2d (3x3, stride 1, pad 1, no bias) whose backward computes dW
    with dw_pack; the JAX package's `conv2d_packed_dw`. Forward is
    F.conv2d; dX is `aten.convolution_backward` with output mask (True,
    False, False), so the native dW is never computed. x: (B, Ci, H, W),
    weight (Co, Ci, 3, 3) in x's dtype. The caller checks `eligible`
    first. `relayouts` counts the maps the backward had to copy into
    channels-last storage for the kernel."""

    relayouts = 0

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return torch.nn.functional.conv2d(x, weight, None, 1, 1)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                dy, x, weight, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
                1, [True, False, False])[0]
        if ctx.needs_input_grad[1]:
            dw = dw_pack(_nhwc(x), _nhwc(dy), out_dtype=weight.dtype)
        return dx, dw
