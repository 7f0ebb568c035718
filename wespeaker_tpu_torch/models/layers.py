"""Shared building blocks for the speaker models.

Counterpart of wespeaker_tpu/models/layers.py. 1-D activations are
channels-last, (B, T, C), as in the JAX package. 2-D maps are logical
(B, C, F, T) tensors, where the JAX package keeps (B, F, T, C): the CAM++
head stores them contiguous (NCHW); Gemini DF-ResNet stores them in
`torch.channels_last` memory format, whose storage is JAX's (B, F, T, C),
so cuDNN runs NHWC and its stage kernel reads rows of C. `conv2d` and
`batch_norm` keep the memory format they are given, and each model
flattens its map to the JAX package's layout. A grouped conv (JAX
`ops/grouped_conv.py`) is `conv2d` of an `nn.Conv2d` with `groups=`.
Parameters keep the upstream torch modules (`nn.Conv1d` weight (O, I, K),
`nn.Conv2d` (O, I, kh, kw)), so upstream state_dicts load unchanged.

Under `ops.conv_dw_pack.set_conv_dw_mode("packed")` (the trainer's
`conv_dw_mode: packed`), a conv2d that `ops.conv_dw_pack.eligible` takes
(3x3, stride 1, pad 1, Ci and Co <= 64) and whose weight gets a gradient
runs as `Conv2dPackedDW`, whose backward computes the filter gradient with
the tap-packed kernel; every 2-D family takes that route, as in the JAX
package (its `_conv` and `PackedDWConv`). The route is chosen from the
shape before the call.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from wespeaker_tpu_torch.ops.conv_dw_pack import (Conv2dPackedDW,
                                                  conv_dw_mode, eligible)
from wespeaker_tpu_torch.parallel.collect import all_reduce_sum
from wespeaker_tpu_torch.parallel.mesh import stats_group


def conv1d(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """Run `conv` on channels-last x (B, T, C_in) -> (B, T, C_out), in x's
    dtype (parameters are cast to it)."""
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv1d(x.transpose(1, 2), w, b, stride=conv.stride,
                 padding=conv.padding, dilation=conv.dilation,
                 groups=conv.groups)
    return y.transpose(1, 2)


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Run `conv` on x (B, C_in, F, T) -> (B, C_out, F', T'), in x's dtype
    (parameters are cast to it); the counterpart of JAX `conv2d` on
    (B, F, T, C)."""
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    if (conv_dw_mode() == "packed" and torch.is_grad_enabled()
            and conv.weight.requires_grad and eligible(x.shape, conv)):
        y = Conv2dPackedDW.apply(x, w)
        return y if b is None else y + b[:, None, None]
    return F.conv2d(x, w, b, stride=conv.stride, padding=conv.padding,
                    dilation=conv.dilation, groups=conv.groups)


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or as it is when it is wider (f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def batch_norm(x: torch.Tensor, bn: nn.Module) -> torch.Tensor:
    """`bn` on channels-last x (B, T, C) or (B, C), or on a 2-D map
    (B, C, F, T). Statistics and affine in f32 (f64 for an f64 x), result
    in x's dtype.

    In training the batch statistics normalise x and update the running
    ones as flax's nn.BatchNorm (momentum 0.9) does, which the JAX package
    uses: running = (1 - m) running + m batch with torch's m = 0.1, and the
    batch variance is the biased one (mean of squared deviations). PyTorch's
    own update would store the unbiased variance, n / (n - 1) times it.

    A BatchNorm that parallel/mesh.py::global_batch_stats gave a group
    takes, in training, the statistics of the batch over every rank of
    that group, as the JAX package's global array does: one all_reduce of
    (sum x, sum x^2, n) in f32, mean and biased variance from them (flax's
    own formula), with the gradient of the reduction (SyncBatchNorm's)."""
    y = wide(x)
    if y.dim() == 3:
        y = y.transpose(1, 2)  # F.batch_norm takes channels second
    group = stats_group(bn)
    if bn.training and group is not None:
        y = _global_batch_norm(y, bn, group)
    elif bn.training:
        with torch.no_grad():
            dims = [d for d in range(y.dim()) if d != 1]
            var, mean = torch.var_mean(y, dim=dims, correction=0)
            bn.running_mean.mul_(1.0 - bn.momentum).add_(bn.momentum * mean)
            bn.running_var.mul_(1.0 - bn.momentum).add_(bn.momentum * var)
            bn.num_batches_tracked.add_(1)
        # normalised by the batch statistics (biased variance, as flax); no
        # running statistics given, so F.batch_norm updates none
        y = F.batch_norm(y, None, None, bn.weight, bn.bias, training=True,
                         eps=bn.eps)
    else:
        y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, training=False, eps=bn.eps)
    if y.dim() == 3:
        y = y.transpose(1, 2)
    return y.to(x.dtype)


def _global_batch_norm(y: torch.Tensor, bn: nn.Module,
                       group) -> torch.Tensor:
    """y (B, C, ...) normalised by the statistics over the group's ranks;
    the running statistics updated from them as batch_norm does."""
    dims = [d for d in range(y.dim()) if d != 1]
    count = torch.full((1,), y.numel() // y.shape[1], dtype=y.dtype,
                       device=y.device)
    sums = all_reduce_sum(torch.cat([y.sum(dims), (y * y).sum(dims),
                                     count]), group)
    c = y.shape[1]
    n = sums[-1]
    mean = sums[:c] / n
    var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(bn.momentum * mean)
        bn.running_var.mul_(1.0 - bn.momentum).add_(bn.momentum * var)
        bn.num_batches_tracked.add_(1)
    shape = [1, c] + [1] * (y.dim() - 2)
    out = (y - mean.view(shape)) * torch.rsqrt(var.view(shape) + bn.eps)
    if bn.weight is not None:
        out = (out * bn.weight.to(y.dtype).view(shape)
               + bn.bias.to(y.dtype).view(shape))
    return out


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """`lin` on x (..., I) -> (..., O), in x's dtype (parameters are cast
    to it), as flax's Dense under the JAX package's amp_cast."""
    b = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), b)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """`ln` over the last axis with statistics and affine in f32 (f64 for
    an f64 x), result in x's dtype. The eps is the module's: flax's
    LayerNorm defaults to 1e-6 where torch's does to 1e-5, so each port
    module sets the one its JAX counterpart uses."""
    y = wide(x)
    w = None if ln.weight is None else ln.weight.to(y.dtype)
    b = None if ln.bias is None else ln.bias.to(y.dtype)
    return F.layer_norm(y, ln.normalized_shape, w, b, ln.eps).to(x.dtype)


def fold_bn(bn: nn.BatchNorm1d):
    """Eval-mode BN as f32 (scale, shift): y = x * scale + shift."""
    scale = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    return scale, bn.bias.float() - bn.running_mean.float() * scale


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int,
                keepdim: bool = False) -> torch.Tensor:
    """Mean over `dim` counting only mask==1 positions; mask broadcasts to x."""
    if mask is None:
        return x.mean(dim=dim, keepdim=keepdim)
    total = (x * mask).sum(dim=dim, keepdim=keepdim)
    count = mask.sum(dim=dim, keepdim=keepdim)
    return total / torch.clamp(count, min=1.0)
