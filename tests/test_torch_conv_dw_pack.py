"""Port parity for the tap-packed filter gradient (`ops.conv_dw_pack`): the
plain version against the JAX package's Pallas kernel, the packed conv's
forward and gradients against autograd, its eligibility against the JAX
package's, and the route `models.layers.conv2d` takes, on the CPU in f32.

- `dw_pack` (plain on a CPU tensor) against JAX `dw_pack(interpret=True)`
  at tests/test_conv_dw_pack.py's shapes plus a one-channel input (the
  ResNet stem): rtol 2e-5, atol 2e-4, that file's tolerance for the same
  sums.
- `Conv2dPackedDW` forward, dX and dW against autograd of `F.conv2d` on the
  same inputs, in channels-last and contiguous maps: rtol/atol 1e-5.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.ops import conv_dw_pack as jdw  # noqa: E402
from wespeaker_tpu_torch.models import layers  # noqa: E402
from wespeaker_tpu_torch.ops import conv_dw_pack as tdw  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [
    (4, 16, 20, 8, 8),     # even H/W
    (2, 9, 13, 8, 16),     # odd H/W, cin != cout
    (3, 8, 8, 16, 8),      # cout < cin
    (2, 10, 12, 1, 8),     # one input channel (the ResNet stem)
    (2, 6, 1, 8, 24),      # W = 1: every kw != 1 tap reads the zero edge
    (2, 5, 9, 8, 24),      # Co = 3 Ci, the card's 8 -> 24 edge shape
])
def test_dw_pack_plain_matches_jax_kernel(shape):
    b, h, w, ci, co = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(b, h, w, ci)).astype(np.float32)
    dy = rng.normal(size=(b, h, w, co)).astype(np.float32)
    want = np.asarray(jdw.dw_pack(jnp.asarray(x), jnp.asarray(dy),
                                  interpret=True))  # (3, 3, Ci, Co)
    before = tdw.dw_pack.launches
    got = tdw.dw_pack(torch.from_numpy(x), torch.from_numpy(dy))
    assert tdw.dw_pack.launches == before  # the plain version on the CPU
    assert got.shape == (co, ci, 3, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().transpose(2, 3, 1, 0), want,
                               rtol=2e-5, atol=2e-4)
    assert tdw.dw_pack(torch.from_numpy(x), torch.from_numpy(dy),
                       out_dtype=torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("ci,co", [(8, 8), (1, 8), (5, 3)])
def test_packed_conv_matches_autograd(ci, co, channels_last):
    rng = np.random.default_rng(10 * ci + co)
    x = torch.from_numpy(rng.normal(size=(2, ci, 9, 11)).astype(np.float32))
    w = torch.from_numpy((0.3 * rng.normal(size=(co, ci, 3, 3))).astype(
        np.float32))
    dy = torch.from_numpy(rng.normal(size=(2, co, 9, 11)).astype(np.float32))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = F.conv2d(xr, wr, None, 1, 1)
    want.backward(dy)
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = tdw.Conv2dPackedDW.apply(xp, wp)
    assert got.grad_fn.name().startswith("Conv2dPackedDW")
    got.backward(dy)
    for a, b in ((got, want), (xp.grad, xr.grad), (wp.grad, wr.grad)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # the weight alone: dX is not computed
    wq = w.clone().requires_grad_()
    tdw.Conv2dPackedDW.apply(x, wq).backward(dy)
    torch.testing.assert_close(wq.grad, wr.grad, rtol=1e-5, atol=1e-5)


CONVS = [  # (in, out, kernel, stride, padding, dilation, groups)
    (32, 32, 3, 1, 1, 1, 1), (1, 32, 3, 1, 1, 1, 1), (64, 64, 3, 1, 1, 1, 1),
    (32, 64, 3, 2, 1, 1, 1), (128, 64, 3, 1, 1, 1, 1),
    (64, 128, 3, 1, 1, 1, 1), (32, 32, 3, 1, 2, 2, 1),
    (32, 32, 3, 1, 0, 1, 1), (32, 32, 1, 1, 0, 1, 1),
    (32, 32, 3, 1, 1, 1, 32), (16, 16, (3, 1), 1, (1, 0), 1, 1)]


@pytest.mark.parametrize("cin,cout,k,s,p,d,g", CONVS)
def test_eligible_agrees_with_jax(cin, cout, k, s, p, d, g):
    conv = torch.nn.Conv2d(cin, cout, k, stride=s, padding=p, dilation=d,
                           groups=g, bias=False)
    kh, kw = conv.kernel_size
    ph, pw = conv.padding
    want = jdw._eligible((2, 40, 100, cin), (kh, kw, cin // g, cout),
                         tuple(conv.stride), ((ph, ph), (pw, pw)),
                         tuple(conv.dilation), g)
    assert tdw.eligible((2, cin, 40, 100), conv) == bool(want)


def test_conv2d_takes_the_packed_route_only_where_asked():
    """Packed mode, an eligible conv and a weight that gets a gradient:
    Conv2dPackedDW; otherwise (native mode, no_grad, a frozen weight, a
    stride-2 conv) F.conv2d, with the same output."""
    torch.manual_seed(0)
    x = torch.randn(2, 8, 6, 10).contiguous(memory_format=torch.channels_last)
    conv = torch.nn.Conv2d(8, 8, 3, padding=1, bias=True)
    strided = torch.nn.Conv2d(8, 8, 3, stride=2, padding=1, bias=False)
    want = F.conv2d(x, conv.weight, conv.bias, padding=1)

    def route(c):
        y = layers.conv2d(x, c)
        return y, "" if y.grad_fn is None else y.grad_fn.name()

    assert tdw.conv_dw_mode() == "native"
    assert "Packed" not in route(conv)[1]
    tdw.set_conv_dw_mode("packed")
    try:
        y, name = route(conv)
        assert "Packed" in name or "Add" in name  # bias added after it
        assert "Packed" in y.grad_fn.next_functions[0][0].name()
        torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
        assert "Packed" not in route(strided)[1]
        with torch.no_grad():
            assert route(conv)[1] == ""
        conv.weight.requires_grad_(False)
        assert "Packed" not in route(conv)[1]
        with pytest.raises(ValueError, match="native|packed"):
            tdw.set_conv_dw_mode("fast")
    finally:
        tdw.set_conv_dw_mode("native")


def test_dw_pack_refuses_what_it_does_not_take():
    x = torch.zeros(2, 4, 5, 8)
    with pytest.raises(ValueError, match="Ci and Co"):
        tdw.dw_pack(torch.zeros(2, 4, 5, 65), x)
    with pytest.raises(ValueError, match="B, H, W"):
        tdw.dw_pack(x, torch.zeros(2, 4, 6, 8))
    with pytest.raises(TypeError):
        tdw.dw_pack(x, x.double())
    with pytest.raises(ValueError, match="no kernel"):
        tdw.dw_pack(x.to("meta"), x.to("meta"))
