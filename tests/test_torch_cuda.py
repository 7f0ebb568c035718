"""Card tests of the port's CUDA kernels against their plain versions.

Marked `cuda`; each test decides at run time whether a card is present and
skips without one. This file imports no JAX, so it also runs on a machine
with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_*.py

Tolerances: f32 kernels against the plain f32 version (TF32 off) at
rtol/atol 1e-4 (sums in another order); bf16 by cosine >= 0.9999 on the
flattened output, the bar of scripts/check_fused_tpu.py.
"""

import numpy as np
import pytest
import torch

from wespeaker_tpu_torch.ops import (cam_block, conv_dw_pack, gemm_sm90,
                                     inv_bottleneck, mfa_astp, mfa_astp_vjp,
                                     pooling, res2_chain, se_block)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def se_args(rng, b, t, c, dtype, device, masked):
    """Random SE-Res2 block operands with folded BN, as the model passes
    them (weights f32; the wrapper rounds them to x's type)."""
    w = c // 8

    def r(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                               * scale, device=device)

    args = dict(
        x=r(b, t, c).to(dtype), w1=r(c, c, scale=c ** -0.5), b1=r(c, scale=.1),
        s1=1 + r(c, scale=.1), h1=r(c, scale=.1),
        cw=r(7, 3, w, w, scale=(3 * w) ** -0.5), cb=r(7, w, scale=.1),
        cs=1 + r(7, w, scale=.1), ch=r(7, w, scale=.1),
        w2=r(c, c, scale=c ** -0.5), b2=r(c, scale=.1), s2=1 + r(c, scale=.1),
        h2=r(c, scale=.1), sw1=r(c, 128, scale=c ** -0.5), sb1=r(128, scale=.1),
        sw2=r(128, c, scale=128 ** -0.5), sb2=r(c, scale=.1))
    mask = None
    if masked:
        lens = rng.integers(t // 2, t + 1, b)
        lens[0] = t
        mask = torch.as_tensor((np.arange(t)[None] < lens[:, None]).astype(
            np.float32), device=device)
    return args, mask


def tail_args(rng, b, t, c, dtype, device, masked, glob):
    d, a = 1536, 128

    def r(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                               * scale, device=device)

    xs = [r(b, t, c).to(dtype) for _ in range(3)]
    args = dict(wm=r(3 * c, d, scale=(3 * c) ** -0.5), bm=r(d, scale=.1),
                k1=r((3 if glob else 1) * d, a, scale=d ** -0.5),
                b1=r(a, scale=.1), k2=r(a, d, scale=a ** -0.5),
                b2=r(d, scale=.1))
    mask = None
    if masked:
        lens = rng.integers(t // 2, t + 1, b)
        lens[0] = t
        mask = torch.as_tensor((np.arange(t)[None] < lens[:, None]).astype(
            np.float32), device=device)
    return xs, args, mask


def assert_matches(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float().flatten(), want.float().flatten()
    assert torch.isfinite(g).all()
    if dtype == torch.float32:
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    else:
        g, w = g.double(), w.double()  # an f32 sum drifts by ~1e-5 here
        cos = (g @ w / (g.norm() * w.norm())).item()
        assert cos >= 0.9999, cos


CASES = [(torch.bfloat16, False, 200, 512), (torch.float32, True, 198, 512),
         (torch.float32, False, 37, 512), (torch.bfloat16, True, 98, 1024)]


@pytest.mark.parametrize("dtype,masked,t,c", CASES)
def test_se_block_kernel_matches_plain(cuda, dtype, masked, t, c):
    args, mask = se_args(np.random.default_rng(0), 3, t, c, dtype, cuda,
                         masked)
    before = se_block.fused_se_res2_block.launches
    got = se_block.fused_se_res2_block(**args, dilation=3, mask=mask)
    torch.cuda.synchronize()
    assert se_block.fused_se_res2_block.launches == before + 1
    want = se_block.se_res2_block_reference(**args, dilation=3, mask=mask)
    assert_matches(got, want, dtype)


# the tail's edges: B*T = 111 and 3, no multiple of the 128-row tile, T = 1;
# and C = 256 (the quality smoke's ECAPA) in both types
TAIL_EDGES = [(torch.bfloat16, True, 37, 1024),
              (torch.bfloat16, False, 1, 512), (torch.float32, True, 1, 1024),
              (torch.bfloat16, True, 200, 256), (torch.float32, True, 198, 256)]


@pytest.mark.parametrize("glob", [True, False])
@pytest.mark.parametrize("dtype,masked,t,c", CASES + TAIL_EDGES)
def test_mfa_astp_kernel_matches_plain(cuda, dtype, masked, t, c, glob):
    xs, args, mask = tail_args(np.random.default_rng(1), 3, t, c, dtype,
                               cuda, masked, glob)
    before = mfa_astp.fused_mfa_astp.launches
    got = mfa_astp.fused_mfa_astp(*xs, **args, mask=mask, glob=glob)
    torch.cuda.synchronize()
    assert mfa_astp.fused_mfa_astp.launches == before + 1
    want = mfa_astp.mfa_astp_reference(*xs, **args, mask=mask, glob=glob)
    assert_matches(got, want, torch.float32 if dtype == torch.float32
                   else dtype)


def test_wrappers_raise_for_unsupported_shapes(cuda):
    """No fallback on the card: a shape the kernel does not take raises."""
    args, _ = se_args(np.random.default_rng(2), 2, 16, 64, torch.float32,
                      cuda, False)
    with pytest.raises(ValueError):
        se_block.fused_se_res2_block(**args, dilation=2)
    xs, targs, _ = tail_args(np.random.default_rng(3), 2, 16, 512,
                             torch.float16, cuda, False, True)
    with pytest.raises(TypeError):
        mfa_astp.fused_mfa_astp(*xs, **targs)


def test_ecapa_kernel_path_matches_plain_path(cuda):
    """ECAPA_TDNN_GLOB_c512 in eval: the kernel path (fused) against the
    layer-by-layer path on the same card, f32 with a ragged mask."""
    from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN

    torch.manual_seed(0)
    model = ECAPA_TDNN(512, 80, 192, global_context_att=True).to(cuda).eval()
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((3, 150, 80)).astype(np.float32),
                        device=cuda)
    mask = torch.ones(3, 150, device=cuda)
    mask[1, 120:] = 0
    with torch.inference_mode():
        s0 = se_block.fused_se_res2_block.launches
        t0 = mfa_astp.fused_mfa_astp.launches
        got = model(x, mask)
        assert se_block.fused_se_res2_block.launches == s0 + 3
        assert mfa_astp.fused_mfa_astp.launches == t0 + 1
        want = model.set_fused(False)(x, mask)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_xi_vector_ecapa_runs_the_block_kernel(cuda):
    """XI_VEC_ECAPA_TDNN_c512 in eval: the three SE-Res2 blocks on their
    kernel and no tail kernel (the tail fuses for ASTP only), against the
    layer-by-layer path, f32 with a ragged mask."""
    from wespeaker_tpu_torch.models.xi_vector import XI_VEC_ECAPA_TDNN_c512

    torch.manual_seed(0)
    model = XI_VEC_ECAPA_TDNN_c512(80, 192).to(cuda).eval()
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((3, 150, 80)).astype(np.float32),
                        device=cuda)
    mask = torch.ones(3, 150, device=cuda)
    mask[1, 100:] = 0
    with torch.inference_mode():
        s0 = se_block.fused_se_res2_block.launches
        t0 = mfa_astp.fused_mfa_astp.launches
        got = model(x, mask)
        assert se_block.fused_se_res2_block.launches == s0 + 3
        assert mfa_astp.fused_mfa_astp.launches == t0
        want = model.set_fused(False)(x, mask)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_ecapa_256_takes_the_layers_and_the_tail_kernel(cuda):
    """ECAPA_TDNN at 256 channels (the quality smoke's model) in bf16 eval:
    its SE blocks (group width 32) run layer by layer, as the JAX width
    rule routes them, so the block kernel never launches and the tail
    kernel launches once a forward; the embeddings match the plain path
    (fused=False, plain pooling) at cosine >= 0.9999."""
    from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN
    from wespeaker_tpu_torch.models.pooling_layers import set_pooling_fused

    torch.manual_seed(0)
    model = ECAPA_TDNN(256, 80, 128).to(cuda).eval()
    assert {b.eval_route for b in (model.layer2, model.layer3,
                                   model.layer4)} == {"layers"}
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((8, 200, 80)).astype(np.float32),
                        device=cuda).to(torch.bfloat16)
    mask = torch.ones(8, 200, device=cuda)
    mask[3, 150:] = 0
    with torch.inference_mode():
        s0 = se_block.fused_se_res2_block.launches
        t0 = mfa_astp.fused_mfa_astp.launches
        got = model(x, mask)
        assert se_block.fused_se_res2_block.launches == s0
        assert mfa_astp.fused_mfa_astp.launches == t0 + 1
        model.set_fused(False)
        set_pooling_fused(model, False)
        want = model(x, mask)
    assert torch.isfinite(got.float()).all()
    a, b = got.double().flatten(), want.double().flatten()
    assert (a @ b / (a.norm() * b.norm())).item() >= 0.9999


def scaled_close(got, want, name):
    """f32 gradient against its plain version, each scaled by its largest
    magnitude (sums over B*T rows in another order), rtol/atol 1e-4."""
    scale = max(want.abs().max().item(), 1e-3)
    torch.testing.assert_close(got / scale, want / scale, rtol=1e-4,
                               atol=1e-4, msg=lambda m: f"{name}: {m}")


# (dtype, T, C, glob); bf16 also without the global context, at T = 37
# (tiles straddle utterances) with C = 1024, and at T = 300 (the softmax
# backward stages T in two chunks); C = 256 in both types, with and without
# the global context (the quality smoke's ECAPA_TDNN has none)
TRAIN_CASES = [(torch.float32, 30, 128, True), (torch.float32, 30, 128, False),
               (torch.float32, 198, 512, True), (torch.bfloat16, 200, 512, True),
               (torch.bfloat16, 200, 512, False),
               (torch.bfloat16, 37, 1024, True),
               (torch.bfloat16, 300, 512, True),
               (torch.bfloat16, 200, 256, True),
               (torch.float32, 198, 256, True),
               (torch.bfloat16, 200, 256, False),
               (torch.float32, 198, 256, False)]
GRAD_NAMES = ["dx2", "dx3", "dx4", "dwm", "dbm", "dk1", "db1", "dk2", "db2"]


def train_args(rng, b, t, c, dtype, device, glob):
    xs, args, _ = tail_args(rng, b, t, c, dtype, device, False, glob)
    w = [args[k] for k in ("wm", "bm", "k1", "b1", "k2", "b2")]
    g = torch.as_tensor(rng.standard_normal((b, 2 * 1536)).astype(
        np.float32), device=device)
    return xs, w, g


@pytest.mark.parametrize("dtype,t,c,glob", TRAIN_CASES + [
    (torch.bfloat16, 21, 512, False), (torch.bfloat16, 1, 512, True)])
def test_mfa_astp_train_fwd_kernel_matches_plain(cuda, dtype, t, c, glob):
    xs, w, _ = train_args(np.random.default_rng(5), 3, t, c, dtype, cuda,
                          glob)
    before = mfa_astp_vjp.mfa_astp_train_fwd.launches
    got = mfa_astp_vjp.mfa_astp_train_fwd(*xs, *w, glob=glob)
    torch.cuda.synchronize()
    assert mfa_astp_vjp.mfa_astp_train_fwd.launches == before + 1
    want = mfa_astp_vjp.mfa_astp_train_fwd_reference(*xs, *w, glob=glob)
    for gv, wv in zip(got, want):
        if not wv.any():  # cstats without the global context: zeros
            assert gv.shape == wv.shape and not gv.any()
            continue
        assert_matches(gv, wv, dtype)


@pytest.mark.parametrize("dtype,t,c,glob", TRAIN_CASES)
def test_mfa_astp_train_bwd_kernel_matches_plain(cuda, dtype, t, c, glob):
    """Both sides take the residuals of the plain forward, so the relu
    mask is the same on both."""
    xs, w, g = train_args(np.random.default_rng(6), 3, t, c, dtype, cuda,
                          glob)
    wm, bm, k1, b1, k2, b2 = w
    pooled, h, att, cstats = mfa_astp_vjp.mfa_astp_train_fwd_reference(
        *xs, *w, glob=glob)
    res = (*xs, wm, k1, b2, k2, pooled, h, att, cstats, g)
    before = mfa_astp_vjp.mfa_astp_train_bwd.launches
    got = mfa_astp_vjp.mfa_astp_train_bwd(*res, glob=glob)
    torch.cuda.synchronize()
    assert mfa_astp_vjp.mfa_astp_train_bwd.launches == before + 1
    want = mfa_astp_vjp.mfa_astp_train_bwd_reference(*res, glob=glob)
    assert got[-1].abs().max().item() == 0.0  # db2
    for name, gv, wv in zip(GRAD_NAMES[:-1], got, want):
        assert gv.shape == wv.shape and gv.dtype == wv.dtype, name
        if dtype == torch.float32:
            scaled_close(gv, wv, name)
        else:
            assert_matches(gv, wv, dtype)
    if dtype == torch.float32:
        # and against autograd through the plain forward
        ins = [v.clone().requires_grad_(True) for v in (*xs, *w)]
        out = mfa_astp_vjp.mfa_astp_train_reference(*ins, glob=glob)
        auto = torch.autograd.grad((out * g).sum(), ins)
        for name, gv, av in zip(GRAD_NAMES[:-1], got, auto):
            scaled_close(gv, av, name)


def test_mfa_astp_train_function_uses_both_kernels(cuda):
    """The autograd Function runs the forward kernel, then the backward
    kernel on its residuals: the same numbers as calling the two wrappers
    directly (both kernels are deterministic)."""
    xs, w, g = train_args(np.random.default_rng(7), 2, 40, 128,
                          torch.float32, cuda, True)
    ins = [v.clone().requires_grad_(True) for v in (*xs, *w)]
    f0 = mfa_astp_vjp.mfa_astp_train_fwd.launches
    b0 = mfa_astp_vjp.mfa_astp_train_bwd.launches
    out = mfa_astp_vjp.mfa_astp_train(*ins, glob=True)
    grads = torch.autograd.grad((out * g).sum(), ins)
    torch.cuda.synchronize()
    assert mfa_astp_vjp.mfa_astp_train_fwd.launches == f0 + 1
    assert mfa_astp_vjp.mfa_astp_train_bwd.launches == b0 + 1
    wm, bm, k1, b1, k2, b2 = w
    pooled, h, att, cstats = mfa_astp_vjp.mfa_astp_train_fwd(*xs, *w)
    direct = mfa_astp_vjp.mfa_astp_train_bwd(*xs, wm, k1, b2, k2, pooled, h,
                                             att, cstats, g)
    assert torch.equal(out, pooled)
    for name, gv, dv in zip(GRAD_NAMES, grads, direct):
        assert torch.equal(gv, dv), name
    with pytest.raises(ValueError, match="mask"):
        mfa_astp_vjp.mfa_astp_train(*ins, glob=True,
                                    mask=torch.ones(2, 40, device=cuda))
    with pytest.raises(TypeError):
        mfa_astp_vjp.mfa_astp_train_fwd(*(x.half() for x in xs), *w)


def cam_args(rng, num_layers, c0, device):
    """Random CAM++ dense-block operands, the input rows of s1, t1 and w1
    zero-padded to C_end, as CAMPPlus passes them (f32; the wrapper rounds
    the matrices to x's type)."""
    cend = c0 + 32 * num_layers

    def r(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                               * scale, device=device)

    live = (torch.arange(cend, device=device)[None]
            < (c0 + 32 * torch.arange(num_layers, device=device))[:, None])
    return dict(s1=(1 + r(num_layers, cend, scale=.1)) * live,
                t1=r(num_layers, cend, scale=.1) * live,
                w1=r(num_layers, cend, 128, scale=c0 ** -0.5) * live[..., None],
                s2=1 + r(num_layers, 128, scale=.1),
                t2=r(num_layers, 128, scale=.1),
                w2=r(num_layers, 3, 128, 32, scale=384 ** -0.5),
                wc1=r(num_layers, 128, 64, scale=128 ** -0.5),
                bc1=r(num_layers, 64, scale=.1),
                wc2=r(num_layers, 64, 32, scale=64 ** -0.5),
                bc2=r(num_layers, 32, scale=.1))


@pytest.mark.parametrize("dtype,masked,t,dilation", [
    (torch.bfloat16, False, 100, 1), (torch.float32, True, 249, 2),
    (torch.float32, False, 37, 1), (torch.bfloat16, True, 149, 2)])
def test_cam_block_kernel_matches_plain(cuda, dtype, masked, t, dilation):
    rng = np.random.default_rng(8)
    b, c0, num_layers = 3, 128, 4
    args = cam_args(rng, num_layers, c0, cuda)
    x = torch.as_tensor(rng.standard_normal((b, t, c0)).astype(np.float32),
                        device=cuda).to(dtype)
    mask = None
    if masked:
        mask = torch.ones(b, t, device=cuda)
        mask[1, t // 2:] = 0
    before = cam_block.fused_cam_dense_block.launches
    got = cam_block.fused_cam_dense_block(x, **args, dilation=dilation,
                                          mask=mask)
    torch.cuda.synchronize()
    assert cam_block.fused_cam_dense_block.launches == before + 1
    want = cam_block.cam_dense_block_reference(x, **args, dilation=dilation,
                                               mask=mask)
    assert torch.equal(got[..., :c0], x)
    assert_matches(got[..., c0:].contiguous(), want[..., c0:].contiguous(),
                   dtype)


def test_cam_block_raises_for_unsupported_shapes(cuda):
    """No fallback on the card: a type or a growth the kernel does not take
    raises."""
    rng = np.random.default_rng(9)
    args = cam_args(rng, 2, 128, cuda)
    x = torch.zeros(2, 20, 128, device=cuda)
    with pytest.raises(TypeError):
        cam_block.fused_cam_dense_block(x.half(), **args, dilation=1)
    bad = dict(args, w2=args["w2"][..., :16])
    with pytest.raises(ValueError, match="growth"):
        cam_block.fused_cam_dense_block(x, **bad, dilation=1)
    with pytest.raises(ValueError, match="mask"):
        cam_block.fused_cam_dense_block(x, **args, dilation=1,
                                        mask=torch.ones(2, 19, device=cuda))


def test_campplus_kernel_path_matches_plain_path(cuda):
    """CAMPPlus at full width in eval: three kernel launches per forward,
    against the layer-by-layer path on the same card, f32 with a ragged
    mask."""
    from wespeaker_tpu_torch.models.campplus import CAMPPlus

    torch.manual_seed(0)
    model = CAMPPlus(80, 512).to(cuda).eval()
    rng = np.random.default_rng(10)
    x = torch.as_tensor(rng.standard_normal((3, 150, 80)).astype(np.float32),
                        device=cuda)
    mask = torch.ones(3, 150, device=cuda)
    mask[1, 110:] = 0
    with torch.inference_mode():
        before = cam_block.fused_cam_dense_block.launches
        got = model(x, mask)
        assert cam_block.fused_cam_dense_block.launches == before + 3
        want = model.set_fused(False)(x, mask)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def stage_args(rng, num_blocks, c, device):
    """Random Gemini stage operands with folded BN, stacked over the blocks
    (f32; the wrapper rounds the matrices to x's type)."""
    d = 4 * c

    def r(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                               * scale, device=device)

    L = num_blocks
    return dict(w1=r(L, c, d, scale=c ** -0.5), s1=1 + r(L, d, scale=.1),
                t1=r(L, d, scale=.1), wdw=r(L, 3, 3, d, scale=1 / 3),
                s2=1 + r(L, d, scale=.1), t2=r(L, d, scale=.1),
                w2=r(L, d, c, scale=d ** -0.5), s3=1 + r(L, c, scale=.1),
                t3=r(L, c, scale=.1))


# Gemini_DF_ResNet114's four stage widths at 2 s (T'=100 after stage 0),
# in both types, ragged T in f32; then, in both types, the edges of the
# bf16 kernel's tile plan: B = 1; F = 1; T = 1; the served T' = 49; T not
# a multiple of the tile and over two tiles (To = 10 at C = 128, 11 for
# T = 61 at C = 32); F = 3 at C = 32; C = 256 at F = 5, T = 7
STAGE_EDGES = [(1, 10, 100, 128), (2, 1, 37, 32), (2, 20, 1, 64),
               (2, 10, 49, 128), (2, 5, 49, 256), (2, 10, 37, 128),
               (2, 40, 61, 32), (2, 3, 50, 32), (2, 5, 7, 256)]
STAGE_CASES = ([(torch.bfloat16, 3, 40, 200, 32), (torch.float32, 3, 20, 99, 64),
                (torch.bfloat16, 3, 10, 100, 128),
                (torch.float32, 3, 5, 37, 256),
                (torch.float32, 3, 40, 198, 32),
                (torch.bfloat16, 3, 5, 99, 256)]
               + [(dtype, *shape) for dtype in (torch.bfloat16, torch.float32)
                  for shape in STAGE_EDGES])


@pytest.mark.parametrize("dtype,b,f,t,c", STAGE_CASES)
def test_inv_bottleneck_kernel_matches_plain(cuda, dtype, b, f, t, c):
    rng = np.random.default_rng(11)
    args = stage_args(rng, 3, c, cuda)
    x = torch.as_tensor(rng.standard_normal((b, f, t, c)).astype(np.float32),
                        device=cuda).to(dtype).permute(0, 3, 1, 2)
    before = inv_bottleneck.fused_inv_bottleneck_stage.launches
    got = inv_bottleneck.fused_inv_bottleneck_stage(x, **args)
    torch.cuda.synchronize()
    assert inv_bottleneck.fused_inv_bottleneck_stage.launches == before + 1
    want = inv_bottleneck.inv_bottleneck_stage_reference(x, **args)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert_matches(got, want, dtype)


def test_inv_bottleneck_bf16_keeps_h_and_g_on_chip(cuda):
    """A bf16 stage call at (B=64, F=40, T=200, C=32), three blocks: the
    device memory it takes beyond x, the output and the weights stays
    under 4 x's bytes, the size of an h workspace alone (the ping-pong
    buffer is one x)."""
    rng = np.random.default_rng(14)
    args = stage_args(rng, 3, 32, cuda)
    x = torch.as_tensor(rng.standard_normal((64, 40, 200, 32)).astype(
        np.float32), device=cuda).to(torch.bfloat16).permute(0, 3, 1, 2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = inv_bottleneck.fused_inv_bottleneck_stage(x, **args)
    torch.cuda.synchronize()
    x_bytes = x.numel() * x.element_size()
    extra = torch.cuda.max_memory_allocated() - base - x_bytes  # the output
    assert extra < 4 * x_bytes, (extra, x_bytes)
    assert torch.isfinite(out.float()).all()


def test_inv_bottleneck_raises_for_unsupported_shapes(cuda):
    """No fallback on the card: a type, a width or a layout the kernel does
    not take raises."""
    args = stage_args(np.random.default_rng(12), 2, 16, cuda)
    x = torch.zeros(2, 4, 8, 16, device=cuda).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="multiple of 32"):
        inv_bottleneck.fused_inv_bottleneck_stage(x, **args)
    args = stage_args(np.random.default_rng(12), 2, 32, cuda)
    x = torch.zeros(2, 4, 8, 32, device=cuda).permute(0, 3, 1, 2)
    with pytest.raises(TypeError):
        inv_bottleneck.fused_inv_bottleneck_stage(x.half(), **args)
    with pytest.raises(ValueError, match="channels-last"):
        inv_bottleneck.fused_inv_bottleneck_stage(x.contiguous(), **args)
    # bf16 takes the widths of the Gemini models only; f32 any multiple
    # of 32
    args = stage_args(np.random.default_rng(12), 2, 96, cuda)
    x = torch.zeros(2, 4, 8, 96, device=cuda).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="C in"):
        inv_bottleneck.fused_inv_bottleneck_stage(x.bfloat16(), **args)
    assert inv_bottleneck.fused_inv_bottleneck_stage(x, **args).shape == (
        x.shape)


def test_gemini_kernel_path_matches_plain_path(cuda):
    """Gemini_DF_ResNet114 at full width in eval: four stage launches per
    forward, against the block-by-block path on the same card, f32 with a
    ragged mask."""
    from wespeaker_tpu_torch.models.gemini_dfresnet import (
        Gemini_DF_ResNet114)

    torch.manual_seed(0)
    model = Gemini_DF_ResNet114(80, 256).to(cuda).eval()
    rng = np.random.default_rng(13)
    x = torch.as_tensor(rng.standard_normal((3, 150, 80)).astype(np.float32),
                        device=cuda)
    mask = torch.ones(3, 150, device=cuda)
    mask[1, 110:] = 0
    with torch.inference_mode():
        before = inv_bottleneck.fused_inv_bottleneck_stage.launches
        got = model(x, mask)
        assert inv_bottleneck.fused_inv_bottleneck_stage.launches == before + 4
        want = model.set_fused(False)(x, mask)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---- the Res2 chain alone (ECAPA's fused_res2 route) ----

RES2_CASES = [(torch.bfloat16, 200, 512, 2), (torch.float32, 198, 512, 3),
              (torch.bfloat16, 98, 1024, 4), (torch.float32, 37, 1024, 2)]


@pytest.mark.parametrize("dtype,t,c,dilation", RES2_CASES)
def test_res2_chain_kernel_matches_plain(cuda, dtype, t, c, dilation):
    args, _ = se_args(np.random.default_rng(14), 3, t, c, dtype, cuda, False)
    chain = dict(kernels=args["cw"], biases=args["cb"], bn_scale=args["cs"],
                 bn_shift=args["ch"])
    before = res2_chain.fused_res2_chain.launches
    got = res2_chain.fused_res2_chain(args["x"], **chain, dilation=dilation)
    torch.cuda.synchronize()
    assert res2_chain.fused_res2_chain.launches == before + 1
    want = res2_chain.res2_chain_reference(args["x"], **chain,
                                           dilation=dilation)
    assert torch.equal(got[..., 7 * c // 8:], args["x"][..., 7 * c // 8:])
    assert_matches(got, want, dtype)


def test_res2_chain_raises_for_unsupported_shapes(cuda):
    """A group width other than 64 or 128, or a type the kernel does not
    take, raises on the card; nothing falls back to the plain version."""
    args, _ = se_args(np.random.default_rng(15), 2, 16, 256, torch.float32,
                      cuda, False)
    chain = dict(kernels=args["cw"], biases=args["cb"], bn_scale=args["cs"],
                 bn_shift=args["ch"])
    before = res2_chain.fused_res2_chain.launches
    with pytest.raises(ValueError, match="group widths"):
        res2_chain.fused_res2_chain(args["x"], **chain, dilation=2)
    args, _ = se_args(np.random.default_rng(15), 2, 16, 512, torch.float32,
                      cuda, False)
    chain = dict(kernels=args["cw"], biases=args["cb"], bn_scale=args["cs"],
                 bn_shift=args["ch"])
    with pytest.raises(TypeError):
        res2_chain.fused_res2_chain(args["x"].half(), **chain, dilation=2)
    assert res2_chain.fused_res2_chain.launches == before


def test_ecapa_fused_res2_path_matches_layer_path(cuda):
    """ECAPA_TDNN_GLOB_c512 in eval with fused=False, fused_res2=True: three
    chain launches per forward, against the layer-by-layer path, f32."""
    from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN_GLOB_c512

    torch.manual_seed(0)
    model = ECAPA_TDNN_GLOB_c512(80, 192, fused=False, fused_res2=True)
    model = model.to(cuda).eval()
    x = torch.as_tensor(np.random.default_rng(16).standard_normal(
        (3, 150, 80)).astype(np.float32), device=cuda)
    with torch.inference_mode():
        before = res2_chain.fused_res2_chain.launches
        got = model(x)
        assert res2_chain.fused_res2_chain.launches == before + 3
        want = model.set_fused(False, fused_res2=False)(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---- the tap-packed filter gradient ----

# (dtype, B, H, W, Ci, Co): ResNet34's stem, layer1 and layer2 shapes at a
# small batch, two w-chunks (W > 112), odd channel counts, edge shapes
DW_CASES = [(torch.bfloat16, 2, 80, 200, 1, 32),
            (torch.bfloat16, 2, 80, 200, 32, 32),
            (torch.bfloat16, 3, 40, 100, 64, 64),
            (torch.float32, 2, 80, 200, 1, 32),
            (torch.float32, 2, 40, 100, 64, 64),
            (torch.float32, 3, 7, 130, 5, 3),
            (torch.bfloat16, 2, 9, 13, 24, 40),
            # the redesigned kernels' edges: Ci -> Co 1 -> 32, 8 -> 24,
            # 48 -> 48, 64 -> 64; W of 1, 17 and 250 (wider than a
            # position chunk); H = 1; B*H below the SM count
            (torch.bfloat16, 2, 9, 1, 1, 32),
            (torch.bfloat16, 2, 9, 17, 8, 24),
            (torch.bfloat16, 2, 9, 250, 48, 48),
            (torch.bfloat16, 1, 1, 250, 64, 64),
            (torch.bfloat16, 3, 5, 17, 64, 64),
            (torch.bfloat16, 2, 1, 17, 1, 32),
            (torch.float32, 2, 9, 17, 8, 24),
            (torch.float32, 1, 1, 250, 64, 64),
            # ERes2Net34's and Res2Net34's Res2 convs of widths 16 (layer1)
            # and 24 (ERes2Net34_aug's layer1), the 1 -> 64 stem of
            # ERes2Net34_aug, SimAM-ResNet34 and the RepVGGs' 64-wide stages
            (torch.bfloat16, 2, 80, 200, 16, 16),
            (torch.bfloat16, 2, 80, 200, 24, 24),
            (torch.bfloat16, 2, 80, 200, 1, 64),
            (torch.float32, 2, 40, 100, 16, 16),
            (torch.float32, 2, 40, 100, 24, 24),
            (torch.float32, 2, 80, 200, 1, 64)]


@pytest.mark.parametrize("dtype,b,h,w,ci,co", DW_CASES)
def test_dw_pack_kernel_matches_plain(cuda, dtype, b, h, w, ci, co):
    """f32 within 1e-4 of the largest magnitude (sums over B*H*W in another
    order), bf16 by cosine; two calls give the same bits."""
    rng = np.random.default_rng(17)
    x = torch.as_tensor(rng.standard_normal((b, h, w, ci)).astype(
        np.float32), device=cuda).to(dtype)
    dy = torch.as_tensor(rng.standard_normal((b, h, w, co)).astype(
        np.float32), device=cuda).to(dtype)
    before = conv_dw_pack.dw_pack.launches
    got = conv_dw_pack.dw_pack(x, dy)
    again = conv_dw_pack.dw_pack(x, dy)
    torch.cuda.synchronize()
    assert conv_dw_pack.dw_pack.launches == before + 2
    assert torch.equal(got, again)
    want = conv_dw_pack.dw_pack_reference(x, dy)
    assert got.shape == (co, ci, 3, 3) and got.dtype == torch.float32
    if dtype == torch.float32:
        scale = want.abs().max()
        torch.testing.assert_close(got / scale, want / scale, rtol=1e-4,
                                   atol=1e-4)
    else:
        assert_matches(got, want, dtype)
    half = conv_dw_pack.dw_pack(x, dy, out_dtype=torch.bfloat16)
    assert torch.equal(half, got.to(torch.bfloat16))


def test_dw_pack_raises_for_unsupported_shapes(cuda):
    """No fallback on the card: more than 64 channels, a type or a layout
    the kernel does not take raises, and nothing is launched."""
    x = torch.zeros(2, 8, 10, 32, device=cuda)
    before = conv_dw_pack.dw_pack.launches
    with pytest.raises(ValueError, match="Ci and Co"):
        conv_dw_pack.dw_pack(torch.zeros(2, 8, 10, 128, device=cuda), x)
    with pytest.raises(TypeError):
        conv_dw_pack.dw_pack(x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        conv_dw_pack.dw_pack(x.transpose(1, 2), x.transpose(1, 2))
    assert conv_dw_pack.dw_pack.launches == before
    strided = torch.nn.Conv2d(32, 32, 3, stride=2, padding=1)
    assert not conv_dw_pack.eligible((2, 32, 8, 10), strided)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resnet34_packed_grads_match_native(cuda, dtype):
    """ResNet34 (feat 80, embed 256) in training at 2 x 200 frames: the
    packed route launches dw_pack 14 times per backward (the stem, layer1's
    six convs, layer2's seven stride-1 convs) and gives the native route's
    gradients (f32 within 1e-3 of each tensor's norm; bf16 by cosine)."""
    from wespeaker_tpu_torch.models.resnet import ResNet34

    torch.manual_seed(0)
    model = ResNet34(80, 256).to(cuda).train()
    x = torch.as_tensor(np.random.default_rng(18).standard_normal(
        (2, 200, 80)).astype(np.float32), device=cuda).to(dtype)
    grads = {}
    for mode in ("packed", "native"):
        conv_dw_pack.set_conv_dw_mode(mode)
        try:
            model.zero_grad()
            before = conv_dw_pack.dw_pack.launches
            model(x).float().square().sum().backward()
            torch.cuda.synchronize()
            grads[mode] = {n: p.grad.clone()
                           for n, p in model.named_parameters()}
            assert conv_dw_pack.dw_pack.launches - before == (
                14 if mode == "packed" else 0)
        finally:
            conv_dw_pack.set_conv_dw_mode("native")
    for n, g in grads["packed"].items():
        want = grads["native"][n].double()
        if dtype == torch.float32:
            err = (g.double() - want).norm() / want.norm()
            assert err <= 1e-3, (n, err.item())
        else:
            cos = (g.double() @ want if g.dim() == 1 else
                   (g.double() * want).sum()) / (g.double().norm()
                                                 * want.norm())
            assert cos >= 0.999, (n, cos.item())


# ---- statistics pooling (ASTP's softmax tail, the masked mean and std) ----

# (dtype, B, T, D, masked): ReDimNetB2's pooling width at a small batch,
# ResNet34's TSTP width, ReDimNetB0's unaligned D = 600 with a ragged mask
# and one utterance with no valid frame, a wide-B, narrow-D case
POOL_CASES = [(torch.bfloat16, 4, 200, 1152, False),
              (torch.bfloat16, 3, 25, 2560, True),
              (torch.float32, 3, 198, 600, True),
              (torch.float32, 70, 33, 40, False)]


def pool_args(rng, b, t, d, dtype, device, masked, offset=0.0):
    """Random logits and x (B, T, D); masked: a ragged mask whose last
    utterance has no valid frame, or "one": one valid frame each. With an
    offset, x = offset + 1e-2 z."""
    def r(*shape, scale=1.0, shift=0.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale
                                + shift).astype(np.float32),
                               device=device).to(dtype)

    mask = None
    if masked == "one":
        mask = torch.zeros(b, t, device=device)
        mask[:, t // 2] = 1
    elif masked:
        lens = rng.integers(t // 2, t + 1, b)
        lens[0], lens[-1] = t, 0  # the last utterance has no valid frame
        mask = torch.as_tensor((np.arange(t)[None] < lens[:, None]).astype(
            np.float32), device=device)
    x = (r(b, t, d, scale=1e-2, shift=offset) if offset
         else r(b, t, d))
    return r(b, t, d), x, mask


def assert_stats_match(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert_matches(g, w, dtype)


# POOL_CASES and row 6's edges: T = 1, one valid frame, D = 7 (no vector
# path), and 65,537 utterances (past the grid.y of the thread-per-channel
# kernel it replaced)
SOFTMAX_CASES = POOL_CASES + [(torch.bfloat16, 4, 1, 128, False),
                              (torch.float32, 4, 9, 64, "one"),
                              (torch.float32, 5, 9, 7, True),
                              (torch.bfloat16, 65537, 3, 8, True)]


@pytest.mark.parametrize("dtype,b,t,d,masked", SOFTMAX_CASES)
def test_softmax_stats_kernel_matches_plain(cuda, dtype, b, t, d, masked):
    logits, x, mask = pool_args(np.random.default_rng(20), b, t, d, dtype,
                                cuda, masked)
    for lg in (logits, logits.float()):  # logits in x's type and in f32
        before = pooling.fused_softmax_stats.launches
        got = pooling.fused_softmax_stats(lg, x, mask)
        torch.cuda.synchronize()
        assert pooling.fused_softmax_stats.launches == before + 1
        assert_stats_match(got, pooling.softmax_stats_reference(lg, x, mask),
                           dtype)
    pooled = pooling.fused_softmax_stats(logits, x, mask, concat=True)
    assert torch.equal(pooled, torch.cat(got, -1))


# POOL_CASES without an offset, and the one-pass kernel's edges: T = 1, one
# valid frame (count <= ddof when ddof = 1), D = 7 (no vector path) and an
# unmasked D = 600, f32 x with mean 1e3 and std 1e-2, and 65,536 utterances
# (past the two-pass kernel's grid.y); (dtype, B, T, D, masked, offset)
MASKED_CASES = [c + (0.0,) for c in POOL_CASES] + [
    (torch.bfloat16, 4, 1, 64, False, 0.0),
    (torch.float32, 4, 1, 64, False, 0.0),
    (torch.float32, 4, 9, 64, "one", 0.0),
    (torch.float32, 5, 9, 7, True, 0.0),
    (torch.bfloat16, 5, 9, 7, False, 0.0),
    (torch.bfloat16, 3, 30, 600, False, 0.0),
    (torch.float32, 4, 200, 256, True, 1e3),
    (torch.bfloat16, 65536, 2, 8, False, 0.0),
    # the TSTP widths of ERes2Net34 and Res2Net34 (8 x 64 x 10 = 5120 at
    # T' = 25) and of the x-vector (1500 at 200 - 14 = 186 frames)
    (torch.bfloat16, 8, 25, 5120, True, 0.0),
    (torch.float32, 8, 25, 5120, False, 0.0),
    (torch.bfloat16, 8, 186, 1500, True, 0.0),
    (torch.float32, 8, 186, 1500, True, 0.0)]


@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("dtype,b,t,d,masked,offset", MASKED_CASES)
def test_masked_stats_kernel_matches_plain(cuda, dtype, b, t, d, masked,
                                           offset, ddof):
    """As assert_matches; at the offset input the std also within 1e-4 of
    its largest magnitude (about 1e-2) of the contract computed in f64."""
    _, x, mask = pool_args(np.random.default_rng(21), b, t, d, dtype, cuda,
                           masked, offset)
    before = pooling.fused_masked_stats.launches
    got = pooling.fused_masked_stats(x, mask, ddof=ddof)
    torch.cuda.synchronize()
    assert pooling.fused_masked_stats.launches == before + 1
    want = pooling.masked_stats_reference(x, mask, ddof)
    assert_stats_match(got, want, dtype)
    if offset:
        # the f32 plain version is itself ~1e-4 of the std away from the
        # truth here (its mean carries a few ulps of 1e3): the kernel's std
        # is held to the contract evaluated in f64
        xd = x.double()
        m = mask[..., None].double()
        count = m.sum(1)
        mean = (xd * m).sum(1) / count.clamp(min=1)
        var = (((xd - mean[:, None]) * m) ** 2).sum(1) / (count - ddof).clamp(
            min=1)
        truth = torch.sqrt(var + 1e-7)
        torch.testing.assert_close(got[1].double(), truth, rtol=0,
                                   atol=1e-4 * truth.abs().max().item())


def test_pooling_kernels_refuse(cuda):
    """No fallback on the card: no backward, no other type, no strided
    operand, no mask of another shape."""
    logits, x, _ = pool_args(np.random.default_rng(22), 2, 16, 128,
                             torch.float32, cuda, False)
    with pytest.raises(RuntimeError, match="no backward"):
        pooling.fused_masked_stats(x.clone().requires_grad_())
    with pytest.raises(RuntimeError, match="no backward"):
        pooling.fused_softmax_stats(logits.clone().requires_grad_(), x)
    with pytest.raises(TypeError):
        pooling.fused_masked_stats(x.half())
    with pytest.raises(TypeError):
        pooling.fused_softmax_stats(logits, x.double())
    with pytest.raises(ValueError):
        pooling.fused_masked_stats(x.transpose(0, 1))
    with pytest.raises(ValueError):
        pooling.fused_softmax_stats(logits, x,
                                    torch.ones(2, 15, device=cuda))


def test_redimnet_pooling_kernels_match_plain_pooling(cuda):
    """ReDimNetB0 (D = 600, not a multiple of 128) in eval: one launch of
    each pooling kernel per forward, against fused=False pooling on the
    same card, f32 with a ragged mask."""
    from wespeaker_tpu_torch.models.pooling_layers import set_pooling_fused
    from wespeaker_tpu_torch.models.redimnet import ReDimNetB0

    torch.manual_seed(0)
    model = ReDimNetB0(60, 192).to(cuda).eval()
    x = torch.as_tensor(np.random.default_rng(23).standard_normal(
        (3, 150, 60)).astype(np.float32), device=cuda)
    mask = torch.ones(3, 150, device=cuda)
    mask[1, 110:] = 0
    with torch.inference_mode():
        s0 = pooling.fused_softmax_stats.launches
        m0 = pooling.fused_masked_stats.launches
        got = model(x, mask)
        assert pooling.fused_softmax_stats.launches == s0 + 1
        assert pooling.fused_masked_stats.launches == m0 + 1
        want = set_pooling_fused(model, False)(x, mask)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---- the Hopper GEMM of rows 1 and 8 (`csrc/gemm_sm90.cuh`), and the
#      redesigned rows' edges ----

# (form, B, T, K, lda, N, seg_len, masked): M = B T rows, utterance-major.
# M tails (333, 259, 498, 5 are no multiple of 128), K = 32 (half a K
# stage) and 992 (CAMPPlus's widest layer), lda > K (the dense map's
# unwritten channels, filled with NaN here), N = 128 and 512; the partial
# sums at T' = 37, 100, 249 and 1 and the SE squeeze's one segment an
# utterance.
GEMM_CASES = [("post", 3, 111, 512, 512, 512, None, False),
              ("post", 1, 64, 992, 992, 128, None, False),
              ("post", 2, 200, 512, 512, 512, 200, True),
              ("bn_relu", 7, 37, 32, 1024, 128, 100, True),
              ("bn_relu", 3, 100, 992, 1024, 128, 100, False),
              ("bn_relu", 2, 249, 288, 512, 128, 100, True),
              ("bn_relu", 5, 1, 128, 160, 128, 100, False)]


# The MFA+ASTP tail's forms (rows 2 and 4): three A maps of C = 512 and
# 1024 columns (M = 111 and 402), the tanh form with a per-utterance row
# bias at T = 37, 1, 200 and 201 (128-row tiles straddle utterances) and
# with a column bias, W K-major inside a wider row (ldw = 3D, NaN past K),
# and the f32 form at the logits' N = 1536 and the context product's
# M = 512 utterances, K = 2D.
TAIL_GEMM_CASES = [("post3", 3, 37, 3 * 512, 3 * 512, 1536, None, False),
                   ("post3", 2, 201, 3 * 1024, 3 * 1024, 1536, None, False),
                   ("tanh_rb", 3, 37, 1536, 3 * 1536, 128, None, False),
                   ("tanh_rb", 5, 1, 1536, 3 * 1536, 128, None, False),
                   ("tanh_rb", 2, 200, 1536, 3 * 1536, 128, None, False),
                   ("tanh_rb", 3, 201, 1536, 1536, 128, None, False),
                   ("tanh", 3, 37, 1536, 1536, 128, None, False),
                   ("f32", 3, 37, 128, 128, 1536, None, False),
                   ("f32", 2, 201, 128, 128, 1536, None, False),
                   ("f32", 512, 1, 3072, 4608, 128, None, False)]


def _tail_gemm_case(rng, form, b, t, k, ldw, n, dev):
    """Operands of gemm_sm90_tail: the parts of A, wt (n, ldw) with NaN
    past k, and the form's vectors."""
    def r(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                               * scale, device=dev)

    m, nparts = b * t, 3 if form == "post3" else 1
    parts = [r(m, k // nparts).to(torch.bfloat16) for _ in range(nparts)]
    wt = r(n, ldw, scale=k ** -0.5).to(torch.bfloat16)
    wt[:, k:] = float("nan")  # never read: W's K extent is k
    kw = dict(bias=r(n, scale=.1))
    if form == "post3":
        kw.update(scale=1 + r(n, scale=.1), shift=r(n, scale=.1))
    if form == "tanh_rb":
        kw = dict(row_bias=r(b, n, scale=.5), t=t)
    return parts, wt, kw, {"post3": "post", "tanh_rb": "tanh"}.get(form, form)


@pytest.mark.parametrize("form,b,t,k,lda,n,seg_len,masked",
                         GEMM_CASES + TAIL_GEMM_CASES)
def test_gemm_sm90_matches_plain(cuda, form, b, t, k, lda, n, seg_len,
                                 masked):
    rng = np.random.default_rng(20)

    def r(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                               * scale, device=cuda)

    if form not in ("post", "bn_relu"):
        # lda is W's row stride here
        parts, wt, kw, name = _tail_gemm_case(rng, form, b, t, k, lda, n,
                                              cuda)
        before = gemm_sm90.gemm_sm90_tail.launches
        got = gemm_sm90.gemm_sm90_tail(parts, wt, name, **kw)
        torch.cuda.synchronize()
        assert gemm_sm90.gemm_sm90_tail.launches == before + 1
        want = gemm_sm90.gemm_sm90_tail_reference(parts, wt, name, **kw)
        assert got.shape == (b * t, n)
        assert_matches(got, want, torch.float32 if name == "f32"
                       else torch.bfloat16)
        return
    m = b * t
    a = r(m, lda).to(torch.bfloat16)
    a[:, k:] = float("nan")  # never read: the K extent is k
    wt = r(n, k, scale=k ** -0.5).to(torch.bfloat16)
    vecs = dict(scale=1 + r(n, scale=.1), shift=r(n, scale=.1))
    if form == "post":
        vecs["bias"] = r(n, scale=.1)
    else:
        vecs.update(a_scale=1 + r(k, scale=.1), a_shift=r(k, scale=.1))
    mask = None
    if masked:
        mask = torch.ones(b, t, device=cuda)
        mask[-1, t // 3:] = 0
    before = gemm_sm90.gemm_sm90.launches
    got = gemm_sm90.gemm_sm90(a, k, wt, **vecs, t=t if seg_len else None,
                              seg_len=seg_len, mask=mask)
    torch.cuda.synchronize()
    assert gemm_sm90.gemm_sm90.launches == before + 1
    part = None
    if seg_len:
        got, part = got
    want = gemm_sm90.gemm_sm90_reference(a, k, wt, **vecs)
    assert_matches(got, want, torch.bfloat16)
    if part is not None:
        # the partials are sums of the stored (rounded) rows: against the
        # same sums of the kernel's own output, slot by slot
        ref = gemm_sm90.partial_sums_reference(got, t, seg_len, mask)
        for g, (_, _, _, units) in enumerate(
                cam_block.segment_units(b, t, seg_len)):
            torch.testing.assert_close(part[g, :units], ref[g, :units],
                                       rtol=1e-5, atol=1e-4)


def test_gemm_sm90_refuses(cuda):
    a = torch.zeros(64, 96, device=cuda, dtype=torch.bfloat16)
    wt = torch.zeros(96, 96, device=cuda, dtype=torch.bfloat16)
    v = torch.ones(96, device=cuda)
    with pytest.raises(ValueError, match="N % 128"):
        gemm_sm90.gemm_sm90(a, 96, wt, v, v, bias=v)
    with pytest.raises(TypeError):
        gemm_sm90.gemm_sm90(a.float(), 96, wt, v, v, bias=v)
    # three A maps whose width (C = 96) is no multiple of the 64-column K
    # tile: the wrapper raises, and the C entry returns cudaErrorInvalidValue
    # (1) without launching anything
    wt3 = torch.zeros(128, 288, device=cuda, dtype=torch.bfloat16)
    v = torch.ones(128, device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        gemm_sm90.gemm_sm90_tail([a, a, a], wt3, "post", bias=v, scale=v,
                                 shift=v)
    out = torch.empty(64, 128, device=cuda, dtype=torch.bfloat16)
    lib = gemm_sm90._tail_lib()
    rc = lib.ws_gemm_sm90_tail(a.data_ptr(), a.data_ptr(), a.data_ptr(), 96,
                               wt3.data_ptr(), 288, v.data_ptr(),
                               v.data_ptr(), v.data_ptr(), None,
                               out.data_ptr(), 64, 128, 288, 0, 0, 3,
                               torch.cuda.current_stream().cuda_stream)
    assert rc == 1
    # the tanh and f32 forms take one A map; the tanh form needs a bias
    rc = lib.ws_gemm_sm90_tail(a.data_ptr(), a.data_ptr(), a.data_ptr(), 96,
                               wt3.data_ptr(), 288, None, None, None, None,
                               out.data_ptr(), 64, 128, 96, 0, 4, 1,
                               torch.cuda.current_stream().cuda_stream)
    assert rc == 1


@pytest.mark.parametrize("dtype,t,masked,dilation", [
    (torch.bfloat16, 37, True, 2), (torch.bfloat16, 100, False, 1),
    (torch.float32, 37, True, 2)])
def test_cam_block_never_reads_unwritten_channels(cuda, dtype, t, masked,
                                                  dilation):
    """Row 8 through its C entry into a dense map whose every channel past
    x is NaN before the call: each layer reads only its live ci channels,
    so the result is finite and equals the plain version."""
    rng = np.random.default_rng(21)
    b, c0, num_layers = 3, 128, 4
    args = cam_args(rng, num_layers, c0, cuda)
    x = torch.as_tensor(rng.standard_normal((b, t, c0)).astype(np.float32),
                        device=cuda).to(dtype)
    mask = None
    if masked:
        mask = torch.ones(b, t, device=cuda)
        mask[2, t // 2:] = 0
    out = torch.full((b, t, c0 + 32 * num_layers), float("nan"),
                     device=cuda, dtype=dtype)
    cam_block._launch(x, **args, dilation=dilation, seg_len=100, mask=mask,
                      out=out)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    want = cam_block.cam_dense_block_reference(x, **args, dilation=dilation,
                                               mask=mask)
    assert torch.equal(out[..., :c0], x)
    assert_matches(out[..., c0:].contiguous(), want[..., c0:].contiguous(),
                   dtype)


def _redesigned_calls(rng, dev):
    """One bf16 call of rows 1, 2, 3, 4, 5, 6 and 8 each, on seeded inputs
    with a ragged mask where the row takes one."""
    args, mask = se_args(rng, 3, 149, 512, torch.bfloat16, dev, True)
    chain = dict(kernels=args["cw"], biases=args["cb"], bn_scale=args["cs"],
                 bn_shift=args["ch"])
    cargs = cam_args(rng, 6, 128, dev)
    cx = torch.as_tensor(rng.standard_normal((3, 149, 128)).astype(
        np.float32), device=dev).to(torch.bfloat16)
    xs, targs, tmask = tail_args(rng, 3, 149, 512, torch.bfloat16, dev, True,
                                 True)
    tw = [targs[k] for k in ("wm", "bm", "k1", "b1", "k2", "b2")]
    g = torch.as_tensor(rng.standard_normal((3, 2 * 1536)).astype(
        np.float32), device=dev)
    fwd = mfa_astp_vjp.mfa_astp_train_fwd(*xs, *tw)
    res = (*xs, tw[0], tw[2], tw[5], tw[4], *fwd, g)
    return {"tail": lambda: mfa_astp.fused_mfa_astp(*xs, *tw, mask=tmask),
            "train_bwd": lambda: torch.cat([
                v.float().flatten() for v in
                mfa_astp_vjp.mfa_astp_train_bwd(*res)]),
            "softmax": lambda: pooling.fused_softmax_stats(
                fwd[1], fwd[1], tmask, concat=True),
            "train_fwd": lambda: torch.cat([
                v.float().flatten() for v in
                mfa_astp_vjp.mfa_astp_train_fwd(*xs, *tw)]),
            "se": lambda: se_block.fused_se_res2_block(**args, dilation=3,
                                                       mask=mask),
            "res2": lambda: res2_chain.fused_res2_chain(args["x"], **chain,
                                                        dilation=4),
            "cam": lambda: cam_block.fused_cam_dense_block(
                cx, **cargs, dilation=2, mask=mask)}


@pytest.mark.parametrize("row", ["se", "res2", "cam", "tail", "train_fwd",
                                 "train_bwd", "softmax"])
def test_redesigned_kernels_give_the_same_bits_twice(cuda, row):
    """No float atomics: two calls on the same input give the same bits."""
    fn = _redesigned_calls(np.random.default_rng(22), cuda)[row]
    first = fn()
    second = fn()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("glob", [True, False])
def test_tail_runs_its_large_products_on_gemm_sm90(cuda, glob):
    """A bf16 row-2 call and a bf16 row-4 call launch gemm_sm90 for the
    MFA, tanh and logits products, and with the global context for the
    context product too (three or four launches), and neither common.cuh's
    WMMA GEMM nor its FMA GEMM, by the launches each library counts by
    route where it makes them (`_build.gemm_routes`). torch.profiler once
    recorded no CUDA event at all for this test in a long session on the
    card, so the route is read from the library, not from its records."""
    from wespeaker_tpu_torch.ops import _build

    xs, args, mask = tail_args(np.random.default_rng(23), 3, 200, 512,
                               torch.bfloat16, cuda, True, glob)
    tw = [args[k] for k in ("wm", "bm", "k1", "b1", "k2", "b2")]
    for lib, call in (
            ("mfa_astp", lambda: mfa_astp.fused_mfa_astp(
                *xs, *tw, mask=mask, glob=glob)),
            ("mfa_astp_train", lambda: mfa_astp_vjp.mfa_astp_train_fwd(
                *xs, *tw, glob=glob))):
        call()
        torch.cuda.synchronize()
        before = _build.gemm_routes(lib)
        call()
        torch.cuda.synchronize()
        after = _build.gemm_routes(lib)
        launched = {k: after[k] - before[k] for k in after}
        assert launched["gemm_sm90"] == 3 + glob, launched
        assert launched["wmma"] == 0 and launched["fma"] == 0, launched


@pytest.mark.parametrize("glob", [True, False])
def test_train_bwd_runs_on_gemm_sm90_and_gemm_tn_sm90(cuda, glob):
    """A bf16 row-5 call: the logits, dpre, (glob) dcms, dacc and dx
    products on gemm_sm90 (five launches, four without the context), the
    three weight gradients in one gemm_tn_sm90 launch, and no WMMA or FMA
    GEMM, by the kernel names torch.profiler records."""
    from torch.profiler import ProfilerActivity, profile

    xs, w, g = train_args(np.random.default_rng(24), 3, 200, 512,
                          torch.bfloat16, cuda, glob)
    wm, bm, k1, b1, k2, b2 = w
    fwd = mfa_astp_vjp.mfa_astp_train_fwd(*xs, *w, glob=glob)
    res = (*xs, wm, k1, b2, k2, *fwd, g)
    mfa_astp_vjp.mfa_astp_train_bwd(*res, glob=glob)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mfa_astp_vjp.mfa_astp_train_bwd(*res, glob=glob)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("gemm_sm90_kernel" in n for n in names) == 4 + glob, names
    assert sum("gemm_tn_sm90_kernel" in n for n in names) == 1, names
    assert not any("wmma" in n or "fma_kernel" in n for n in names), names


@pytest.mark.parametrize("k,m,n", [(1000, 128, 256), (51, 384, 128),
                                   (51200, 256, 128), (4096, 1536, 1536)])
def test_gemm_tn_sm90_matches_plain(cuda, k, m, n):
    """The weight-gradient kernel alone: K no multiple of 64 (TMA reads
    zeros past it), a split count from 1 up, against a^T b in f32 (rtol
    1e-4, atol 1e-4 of the largest magnitude: sums over K in another
    order), and the same bits twice."""
    rng = np.random.default_rng(25)
    a = torch.as_tensor(rng.standard_normal((k, m)).astype(np.float32),
                        device=cuda).to(torch.bfloat16)
    b = torch.as_tensor(rng.standard_normal((k, n)).astype(np.float32),
                        device=cuda).to(torch.bfloat16)
    before = gemm_sm90.gemm_tn_sm90.launches
    got = gemm_sm90.gemm_tn_sm90(a, b)
    again = gemm_sm90.gemm_tn_sm90(a, b)
    torch.cuda.synchronize()
    assert gemm_sm90.gemm_tn_sm90.launches == before + 2
    assert torch.equal(got, again)
    scaled_close(got, gemm_sm90.gemm_tn_sm90_reference(a, b), "a^T b")
    with pytest.raises(ValueError):
        gemm_sm90.gemm_tn_sm90(a[:, :64], b)


def test_plda_llr_on_the_card_matches_the_cpu(cuda):
    """backend/plda.py's scoring on the card: llr_scores and score_trials
    (counts and multisession averaging) against the same f32 function on
    the CPU (rtol 1e-5, atol 1e-4), and within 1e-4 of each score's
    magnitude (floored at 1) of the function in f64 on the CPU."""
    from wespeaker_tpu_torch.backend import plda

    rng = np.random.default_rng(26)
    dim = 64
    spk2emb = {f"s{s}": rng.normal(size=(2 + s % 5, dim)) + 2 * rng.normal(
        size=dim) for s in range(40)}
    model = plda.TwoCovPLDA(dim, normalize_length=True).train(spk2emb, 3)
    enroll = {f"e{i}": rng.normal(size=(1 + i % 3, dim)) for i in range(30)}
    test = {f"t{i}": rng.normal(size=dim) for i in range(50)}
    trials = [(e, t) for e in enroll for t in test]
    for multi in (True, False):
        got = model.score_trials(enroll, test, trials, multi, device=cuda)
        want = model.score_trials(enroll, test, trials, multi, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    e = model.transform_embeddings(rng.normal(size=(500, dim)))
    t = model.transform_embeddings(rng.normal(size=(500, dim)))
    n = rng.integers(1, 6, size=500)
    got = model.llr_scores(e, t, n, device=cuda)
    np.testing.assert_allclose(got, model.llr_scores(e, t, n, device="cpu"),
                               rtol=1e-5, atol=1e-4)
    f64 = plda._llr(torch.as_tensor(model.psi), torch.as_tensor(e),
                    torch.as_tensor(t), torch.as_tensor(n[:, None],
                                                        dtype=torch.float64))
    f64 = f64.numpy()
    assert (np.abs(got - f64) <= 1e-4 * np.maximum(np.abs(f64), 1)).all()
