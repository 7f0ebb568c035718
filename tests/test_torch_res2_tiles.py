"""The bf16 Res2 chain kernel on the tensor cores (rows 1 and 3) and the SE
block's squeeze from the GEMM's partial sums, on the CPU.

- The chain's tile plan (`ops.se_block.chain_plan`): its output tiles cover
  every frame of an utterance exactly once, step 0's input covers the
  region and a d-frame halo, and it fits the card's shared memory, at
  widths 64 and 128, dilations 2-4 and T = 1, 37, 200, 300 and 6000; a
  dilation that leaves no frame a tile raises. The squeeze's workspace
  slots (`squeeze_slots`) cover each row of an utterance once.
- A plain-torch emulation of what `res2_chain_tc_kernel` computes: per
  tile, every step over a region of 256 (width 64) or 128 (width 128)
  frames from t0 - (nums - 1) d, the step's input held as the kernel holds
  it (step 0 h1's group 0 over the region and a d-frame halo; step s + 1
  y + h1's group s + 1 over the region, rounded, zero outside the
  utterance, the halo rows left as they were), bf16-rounded operands
  (x's type) and f32 sums, only the tile's frames written. It matches JAX's
  `res2_chain_reference` in f32 at rtol/atol 1e-5 at T = 37 and 300 (two
  tiles), dilations 2 and 4; left without the zeroing outside the
  utterance, it misses at the edges. Through the whole SE-Res2 block, with
  the squeeze's mean from per-unit partial sums in order, it matches
  `se_res2_block_reference` at 1e-5, masked and not.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.ops import res2_pallas as jres2  # noqa: E402
from wespeaker_tpu.ops import se_block_pallas as jse  # noqa: E402
from wespeaker_tpu_torch.ops import cam_block, se_block  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("dilation", [2, 3, 4])
@pytest.mark.parametrize("t", [1, 37, 200, 300, 6000])
def test_chain_plan_covers_each_frame_once_and_fits(t, dilation, width):
    nums = 7
    plan = se_block.chain_plan(t, width, nums, dilation)
    hits = np.zeros(t, np.int64)
    for ti in range(plan.tiles):
        t0 = ti * plan.frames
        hits[t0:t0 + plan.frames] += 1
        # the final step is right on [fa + (nums - 1) d, fa + rows - ...)
        fa = t0 - (nums - 1) * dilation
        assert fa + (nums - 1) * dilation == t0
        assert fa + plan.rows - (nums - 1) * dilation == t0 + plan.frames
    assert (hits == 1).all()
    assert plan.sp_rows >= plan.rows + 2 * dilation
    assert plan.sp_rows % 128 == 0  # whole TMA boxes
    assert plan.smem <= 232448


def test_chain_plan_refuses_what_leaves_no_frame():
    with pytest.raises(ValueError, match="no frame"):
        se_block.chain_plan(200, 128, 7, 11)
    with pytest.raises(ValueError, match="widths"):
        se_block.chain_plan(200, 32, 7, 2)


@pytest.mark.parametrize("b,t", [(3, 200), (2, 37), (4, 1), (2, 6000)])
def test_squeeze_slots_cover_each_row_once(b, t):
    units = cam_block.segment_units(b, t, t)
    assert all(n <= se_block.squeeze_slots(t) for *_, n in units)
    hits = np.zeros(b * t, np.int64)
    for r0, r1, u0, n in units:
        for i in range(n):
            hits[max(r0, (u0 + i) * 64):min(r1, (u0 + i + 1) * 64)] += 1
    assert (hits == 1).all()


def emulate_chain(h1, cw, cb, cs, ch, dilation, zero_outside=True):
    """What csrc/se_block.cu's res2_chain_tc_kernel computes, tile by tile,
    in h1's type."""
    io = h1.dtype
    b, t, c = h1.shape
    nums, _, w, _ = cw.shape
    d = dilation
    plan = se_block.chain_plan(t, w, nums, d)
    taps = cw.to(io).float()
    y = torch.empty_like(h1)
    y[..., nums * w:] = h1[..., nums * w:]

    def group(bi, g, frames):  # h1's group g at these frames, zero outside
        v = torch.zeros(len(frames), w, dtype=io)
        ok = (frames >= 0) & (frames < t)
        v[ok] = h1[bi, frames[ok], g * w:(g + 1) * w]
        return v

    for bi in range(b):
        for ti in range(plan.tiles):
            t0 = ti * plan.frames
            fa = t0 - (nums - 1) * d
            region = torch.arange(fa, fa + plan.rows)
            inside = (region >= 0) & (region < t)
            keep = (region >= t0) & (region < min(t0 + plan.frames, t))
            sp = group(bi, 0, torch.arange(fa - d, fa + plan.rows + d))
            for s in range(nums):
                spf = sp.float()
                acc = sum(spf[k * d:k * d + plan.rows] @ taps[s, k]
                          for k in range(3))
                yv = (torch.relu(acc + cb[s]) * cs[s] + ch[s]).to(io)
                y[bi, region[keep], s * w:(s + 1) * w] = yv[keep]
                if s + 1 < nums:
                    nxt = (yv.float() + group(bi, s + 1, region).float()
                           ).to(io)
                    if zero_outside:
                        nxt[~inside] = 0
                    sp = sp.clone()
                    sp[d:d + plan.rows] = nxt
    return y


def _chain_case(rng, b, t, c):
    w = c // 8

    def r(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return r(b, t, c), dict(kernels=r(7, 3, w, w, s=(3 * w) ** -0.5),
                            biases=r(7, w, s=.1), bn_scale=1 + r(7, w, s=.1),
                            bn_shift=r(7, w, s=.1))


@pytest.mark.parametrize("t,dilation", [(37, 2), (300, 4), (300, 2)])
def test_chain_emulation_matches_jax_reference(t, dilation):
    x, args = _chain_case(np.random.default_rng(40), 2, t, 512)
    want = np.asarray(jres2.res2_chain_reference(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in args.items()},
        dilation=dilation))
    ta = [torch.from_numpy(args[k]) for k in ("kernels", "biases",
                                               "bn_scale", "bn_shift")]
    got = emulate_chain(torch.from_numpy(x), *ta, dilation)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_chain_emulation_needs_the_zeroing_outside_the_utterance():
    """The region reaches past the utterance's ends; the next step's input
    there must be the conv's zero padding, not y + h1."""
    x, args = _chain_case(np.random.default_rng(41), 1, 37, 512)
    want = np.asarray(jres2.res2_chain_reference(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in args.items()},
        dilation=2))
    ta = [torch.from_numpy(args[k]) for k in ("kernels", "biases",
                                               "bn_scale", "bn_shift")]
    got = emulate_chain(torch.from_numpy(x), *ta, 2, zero_outside=False)
    assert not np.allclose(got.numpy(), want, **TOL)


def emulate_se_block(x, w1, b1, s1, h1, cw, cb, cs, ch, w2, b2, s2, h2, sw1,
                     sb1, sw2, sb2, dilation, mask=None):
    """The bf16 SE-Res2 block's launches, in x's type: the two GEMMs, the
    emulated chain, the squeeze's mean from per-unit partial sums of the
    stored h2 (one segment an utterance), the excitation, the residual."""
    io = x.dtype
    b, t, c = x.shape

    def pw(v, w, bias, scale, shift):
        acc = v.float() @ w.to(io).float() + bias
        return (torch.relu(acc) * scale + shift).to(io)

    h1v = pw(x, w1, b1, s1, h1)
    yv = emulate_chain(h1v, cw, cb, cs, ch, dilation)
    h2v = pw(yv, w2, b2, s2, h2).reshape(b * t, c)
    mflat = torch.ones(b * t) if mask is None else mask.reshape(b * t)
    mean = torch.empty(b, c)
    for g, (r0, r1, u0, n) in enumerate(cam_block.segment_units(b, t, t)):
        total = torch.zeros(c)
        for j in range(n):
            lo, hi = max(r0, (u0 + j) * 64), min(r1, (u0 + j + 1) * 64)
            total = total + (h2v[lo:hi].float() * mflat[lo:hi, None]).sum(0)
        cnt = t if mask is None else max(float(mask[g].sum()), 1.0)
        mean[g] = total / cnt
    z = torch.relu(mean.to(io).float() @ sw1.to(io).float() + sb1)
    g = torch.sigmoid(z.to(io).float() @ sw2.to(io).float() + sb2)
    return (x.float() + h2v.reshape(b, t, c).float() * g[:, None]).to(io)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t", [37, 200])
def test_se_block_emulation_matches_jax_reference(t, masked):
    rng = np.random.default_rng(42)
    b, c = 2, 512
    x, chain = _chain_case(rng, b, t, c)

    def r(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    args = dict(w1=r(c, c, s=c ** -0.5), b1=r(c, s=.1), s1=1 + r(c, s=.1),
                h1=r(c, s=.1), cw=chain["kernels"], cb=chain["biases"],
                cs=chain["bn_scale"], ch=chain["bn_shift"],
                w2=r(c, c, s=c ** -0.5), b2=r(c, s=.1), s2=1 + r(c, s=.1),
                h2=r(c, s=.1), sw1=r(c, 128, s=c ** -0.5), sb1=r(128, s=.1),
                sw2=r(128, c, s=128 ** -0.5), sb2=r(c, s=.1))
    mask = None
    if masked:
        mask = np.ones((b, t), np.float32)
        mask[1, t // 2:] = 0
    want = np.asarray(jse.se_res2_block_reference(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in args.items()},
        dilation=3, mask=None if mask is None else jnp.asarray(mask)))
    got = emulate_se_block(
        torch.from_numpy(x), **{k: torch.from_numpy(v)
                                for k, v in args.items()},
        dilation=3, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
