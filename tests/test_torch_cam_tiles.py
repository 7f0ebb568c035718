"""The bf16 CAM++ dense-block kernel's plans and arithmetic, on the CPU.

- The GEMM's partial-sum workspace (`ops.cam_block.segment_units`,
  `partial_slots`): every row of M = B*T lies in exactly one (segment,
  slot), each slot a segment uses holds at least one of its rows, and the
  slots fit the workspace, at T' = 1, 37, 100, 249, 250 and segment lengths
  1, 64, 100 and longer than T. The conv's 128-frame tiles cover every
  frame once (`tap_items`: 128-frame items, two a CTA), and its TMA box and
  shared memory fit.
- A plain-torch emulation of what the kernel computes: per layer, the A
  operand read with a K extent of exactly ci (never the channels past it),
  BN1-relu, the 1x1 product and BN2-relu; the masked partial sums of h over
  each 64-row unit of M and each segment, row by row in order; the gate of
  each segment from those partials; the k=3 dilated conv on 128-frame tiles
  of one utterance with a d-frame halo (zeros past the utterance's ends),
  times the gate. In f32 it matches JAX's `cam_dense_block_reference` at
  rtol/atol 1e-5 (the same arithmetic, sums in another order) at T' = 37,
  100 and 250, masked and not. With the dense map's channels past x filled
  with NaN before the call, the emulation stays finite; one that reads the
  zero-padded K of w1 (C_end columns) does not.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.ops import cam_block_pallas as jcam  # noqa: E402
from wespeaker_tpu_torch.ops import cam_block  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,t,seg_len", [
    (3, 100, 100), (7, 37, 100), (2, 249, 100), (2, 250, 100), (5, 1, 100),
    (3, 100, 64), (2, 37, 1), (3, 50, 300), (512, 100, 100)])
def test_partial_slots_cover_each_row_once(b, t, seg_len):
    units = cam_block.segment_units(b, t, seg_len)
    slots = cam_block.partial_slots(t, seg_len)
    assert len(units) == b * -(-t // seg_len)
    hits = np.zeros(b * t, np.int64)
    for r0, r1, u0, n in units:
        assert 1 <= n <= slots
        for i in range(n):
            lo, hi = max(r0, (u0 + i) * 64), min(r1, (u0 + i + 1) * 64)
            assert hi > lo  # every slot a segment uses holds some of it
            hits[lo:hi] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("t,dilation,seg_len", [
    (100, 1, 100), (100, 2, 100), (37, 2, 100), (249, 2, 100), (1, 1, 100),
    (149, 2, 1), (300, 64, 100)])
def test_conv_tiles_cover_each_frame_once_and_fit(t, dilation, seg_len):
    rows, b = cam_block.TAP_ROWS, 3
    hits = np.zeros((b, t), np.int64)
    per_cta = {}
    for cta, bi, t0 in cam_block.tap_items(b, t):
        hits[bi, t0:t0 + rows] += 1
        per_cta[cta] = per_cta.get(cta, 0) + 1
    assert (hits == 1).all()
    assert max(per_cta.values()) <= cam_block.TAP_ITEMS
    assert rows + 2 * dilation <= 256  # one TMA box of h rows
    assert cam_block.tap_smem_bytes(dilation, seg_len, t) <= 232448


def _case(rng, b, t, c0, num_layers, masked):
    cend = c0 + 32 * num_layers

    def r(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    live = (np.arange(cend)[None] < (c0 + 32 * np.arange(num_layers))[:, None]
            ).astype(np.float32)
    args = dict(s1=(1 + r(num_layers, cend, s=.1)) * live,
                t1=r(num_layers, cend, s=.1) * live,
                w1=r(num_layers, cend, 128, s=c0 ** -0.5) * live[..., None],
                s2=1 + r(num_layers, 128, s=.1), t2=r(num_layers, 128, s=.1),
                w2=r(num_layers, 3, 128, 32, s=384 ** -0.5),
                wc1=r(num_layers, 128, 64, s=128 ** -0.5),
                bc1=r(num_layers, 64, s=.1),
                wc2=r(num_layers, 64, 32, s=64 ** -0.5),
                bc2=r(num_layers, 32, s=.1))
    mask = None
    if masked:
        lens = rng.integers(t // 2, t + 1, b)
        lens[0] = t
        mask = (np.arange(t)[None] < lens[:, None]).astype(np.float32)
    return r(b, t, c0), args, mask


def emulate(x, s1, t1, w1, s2, t2, w2, wc1, bc1, wc2, bc2, dilation,
            seg_len=100, mask=None, read_padded=False):
    """What csrc/cam_block.cu's bf16 path computes, in x's type, into a
    dense map whose channels past x start as NaN."""
    io = x.dtype
    b, t, c0 = x.shape
    num_layers = w1.shape[0]
    cend = c0 + 32 * num_layers
    m, d = b * t, dilation
    nseg = -(-t // seg_len)
    out = torch.full((b, t, cend), float("nan"), dtype=io)
    out[..., :c0] = x
    mflat = torch.ones(m) if mask is None else mask.reshape(m)
    units = cam_block.segment_units(b, t, seg_len)
    slots = cam_block.partial_slots(t, seg_len)
    for i in range(num_layers):
        ci = c0 + 32 * i
        k = cend if read_padded else ci  # the A tensor map's K extent
        a = out.reshape(m, cend)[:, :k].float()
        a = torch.relu(a * s1[i, :k] + t1[i, :k]).to(io).float()
        h = torch.relu((a @ w1[i, :k].to(io).float()) * s2[i] + t2[i]).to(io)
        # the GEMM epilogue's partial sums, a unit's rows in order
        part = torch.zeros(len(units), slots, 128)
        for g, (r0, r1, u0, n) in enumerate(units):
            for j in range(n):
                s = torch.zeros(128)
                for row in range(max(r0, (u0 + j) * 64),
                                 min(r1, (u0 + j + 1) * 64)):
                    s = s + h[row].float() * mflat[row]
                part[g, j] = s
        # the gate of each segment, from the partials in order
        gate = torch.zeros(b, nseg, 32)
        for bi in range(b):
            seg = [part[bi * nseg + s, :units[bi * nseg + s][3]].sum(0)
                   for s in range(nseg)]
            gsum = torch.zeros(128)
            for v in seg:
                gsum = gsum + v
            mb = mflat[bi * t:(bi + 1) * t]
            gmean = gsum / max(float(mb.sum()), 1.0)
            for s in range(nseg):
                cnt = float(mb[s * seg_len:(s + 1) * seg_len].sum())
                ctx = (gmean + seg[s] / max(cnt, 1.0)).to(io).float()
                hid = torch.relu(ctx @ wc1[i].to(io).float() + bc1[i])
                hid = hid.to(io).float()
                gate[bi, s] = torch.sigmoid(hid @ wc2[i].to(io).float()
                                            + bc2[i])
        # the conv on 128-frame tiles with a d-frame halo, times the gate
        hb = h.reshape(b, t, 128).float()
        taps = w2[i].to(io).float()
        rows = cam_block.TAP_ROWS
        for bi in range(b):
            for t0 in range(0, t, rows):
                tile = torch.zeros(rows + 2 * d, 128)
                lo, hi = max(0, t0 - d), min(t, t0 + rows + d)
                tile[lo - (t0 - d):hi - (t0 - d)] = hb[bi, lo:hi]
                y = sum(tile[kk * d:kk * d + rows] @ taps[kk]
                        for kk in range(3))
                for r in range(min(rows, t - t0)):
                    out[bi, t0 + r, ci:ci + 32] = (
                        y[r] * gate[bi, (t0 + r) // seg_len]).to(io)
    return out


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t,dilation", [(37, 2), (100, 1), (250, 2)])
def test_emulation_matches_jax_reference(t, dilation, masked):
    rng = np.random.default_rng(30)
    x, args, mask = _case(rng, 2, t, 64, 3, masked)
    want = np.asarray(jcam.cam_dense_block_reference(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in args.items()},
        dilation=dilation, seg_len=100,
        mask=None if mask is None else jnp.asarray(mask)))
    got = emulate(torch.from_numpy(x),
                  **{k: torch.from_numpy(v) for k, v in args.items()},
                  dilation=dilation, seg_len=100,
                  mask=None if mask is None else torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_reading_the_padded_k_meets_the_nan_channels():
    """The dense map's channels past ci are not written yet (NaN here):
    reading them through w1's zero padding gives NaN * 0 = NaN, reading a K
    extent of ci does not."""
    rng = np.random.default_rng(31)
    x, args, _ = _case(rng, 2, 37, 64, 3, False)
    targs = {k: torch.from_numpy(v) for k, v in args.items()}
    good = emulate(torch.from_numpy(x), **targs, dilation=2)
    bad = emulate(torch.from_numpy(x), **targs, dilation=2, read_padded=True)
    assert torch.isfinite(good).all()
    assert not torch.isfinite(bad[..., 64:]).all()
