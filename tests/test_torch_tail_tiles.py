"""The bf16 MFA+ASTP forward chain's plans and arithmetic (rows 2 and 4,
csrc/mfa_astp_fwd.cuh on csrc/gemm_sm90.cuh), on the CPU.

- gemm_sm90's three-map K walk (`ops.gemm_sm90.k_walk`, which the C
  launcher mirrors): K tile kt of the MFA conv reads A map kt // (C / 64)
  at column (kt % (C / 64)) * 64, every column of every map once, at C =
  512 and 1024; C % 64 != 0 is refused. The 128-row output tiles
  (`tile_utterances`) cover every row of M = B*T once and give each row
  its own utterance, r // t, for the tanh form's row bias: tiles straddle
  utterances at T = 1, 21, 37, 200 and 201 (B*T no multiple of 128).
- A plain-torch emulation of what the kernels compute, tile by tile: h
  from the K walk over the three inputs, relu(acc + bm) * 1 + 0; the
  context stats (masked, unbiased, + 1e-7; in training the f32 residual and
  its rounded copy) and the context product (the f32 form, W the context
  columns of the same K-major k1); att = tanh(acc + ctx[r // t])
  row by row in each 128-row tile (or + b1 without the context); the f32
  logits acc + b2; the masked softmax over T and the weighted stats. In
  f32 it matches JAX's `mfa_astp_reference` and `fused_mfa_astp(...,
  interpret=True)` at rtol/atol 1e-5, glob and not, masked and not, C =
  512 and 1024 (at T = 1 the std half is the rounding of h^2 alone, on
  which JAX's two paths differ, and is held to that rounding's size); for
  the training forward, JAX's `_fwd_values` (the Pallas
  kernel in interpret mode: pooled, h, att, cstats) and
  `mfa_astp_train_reference`. An emulation that gives a whole tile its
  first row's utterance misses where tiles straddle utterances.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.ops import mfa_astp_pallas as jtail  # noqa: E402
from wespeaker_tpu.ops import mfa_astp_vjp as jvjp  # noqa: E402
from wespeaker_tpu_torch.ops import gemm_sm90 as g9  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
D, A = 256, 128  # two 128-column tiles of the MFA conv; the attention width


@pytest.mark.parametrize("c", [512, 1024, 64, 192])
def test_k_walk_reads_every_column_of_every_map_once(c):
    walk = g9.k_walk(3 * c, 3)
    kpt = c // 64
    assert len(walk) == 3 * kpt
    seen = np.zeros((3, c), np.int64)
    for kt, (part, col) in enumerate(walk):
        # the launcher's formula: part kt / kpt, column (kt % kpt) * 64
        assert (part, col) == (kt // kpt, (kt % kpt) * 64)
        seen[part, col:col + 64] += 1
    assert (seen == 1).all()
    assert g9.k_walk(c, 1) == [(0, 64 * i) for i in range(kpt)]


@pytest.mark.parametrize("c", [96, 520, 32])
def test_k_walk_refuses_a_map_of_no_whole_k_tile(c):
    with pytest.raises(ValueError, match="multiple of 64"):
        g9.k_walk(3 * c, 3)


@pytest.mark.parametrize("b,t", [(5, 1), (3, 21), (3, 37), (2, 200),
                                 (2, 201), (512, 200), (7, 37)])
def test_row_tiles_cover_each_row_once_with_its_utterance(b, t):
    m = b * t
    hits = np.zeros(m, np.int64)
    straddle = 0
    for m0, utt in g9.tile_utterances(m, t):
        assert m0 % 128 == 0 and 1 <= len(utt) <= 128
        rows = np.arange(m0, m0 + len(utt))
        hits[rows] += 1
        assert (utt.numpy() == rows // t).all()
        straddle += int(utt[0] != utt[-1])
    assert (hits == 1).all()
    # T does not divide the tile's 128 rows: some tile holds rows of two
    # utterances
    assert straddle > 0


def _gemm_tiles(parts, wt, n_cols, epilogue, t, first_row_utt=False):
    """gemm_sm90 on (M, kp) parts and W K-major, tile by tile: each
    128 x 128 output tile sums its 64-column K tiles in the walk's order,
    then applies epilogue(acc, rows, utterances) to the tile."""
    m, kp = parts[0].shape
    k = kp * len(parts)
    out = None
    for m0, utt in g9.tile_utterances(m, t):
        rows = slice(m0, m0 + len(utt))
        if first_row_utt:
            utt = torch.full_like(utt, int(utt[0]))
        for n0 in range(0, n_cols, 128):
            acc = torch.zeros(len(utt), 128)
            for kt, (part, col) in enumerate(g9.k_walk(k, len(parts))):
                acc += (parts[part][rows, col:col + 64]
                        @ wt[n0:n0 + 128, kt * 64:(kt + 1) * 64].t())
            v = epilogue(acc, n0, utt)
            if out is None:
                out = torch.empty(m, n_cols, dtype=v.dtype)
            out[rows, n0:n0 + 128] = v
    return out


def emulate_chain(xs, wm, bm, k1, b1, k2, b2, mask, glob,
                  io=torch.float32, first_row_utt=False):
    """What csrc/mfa_astp_fwd.cuh computes, as the kernels tile it: ->
    (pooled, h, att, cstats). xs (B, T, C) each, the weights as the
    wrappers receive them (wm (3C, D), k1 (3D or D, A), k2 (A, D)); the
    kernels read W K-major, their .t()."""
    b, t, c = xs[0].shape
    d, a, m = wm.shape[1], k2.shape[0], b * t
    parts = [x.reshape(m, c) for x in xs]
    wmt, k1t, k2t = wm.t(), k1.t(), k2.t()
    # 1. h: the post form with scale 1 and shift 0
    h = _gemm_tiles(parts, wmt, d, lambda acc, n0, _: (torch.relu(
        acc + bm[n0:n0 + 128]) * 1.0 + 0.0).to(io), t)
    hf = h.float().reshape(b, t, d)
    cstats = torch.zeros(b, 2 * d)
    if glob:
        # 2. the context stats over the valid frames, unbiased, + 1e-7
        mk = (torch.ones(b, t) if mask is None else mask)[..., None]
        cnt = mk.sum(1)
        mean = (hf * mk).sum(1) / (torch.clamp(cnt, min=1.0) if mask
                                   is not None else float(t))
        var = (((hf - mean[:, None]) ** 2) * mk).sum(1) / torch.clamp(
            cnt - 1.0, min=1.0)
        cstats = torch.cat([mean, torch.sqrt(var + 1e-7)], dim=-1)
        # 3. ctx = [cmean | cstd] (rounded) @ [k1m; k1s] + b1: the f32 form
        #    over one row an utterance, W the context columns of k1.t()
        ctx = _gemm_tiles([cstats.to(io).float()], k1t[:, d:], a,
                          lambda acc, n0, _: acc + b1[n0:n0 + 128], 1)

        def tanh_rb(acc, n0, utt):
            return torch.tanh(acc + ctx[utt, n0:n0 + 128]).to(io)
    else:
        def tanh_rb(acc, n0, utt):
            return torch.tanh(acc + b1[n0:n0 + 128]).to(io)
    # 4. att: the tanh form, each row its utterance's bias; K = D of the
    #    (A, ldk1) weight
    att = _gemm_tiles([h.float()], k1t[:, :d], a, tanh_rb, t, first_row_utt)
    # 5. logits: the f32 form
    logits = _gemm_tiles([att.float()], k2t, d,
                         lambda acc, n0, _: acc + b2[n0:n0 + 128], t)
    # 6. softmax over T, masked frames at -1e30, weighted stats
    lg = logits.reshape(b, t, d)
    if mask is not None:
        lg = torch.where(mask[..., None] > 0, lg, torch.full_like(lg, -1e30))
    e = torch.exp(lg - lg.amax(1, keepdim=True))
    s = e.sum(1)
    mu = (e * hf).sum(1) / s
    # the kernel's s2 += (e h) h and var = s2 / s - mu mu are contracted
    # multiply-adds (one rounding each): in float64, exact for f32 products,
    # then rounded. At T = 1 var is that rounding alone (the std sits near
    # its floor sqrt(1e-7)), so the contraction decides the bits there.
    s2 = ((e * hf).double() * hf.double()).sum(1).float()
    var = ((s2 / s).double() - mu.double() ** 2).float()
    pooled = torch.cat([mu, torch.sqrt(torch.clamp(var, min=1e-7))], -1)
    return pooled, h.reshape(b, t, d), att.reshape(b, t, a), cstats


def _case(seed, b, t, c, glob, masked):
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    xs = [r(b, t, c) for _ in range(3)]
    w = dict(wm=r(3 * c, D, s=(3 * c) ** -0.5), bm=r(D, s=.1),
             k1=r((3 if glob else 1) * D, A, s=D ** -0.5), b1=r(A, s=.1),
             k2=r(A, D, s=A ** -0.5), b2=r(D, s=.1))
    mask = None
    if masked:
        lens = rng.integers(max(t // 2, 1), t + 1, b)
        lens[0] = t
        mask = (np.arange(t)[None] < lens[:, None]).astype(np.float32)
    return xs, w, mask


@pytest.mark.parametrize("b,t,c,glob,masked", [
    (3, 37, 512, True, True), (2, 201, 1024, True, False),
    (5, 1, 512, True, False), (3, 21, 1024, False, True),
    (2, 200, 512, False, False), (2, 200, 512, True, True)])
def test_emulation_matches_jax_inference(b, t, c, glob, masked):
    xs, w, mask = _case(10 + t, b, t, c, glob, masked)
    tx = [torch.from_numpy(v) for v in xs]
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    tm = None if mask is None else torch.from_numpy(mask)
    got = emulate_chain(tx, **tw, mask=tm, glob=glob)[0].numpy()
    jx = [jnp.asarray(v) for v in xs]
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jm = None if mask is None else jnp.asarray(mask)
    want_ref = np.asarray(jtail.mfa_astp_reference(*jx, **jw, mask=jm,
                                                   glob=glob))
    want_kernel = np.asarray(jtail.fused_mfa_astp(*jx, **jw, mask=jm,
                                                  glob=glob, interpret=True))
    assert got.shape == (b, 2 * D)
    if t == 1:
        # one frame: the weighted variance is E[h^2] - E[h]^2 = the
        # rounding of h^2 alone, whose bits depend on where a sum contracts
        # into a multiply-add (JAX's reference and its Pallas kernel differ
        # by up to 2e-4 here). The mean half is held at 1e-5; the std half,
        # sqrt of at most one rounding of h^2, within sqrt(2^-22) max |h|.
        hmax = float(np.abs(emulate_chain(tx, **tw, mask=tm,
                                          glob=glob)[1].numpy()).max())
        for want in (want_ref, want_kernel):
            np.testing.assert_allclose(got[:, :D], want[:, :D], **TOL)
            np.testing.assert_allclose(got[:, D:], want[:, D:], rtol=0,
                                       atol=2.0 ** -11 * hmax)
    else:
        np.testing.assert_allclose(got, want_ref, **TOL)
        np.testing.assert_allclose(got, want_kernel, **TOL)
    if glob and t % 128 and b * t > 128:
        # a tile that straddles utterances needs each row's own bias
        wrong = emulate_chain(tx, **tw, mask=tm, glob=glob,
                              first_row_utt=True)[0].numpy()
        assert not np.allclose(wrong, want_ref, **TOL)


@pytest.mark.parametrize("b,t,c,glob", [(3, 37, 512, True),
                                        (2, 201, 1024, True),
                                        (3, 21, 512, False)])
def test_emulation_matches_jax_train_forward(b, t, c, glob):
    xs, w, _ = _case(20 + t, b, t, c, glob, False)
    tx = [torch.from_numpy(v) for v in xs]
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    got = [v.numpy() for v in emulate_chain(tx, **tw, mask=None,
                                            glob=glob)]
    jx = [jnp.asarray(v) for v in xs]
    jw = [jnp.asarray(w[k]) for k in ("wm", "bm", "k1", "b1", "k2", "b2")]
    want = [np.asarray(v) for v in jvjp._fwd_values(*jx, *jw, glob, True)]
    for name, g, wv in zip(("pooled", "h", "att", "cstats"), got, want):
        assert g.shape == wv.shape, name
        np.testing.assert_allclose(g, wv, **TOL, err_msg=name)
    np.testing.assert_allclose(got[0], np.asarray(
        jvjp.mfa_astp_train_reference(*jx, *jw, glob=glob)), **TOL)
