"""The bf16 MFA+ASTP forward chain's plans and arithmetic (rows 2 and 4,
csrc/mfa_astp_fwd.cuh on csrc/gemm_sm90.cuh), on the CPU.

- gemm_sm90's three-map K walk (`ops.gemm_sm90.k_walk`, which the C
  launcher mirrors): K tile kt of the MFA conv reads A map kt // (C / 64)
  at column (kt % (C / 64)) * 64, every column of every map once, at C =
  256, 512 and 1024; C % 64 != 0 is refused. The 128-row output tiles
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
  256 (the quality smoke's ECAPA), 512 and 1024 (at T = 1 the std half is the rounding of h^2 alone, on
  which JAX's two paths differ, and is held to that rounding's size); for
  the training forward, JAX's `_fwd_values` (the Pallas
  kernel in interpret mode: pooled, h, att, cstats) and
  `mfa_astp_train_reference`. An emulation that gives a whole tile its
  first row's utterance misses where tiles straddle utterances.
- The bf16 backward's plans (csrc/mfa_astp_train.cu on gemm_sm90 and
  gemm_tn_sm90): the weight-gradient launch's units (`ops.gemm_sm90.
  tn_units`, mirrored by the C launcher) give every output tile every K
  row once, splits in order, and fill their last wave of 132 SMs to at
  least 95% at the flagship shape; row tile m0 of dwm reads x_{2 + m0 // C} at column m0 % C; the
  dx launch's column tile n0 writes dx_{2 + n0 // C} (`dx_tiles`).
- A plain-torch emulation of the backward as the kernels compute it: the
  logits in the f32 form; the softmax backward by 64-channel groups, four
  frame strides per channel with rescaled sums, staged `softmax_bwd_frames`
  frames at a time (and, forced, 16 at a time: the chunked path); dpre in
  the tanh_grad form with dctx from the partial sums (each utterance's
  64-row-unit slots in order, the unwritten ones NaN); dcms in the f32
  form and the context terms h k + c0 per (utterance, channel); dacc in
  the relu_grad form with each row's own utterance's terms and dbm from
  the partial sums; dx in the plain form over N = 3C,
  each column tile into its dx_i; the weight gradients unit by unit and
  their splits summed in order. In f32 it matches JAX's `_bwd_pallas`
  (interpret mode) and `_bwd_jnp`, all nine gradients, at rtol 1e-5 and
  atol 1e-5 of each gradient's largest magnitude (sums over B*T rows in
  another order), at T = 37 and 201 (tiles straddle utterances), C = 256,
  512 and 1024, glob on and off; with the tile's first-row utterance in the
  relu_grad form it misses.
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
from wespeaker_tpu_torch.ops import mfa_astp_vjp as tvjp  # noqa: E402
from wespeaker_tpu_torch.ops.gemm_sm90 import (partial_slots,  # noqa: E402
                                               segment_units)

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
D, A = 256, 128  # two 128-column tiles of the MFA conv; the attention width


@pytest.mark.parametrize("c", [512, 1024, 256, 64, 192])
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
    return _gemm_tiles_rows(parts, wt, n_cols,
                            lambda acc, rows, n0, utt: epilogue(acc, n0,
                                                                utt),
                            t, first_row_utt)


def _gemm_tiles_rows(parts, wt, n_cols, epilogue, t, first_row_utt=False):
    """_gemm_tiles whose epilogue(acc, rows, n0, utterances) also gets the
    tile's rows (a slice of M), for the forms that read per-element
    operands."""
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
            v = epilogue(acc, rows, n0, utt)
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
    (2, 200, 512, False, False), (2, 200, 512, True, True),
    (3, 37, 256, True, True), (3, 37, 256, False, True)])
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
                                        (3, 21, 512, False),
                                        (3, 37, 256, True),
                                        (3, 37, 256, False)])
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


# ---- the bf16 backward (row 5) ----

GRADS = ["dx2", "dx3", "dx4", "dwm", "dbm", "dk1", "db1", "dk2", "db2"]


@pytest.mark.parametrize("b,t,c", [(3, 37, 512), (2, 201, 1024),
                                   (256, 200, 512), (256, 200, 1024),
                                   (5, 1, 512), (64, 200, 256)])
def test_weight_grad_units_cover_every_k_row_once(b, t, c):
    """dwm (3C, D), dk2 (A, D), dk1x (D, A) at D = 1536, A = 128: each
    output tile gets each 64-row K tile once, its splits in order; dwm's
    row tile m0 reads x_{2 + m0 // C} at column m0 % C."""
    d, a, k = 1536, 128, b * t
    products = [(3, c, d), (1, a, d), (1, d, a)]
    units = list(g9.tn_units(products, k))
    ktiles = -(-k // 64)
    seen = {}
    for u in units:
        key = (u["q"], u["m0"], u["n0"])
        seen.setdefault(key, []).append((u["split"], u["k0"], u["k1"]))
        parts, a_cols, n = products[u["q"]]
        assert 0 <= u["part"] < parts and u["col"] + 128 <= (
            a_cols if parts > 1 else a_cols * parts)
        if u["q"] == 0:
            assert (u["part"], u["col"]) == (u["m0"] // c, u["m0"] % c)
    want_tiles = sum(p * ac // 128 * n // 128 for p, ac, n in products)
    assert len(seen) == want_tiles
    for runs in seen.values():
        splits = [s for s, _, _ in runs]
        assert splits == sorted(splits) == list(range(len(runs)))
        edges = [k0 for _, k0, _ in runs] + [runs[-1][2]]
        assert edges[0] == 0 and edges[-1] == 64 * ktiles
        assert all(k1 == k0 for (_, _, k1), (_, k0, _) in zip(runs,
                                                                runs[1:]))
        assert all(k1 > k0 for _, k0, k1 in runs)
    if b == 256:
        # the flagship: the units fill their last wave of 132 SMs to >= 95%
        waves = -(-len(units) // 132)
        assert len(units) / (132 * waves) >= 0.95


@pytest.mark.parametrize("c", [512, 1024, 256, 128])
def test_dx_column_tiles_write_each_output_once(c):
    hits = np.zeros((3, c), np.int64)
    for n0, (o, col) in zip(range(0, 3 * c, 128), tvjp.dx_tiles(c)):
        assert (o, col) == (n0 // c, n0 % c) and col + 128 <= c
        hits[o, col:col + 128] += 1
    assert (hits == 1).all()
    with pytest.raises(ValueError, match="128"):
        tvjp.dx_tiles(192)


def _partial_sums(v, t):
    """gemm_sm90's partial sums of the f32 tile values v (M, N), one
    segment an utterance: each 64-row unit sums its runs of one
    utterance's rows in row order into slot unit - u0 (the rest stay NaN,
    unwritten), then each utterance's slots are summed in order
    (slot_sum_kernel). -> (B, N)"""
    m, n = v.shape
    b = m // t
    part = torch.full((b, partial_slots(t, t), n), float("nan"))
    for unit in range(-(-m // 64)):
        r = unit * 64
        while r < min(m, unit * 64 + 64):
            bi = r // t
            end = min(m, unit * 64 + 64, (bi + 1) * t)
            acc = torch.zeros(n)
            for i in range(r, end):
                acc = acc + v[i]
            part[bi, unit - (bi * t) // 64] = acc
            r = end
    out = torch.empty(b, n)
    for bi, (_, _, _, units) in enumerate(segment_units(b, t, t)):
        acc = torch.zeros(n)
        for u in range(units):
            acc = acc + part[bi, u]
        out[bi] = acc
    return out


def _softmax_bwd(logits, h, pooled, g, tc):
    """softmax_bwd_kernel: per channel four frame strides (part p takes
    frames p, p + 4, ... of each staged chunk of tc frames), each with a
    running max and its sums rescaled where a chunk raises it, merged in
    part order; then dlogits and dh_pool. -> (dl, dh_pool) (B, T, D)."""
    b, t, d = logits.shape
    mean, sd = pooled[:, :d], pooled[:, d:]
    gv = torch.where(sd * sd > 1e-7, g[:, d:] * 0.5 / sd.clamp(min=1e-12),
                     torch.zeros_like(sd))
    gme = g[:, :d] - 2.0 * gv * mean
    m = torch.full((4, b, d), -3.0e38)
    s, sw = torch.zeros(4, b, d), torch.zeros(4, b, d)
    for f0 in range(0, t, tc):
        n = min(tc, t - f0)
        for p in range(4):
            idx = torch.arange(f0 + p, f0 + n, 4)
            if len(idx) == 0:
                continue
            lg, x = logits[:, idx], h[:, idx]
            mx = torch.maximum(m[p], lg.amax(1))
            sc = torch.exp(m[p] - mx)
            e = torch.exp(lg - mx[:, None])
            s[p] = s[p] * sc + e.sum(1)
            sw[p] = sw[p] * sc + (e * (gme[:, None] * x
                                       + gv[:, None] * x * x)).sum(1)
            m[p] = mx
    mx = m.amax(0)
    ss, ssw = torch.zeros(b, d), torch.zeros(b, d)
    for p in range(4):
        sc = torch.exp(m[p] - mx)
        ss, ssw = ss + s[p] * sc, ssw + sw[p] * sc
    w = torch.exp(logits - mx[:, None]) / ss[:, None]
    dw = gme[:, None] * h + gv[:, None] * h * h
    return (w * (dw - (ssw / ss)[:, None]),
            w * (gme[:, None] + 2.0 * gv[:, None] * h))


def emulate_bwd(xs, wm, k1, b2, k2, pooled, h, att, cstats, g, glob,
                tc=None, first_row_utt=False):
    """What the bf16 backward's launches compute, as they tile it, in f32:
    -> the nine gradients as mfa_astp_train_bwd returns them."""
    b, t, c = xs[0].shape
    d, a, m = wm.shape[1], k2.shape[0], b * t
    h2, att2 = h.reshape(m, d), att.reshape(m, a)
    # 1. logits: the f32 form, W = k2^T (D, A)
    logits = _gemm_tiles([att2], k2.t(), d,
                         lambda acc, n0, _: acc + b2[n0:n0 + 128], t)
    # 2. the softmax backward
    dl, dh_pool = _softmax_bwd(logits.reshape(b, t, d), h, pooled, g,
                               tc or tvjp.softmax_bwd_frames(4))
    dl2, dh_pool2 = dl.reshape(m, d), dh_pool.reshape(m, d)
    # 3. dpre: the tanh_grad form, W = k2 (A, D), att read per element;
    #    dctx from its partial sums of the f32 values
    dpre = _gemm_tiles_rows(
        [dl2], k2, a, lambda acc, rows, n0, _: acc * (
            1.0 - att2[rows, n0:n0 + 128] ** 2), t)
    dctx = _partial_sums(dpre, t)
    # 4. dcms: the f32 form over one row an utterance, W = k1's context
    #    rows (2D, A)
    cm, cs = cstats[:, :d], cstats[:, d:]
    if glob:
        dcms = _gemm_tiles([dctx], k1[d:], 2 * d, lambda acc, n0, _: acc, 1)
        dcm, dcs = dcms[:, :d], dcms[:, d:]

    # 5. dacc: the relu_grad form, W = k1x (D, A), each row with its own
    #    utterance's context terms; dbm from the partial sums, utterances
    #    in 32 groups (slot_total_kernel), the groups in order
    def relu_grad(acc, rows, n0, utt):
        cols = slice(n0, n0 + 128)
        hv = h2[rows, cols]
        v = acc + dh_pool2[rows, cols]
        if glob:
            # ctx_coef_kernel's [k | c0], then h k + c0
            k = 2.0 / max(t - 1, 1) * dcs[utt, cols] * 0.5 / cs[utt, cols]
            v = v + (hv * k + (dcm[utt, cols] / t - cm[utt, cols] * k))
        return torch.where(hv > 0, v, torch.zeros_like(v))

    dacc = _gemm_tiles_rows([dpre], k1[:d], d, relu_grad, t, first_row_utt)
    per_utt = _partial_sums(dacc, t)
    dbm = torch.zeros(d)
    for j in range(32):
        grp = torch.zeros(d)
        for bi in range(j, b, 32):
            grp = grp + per_utt[bi]
        dbm = dbm + grp
    # 6. dx: the plain form over N = 3C, W = wm (3C, D), each column tile
    #    into its dx_i
    dx_all = _gemm_tiles([dacc], wm, 3 * c, lambda acc, n0, _: acc, t)
    dxs = [torch.full((m, c), float("nan")) for _ in range(3)]
    for n0, (o, col) in zip(range(0, 3 * c, 128), tvjp.dx_tiles(c)):
        dxs[o][:, col:col + 128] = dx_all[:, n0:n0 + 128]
    # 7. the weight gradients, unit by unit into their split's slab, the
    #    splits summed in order
    a_ops = [[x.reshape(m, c) for x in xs], [att2], [h2]]
    b_ops = [dacc, dl2, dpre]
    products = [(3, c, d), (1, a, d), (1, d, a)]
    slabs = {}
    for u in g9.tn_units(products, m):
        q = u["q"]
        kr = slice(u["k0"], min(u["k1"], m))
        av = a_ops[q][u["part"]][kr, u["col"]:u["col"] + 128]
        bv = b_ops[q][kr, u["n0"]:u["n0"] + 128]
        slab = slabs.setdefault((u["split"], q), torch.full(
            (products[q][0] * products[q][1], products[q][2]),
            float("nan")))
        slab[u["m0"]:u["m0"] + 128, u["n0"]:u["n0"] + 128] = av.t() @ bv
    wg = []
    for q, (parts, a_cols, n) in enumerate(products):
        acc = torch.zeros(parts * a_cols, n)
        for split in sorted(sp for sp, qq in slabs if qq == q):
            acc = acc + slabs[(split, q)]
        wg.append(acc)
    dwm, dk2, dk1x = wg
    dk1 = (torch.cat([dk1x, cm.t() @ dctx, cs.t() @ dctx], 0) if glob
           else dk1x)
    return ([x.reshape(b, t, c) for x in dxs]
            + [dwm, dbm, dk1, dctx.sum(0), dk2, torch.zeros(d)])


def _bwd_case(seed, b, t, c, glob):
    xs, w, _ = _case(seed, b, t, c, glob, False)
    jx = [jnp.asarray(v) for v in xs]
    jw = [jnp.asarray(w[k]) for k in ("wm", "bm", "k1", "b1", "k2", "b2")]
    pooled, h, att, cstats = jvjp._fwd_values(*jx, *jw, glob, True)
    g = np.random.default_rng(seed + 1).normal(
        size=(b, 2 * D)).astype(np.float32)
    jres = (*jx, jw[0], jw[2], jw[5], jw[4], pooled, h, att, cstats)
    tres = [torch.from_numpy(np.array(v)) for v in (
        *xs, w["wm"], w["k1"], w["b2"], w["k2"], pooled, h, att, cstats)]
    return jres, tres, g


def _close_scaled(got, want, name):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=name)


@pytest.mark.parametrize("b,t,c,glob,tc", [
    (3, 37, 512, True, None), (2, 201, 1024, True, None),
    (3, 37, 1024, False, 16), (2, 201, 512, False, None),
    (3, 37, 512, True, 16), (3, 37, 256, True, None),
    (3, 37, 256, False, None)])
def test_bwd_emulation_matches_jax(b, t, c, glob, tc):
    jres, tres, g = _bwd_case(40 + t + c // 512, b, t, c, glob)
    got = emulate_bwd(tres[:3], *tres[3:], torch.from_numpy(g), glob, tc)
    want_pallas = jvjp._bwd_pallas(glob, True, jres, jnp.asarray(g))
    want_jnp = jvjp._bwd_jnp(glob, True, jres, jnp.asarray(g))
    for name, gv, wp, wj in zip(GRADS, got, want_pallas, want_jnp):
        assert tuple(gv.shape) == tuple(np.shape(wp)), name
        _close_scaled(gv.numpy(), wp, name)
        _close_scaled(gv.numpy(), wj, name)
    if glob:
        # 128-row tiles straddle utterances at T = 37 and 201: the relu_grad
        # form needs each row's own utterance's context terms
        wrong = emulate_bwd(tres[:3], *tres[3:], torch.from_numpy(g), glob,
                            tc, first_row_utt=True)
        assert not np.allclose(wrong[0].numpy(), np.asarray(want_pallas[0]),
                               rtol=1e-5, atol=1e-5 * float(np.abs(
                                   np.asarray(want_pallas[0])).max()))
