"""Port parity for the statistics-pooling kernels' plain versions and the
pooling layers' kernel route, against the JAX package on the same numpy
inputs, in f32 on the CPU.

- softmax_stats_reference and masked_stats_reference against JAX's Pallas
  kernels (wespeaker_tpu/ops/pooling_pallas.py) in interpret mode, as
  tests/test_pallas_ops.py runs them: D = 128 and 256, B = 3 (the JAX
  kernels pad B to 8), with and without a mask (JAX's softmax kernel takes
  no mask: the masked logits go in at -1e30, as ASTP sets them), ddof 0
  and 1; rtol/atol 1e-5 (f32 sums in another order over T <= 50).
- At D = 600, which the JAX kernels do not take (D % 128 != 0), the plain
  versions against JAX's jnp `pooling_layers._std` and ASTP tail, with an
  utterance that has no valid frame (uniform softmax weights); 1e-5.
- Row 6's one-pass design (csrc/common.cuh `softmax_stats_kernel`),
  emulated in torch as the kernel walks it (`ops.pooling.softmax_plan`:
  kc channels a thread, items of 32 columns, tw warps an item, warp j
  taking frames j, j + tw, ... in batches of 8 (4 on the scalar path),
  each batch's max first and the sums rescaled by exp(m_old - m_new) (the
  kernel works in base 2, exp2 of the logits times log2(e)), the
  warps' parts merged by the same rescaling in warp order): against JAX's
  Pallas kernel (interpret) or, at D = 600, its jnp softmax and sums, at
  rtol/atol 1e-5, masked and not, with an utterance that has no valid
  frame, D = 600, T = 1 (the std, the rounding of x^2 alone there, within
  sqrt(2^-22) max |x|), logits near +80 and -80 (exp overflows without
  the max), with bf16-sized (kc = 4) and f32-sized (kc = 2) logits and
  tw = 1 to 8; merging the warps' parts without the rescaling misses.
- TSDP, TSTP and ASTP (with and without global context) in eval with
  autograd off, which routes them through ops.pooling (the plain versions
  on the CPU), against JAX's flax layers at 1e-5, with no kernel launch;
  the same layers in training and under autograd take the plain path.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.models import pooling_layers as jpool  # noqa: E402
from wespeaker_tpu.ops import pooling_pallas  # noqa: E402
from wespeaker_tpu_torch.models import pooling_layers as tpool  # noqa: E402
from wespeaker_tpu_torch.ops import pooling  # noqa: E402
from wespeaker_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
LOG2E = 1.4426950408889634


def _inputs(seed, b, t, d, masked, empty=False):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.normal(size=(b, t, d))).astype(np.float32)
    x = (rng.normal(size=(b, t, d)) + 0.5).astype(np.float32)
    mask = None
    if masked:
        lens = rng.integers(t // 3, t, b)
        lens[0] = t
        if empty:
            lens[-1] = 0
        mask = (np.arange(t)[None] < lens[:, None]).astype(np.float32)
    return logits, x, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [128, 256])
def test_softmax_stats_twin_matches_pallas(d, masked):
    logits, x, mask = _inputs(d + masked, 3, 50, d, masked)
    jlogits = jnp.asarray(logits)
    if masked:
        jlogits = jnp.where(jnp.asarray(mask)[..., None] > 0, jlogits, -1e30)
    want = pooling_pallas.fused_softmax_stats(jlogits, jnp.asarray(x),
                                              interpret=True)
    got = pooling.softmax_stats_reference(_t(logits), _t(x), _t(mask))
    _close(got, want)
    # the wrapper on a CPU tensor takes the twin, without a launch
    before = pooling.fused_softmax_stats.launches
    _close(pooling.fused_softmax_stats(_t(logits), _t(x), _t(mask)), want)
    assert pooling.fused_softmax_stats.launches == before


@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [128, 256])
def test_masked_stats_twin_matches_pallas(d, masked, ddof):
    _, x, mask = _inputs(d + 2 * masked + ddof, 3, 41, d, masked)
    want = pooling_pallas.fused_masked_stats(
        jnp.asarray(x), None if mask is None else jnp.asarray(mask),
        ddof=ddof, interpret=True)
    _close(pooling.masked_stats_reference(_t(x), _t(mask), ddof), want)
    before = pooling.fused_masked_stats.launches
    pooled = pooling.fused_masked_stats(_t(x), _t(mask), ddof, concat=True)
    assert pooled.shape == (3, 2 * d)
    _close((pooled[:, :d], pooled[:, d:]), want)
    assert pooling.fused_masked_stats.launches == before


@pytest.mark.parametrize("case", ["offset", "one_frame"])
def test_masked_stats_twin_matches_pallas_at_edges(case):
    """The plain masked stats against JAX's Pallas kernel (interpret) where
    a one-pass kernel could go wrong: |mean| >> std (x = 1e3 + 1e-2 z, a
    ragged mask; the std within 1e-4 of its largest magnitude: both sum in
    f32 in their own order, and their means, a few ulps of 1e3 apart, move
    a 1e-2 std by ~2e-6, where raw sums of x and x^2 would lose every
    digit) and T = 1 with ddof 1 (count - ddof = 0, so the std is
    sqrt(1e-7))."""
    rng = np.random.default_rng(31)
    if case == "offset":
        b, t = 3, 41
        x = (1e3 + 1e-2 * rng.normal(size=(b, t, 128))).astype(np.float32)
        lens = np.array([t, 17, 2])
    else:
        b, t = 3, 1
        x = rng.normal(size=(b, t, 128)).astype(np.float32)
        lens = np.array([1, 1, 0])
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.float32)
    want = pooling_pallas.fused_masked_stats(
        jnp.asarray(x), jnp.asarray(mask), ddof=1, interpret=True)
    mean, std = pooling.masked_stats_reference(_t(x), _t(mask), 1)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(std.numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want[1])).max())
    if case == "one_frame":
        np.testing.assert_allclose(std.numpy(), np.sqrt(1e-7), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_twins_take_unaligned_width(masked):
    """D = 600 (ReDimNetB0's pooling width), which the TPU kernels refuse:
    the twins against JAX's jnp _std and ASTP tail, an utterance with no
    valid frame included."""
    logits, x, mask = _inputs(600 + masked, 3, 47, 600, masked, empty=True)
    jm = None if mask is None else jnp.asarray(mask)
    _close(pooling.masked_stats_reference(_t(x), _t(mask)),
           jpool._std(jnp.asarray(x), jm, ddof=1))
    a = jnp.asarray(logits)
    if masked:
        a = jnp.where(jm[..., None] > 0, a, -1e30)
    w = jax.nn.softmax(a, axis=1)
    mean = jnp.sum(w * x, axis=1)
    std = jnp.sqrt(jnp.clip(jnp.sum(w * x ** 2, axis=1) - mean ** 2,
                            min=1e-7))
    got = pooling.softmax_stats_reference(_t(logits), _t(x), _t(mask))
    _close(got, (mean, std))
    if masked:  # no valid frame: uniform weights over all T frames
        np.testing.assert_allclose(got[0][-1].numpy(), x[-1].mean(0),
                                   **TOL)


def emulate_softmax_stats(logits, x, mask, logit_bytes, rescale=True):
    """Row 6 as the kernel computes it, in f32 (see the module docstring);
    rescale=False merges the warps' parts as if they shared one max."""
    b, t, d = x.shape
    kc, _, tw = pooling.softmax_plan(b, t, d, logit_bytes)
    ku = pooling.SOFTMAX_FRAMES if d % kc == 0 else 4
    a = logits.float() * LOG2E  # base 2, as the kernel
    if mask is not None:
        a = torch.where(mask[..., None] > 0, a, torch.full_like(a, -1e30))
    xf = x.float()
    parts = []
    for j in range(tw):
        m = torch.full((b, d), -3.0e38)
        s, s1, s2 = (torch.zeros(b, d) for _ in range(3))
        for f0 in range(j, t, tw * ku):
            idx = torch.arange(f0, min(f0 + tw * ku, t), tw)
            mx = torch.maximum(m, a[:, idx].amax(1))
            sc = torch.exp2(m - mx)
            e = torch.exp2(a[:, idx] - mx[:, None])
            eh = e * xf[:, idx]
            s = s * sc + e.sum(1)
            s1 = s1 * sc + eh.sum(1)
            s2 = s2 * sc + (eh * xf[:, idx]).sum(1)
            m = mx
        parts.append((m, s, s1, s2))
    m, s, s1, s2 = parts[0]
    for mq, sq, s1q, s2q in parts[1:]:
        mx = torch.maximum(m, mq)
        sa, sb = ((torch.exp2(m - mx), torch.exp2(mq - mx)) if rescale
                  else (1.0, 1.0))
        s, s1, s2 = s * sa + sq * sb, s1 * sa + s1q * sb, s2 * sa + s2q * sb
        m = mx
    mean = s1 / s
    return mean, torch.sqrt(torch.clamp(s2 / s - mean * mean, min=1e-7))


def _jax_softmax_stats(logits, x, mask):
    """JAX's Pallas kernel in interpret mode (D % 128 == 0; the masked
    logits go in at -1e30, as ASTP sets them), else its jnp softmax and
    sums."""
    a = jnp.asarray(logits)
    if mask is not None:
        a = jnp.where(jnp.asarray(mask)[..., None] > 0, a, -1e30)
    if x.shape[-1] % 128 == 0:
        return pooling_pallas.fused_softmax_stats(a, jnp.asarray(x),
                                                  interpret=True)
    w = jax.nn.softmax(a, axis=1)
    mean = jnp.sum(w * x, axis=1)
    return mean, jnp.sqrt(jnp.clip(jnp.sum(w * x ** 2, axis=1) - mean ** 2,
                                   min=1e-7))


@pytest.mark.parametrize("logit_bytes", [2, 4])
@pytest.mark.parametrize("b,t,d,masked,shift", [
    (3, 201, 128, False, 0.0),      # few items: T over 8 warps
    (3, 201, 128, True, 0.0),       # ... with an utterance of no frame
    (40, 70, 256, True, 80.0),      # logits near +80
    (3, 50, 128, False, -80.0),     # near -80
    (3, 47, 600, True, 0.0),        # D = 600: the scalar path's batches
    (5, 1, 128, False, 0.0),        # T = 1
    (700, 9, 64, False, 0.0)])      # items fill the card: one warp each
def test_softmax_stats_one_pass_matches_jax(b, t, d, masked, shift,
                                            logit_bytes):
    logits, x, mask = _inputs(b * 7 + t + d, b, t, d, masked, empty=True)
    logits = logits + np.float32(shift)
    want = _jax_softmax_stats(logits, x, mask)
    got = emulate_softmax_stats(_t(logits), _t(x), _t(mask), logit_bytes)
    if t == 1:
        # one frame: the variance E[x^2] - mean^2 is the rounding of x^2
        # alone, whose bits depend on where a sum contracts into a
        # multiply-add; the mean at 1e-5, the std within sqrt(2^-22) max |x|
        _close(got[:1], want[:1])
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=2.0 ** -11 * np.abs(x).max())
    else:
        _close(got, want)
    kc, chunks, tw = pooling.softmax_plan(b, t, d, logit_bytes)
    assert kc == 8 // logit_bytes and chunks * 32 * kc >= d
    if masked:  # no valid frame: uniform weights over all T frames
        np.testing.assert_allclose(got[0][-1].numpy(), x[-1].mean(0), **TOL)
    if tw > 1 and shift:
        wrong = emulate_softmax_stats(_t(logits), _t(x), _t(mask),
                                      logit_bytes, rescale=False)
        assert not np.allclose(wrong[0].numpy(), np.asarray(want[0]), **TOL)


def test_softmax_plan_splits_t_only_where_items_do_not_fill():
    # ReDimNetB2 (B = 512, D = 1152): bf16 logits, 9 chunks, two warps an
    # item; f32 logits, 18 chunks, one; ECAPA's tail (D = 1536, f32) at
    # B = 512 one warp, at B = 256 two; a few utterances take eight
    assert pooling.softmax_plan(512, 200, 1152, 2) == (4, 9, 2)
    assert pooling.softmax_plan(512, 200, 1152, 4) == (2, 18, 1)
    assert pooling.softmax_plan(512, 200, 1536, 4) == (2, 24, 1)
    assert pooling.softmax_plan(256, 200, 1536, 4) == (2, 24, 2)
    assert pooling.softmax_plan(3, 201, 128, 2) == (4, 1, 8)
    # 65,537 utterances: a 1-D grid of items, no cap on B
    assert pooling.softmax_plan(65537, 2, 8, 2) == (4, 1, 1)
    # the plan follows the SMs it is given: on half the card ReDimNetB2's
    # 4,608 bf16 items fill it twice over with one warp each
    assert pooling.softmax_plan(512, 200, 1152, 2, sms=66) == (4, 9, 1)


def test_wrappers_check_shapes_on_every_device():
    x = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError):
        pooling.fused_masked_stats(x, torch.ones(2, 4))
    with pytest.raises(ValueError):
        pooling.fused_softmax_stats(torch.zeros(2, 5, 7), x)
    with pytest.raises(ValueError):
        pooling.fused_masked_stats(x[0])


def _layer_pair(kind, d, rng):
    """(flax module, numpy variables, port layer loaded from them)."""
    if kind == "ASTP_glob":
        jl = jpool.ASTP(d, bottleneck_dim=16, global_context_att=True)
        tl = tpool.ASTP(d, bottleneck_dim=16, global_context_att=True)
    elif kind == "ASTP":
        jl = jpool.ASTP(d, bottleneck_dim=16)
        tl = tpool.ASTP(d, bottleneck_dim=16)
    else:
        jl, tl = getattr(jpool, kind)(d), getattr(tpool, kind)(d)
    variables = jax.device_get(jl.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 4, d))))
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * rng.normal(size=v.shape).astype(
            np.float32), variables.get("params", {}))
    tl.load_state_dict(weights.from_jax_variables({"params": params}, kind),
                       strict=True)
    return jl, {"params": params}, tl.eval()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["TSDP", "TSTP", "ASTP", "ASTP_glob"])
def test_pooling_layers_kernel_route_matches_jax(kind, masked):
    rng = np.random.default_rng(len(kind) + masked)
    d = 24
    _, x, mask = _inputs(7, 3, 30, d, masked, empty=True)
    jl, variables, tl = _layer_pair(kind, d, rng)
    want = np.asarray(jl.apply(variables, jnp.asarray(x),
                               None if mask is None else jnp.asarray(mask)))
    calls = []
    for name in ("fused_masked_stats", "fused_softmax_stats"):
        fn = getattr(tpool, name)

        def counting(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        setattr(tpool, name, counting)
    before = (pooling.fused_masked_stats.launches,
              pooling.fused_softmax_stats.launches)
    try:
        with torch.no_grad():
            got = tl(_t(x), _t(mask))
        route = list(calls)
        with torch.enable_grad():  # autograd on: the plain path
            plain = tl(_t(x), _t(mask)).detach()
        tl.train()
        with torch.no_grad():  # training: the plain path
            plain_train = tl(_t(x), _t(mask))
    finally:
        tpool.fused_masked_stats = pooling.fused_masked_stats
        tpool.fused_softmax_stats = pooling.fused_softmax_stats
    assert route == {"TSDP": ["fused_masked_stats"],
                     "TSTP": ["fused_masked_stats"],
                     "ASTP": ["fused_softmax_stats"],
                     "ASTP_glob": ["fused_masked_stats",
                                   "fused_softmax_stats"]}[kind]
    assert calls == route
    assert (pooling.fused_masked_stats.launches,
            pooling.fused_softmax_stats.launches) == before
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    np.testing.assert_allclose(plain_train.numpy(), want, **TOL)


def test_set_pooling_fused_reaches_every_stats_layer():
    model = torch.nn.ModuleDict({"a": tpool.TSTP(8), "b": tpool.ASTP(8),
                                 "c": tpool.TSDP(8), "d": tpool.TAP(8)})
    tpool.set_pooling_fused(model, False)
    assert [getattr(m, "fused", "none") for m in model.values()] == [
        False, False, False, "none"]
