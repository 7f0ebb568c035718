"""Port parity: the plain versions of the port's two CUDA kernels against
the JAX package's plain reference and its Pallas kernel run in interpret
mode, on the same numpy inputs, in f32.

On a CPU tensor the port's wrapper takes its plain version, so the wrapper
is what is called here. Tolerance rtol/atol 1e-5: same f32 arithmetic,
sums in another order.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.ops import mfa_astp_pallas as jtail  # noqa: E402
from wespeaker_tpu.ops import se_block_pallas as jse  # noqa: E402
from wespeaker_tpu_torch.ops import mfa_astp as ttail  # noqa: E402
from wespeaker_tpu_torch.ops import se_block as tse  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _mask(rng, b, t):
    lens = rng.integers(t // 2, t + 1, b)
    lens[0] = t
    return (np.arange(t)[None] < lens[:, None]).astype(np.float32)


def _se_args(rng, b, t, c):
    w = c // 8

    def r(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return dict(
        x=r(b, t, c), w1=r(c, c, s=c ** -0.5), b1=r(c, s=.1),
        s1=1 + r(c, s=.1), h1=r(c, s=.1), cw=r(7, 3, w, w, s=(3 * w) ** -0.5),
        cb=r(7, w, s=.1), cs=1 + r(7, w, s=.1), ch=r(7, w, s=.1),
        w2=r(c, c, s=c ** -0.5), b2=r(c, s=.1), s2=1 + r(c, s=.1),
        h2=r(c, s=.1), sw1=r(c, 128, s=c ** -0.5), sb1=r(128, s=.1),
        sw2=r(128, c, s=128 ** -0.5), sb2=r(c, s=.1))


@pytest.mark.parametrize("masked,t", [(False, 24), (True, 24), (True, 21),
                                      (False, 19)])
def test_se_block_plain_matches_jax(masked, t):
    rng = np.random.default_rng(0)
    b, c, dil = 3, 64, 3
    args = _se_args(rng, b, t, c)
    mask = _mask(rng, b, t) if masked else None
    got = tse.fused_se_res2_block(
        **{k: torch.from_numpy(v) for k, v in args.items()}, dilation=dil,
        mask=None if mask is None else torch.from_numpy(mask)).numpy()
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    jmask = None if mask is None else jnp.asarray(mask)
    want_ref = np.asarray(jse.se_res2_block_reference(**jargs, dilation=dil,
                                                      mask=jmask))
    want_kernel = np.asarray(jse.fused_se_res2_block(
        **jargs, dilation=dil, mask=jmask, interpret=True))
    assert got.shape == (b, t, c)
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_kernel, **TOL)


@pytest.mark.parametrize("glob,masked,t", [(True, False, 24), (True, True, 24),
                                           (False, False, 24),
                                           (False, True, 24),
                                           (True, True, 21)])
def test_mfa_astp_plain_matches_jax(glob, masked, t):
    rng = np.random.default_rng(1)
    b, c, d, a = 3, 64, 192, 32

    def r(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    xs = [r(b, t, c) for _ in range(3)]
    args = dict(wm=r(3 * c, d, s=(3 * c) ** -0.5), bm=r(d, s=.1),
                k1=r((3 if glob else 1) * d, a, s=d ** -0.5), b1=r(a, s=.1),
                k2=r(a, d, s=a ** -0.5), b2=r(d, s=.1))
    mask = _mask(rng, b, t) if masked else None
    got = ttail.fused_mfa_astp(
        *map(torch.from_numpy, xs),
        **{k: torch.from_numpy(v) for k, v in args.items()},
        mask=None if mask is None else torch.from_numpy(mask),
        glob=glob).numpy()
    jx = [jnp.asarray(v) for v in xs]
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    jmask = None if mask is None else jnp.asarray(mask)
    want_ref = np.asarray(jtail.mfa_astp_reference(*jx, **jargs, mask=jmask,
                                                   glob=glob))
    want_kernel = np.asarray(jtail.fused_mfa_astp(
        *jx, **jargs, mask=jmask, glob=glob, interpret=True))
    assert got.shape == (b, 2 * d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_kernel, **TOL)


def test_launch_counters_stay_put_on_cpu():
    """The CPU path is the plain version: it launches nothing."""
    rng = np.random.default_rng(2)
    args = {k: torch.from_numpy(v) for k, v in _se_args(rng, 1, 8, 64).items()}
    before = tse.fused_se_res2_block.launches
    tse.fused_se_res2_block(**args, dilation=2)
    assert tse.fused_se_res2_block.launches == before
