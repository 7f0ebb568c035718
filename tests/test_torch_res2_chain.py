"""Port parity for the ECAPA Res2 chain kernel's plain version and the
`fused_res2` route, against the JAX package on the same numpy inputs, in
f32 on the CPU.

- The chain (`ops.res2_chain`) against JAX `res2_chain_reference` and its
  Pallas kernel `fused_res2_chain` in interpret mode, at C = 64 (width 8)
  and C = 512 (width 64, ECAPA c512's), dilation 2 and 4, T = 24 and 21:
  rtol/atol 1e-5 (the same f32 arithmetic, sums in another order).
- The whole ECAPA_TDNN_GLOB_c512 (feat 24, embed 16, JAX variables with
  randomised BN statistics) with `fused=False, fused_res2=True` in eval
  against JAX's `ECAPA_TDNN(fused_res2=True, fused_block=False,
  fused_tail=False)` at T = 24, where JAX's `kernel_fits` takes the Pallas
  kernel (interpret mode): within 1e-4 relative (f32 through ~10 layers),
  with exactly 3 chain calls per forward.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict, unflatten_dict  # noqa: E402

from wespeaker_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA  # noqa: E402
from wespeaker_tpu.ops import res2_pallas as jres2  # noqa: E402
from wespeaker_tpu_torch.models import ecapa_tdnn  # noqa: E402
from wespeaker_tpu_torch.models.ecapa_tdnn import (  # noqa: E402
    ECAPA_TDNN_GLOB_c512)
from wespeaker_tpu_torch.ops import res2_chain  # noqa: E402
from wespeaker_tpu_torch.utils.weights import from_jax_variables  # noqa

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
FEAT, EMB = 24, 16


def _chain_case(c, t, seed):
    rng = np.random.default_rng(seed)
    w = c // 8

    def r(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    x = r(3, t, c)
    return x, dict(kernels=r(7, 3, w, w, s=(3 * w) ** -0.5),
                   biases=r(7, w, s=.1), bn_scale=1 + r(7, w, s=.1),
                   bn_shift=r(7, w, s=.1))


def _port_chain(x, args, dilation):
    return res2_chain.fused_res2_chain(
        torch.from_numpy(x), **{k: torch.from_numpy(v)
                                for k, v in args.items()},
        dilation=dilation).numpy()


@pytest.mark.parametrize("t", [24, 21])
@pytest.mark.parametrize("c,dilation", [(64, 2), (512, 4)])
def test_chain_plain_matches_jax(c, dilation, t):
    x, args = _chain_case(c, t, seed=c + t + dilation)
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    want = np.asarray(jres2.res2_chain_reference(jnp.asarray(x), **jargs,
                                                 dilation=dilation))
    want_kernel = np.asarray(jres2.fused_res2_chain(
        jnp.asarray(x), **jargs, dilation=dilation, interpret=True))
    before = res2_chain.fused_res2_chain.launches
    got = _port_chain(x, args, dilation)
    assert res2_chain.fused_res2_chain.launches == before  # plain on CPU
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 7 * (c // 8):],
                                  x[..., 7 * (c // 8):])
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, want_kernel, **TOL)


def test_chain_wrapper_refuses_what_it_does_not_take():
    """A split that does not cover C, affines of another shape and a device
    without a kernel raise; the CUDA checks refuse a width or a type the
    kernel does not take."""
    x, args = _chain_case(64, 8, seed=1)
    tx = torch.from_numpy(x)
    targs = {k: torch.from_numpy(v) for k, v in args.items()}
    with pytest.raises(ValueError, match="groups"):
        res2_chain.fused_res2_chain(tx[..., :56], **targs, dilation=2)
    with pytest.raises(ValueError, match="bn_shift"):
        res2_chain.fused_res2_chain(
            tx, **dict(targs, bn_shift=torch.zeros(6, 8)), dilation=2)
    with pytest.raises(ValueError, match="no kernel"):
        res2_chain.fused_res2_chain(tx.to("meta"), **targs, dilation=2)
    with pytest.raises(ValueError, match="group widths"):
        res2_chain._check_cuda_args(tx, 8, 2)
    with pytest.raises(TypeError, match="f32 or bf16"):
        res2_chain._check_cuda_args(tx.half(), 64, 2)


def _jax_variables(model, seed=0):
    """model.init, then BN statistics and affines randomised; numpy."""
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 24, FEAT)), train=False))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    flat = flatten_dict(jax.device_get(variables))
    for path, v in flat.items():
        v = np.asarray(v, np.float32)
        if path[-1] == "mean":
            v = 0.1 * rng.normal(size=v.shape)
        elif path[-1] == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif path[-1] == "bias":
            v = 0.1 * rng.normal(size=v.shape)
        flat[path] = v.astype(np.float32)
    return unflatten_dict(flat)


def test_ecapa_fused_res2_matches_jax(monkeypatch):
    jmodel = JECAPA(channels=512, feat_dim=FEAT, embed_dim=EMB,
                    global_context_att=True, fused_res2=True,
                    fused_block=False, fused_tail=False)
    variables = _jax_variables(jmodel)
    x = np.random.default_rng(2).normal(size=(2, 24, FEAT)).astype(
        np.float32)
    assert jres2.kernel_fits(24, 512, 8)  # JAX takes its Pallas kernel
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x))(
        variables, jnp.asarray(x)))

    calls = []

    def counting(*a, **k):
        calls.append(a[0].shape)
        return res2_chain.fused_res2_chain(*a, **k)

    monkeypatch.setattr(ecapa_tdnn, "fused_res2_chain", counting)
    model = ECAPA_TDNN_GLOB_c512(FEAT, EMB, fused=False, fused_res2=True)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        assert calls == [(2, 24, 512)] * 3
        layers = model.set_fused(False, fused_res2=False)(
            torch.from_numpy(x)).numpy()
        model.set_fused(False, fused_res2=True).train()(torch.from_numpy(x))
    assert len(calls) == 3  # neither the layer path nor training calls it
    scale = np.abs(want).max()
    for a in (got, layers):
        np.testing.assert_allclose(a, want, rtol=1e-4, atol=1e-4 * scale)
