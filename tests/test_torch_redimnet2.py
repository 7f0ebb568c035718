"""Port parity for ReDimNet2 against the JAX package on the same seeded
numpy inputs and weights (tests/torch_zoo_util.py), in f32 on the CPU.

- Two narrow models (C = 4, feat 16, embed 16; grouped tconvs with
  `compress_tconvs`): a stride-2-in-frequency stage that expands its
  channels twice (the squeeze-back conv + BN) and a stride-2-in-time stage
  (upsampled back to full T), each with a 'conv+att' time-context block,
  one with a 1-D head conv and basic_resnet blocks, the other with the
  2-D output and head (as ReDimNet2B6) and convnext_like blocks; ASTP with
  global context; in eval, unmasked at T = 40 and masked at T = 41 (cut
  to 40 by the time stride): rtol/atol 1e-4. The pooling takes the
  kernels' plain versions on the CPU (eval, autograd off) and the plain
  path (`set_pooling_fused(model, False)`); both agree with JAX.
- The flax trees load strictly into the upstream-named modules
  (`stage<s>.0.w`, `fin_wght1d.w`, `stage<s>.<i>.conv_block`, ...) and
  map back exactly, by the port's inverse and by the JAX package's
  converter; the rules are torch_compat's.
- ReDimNet2B0 to B5 at the recipe's width (feat 72, embed 192): every
  parameter and BN statistic of the port (built on the meta device) with
  the shape jax.eval_shape gives the JAX model's (B6 through its YAML in
  tests/test_torch_zoo_recipes.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from tests.test_torch_resnet import _ragged_mask  # noqa: E402
from tests.torch_zoo_util import (numpy_variables, port_shapes,  # noqa
                                  torch_shapes)
from wespeaker_tpu.models import redimnet2 as jred2  # noqa: E402
from wespeaker_tpu.utils import torch_compat  # noqa: E402
from wespeaker_tpu_torch.models import get_speaker_model, redimnet2  # noqa
from wespeaker_tpu_torch.models.pooling_layers import \
    set_pooling_fused  # noqa: E402
from wespeaker_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(2)
NAME = "ReDimNet2B0"  # any ReDimNet2 name chooses the same rules
FEAT, EMB = 16, 16
TOL = dict(rtol=1e-4, atol=1e-4)
STAGES = (((2, 1), 1, 2, ((3, 3),), 4), ((1, 2), 1, 1, ((3, 3),), 4))
KINDS = {
    "head1d": dict(out_channels=8, return_2d_output=False,
                   block_2d_type="basic_resnet"),
    "out2d": dict(out_channels=6, return_2d_output=True,
                  block_2d_type="convnext_like"),
}


def _kw(kind):
    return dict(F=FEAT, C=4, feat_dim=FEAT, embed_dim=EMB,
                stages_setup=STAGES, **KINDS[kind])


@pytest.fixture(scope="module")
def jax_models():
    out = {}
    for i, kind in enumerate(KINDS):
        module = jred2.ReDimNet2Wrap(**_kw(kind))
        variables = numpy_variables(module, jnp.zeros((1, 40, FEAT)), i)
        apply = jax.jit(lambda v, x, m, mod=module: mod.apply(v, x, mask=m))
        out[kind] = (module, variables, apply)
    return out


def _port(kind, variables):
    model = redimnet2.ReDimNet2Wrap(**_kw(kind))
    model.load_state_dict(weights.from_jax_variables(variables, NAME),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("masked,t", [(False, 40), (True, 41)])
@pytest.mark.parametrize("kind", list(KINDS))
def test_redimnet2_matches_jax(jax_models, kind, masked, t):
    _, variables, apply = jax_models[kind]
    rng = np.random.default_rng(t + masked)
    x = rng.normal(size=(3, t, FEAT)).astype(np.float32)
    mask = _ragged_mask(3, t) if masked else None
    want = np.asarray(apply(variables, jnp.asarray(x),
                            None if mask is None else jnp.asarray(mask)))
    model = _port(kind, variables)
    tm = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        got = model(torch.from_numpy(x), tm).numpy()
        plain = set_pooling_fused(model, False)(torch.from_numpy(x),
                                                tm).numpy()
    assert got.shape == (3, EMB) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(plain, want, **TOL)


def test_redimnet2_frame_features_match_jax(jax_models):
    module, variables, _ = jax_models["out2d"]
    x = np.random.default_rng(5).normal(size=(2, 40, FEAT)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, x: module.apply(
        v, x, return_frame_feat=True))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port("out2d", variables)(torch.from_numpy(x),
                                        return_frame_feat=True).numpy()
    assert got.shape == want.shape == (2, 40, 6 * 8)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_redimnet2_variables_load_strictly_and_map_back(jax_models, kind):
    _, variables, _ = jax_models[kind]
    sd = weights.from_jax_variables(variables, NAME)
    model = redimnet2.ReDimNet2Wrap(**_kw(kind))
    assert set(sd) == set(model.state_dict())
    for key in ("backbone.stage0.0.w", "backbone.stage1.0.w",
                "backbone.fin_wght1d.w", "backbone.stage0.2.weight",
                "backbone.stage0.3.conv_block.norm.running_var"
                if kind == "out2d" else
                "backbone.stage0.3.conv_block.conv1pw.bias",
                "backbone.stage0.4.1.running_var",
                "backbone.stage0.6.tcm.4.feed_forward.output_dense.weight",
                "backbone.stem.1.bias", "backbone.head.weight",
                "pool.linear1.weight", "bn.running_mean", "linear.weight"):
        assert key in sd, key
    model.load_state_dict(sd, strict=True)
    want = flatten_dict(variables)
    for back in (weights.to_jax_variables(model.state_dict(), NAME),
                 jax.device_get(torch_compat.torch_to_flax_variables(
                     model.state_dict(), variables,
                     torch_compat.rules_for(NAME)))):
        got = flatten_dict(back)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    assert list(weights.rules_for(NAME)) == [
        tuple(r) for r in torch_compat.rules_for(NAME)]
    assert weights.rules_for("ReDimNet2Wrap") == weights.rules_for(NAME)


@pytest.mark.parametrize("name", [f"ReDimNet2B{i}" for i in range(6)])
def test_constructors_have_the_jax_shapes(name):
    """B6, redimnet2.yaml's model, is held to the same by
    tests/test_torch_zoo_recipes.py."""
    with torch.device("meta"):
        model = get_speaker_model(name)(feat_dim=72, embed_dim=192)
    want = torch_shapes(getattr(jred2, name)(feat_dim=72, embed_dim=192),
                        jnp.zeros((1, 8, 72)), name)
    assert port_shapes(model) == want
