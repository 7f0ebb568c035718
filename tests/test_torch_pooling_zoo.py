"""Port parity for the attentive poolings ASP, MHASTP, MQMHASTP and XI
against the JAX package's flax layers on the same numpy inputs, in f32 on
the CPU.

Each layer at D = 16 (MHASTP and MQMHASTP over 2 and 4 heads, d_s 1 and
2; XI with and without `stddev`), B = 3, T = 24, in eval with BN
statistics perturbed by 0.1 normal noise, unmasked and masked (the second
utterance's last third, and the third's frames 5-11, an all-masked block
inside the utterance): rtol/atol 1e-5. The flax trees load strictly into
the port's upstream-named modules and map back exactly. `get_pooling`
drops the kwargs a class does not take, and `pooling_out_dim` takes the
kwargs that change the width, each as the JAX package's do.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict, unflatten_dict  # noqa: E402

from wespeaker_tpu.models import pooling_layers as jpool  # noqa: E402
from wespeaker_tpu_torch.models import pooling_layers as tpool  # noqa: E402
from wespeaker_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
B, T, D = 3, 24, 16
CASES = {
    "ASP": ("ASP", {"hidden_dim": 8}),
    "MHASTP-d1": ("MHASTP", {"head_num": 2, "d_s": 1, "bottleneck_dim": 8}),
    "MHASTP-d2": ("MHASTP", {"head_num": 4, "d_s": 2, "layer_num": 3,
                             "bottleneck_dim": 8}),
    "MQMHASTP": ("MQMHASTP", {"query_num": 2, "head_num": 2,
                              "bottleneck_dim": 8}),
    "XI": ("XI", {"hidden_size": 8}),
    "XI-stddev": ("XI", {"hidden_size": 8, "stddev": True}),
}


def _mask():
    m = np.ones((B, T), np.float32)
    m[1, (2 * T) // 3:] = 0
    m[2, 5:12] = 0
    return m


def _perturbed(variables, seed):
    """Params as drawn (XI's zero priors drawn too), BN statistics plus 0.1
    normal noise; a numpy tree."""
    rng = np.random.default_rng(seed)
    flat = flatten_dict(jax.device_get(variables))
    for path, v in flat.items():
        v = np.asarray(v, np.float32)
        if path[0] == "batch_stats" or path[-1].startswith("prior"):
            v = v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
        flat[path] = v
    return unflatten_dict(flat)


@pytest.fixture(scope="module")
def jax_poolings():
    """{case: (variables, jitted apply)}, one init a layer."""
    out = {}
    x0 = jnp.zeros((B, T, D))
    for i, (case, (name, kw)) in enumerate(CASES.items()):
        module = jpool.get_pooling(name, D, **kw)
        variables = _perturbed(module.init(jax.random.PRNGKey(i), x0), i)
        apply = jax.jit(lambda v, x, m, mod=module: mod.apply(v, x, m))
        out[case] = (variables, apply)
    return out


def _port(case, variables):
    name, kw = CASES[case]
    layer = tpool.get_pooling(name, D, **kw)
    # XI's children take the XI rules, chosen by an x-vector's name
    layer.load_state_dict(weights.from_jax_variables(variables, "XVEC"),
                          strict=True)
    return layer.eval()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_pooling_matches_jax(jax_poolings, case, masked):
    variables, apply = jax_poolings[case]
    rng = np.random.default_rng(len(case) + masked)
    x = (rng.normal(size=(B, T, D)) + 0.3).astype(np.float32)
    mask = _mask() if masked else None
    want = np.asarray(apply(variables, jnp.asarray(x),
                            None if mask is None else jnp.asarray(mask)))
    layer = _port(case, variables)
    with torch.no_grad():
        got = layer(torch.from_numpy(x),
                    None if mask is None else torch.from_numpy(mask))
    name, kw = CASES[case]
    assert got.shape == (B, tpool.pooling_out_dim(name, D, **kw))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_pooling_variables_load_strictly_and_map_back(jax_poolings, case):
    """The flax tree gives exactly the port's upstream keys and
    to_jax_variables gives the tree back."""
    variables, _ = jax_poolings[case]
    sd = weights.from_jax_variables(variables, "XVEC")
    name, kw = CASES[case]
    assert set(sd) == set(tpool.get_pooling(name, D, **kw).state_dict())
    back = weights.to_jax_variables(sd, "XVEC")
    want = flatten_dict(variables)
    got = flatten_dict(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    expect = {"ASP": "attention.3.weight",
              "MHASTP": "heads_att_trans.1.att_1.weight",
              "MQMHASTP": "n_query.1.heads_att_trans.0.att_0.bias",
              "XI": "lin1_relu_bn.2.running_var"}[name]
    assert expect in sd


def test_get_pooling_drops_what_a_class_does_not_take():
    """ECAPA and ReDimNet pass global_context_att to every pooling; the
    classes that do not take it drop it, on both sides."""
    kw = {"global_context_att": True, "hidden_dim": 12, "stddev": True,
          "query_num": 3}
    for name in ("TAP", "TSDP", "TSTP", "ASTP", "ASP", "MHASTP",
                 "MQMHASTP", "XI"):
        layer = tpool.get_pooling(name, D, **kw)
        jlayer = jpool.get_pooling(name, D, **kw)
        assert type(layer).__name__ == type(jlayer).__name__ == name
    assert tpool.get_pooling("ASP", D, **kw).attention[0].out_channels == 12
    assert tpool.get_pooling("XI", D, **kw).stddev
    assert len(tpool.get_pooling("MQMHASTP", D, **kw).n_query) == 3
    assert tpool.get_pooling("ASTP", D, **kw).global_context_att
    with pytest.raises(KeyError):
        tpool.get_pooling("NOPE", D)


@pytest.mark.parametrize("name,kw", [
    ("TAP", {}), ("TSDP", {}), ("TSTP", {}), ("ASTP", {}), ("ASP", {}),
    ("MHASTP", {}), ("MQMHASTP", {}), ("MQMHASTP", {"query_num": 4}),
    ("XI", {}), ("XI", {"stddev": True})])
def test_pooling_out_dim_matches_jax(name, kw):
    want = jpool.pooling_out_dim(name, 64, **kw)
    assert tpool.pooling_out_dim(name, 64, **kw) == want
    layer = tpool.get_pooling(name, 64, **kw).eval()
    with torch.no_grad():
        assert layer(torch.randn(2, 5, 64)).shape == (2, want)
