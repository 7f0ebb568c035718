"""ReDimNet's 'gru' time block against the JAX package, in f32 on the CPU.

- `GRU` (models/redimnet.py, torch's nn.GRU under upstream's names)
  against JAX's BiGRU, recurring over time and, with torch_quirk /
  gru_quirk_compat, over the batch axis as upstream's batch_first=False
  GRU does; the weights go from the port's state_dict to flax through the
  JAX package's own converter (torch_compat.torch_to_flax_variables, which
  splits the packed gates with expand_torch_gru_keys): within 1e-5.
- A narrow ReDimNet with block_1d_type 'gru' (C=4, feat 16, two stages,
  B=2 x 40 frames), both modes, against JAX's model on the port's weights
  (utils/weights.py::to_jax_variables splits nn.GRU's packed gates into
  the flax GRUCell leaves; the tree is the one that flax's init traces):
  within 1e-4, the tolerance of tests/test_torch_redimnet.py; the model
  loaded back by from_jax_variables gives the same output, and
  to_jax_variables of it gives the flax tree back bit for bit. (flax's
  eager init of this model takes ~20 s here, its trace well under one.)
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from wespeaker_tpu.models import redimnet as jredimnet  # noqa: E402
from wespeaker_tpu.utils import torch_compat  # noqa: E402
from wespeaker_tpu_torch.models import redimnet  # noqa: E402
from wespeaker_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(2)
K = ((3, 3),)


@pytest.mark.parametrize("quirk", [False, True])
def test_gru_matches_jax_bigru(quirk):
    torch.manual_seed(0)
    port = redimnet.GRU(6, torch_quirk=quirk)
    with torch.no_grad():
        for p in port.parameters():
            p.uniform_(-0.5, 0.5)
    x = np.random.default_rng(1).standard_normal((3, 7, 6)).astype(
        np.float32)
    jmod = jredimnet.BiGRU(6, torch_quirk=quirk)
    init = jmod.init(jax.random.PRNGKey(0), jnp.zeros((3, 7, 6)))
    variables = torch_compat.torch_to_flax_variables(
        {k: v.numpy() for k, v in port.state_dict().items()}, init)
    want = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (3, 7, 12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the port's packing inverts the converter's split (b_hr, b_hz folded)
    sd = weights.pack_gru_keys(weights.expand_gru_keys(port.state_dict()))
    again = redimnet.GRU(6, torch_quirk=quirk)
    again.load_state_dict(sd, strict=True)
    np.testing.assert_allclose(again(torch.from_numpy(x)).detach().numpy(),
                               want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quirk", [False, True])
def test_redimnet_gru_block_matches_jax(quirk):
    kw = dict(feat_dim=16, C=4, block_1d_type="gru",
              block_2d_type="basic_resnet",
              stages_setup=((1, 1, 1, K, 4), (2, 1, 1, K, 4)),
              group_divisor=2, embed_dim=8, gru_quirk_compat=quirk)
    torch.manual_seed(2)
    port = redimnet.ReDimNet(**kw).eval()
    sd = port.state_dict()
    assert any(k.endswith("tcm.0.gru.weight_hh_l0_reverse") for k in sd)
    variables = weights.to_jax_variables(sd, "ReDimNetB2")
    jmod = jredimnet.ReDimNet(**kw)
    shapes = flatten_dict(jax.eval_shape(jmod.init, jax.random.PRNGKey(2),
                                         jnp.zeros((1, 40, 16))))
    flat = flatten_dict(variables)
    assert set(flat) == set(shapes)
    for path, value in flat.items():
        assert value.shape == shapes[path].shape, path
    x = np.random.default_rng(3).standard_normal((2, 40, 16)).astype(
        np.float32)
    want = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # flax -> torch -> flax is the identity (torch -> flax folds b_hr and
    # b_hz into the input biases)
    again = redimnet.ReDimNet(**kw).eval()
    again.load_state_dict(weights.from_jax_variables(variables,
                                                     "ReDimNetB2"),
                          strict=True)
    np.testing.assert_allclose(again(torch.from_numpy(x)).detach().numpy(),
                               want, rtol=1e-4, atol=1e-4)
    back = flatten_dict(weights.to_jax_variables(again.state_dict(),
                                                 "ReDimNetB2"))
    assert set(back) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(back[path], value, err_msg=str(path))
