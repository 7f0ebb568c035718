"""Port parity: the whole ECAPA-TDNN, the weight carry-over and the
extraction forward (`make_eval_embed_fn`) against the JAX package.

A small ECAPA_TDNN with global context (channels 64, feat 24) is built in
JAX with randomised BN statistics; its variables go to the port through
`utils.weights.from_jax_variables`. Embeddings must agree within 1e-4
relative (f32, sums in another order through ~10 layers).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict, unflatten_dict  # noqa: E402

from wespeaker_tpu.frontend import FbankConfig as JFbankConfig  # noqa: E402
from wespeaker_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA  # noqa: E402
from wespeaker_tpu.train import make_eval_embed_fn as j_embed_fn  # noqa: E402
from wespeaker_tpu.utils.torch_compat import (rules_for,  # noqa: E402
                                              torch_to_flax_variables)
from wespeaker_tpu_torch.frontend import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.models import get_speaker_model  # noqa: E402
from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN  # noqa: E402
from wespeaker_tpu_torch.train import make_eval_embed_fn  # noqa: E402
from wespeaker_tpu_torch.utils.checkpoint import load_checkpoint  # noqa
from wespeaker_tpu_torch.utils.weights import from_jax_variables  # noqa

torch.set_num_threads(2)
C, FEAT, EMB = 64, 24, 16


def _jax_variables(model, seed=0):
    """model.init, then BN statistics and biases randomised so that BN
    folding and every bias are exercised; returns a numpy tree."""
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 32, FEAT)), train=False)
    rng = np.random.default_rng(seed)
    flat = flatten_dict(jax.device_get(variables))
    for path, v in flat.items():
        v = np.asarray(v, np.float32)
        if path[-1] == "mean":
            v = 0.1 * rng.normal(size=v.shape)
        elif path[-1] == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif path[-1] == "scale":
            v = 1 + 0.1 * rng.normal(size=v.shape)
        elif path[-1] == "bias":
            v = 0.1 * rng.normal(size=v.shape)
        flat[path] = v.astype(np.float32)
    return unflatten_dict(flat)


def _port(variables, glob=True):
    model = ECAPA_TDNN(C, FEAT, EMB, global_context_att=glob)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model.eval()


def _mask(b, t):
    m = np.ones((b, t), np.float32)
    m[1, t * 2 // 3:] = 0
    return m


def _close(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("masked", [False, True])
def test_ecapa_matches_jax_standard_and_fused(masked):
    jmodel = JECAPA(channels=C, feat_dim=FEAT, embed_dim=EMB,
                    global_context_att=True, fused_block=False,
                    fused_tail=False)
    jfused = JECAPA(channels=C, feat_dim=FEAT, embed_dim=EMB,
                    global_context_att=True, fused_block=True,
                    fused_tail=True)  # Pallas tail in interpret mode
    variables = _jax_variables(jmodel)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 24, FEAT)).astype(np.float32)
    mask = _mask(3, 24) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), mask=jm))
    want_fused = np.asarray(jfused.apply(variables, jnp.asarray(x), mask=jm))

    model = _port(variables)
    tm = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        got = model(torch.from_numpy(x), tm).numpy()  # fused calls, plain
        got_layers = model.set_fused(False)(torch.from_numpy(x), tm).numpy()
    assert got.shape == (3, EMB)
    _close(got, want)
    _close(got, want_fused)
    _close(got_layers, want)


def test_ecapa_without_global_context_matches_jax():
    jmodel = JECAPA(channels=C, feat_dim=FEAT, embed_dim=EMB)
    variables = _jax_variables(jmodel, seed=2)
    x = np.random.default_rng(3).normal(size=(2, 21, FEAT)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(variables, glob=False)(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_state_dict_maps_back_to_the_jax_tree():
    """The port's state_dict, read by the JAX package's torch converter,
    gives back the JAX variables exactly."""
    jmodel = JECAPA(channels=C, feat_dim=FEAT, embed_dim=EMB,
                    global_context_att=True)
    variables = _jax_variables(jmodel, seed=4)
    sd = _port(variables).state_dict()
    back = torch_to_flax_variables(sd, variables, rules_for("ECAPA_TDNN"))
    want = flatten_dict(variables)
    got = flatten_dict(jax.device_get(back))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_checkpoint_reloads_strictly(tmp_path):
    ctor = get_speaker_model("ECAPA_TDNN_GLOB_c512")
    assert ctor is not None
    torch.manual_seed(0)
    src = ECAPA_TDNN(C, FEAT, EMB, global_context_att=True)
    path = tmp_path / "model.pt"
    torch.save(src.state_dict(), path)
    dst = load_checkpoint(str(path),
                          ECAPA_TDNN(C, FEAT, EMB, global_context_att=True))
    for k, v in src.state_dict().items():
        assert torch.equal(v, dst.state_dict()[k]), k

    # an upstream training checkpoint: margin head beside the model, no BN
    # counters; both handled by name
    sd = {k: v for k, v in src.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    sd["projection.weight"] = torch.zeros(10, EMB)
    torch.save({"state_dict": sd}, path)
    load_checkpoint(str(path),
                    ECAPA_TDNN(C, FEAT, EMB, global_context_att=True))

    # anything else is a real mismatch
    sd["layer1.unexpected"] = torch.zeros(1)
    torch.save(sd, path)
    with pytest.raises(RuntimeError):
        load_checkpoint(str(path),
                        ECAPA_TDNN(C, FEAT, EMB, global_context_att=True))


@pytest.mark.parametrize("masked", [False, True])
def test_make_eval_embed_fn_matches_jax(masked):
    jmodel = JECAPA(channels=C, feat_dim=FEAT, embed_dim=EMB,
                    global_context_att=True)
    variables = _jax_variables(jmodel, seed=5)
    rng = np.random.default_rng(6)
    wav = rng.uniform(-0.5, 0.5, (2, 4400)).astype(np.float32)
    batch = {"wav": wav}
    if masked:
        m = np.ones_like(wav)
        m[1, 3000:] = 0
        batch["mask"] = m
    want = np.asarray(j_embed_fn(jmodel, JFbankConfig(num_mel_bins=FEAT))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    fn = make_eval_embed_fn(_port(variables), FbankConfig(num_mel_bins=FEAT),
                            device="cpu")
    got = fn(batch).numpy()
    assert got.shape == (2, EMB) and got.dtype == np.float32
    _close(got, want)
