"""The port's w2v-bert 2.0 frontend and adapter-MFA head
(wespeaker_tpu_torch/frontend/w2vbert.py, models/w2vbert_adapter_mfa.py)
against the JAX package's, f32 on the CPU, at a tiny width (hidden 32, 2
conformer layers, 4 heads; tests/test_w2vbert.py's scale).

Weights: seeded numpy for the flax tree (tests/torch_zoo_util.py),
carried by utils/weights.py. w2vbert_features (povey fbank of x * 2^15,
per-bin ddof-1 normalisation over the valid frames, stride-2 stacking)
and its stacked mask, which keeps source rows 1::2, within 1e-5 of the
largest magnitude, masked and not; every hidden state within 1e-5 on a
masked ragged batch, and the padded row's valid frames against the
utterance alone; the conv module's depthwise conv is causal (a frame's
output ignores later frames); the adapters' LayerNorm uses flax's eps
1e-6, which shows on inputs of small variance; tiny copies of the three
w2vbert_s*.yaml composites embed as the JAX package's (1e-5).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.frontend import w2vbert as jw2v  # noqa: E402
from wespeaker_tpu.models import w2vbert_adapter_mfa as jhead  # noqa: E402
from wespeaker_tpu_torch.frontend import w2vbert as w2v  # noqa: E402
from wespeaker_tpu_torch.models import w2vbert_adapter_mfa as head  # noqa
from wespeaker_tpu_torch.utils.weights import from_jax_variables  # noqa

from tests.test_torch_frontend_composite import (  # noqa: E402
    YAMLS, _configs, _tiny, _wavs)
from tests.test_torch_frontend_recipes import _port, recipe_pair  # noqa
from tests.torch_zoo_util import numpy_variables  # noqa: E402
from wespeaker_tpu_torch.train import make_eval_embed_fn  # noqa: E402
from wespeaker_tpu_torch.train.composite import featurizers  # noqa: E402

torch.set_num_threads(2)
CFG = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=64)
N, N_SHORT = 8000, 5360   # samples: 49 and 32 fbank frames


def _rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _wavs(seed):
    rng = np.random.default_rng(seed)
    wav = rng.uniform(-0.5, 0.5, (2, N)).astype(np.float32)
    wav[1, N_SHORT:] = 0.0
    mask = np.ones((2, N), np.float32)
    mask[1, N_SHORT:] = 0.0
    return wav, mask


# jitted: one compile a shape instead of one an eager op
_jfeatures = jax.jit(jw2v.w2vbert_features)


def test_features_and_stacked_mask_match_jax():
    wav, mask = _wavs(0)
    got, gmask = w2v.w2vbert_features(torch.from_numpy(wav),
                                      torch.from_numpy(mask))
    want, wmask = _jfeatures(jnp.asarray(wav), jnp.asarray(mask))
    assert got.shape == want.shape == (2, 24, 160)
    assert _rel_err(got, want) <= 1e-5
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    # rows 1::2 of the 49 (and 32) frames: 24 and 16 stacked frames, the
    # second source frame of each deciding
    assert gmask.sum(1).tolist() == [24.0, 16.0]
    plain, none = w2v.w2vbert_features(torch.from_numpy(wav[:1]))
    assert none is None
    assert _rel_err(plain, _jfeatures(jnp.asarray(wav[:1]))[0]) <= 1e-5


def test_frontend_matches_jax_and_each_utterance_alone():
    jm = jw2v.W2VBertFrontend(jw2v.W2VBertConfig(**CFG))
    variables = numpy_variables(jm, jnp.zeros((1, 24, 160)), seed=1)
    port = w2v.W2VBertFrontend(w2v.W2VBertConfig(**CFG)).eval()
    port.load_state_dict(from_jax_variables(variables, "Wav2Vec2Bert"),
                         strict=True)
    wav, mask = _wavs(2)
    feats, fmask = _jfeatures(jnp.asarray(wav), jnp.asarray(mask))
    j_hidden, j_last = jax.jit(jm.apply)(variables, feats, fmask)
    x, m = torch.tensor(np.asarray(feats)), torch.tensor(np.asarray(fmask))
    with torch.no_grad():
        hidden, last = port(x, m)
        solo, _ = port(x[1:, :16])
    assert len(hidden) == len(j_hidden) == 3
    for got, want in zip(hidden, j_hidden):
        assert _rel_err(got, want) <= 1e-5
    assert _rel_err(last, j_last) <= 1e-5
    for got, want in zip(hidden, solo):
        assert _rel_err(got[1:, :16], want) <= 1e-5


def test_depthwise_conv_is_causal():
    """Padding k - 1 frames on the left: changing frames after t leaves
    the conv module's output at frames <= t unchanged, and the module
    matches the JAX one."""
    cfg = w2v.W2VBertConfig(**CFG)
    jmod = jw2v.W2VBertConvModule(jw2v.W2VBertConfig(**CFG))
    variables = numpy_variables(jmod, jnp.zeros((1, 12, 32)), seed=3)
    mod = w2v.W2VBertConvModule(cfg)
    mod.load_state_dict(from_jax_variables(variables, "Wav2Vec2Bert"),
                        strict=True)
    x = torch.randn(1, 40, 32, generator=torch.Generator().manual_seed(4))
    later = x.clone()
    later[:, 25:] += 1.0
    with torch.no_grad():
        a, b = mod(x), mod(later)
    assert torch.equal(a[:, :25], b[:, :25])
    assert not torch.allclose(a[:, 25:], b[:, 25:])
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x.numpy()))
    assert _rel_err(a, want) <= 1e-5


def test_adapter_mfa_head_matches_jax_with_flax_eps():
    jm = jhead.W2VBert_Adapter_MFA(feat_dim=32, embed_dim=16, n_mfa_layers=2,
                                   adapter_dim=8,
                                   num_frontend_hidden_layers=2)
    rng = np.random.default_rng(5)
    # adapter inputs of small variance, where the LayerNorm eps shows
    states = [(1e-4 * rng.standard_normal((3, 11, 32))).astype(np.float32)
              for _ in range(3)]
    mask = np.ones((3, 11), np.float32)
    mask[2, 6:] = 0.0
    variables = numpy_variables(jm, [jnp.zeros((1, 11, 32))] * 3, seed=6)
    want = jax.jit(lambda v, s, m: jm.apply(v, s, m))(
        variables, [jnp.asarray(s) for s in states], jnp.asarray(mask))
    port = head.W2VBert_Adapter_MFA(32, 16, n_mfa_layers=2, adapter_dim=8,
                                    num_frontend_hidden_layers=2).eval()
    sd = from_jax_variables(variables, "W2VBert_Adapter_MFA")
    sd["pooling.attention.2.num_batches_tracked"] = torch.tensor(0)
    port.load_state_dict(sd, strict=True)
    assert {a[1].eps for a in port.adapter_layers} == {1e-6}
    args = ([torch.from_numpy(s) for s in states], torch.from_numpy(mask))
    with torch.no_grad():
        assert _rel_err(port(*args), want) <= 1e-5
        for a in port.adapter_layers:
            a[1].eps = 1e-5
        assert _rel_err(port(*args), want) > 1e-3


@pytest.mark.parametrize("path", YAMLS[2:5], ids=lambda p: p.stem)
def test_recipe_composite_embeds_as_jax(path):
    """A tiny copy of each w2vbert_s*.yaml (TINY of
    test_torch_frontend_composite.py), as the WavLM recipes' in
    test_torch_frontend_recipes.py."""
    configs = _tiny(_configs(path))
    jb, apply, variables = recipe_pair(configs)
    wav, mask = _wavs(2)
    want = apply(variables, jnp.asarray(wav), jnp.asarray(mask))
    fn = make_eval_embed_fn(_port(configs, variables), device="cpu",
                            featurize_fn=featurizers(configs)[1])
    got = fn({"wav": wav, "mask": mask})
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-5
