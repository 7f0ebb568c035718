"""The port's Whisper frontend and PMFA head (wespeaker_tpu_torch/
frontend/whisper_mel.py, whisper_encoder.py, models/whisper_PMFA.py)
against the JAX package's, f32 on the CPU, at a tiny width (16 mels, 3
blocks of 32, layers 1-2 concatenated, n_ctx 128; as
tests/test_composite_frontend.py's tiny whisper).

Weights: seeded numpy for the flax tree (tests/torch_zoo_util.py),
carried by utils/weights.py. whisper_logmel within 1e-5 of the largest
magnitude (batched and 1-D), its operators uploaded once per device; the
encoder's output within 1e-5 on a masked ragged batch and the padded
row's valid frames against the utterance alone; the flax LayerNorm eps
(1e-6: the JAX modules name none) where it shows, on inputs of small
variance; the PMFA head in eval with BN statistics and a mask. Tiny
copies of the two whisper_pmfa YAMLs embed as the JAX package's (1e-5); a
JAX composite `.ckpt` loads into the port (bin/extract.py's loader) and
embeds as JAX does, and the port's `.ckpt` (to_jax_variables) is byte for
byte the one JAX wrote. The train steps of the composite are in
test_torch_frontend_train.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.frontend import whisper_encoder as jwe  # noqa: E402
from wespeaker_tpu.frontend import whisper_mel as jmel  # noqa: E402
from wespeaker_tpu.models import whisper_PMFA as jpmfa  # noqa: E402
from wespeaker_tpu_torch.frontend import whisper_encoder as we  # noqa
from wespeaker_tpu_torch.frontend import whisper_mel as mel  # noqa: E402
from wespeaker_tpu_torch.models import whisper_PMFA as pmfa  # noqa: E402
from wespeaker_tpu_torch.utils.weights import from_jax_variables  # noqa

from tests.test_torch_frontend_composite import (  # noqa: E402
    YAMLS, _configs, _tiny, _wavs)
from tests.test_torch_frontend_recipes import _port, recipe_pair  # noqa
from tests.torch_zoo_util import numpy_variables  # noqa: E402
from wespeaker_tpu_torch.train import make_eval_embed_fn  # noqa: E402
from wespeaker_tpu_torch.train.composite import featurizers  # noqa: E402
from wespeaker_tpu_torch.utils.weights import (  # noqa: E402
    rules_name, to_jax_variables)

torch.set_num_threads(2)
FE = dict(n_mels=16, num_blocks=3, output_size=32, n_head=4, layer_st=1,
          layer_ed=2, n_ctx=128)


def _rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def test_whisper_logmel_matches_jax_and_uploads_once():
    rng = np.random.default_rng(0)
    wav = rng.uniform(-0.5, 0.5, (3, 16037)).astype(np.float32)
    cfg = mel.WhisperMelConfig(num_mel_bins=16)
    jcfg = jmel.WhisperMelConfig(num_mel_bins=16)
    jlogmel = jax.jit(jmel.whisper_logmel, static_argnums=1)
    got = mel.whisper_logmel(torch.from_numpy(wav), cfg)
    want = jlogmel(jnp.asarray(wav), jcfg)
    assert got.shape == want.shape == (3, 100, 16)
    assert _rel_err(got, want) <= 1e-5
    hits = mel._operators.cache_info().hits
    one = mel.whisper_logmel(torch.from_numpy(wav[1]), cfg)
    assert mel._operators.cache_info().hits == hits + 1
    assert _rel_err(one, jlogmel(jnp.asarray(wav[1]), jcfg)) <= 1e-5
    np.testing.assert_allclose(
        mel.make_whisper_mel_banks(mel.WhisperMelConfig()),
        jmel.make_whisper_mel_banks(jmel.WhisperMelConfig()), rtol=0,
        atol=0)


def _encoder_pair(seed=0):
    jm = jwe.WhisperEncoderFrontend(**FE)
    variables = numpy_variables(jm, jnp.zeros((1, 40, 16)), seed=seed)
    port = we.WhisperEncoderFrontend(**FE)
    port.load_state_dict(from_jax_variables(variables, "WhisperEncoder"),
                         strict=True)
    return jax.jit(jm.apply), variables, port.eval()


def test_encoder_matches_jax_and_each_utterance_alone():
    japply, variables, port = _encoder_pair()
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 41, 16)).astype(np.float32)
    mask = np.ones((2, 41), np.float32)
    mask[1, 26:] = 0.0
    want = japply(variables, jnp.asarray(feats), jnp.asarray(mask))
    with torch.no_grad():
        got = port(torch.from_numpy(feats), torch.from_numpy(mask))
        solo = port(torch.from_numpy(feats[1:, :26]))
    assert got.shape == want.shape == (2, 21, 64)
    assert _rel_err(got, want) <= 1e-5
    # an even valid length: conv2's last valid output sees only valid
    # frames (at an odd one it sees conv1's output past the end, in both
    # packages)
    assert solo.shape[1] == 13
    assert _rel_err(got[1:, :13], solo) <= 1e-5
    # beyond n_ctx frames the sequence is cut (AudioEncoder's n_ctx)
    long = rng.standard_normal((1, 2 * FE["n_ctx"] + 9, 16)).astype(
        np.float32)
    with torch.no_grad():
        cut = port(torch.from_numpy(long))
    assert cut.shape[1] == FE["n_ctx"]


def test_layer_norms_use_flax_eps():
    """The JAX modules' LayerNorms name no eps, so flax's 1e-6 holds (not
    torch's 1e-5): on inputs of variance ~1e-6 a block matches the JAX
    block only with it."""
    port = we.WhisperEncoderFrontend(**FE)
    eps = {m.eps for m in port.modules()
           if isinstance(m, torch.nn.LayerNorm)}
    assert eps == {1e-6}
    jblock = jwe.ResidualAttentionBlock(32, 4)
    x = (1e-3 * np.random.default_rng(2).standard_normal((2, 9, 32))
         ).astype(np.float32)
    variables = numpy_variables(jblock, jnp.zeros((1, 9, 32)), seed=3)
    want = jax.jit(jblock.apply)(variables, jnp.asarray(x))
    block = we.ResidualAttentionBlock(32, 4)
    block.load_state_dict(from_jax_variables(variables, "WhisperEncoder"),
                          strict=True)
    with torch.no_grad():
        assert _rel_err(block(torch.from_numpy(x)), want) <= 1e-5
        block.attn_ln.eps = block.mlp_ln.eps = 1e-5
        assert _rel_err(block(torch.from_numpy(x)), want) > 1e-3


def test_pmfa_head_matches_jax():
    jm = jpmfa.whisper_PMFA_large_v2(64, 16)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 21, 64)).astype(np.float32)
    mask = np.ones((3, 21), np.float32)
    mask[2, 9:] = 0.0
    variables = numpy_variables(jm, jnp.zeros((1, 21, 64)), seed=5)
    want = jax.jit(lambda v, a, m: jm.apply(v, a, m))(
        variables, jnp.asarray(x), jnp.asarray(mask))
    port = pmfa.whisper_PMFA_large_v2(64, 16)
    sd = from_jax_variables(variables, "whisper_PMFA")
    sd["bn.norm.num_batches_tracked"] = torch.tensor(0)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("stage", [1, 2])
def test_recipe_composite_embeds_as_jax(stage):
    """A tiny copy of whisper_pmfa_stage<n>.yaml (TINY of
    test_torch_frontend_composite.py), as the other recipes' in
    test_torch_frontend_recipes.py."""
    configs = _tiny(_configs(YAMLS[4 + stage]))
    jb, apply, variables = recipe_pair(configs)
    wav, mask = _wavs(2)
    want = apply(variables, jnp.asarray(wav), jnp.asarray(mask))
    fn = make_eval_embed_fn(_port(configs, variables), device="cpu",
                            featurize_fn=featurizers(configs)[1])
    got = fn({"wav": wav, "mask": mask})
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-5


def test_jax_composite_ckpt_both_ways(tmp_path):
    """A JAX `.ckpt` of the whisper composite (with its head) loads into
    the port through bin/extract.py's loader and embeds as JAX; the
    port's tree of the loaded model is the one JAX wrote, exactly."""
    from wespeaker_tpu.utils import checkpoint as jckpt
    from wespeaker_tpu_torch.bin.extract import load_model_for_eval
    from wespeaker_tpu_torch.utils.checkpoint import (read_msgpack_checkpoint,
                                                      save_msgpack_checkpoint)

    configs = _tiny(_configs(YAMLS[5]))
    jb, apply, variables = recipe_pair(configs)
    path = str(tmp_path / "model_0.ckpt")
    jckpt.save_checkpoint(path, dict(variables))
    model = load_model_for_eval(configs, path, device="cpu")
    wav, mask = _wavs(3)
    got = make_eval_embed_fn(model, device="cpu",
                             featurize_fn=featurizers(configs)[1])(
        {"wav": wav, "mask": mask})
    assert _rel_err(got, apply(variables, jnp.asarray(wav),
                               jnp.asarray(mask))) <= 1e-5
    back = str(tmp_path / "port.ckpt")
    save_msgpack_checkpoint(back, to_jax_variables(model.state_dict(),
                                                   rules_name(model)))
    with open(path, "rb") as a, open(back, "rb") as b:
        assert a.read() == b.read()
    assert sorted(read_msgpack_checkpoint(back)["params"]) == [
        "frontend", "speaker_model"]
