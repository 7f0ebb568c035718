"""The port's WavLM / HuBERT / wav2vec 2.0 encoder
(wespeaker_tpu_torch/frontend/wavlm.py) against the JAX package's
(wespeaker_tpu/frontend/wavlm.py), at the JAX tests' tiny size (hidden
32, 2 layers, conv_dim 16; tests/test_wavlm.py::_tiny_cfg has 3), f32 on
the CPU.

Weights: seeded numpy for the flax tree (tests/torch_zoo_util.py),
carried to the port by utils/weights.py. Every hidden state and the last
within 1e-5 of the largest magnitude on a masked ragged batch, in the
Base (post-LN, group norm), Large (pre-LN, layer norms, input
normalisation) and HuBERT (no relative-position bias, an odd positional
kernel) forms; the masked batch against each utterance alone;
and the places where a port goes wrong quietly: the bucket function's
rounding (computed in f64 on the host; f32 moves edges), the gate's
(B, H, T, 2, 4) reading, the even kernel's trailing frame, the conv
stack's length arithmetic on ragged lengths, and the weight-norm fold.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.frontend import wavlm as jwavlm  # noqa: E402
from wespeaker_tpu_torch.frontend import wavlm  # noqa: E402
from wespeaker_tpu_torch.models.layers import conv1d  # noqa: E402
from wespeaker_tpu_torch.utils.weights import from_jax_variables  # noqa

from tests.torch_zoo_util import numpy_variables  # noqa: E402

torch.set_num_threads(2)
N = 6400          # samples: 19 frames
N_SHORT = 4480    # the ragged row's valid samples: 13 frames


def _tiny(form: str, **over):
    large = form != "base"
    kw = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=64, conv_dim=(16,) * 7, conv_bias=large,
              feat_extract_norm="layer" if large else "group",
              do_stable_layer_norm=large, num_conv_pos_embeddings=16,
              num_conv_pos_embedding_groups=4, num_buckets=40,
              max_bucket_distance=100, use_rel_pos_bias=form != "hubert")
    kw.update(over)
    return kw


def _pair(form, **over):
    """(jitted JAX apply, variables, port module) with the same weights."""
    kw = _tiny(form, **over)
    norm = form == "large"
    jm = jwavlm.WavLMFrontend(jwavlm.WavLMConfig(**kw), normalize_input=norm)
    variables = numpy_variables(jm, jnp.zeros((1, N)), seed=0)
    port = wavlm.WavLMFrontend(wavlm.WavLMConfig(**kw), normalize_input=norm)
    port.load_state_dict(from_jax_variables(variables, "WavLM"), strict=True)
    return jax.jit(jm.apply), variables, port.eval()


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    wav = rng.uniform(-0.5, 0.5, (2, N)).astype(np.float32)
    mask = np.ones((2, N), np.float32)
    mask[1, N_SHORT:] = 0.0
    wav[1, N_SHORT:] = 0.0
    return wav, mask


def _rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("form,over", [
    ("base", {}), ("large", {}), ("hubert", {"num_conv_pos_embeddings": 15})],
    ids=["base", "large", "hubert-odd-pos-kernel"])
def test_hidden_states_match_jax_and_each_utterance_alone(form, over):
    japply, variables, port = _pair(form, **over)
    wav, mask = _batch()
    j_hidden, j_last = japply(variables, jnp.asarray(wav), jnp.asarray(mask))
    with torch.no_grad():
        hidden, last = port(torch.from_numpy(wav), torch.from_numpy(mask))
        solo, _ = port(torch.from_numpy(wav[1:, :N_SHORT]))
    assert len(hidden) == len(j_hidden) == 3
    for got, want in zip(hidden, j_hidden):
        assert got.shape == want.shape
        assert _rel_err(got, want) <= 1e-5
    assert _rel_err(last, j_last) <= 1e-5
    # the padded row's valid frames are the utterance alone's
    t = port.cfg.feat_extract_output_lengths(N_SHORT)
    for got, want in zip(hidden, solo):
        assert want.shape[1] == t
        assert _rel_err(got[1:, :t], want) <= 1e-5


def test_relative_position_buckets_match_jax_and_need_f64():
    for t, nb, dist in ((37, 40, 100), (300, 320, 800), (1500, 320, 800)):
        got = wavlm.relative_position_buckets(t, t, nb, dist)
        want = jwavlm.relative_position_buckets(t, t, nb, dist)
        np.testing.assert_array_equal(got, want)
    # in f32 the log's rounding moves bucket edges: the host's f64 matters
    rel = np.arange(1, 1500)
    nb, max_exact = 160, 80

    def large(dtype):
        v = np.log(rel.astype(dtype) / dtype(max_exact))
        v = v / dtype(math.log(800 / max_exact)) * dtype(nb - max_exact)
        return max_exact + v.astype(np.int64)

    assert (large(np.float64) != large(np.float32)).any()
    ref = wavlm.relative_position_buckets(1, 1500, 320, 800)[0, 1:]
    assert (np.minimum(large(np.float64), nb - 1)[max_exact:] + nb
            == ref[max_exact:]).all()


def test_gate_reads_two_groups_of_four():
    """The gate sums the 8 projections in fours, (B, H, T, 2, 4), as the
    JAX package does; the other reading, (B, H, T, 4, 2) summed, differs."""
    rng = np.random.default_rng(2)
    proj = rng.standard_normal((2, 4, 5, 8)).astype(np.float32)
    const = rng.standard_normal((1, 4, 1, 1)).astype(np.float32)

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    # jax/flax wavlm.py:125-131 in numpy
    g = sigmoid(proj.reshape(2, 4, 5, 2, 4).sum(-1))
    want = g[..., 0:1] * (g[..., 1:2] * const - 1.0) + 2.0
    got = wavlm.rel_pos_gate(torch.from_numpy(proj), torch.from_numpy(const))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    other = sigmoid(proj.reshape(2, 4, 5, 4, 2).sum(-1))
    assert np.abs(other[..., 0:1] - g[..., 0:1]).max() > 1e-2


def test_even_positional_kernel_drops_its_trailing_frame():
    """Padding k // 2 on both sides gives T + 1 frames for an even k; the
    frontend drops the last (WavLMSamePadLayer) and keeps T. Which frame
    goes is held by the JAX parity above (k = 16 and 15)."""
    cfg = wavlm.WavLMConfig(**_tiny("base"))
    torch.manual_seed(0)
    port = wavlm.WavLMFrontend(cfg).eval()
    with torch.no_grad():
        padded = conv1d(torch.randn(2, 19, 32),
                        port.encoder.pos_conv_embed.conv)
        hidden, _ = port(torch.zeros(1, N))
    assert padded.shape[1] == 20
    assert hidden[0].shape[1] == cfg.feat_extract_output_lengths(N) == 19


def test_conv_stack_lengths_on_ragged_batches():
    """feat_extract_output_lengths and the frame mask against the conv
    stack's true output length, utterance by utterance, and against the
    JAX package's arithmetic."""
    kw = _tiny("large")
    cfg = wavlm.WavLMConfig(**kw)
    jcfg = jwavlm.WavLMConfig(**kw)
    torch.manual_seed(0)
    enc = wavlm.WavLMFeatureEncoder(cfg).eval()
    lengths = [400, 401, 719, 720, 721, 1999, 2000, 4480, 6399, 6400]
    mask = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1.0
        with torch.no_grad():
            true_t = enc(torch.zeros(1, n)).shape[1]
        assert cfg.feat_extract_output_lengths(n) == true_t
        assert jcfg.feat_extract_output_lengths(n) == true_t
    t_out = cfg.feat_extract_output_lengths(max(lengths))
    fmask = wavlm.frame_mask(cfg, torch.from_numpy(mask), t_out)
    want = np.asarray(jax.jit(jwavlm.WavLMFrontend(jcfg).downsample_mask,
                              static_argnums=1)(jnp.asarray(mask), t_out))
    np.testing.assert_array_equal(fmask.numpy(), want)
    assert fmask.sum(1).tolist() == [cfg.feat_extract_output_lengths(n)
                                     for n in lengths]


@pytest.mark.parametrize("names", ["parametrizations", "weight_g"])
def test_weight_norm_fold_matches_jax(names):
    rng = np.random.default_rng(3)
    g = rng.standard_normal((1, 1, 16)).astype(np.float32)
    v = rng.standard_normal((32, 8, 16)).astype(np.float32)
    base = "encoder.pos_conv_embed.conv"
    keys = ((f"{base}.parametrizations.weight.original0",
             f"{base}.parametrizations.weight.original1")
            if names == "parametrizations" else
            (f"{base}.weight_g", f"{base}.weight_v"))
    sd = {keys[0]: g, keys[1]: v, f"{base}.bias": np.zeros(32, np.float32)}
    want = jwavlm.fold_wavlm_weight_norm(sd)
    got = wavlm.fold_wavlm_weight_norm(
        {k: torch.from_numpy(a) for k, a in sd.items()})
    assert sorted(got) == sorted(want) == [f"{base}.bias", f"{base}.weight"]
    np.testing.assert_allclose(got[f"{base}.weight"].numpy(),
                               want[f"{base}.weight"], rtol=1e-6, atol=1e-7)


def test_wavlm_config_presets_match_jax():
    for name in ("base", "large", "hubert_base", "hubert_large"):
        got = dataclasses.asdict(getattr(wavlm.WavLMConfig, name)())
        want = dataclasses.asdict(getattr(jwavlm.WavLMConfig, name)())
        assert got == want
