"""Port parity: Kaldi fbank and CMVN (wespeaker_tpu_torch.frontend.fbank)
against the JAX package and the independent numpy oracle.

Tolerance: atol 1e-3 on log-mel. Inputs scaled by 2^15 are summed over 400
taps in another order by the two frameworks; the log of powers of order
1e6..1e12 keeps that within 1e-3 absolute.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from tests.kaldi_fbank_numpy import fbank_numpy  # noqa: E402
from wespeaker_tpu.frontend import fbank as jfb  # noqa: E402
from wespeaker_tpu_torch.frontend import fbank as tfb  # noqa: E402

torch.set_num_threads(2)
ATOL = 1e-3


def _wav(n=16000 + 2137, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    return (rng.uniform(-1, 1, shape) * (1 << 15)).astype(np.float32)


def _cfg(module, **kw):
    return module.FbankConfig(dither=0.0, **kw)


# (window, bins, rate, frames of the 18,137-sample input); 8 kHz, 40
# povey bins is the SRE recipes' fbank (examples/sre/v2/conf)
@pytest.mark.parametrize("window,num_mel,rate,frames", [
    ("hamming", 80, 16000, 111), ("povey", 40, 16000, 111),
    ("povey", 40, 8000, 225)])
def test_fused_fbank_matches_jax_and_oracle(window, num_mel, rate, frames):
    wav = _wav(batch=2)
    got = tfb.compute_fbank(torch.from_numpy(wav),
                            _cfg(tfb, num_mel_bins=num_mel,
                                 window_type=window,
                                 sample_rate=rate)).numpy()
    want = np.asarray(jfb.compute_fbank(
        jnp.asarray(wav), _cfg(jfb, num_mel_bins=num_mel,
                               window_type=window, sample_rate=rate)))
    assert got.shape == want.shape == (2, frames, num_mel)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    oracle = fbank_numpy(wav[1].astype(np.float64), sample_rate=rate,
                         num_mel=num_mel, window=window)
    np.testing.assert_allclose(got[1], oracle, rtol=0, atol=ATOL)


def test_exact_fbank_path_matches_jax_and_oracle():
    """The per-frame rfft path (the one dither takes), without dither."""
    wav = _wav(seed=1)
    tcfg, jcfg = _cfg(tfb), _cfg(jfb)
    got = tfb._fbank_impl(torch.from_numpy(wav), tcfg, None).numpy()
    want = np.asarray(jfb._fbank_impl(jnp.asarray(wav), jcfg,
                                      jcfg.num_frames(wav.shape[-1]), None))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, fbank_numpy(wav.astype(np.float64)),
                               rtol=0, atol=ATOL)


def test_dither_comes_from_the_generator():
    wav = torch.from_numpy(_wav(seed=2))
    cfg = tfb.FbankConfig(dither=1.0)
    with pytest.raises(ValueError):
        tfb.compute_fbank(wav, cfg)
    a = tfb.compute_fbank(wav, cfg, generator=torch.Generator().manual_seed(0))
    b = tfb.compute_fbank(wav, cfg, generator=torch.Generator().manual_seed(0))
    c = tfb.compute_fbank(wav, cfg, generator=torch.Generator().manual_seed(1))
    clean = tfb.compute_fbank(wav, _cfg(tfb))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # dither of 1 LSB on a full-scale signal barely moves the log-mel
    assert (a - clean).abs().max() < 0.05


def test_bf16_conv_close_to_f32():
    wav = torch.from_numpy(_wav(seed=3, batch=2))
    want = tfb.compute_fbank(wav, _cfg(tfb))
    got = tfb.compute_fbank(wav, _cfg(tfb), conv_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert (got - want).abs().max() < 0.15
    assert (got - want).abs().mean() < 0.02


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("norm_var", [False, True])
def test_cmvn_matches_jax(masked, norm_var):
    rng = np.random.default_rng(4)
    feat = rng.normal(size=(3, 40, 24)).astype(np.float32) * 3 + 1
    mask = None
    if masked:
        mask = (np.arange(40)[None] < np.array([[40], [25], [9]])).astype(
            np.float32)
    got = tfb.apply_cmvn(torch.from_numpy(feat), norm_var=norm_var,
                         mask=None if mask is None else torch.from_numpy(mask))
    want = jfb.apply_cmvn(jnp.asarray(feat), norm_var=norm_var,
                          mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_host_operators_match_jax():
    cfg_t, cfg_j = _cfg(tfb), _cfg(jfb)
    np.testing.assert_array_equal(tfb.make_window(cfg_t),
                                  jfb.make_window(cfg_j))
    np.testing.assert_array_equal(tfb.make_mel_banks(cfg_t),
                                  jfb.make_mel_banks(cfg_j))
    np.testing.assert_array_equal(tfb._fused_dft_kernel(cfg_t),
                                  jfb._fused_dft_kernel(cfg_j))
