"""The port's bridge to the C++ runtime (wespeaker_tpu_torch/
runtime_binding.py) on the CPU: the library and binaries built with the
host compiler alone into build/runtime-<hash>/, the runtime's fbank
against the port's (the JAX test's bar: atol 2e-3, rtol 1e-3, a
different FFT and log), its engine with a narrow port ECAPA as the
callback against the JAX package's binding running JAX's ECAPA with the
same weights (1e-5 of the largest magnitude: two frameworks' f32
forwards) and against the engine's chunking redone in Python, the
mean-mel engine, the streaming pipeline and the two binaries.

The JAX binding builds with cmake into runtime/build/; here it is pointed
at the port's build of the same sources, so that no two test workers
build into one directory at once."""

import subprocess

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_zoo_util import numpy_variables  # noqa: E402
from wespeaker_tpu import runtime_binding as j_rb  # noqa: E402
from wespeaker_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA  # noqa
from wespeaker_tpu_torch import runtime_binding as rb  # noqa: E402
from wespeaker_tpu_torch.data.wav_io import write_wav  # noqa: E402
from wespeaker_tpu_torch.frontend.fbank import (  # noqa: E402
    FbankConfig, compute_fbank)
from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN  # noqa: E402
from wespeaker_tpu_torch.utils.weights import from_jax_variables  # noqa

torch.set_num_threads(2)
C, FEAT, EMB = 32, 40, 32


@pytest.fixture(scope="module")
def built():
    return rb.build_runtime()


def _wave(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, n) * (1 << 15)).astype(np.float32)


def test_the_build_is_keyed_by_its_sources(built):
    assert built == rb.build_dir() and built.parent.name == "build"
    assert built.name.startswith("runtime-") and len(built.name) == 20
    for name in (rb.LIB_NAME,) + rb.BINARIES:
        assert (built / name).exists()
    assert rb.build_runtime() == built  # nothing to rebuild


@pytest.mark.parametrize("bins,window", [(80, "hamming"), (40, "povey")])
def test_native_fbank_matches_the_ports_fbank(built, bins, window):
    wav = _wave(0, 32240)
    native = rb.NativeFbank(num_bins=bins, window_type=window)(wav)
    ref = compute_fbank(torch.from_numpy(wav), FbankConfig(
        num_mel_bins=bins, window_type=window)).numpy()
    assert native.shape == ref.shape
    np.testing.assert_allclose(native, ref, atol=2e-3, rtol=1e-3)


def test_engine_with_a_port_ecapa_matches_the_jax_engine(built,
                                                         monkeypatch):
    monkeypatch.setattr(j_rb, "BUILD_DIR", str(built))
    monkeypatch.setattr(j_rb, "LIB_PATH", str(built / rb.LIB_NAME))
    jmodel = JECAPA(channels=C, feat_dim=FEAT, embed_dim=EMB,
                    fused_block=False, fused_tail=False)
    variables = numpy_variables(jmodel, jnp.zeros((1, 32, FEAT)), seed=3)
    fwd = jax.jit(lambda f: jmodel.apply(variables, f, train=False))
    j_engine = j_rb.NativeEngine(
        feat_dim=FEAT, embed_dim=EMB,
        embed_fn=lambda f: np.asarray(fwd(jnp.asarray(f[None])))[0])
    model = ECAPA_TDNN(C, FEAT, EMB)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    embed = rb.model_embed_fn(model.eval(), "cpu")
    engine = rb.NativeEngine(feat_dim=FEAT, embed_fn=embed, embed_dim=EMB)
    # 3.3 s: one whole 198-frame chunk and one padded from the head
    wav = _wave(2, 16000 * 3 + 4800)
    got, want = engine.extract(wav), j_engine.extract(wav)
    scale = np.abs(want).max()
    assert got.shape == (EMB,) and scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    chunks = rb.engine_chunks(rb.NativeFbank(FEAT)(wav))
    assert len(chunks) == 2 and all(c.shape == (198, FEAT) for c in chunks)
    py = np.mean([embed(c) for c in chunks], axis=0)
    np.testing.assert_allclose(got, py, rtol=0, atol=1e-6 * scale)
    assert engine.cosine(got, got) == pytest.approx(1.0, abs=1e-6)


def test_a_failing_callback_raises_from_extract(built):
    def broken(feats):
        raise RuntimeError("no model")

    engine = rb.NativeEngine(feat_dim=FEAT, embed_fn=broken, embed_dim=4)
    with pytest.raises(RuntimeError, match="no model"):
        engine.extract(_wave(3, 16000))
    with pytest.raises(ValueError, match="embed_dim"):
        rb.NativeEngine(feat_dim=FEAT, embed_fn=broken)


def test_meanmel_engine_and_the_streaming_pipeline(built):
    engine = rb.NativeEngine(feat_dim=FEAT)
    emb = engine.extract(_wave(4, 16000 * 2))
    assert emb.shape == (FEAT,) and np.isfinite(emb).all()
    assert engine.cosine(emb, emb) == pytest.approx(1.0, abs=1e-5)
    wav = _wave(5, 16000)
    one_shot = rb.NativeFbank(num_bins=FEAT)(wav)
    pipe = rb.NativePipeline(num_bins=FEAT)
    for i in range(0, len(wav), 1000):
        pipe.accept(wav[i:i + 1000])
    pipe.finish()
    np.testing.assert_allclose(pipe.read(len(one_shot)), one_shot,
                               atol=1e-4)
    assert pipe.read(5).shape[0] == 0


def test_the_two_binaries_run(built, tmp_path):
    rng = np.random.default_rng(6)
    lines = []
    for i in range(3):
        p = tmp_path / f"u{i}.wav"
        write_wav(p, rng.uniform(-0.5, 0.5, 32000).astype(np.float32),
                  16000)
        lines.append(f"u{i} {p}")
    scp = tmp_path / "wav.scp"
    scp.write_text("\n".join(lines) + "\n")
    out = tmp_path / "emb.txt"
    res = subprocess.run([rb.binary("extract_emb_main"), str(scp), str(out),
                          str(FEAT), "16000", "198", "2"],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0 and "RTF" in res.stderr, res.stderr
    rows = out.read_text().split("\n")
    assert len([r for r in rows if r]) == 3
    assert len(rows[0].split()) == FEAT + 1
    asv = rb.binary("asv_main")
    a, b = str(tmp_path / "u0.wav"), str(tmp_path / "u1.wav")
    r = subprocess.run([asv, a, a, "0.9", str(FEAT)], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0 and "ACCEPT" in r.stdout
    r = subprocess.run([asv, a, b, "1.1", str(FEAT)], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 2 and "REJECT" in r.stdout
