"""Port serving: an EmbeddingServer(device="cpu") with a small ECAPA model
loaded from a torch checkpoint answers /health, /embed (JSON and RIFF
bodies) and /similarity, and each reply agrees with the JAX package's
embedding of the same utterance alone.

Two references per reply: the JAX forward of the utterance padded to the
server's quantum with its sample mask (the same function, so within 1e-4
relative), and the JAX forward of the utterance alone, unpadded (cosine
>= 0.999: the padded frames past the end reach the last valid frames
through the k=3 convs, which the mask does not gate, as in the JAX server).
"""

import concurrent.futures
import json
import urllib.request

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
from wespeaker_tpu_torch.data.wav_io import read_wav, write_wav  # noqa: E402
from wespeaker_tpu_torch.serving import EmbeddingServer  # noqa: E402
from wespeaker_tpu_torch.utils.weights import from_jax_variables  # noqa: E402

torch.set_num_threads(2)
FEAT, EMB, RATE = 24, 16, 16000
CONFIG = {"model": "ECAPA_TDNN",
          "model_args": {"channels": 64, "feat_dim": FEAT, "embed_dim": EMB,
                         "global_context_att": True},
          "dataset_args": {"fbank_args": {"num_mel_bins": FEAT}}}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jmodel = JECAPA(**CONFIG["model_args"])
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, FEAT)),
                            train=False)
    rng = np.random.default_rng(0)
    flat = flatten_dict(jax.device_get(variables))
    for path in flat:
        if path[-1] == "var":
            flat[path] = rng.uniform(0.5, 1.5, flat[path].shape).astype(
                np.float32)
    variables = unflatten_dict(flat)
    path = tmp_path_factory.mktemp("ckpt") / "model.pt"
    torch.save(from_jax_variables(variables), path)
    jfn = jax.jit(j_embed_fn(jmodel, JFbankConfig(num_mel_bins=FEAT)))

    def jax_embed(wav, pad_to=None):
        n = len(wav)
        length = pad_to or n
        w = np.zeros((1, length), np.float32)
        w[0, :n] = wav
        batch = {"wav": jnp.asarray(w)}
        if pad_to:
            m = np.zeros((1, length), np.float32)
            m[0, :n] = 1
            batch["mask"] = jnp.asarray(m)
        return np.asarray(jfn(variables, batch))[0]

    server = EmbeddingServer(CONFIG, str(path), port=0, max_batch=4,
                             max_wait_ms=50, device="cpu").start()
    yield f"http://127.0.0.1:{server.port}", jax_embed
    server.close()


def _post(url, body, ctype="application/json"):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def _check(got, wav, jax_embed):
    padded = -(-len(wav) // RATE) * RATE
    want = jax_embed(wav, pad_to=padded)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    assert _cos(got, jax_embed(wav)) >= 0.999


def test_health_and_concurrent_json_embeds(served):
    base, jax_embed = served
    with urllib.request.urlopen(f"{base}/health", timeout=30) as r:
        assert json.load(r)["status"] == "ok"
    rng = np.random.default_rng(1)
    wavs = [rng.uniform(-0.5, 0.5, n).astype(np.float32)
            for n in (9000, 17000, 23000)]

    def embed(w):
        body = json.dumps({"wav": w.tolist(), "sample_rate": RATE}).encode()
        return np.asarray(_post(f"{base}/embed", body)["embedding"])

    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        got = list(ex.map(embed, wavs))
    for wav, emb in zip(wavs, got):
        assert emb.shape == (EMB,)
        _check(emb, wav, jax_embed)


def test_riff_body_and_similarity(served, tmp_path):
    base, jax_embed = served
    wav = np.random.default_rng(2).uniform(-0.5, 0.5, 12000).astype(
        np.float32)
    write_wav(tmp_path / "a.wav", wav, RATE)
    got = np.asarray(_post(f"{base}/embed", (tmp_path / "a.wav").read_bytes(),
                           "audio/wav")["embedding"])
    pcm, sr = read_wav(str(tmp_path / "a.wav"))
    assert sr == RATE
    _check(got, pcm, jax_embed)

    body = json.dumps({"wav1": wav.tolist(), "wav2": wav.tolist()}).encode()
    assert _post(f"{base}/similarity", body)["similarity"] == pytest.approx(
        1.0, abs=1e-4)
