"""Port parity for the diarization pipeline and its entry points, against
the JAX package on the CPU.

One synthetic recording: two tone "speakers" (the JAX test's, amplitude
modulated) in 8 alternating 3 s turns with 0.5 s of silence between them,
16 kHz; the oracle SAD and the reference RTTM are the turns.
- `diarize_wav` with the JAX test's mock embedder (the windows' std over
  time) on the oracle turns, per-window and per-segment CMN: the same
  subsegment ids, the windows it embeds within 1e-4 (fbank), the same
  partition, and DER 0 between the two hypotheses.
- Then with a narrow ECAPA (C=32, feat 40, embed 32, f32) whose weights
  come from JAX's flax init (utils/weights.py::from_jax_variables): each
  batch's embeddings within 1e-4 of the largest magnitude, and the same
  merged segments up to label names.
- `bin/diarize.py` against JAX's `diarize` on a JAX-written `.ckpt`
  (oracle SAD and a reference RTTM): the same RTTM up to label names and
  the same DER; the `--sad_model` path with a scripted torch module
  (system SAD equal to JAX's, the CLI's RTTM equal to `diarize_wav` on
  those segments).
- `/diarize` on the port's CPU server: the reply equals `diarize_wav`
  in-process (to the reply's 3 decimals); a server given no diarization
  function answers 501.
- `Speaker` on a model directory against JAX's `Speaker`:
  `extract_embedding` and `compute_similarity` within 1e-4,
  `diarize` (energy VAD, UMAP) the same segments up to label names;
  `register` / `recognize`; hub names refused.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402
from flax.core import unfreeze  # noqa: E402

from wespeaker_tpu.bin import diarize as jdiar_cli  # noqa: E402
from wespeaker_tpu.cli import speaker as jspeaker  # noqa: E402
from wespeaker_tpu.diar import pipeline as jpipe  # noqa: E402
from wespeaker_tpu.diar import vad as jvad  # noqa: E402
from wespeaker_tpu.frontend import FbankConfig as JFbankConfig  # noqa: E402
from wespeaker_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA  # noqa: E402
from wespeaker_tpu.utils import checkpoint as jckpt  # noqa: E402
from wespeaker_tpu_torch.bin import diarize as tdiar_cli  # noqa: E402
from wespeaker_tpu_torch.bin.extract import (fbank_config,  # noqa: E402
                                             load_model_for_eval)
from wespeaker_tpu_torch.cli import speaker as tspeaker  # noqa: E402
from wespeaker_tpu_torch.data.wav_io import read_wav, write_wav  # noqa: E402
from wespeaker_tpu_torch.diar import pipeline as tpipe  # noqa: E402
from wespeaker_tpu_torch.diar import rttm as trttm  # noqa: E402
from wespeaker_tpu_torch.diar import vad as tvad  # noqa: E402
from wespeaker_tpu_torch.frontend.fbank import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN  # noqa: E402
from wespeaker_tpu_torch.serving import EmbeddingServer  # noqa: E402
from wespeaker_tpu_torch.utils.weights import (  # noqa: E402
    from_jax_variables)

torch.set_num_threads(2)
SR = 16000
TURN, GAP, TURNS = 3.0, 0.5, 8
C, FEAT, EMB = 32, 40, 32
CONFIG = {"model": "ECAPA_TDNN",
          "model_args": {"channels": C, "feat_dim": FEAT, "embed_dim": EMB},
          "dataset_args": {"fbank_args": {"num_mel_bins": FEAT}}}


def relabelled(merged):
    """Merged segments with labels renamed by first appearance."""
    names = {}
    return [(u, b, e, names.setdefault(lab, len(names)))
            for u, b, e, lab in merged]


def rttm_rows(path):
    rows = []
    for line in open(path):
        p = line.split()
        rows.append((p[1], p[3], p[4], p[7]))
    return relabelled(rows)


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    """The recording (written as PCM16 and read back), its turns, the
    files of the CLIs, the JAX model and its variables, the port model
    with the same weights."""
    root = tmp_path_factory.mktemp("diar")
    rng = np.random.default_rng(0)
    t = np.arange(int(SR * TURN)) / SR

    def speaker(freqs):
        sig = sum(np.sin(2 * np.pi * f * t) for f in freqs)
        sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * 3.0 * t))
        return (0.3 * sig / np.max(np.abs(sig))
                + rng.normal(0, 0.005, len(t))).astype(np.float32)

    parts, turns, cur = [], [], 0.0
    for i in range(TURNS):
        parts.append(speaker([300, 500] if i % 2 == 0 else [900, 1400]))
        parts.append(np.zeros(int(SR * GAP), np.float32))
        turns.append((cur, cur + TURN, f"spk{i % 2}"))
        cur += TURN + GAP
    write_wav(root / "rec.wav", np.concatenate(parts), SR)
    wav, _ = read_wav(str(root / "rec.wav"))
    (root / "wav.scp").write_text(f"rec {root / 'rec.wav'}\n")
    (root / "ref.rttm").write_text("".join(
        f"SPEAKER rec 1 {b:.3f} {e - b:.3f} <NA> <NA> {s} <NA> <NA>\n"
        for b, e, s in turns))
    for i, f0 in enumerate((300, 900)):
        n = 2 * SR
        tone = np.sin(2 * np.pi * f0 * np.arange(n) / SR)
        write_wav(root / f"u{i}.wav", (0.3 * tone + rng.normal(
            0, 0.01, n)).astype(np.float32), SR)

    jmodel = JECAPA(channels=C, feat_dim=FEAT, embed_dim=EMB)
    variables = unfreeze(jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, FEAT)), train=False)))
    jckpt.save_checkpoint(str(root / "avg_model.ckpt"), variables)
    with open(root / "config.yaml", "w") as f:
        yaml.safe_dump(CONFIG, f)
    model = ECAPA_TDNN(C, FEAT, EMB)
    model.load_state_dict(from_jax_variables(variables))
    return {"root": root, "wav": wav, "turns": [(b, e) for b, e, _ in turns],
            "jmodel": jmodel, "variables": variables, "model": model.eval()}


@pytest.mark.parametrize("subseg_cmn", [True, False])
def test_diarize_wav_mock_embedder_matches_jax(rec, subseg_cmn):
    seen = {"jax": [], "port": []}

    def jax_embed(banks):
        seen["jax"].append(np.asarray(banks))
        return banks.std(axis=1)

    def port_embed(banks):
        seen["port"].append(banks.numpy())
        return banks.std(dim=1, correction=0)

    kw = dict(sad_segments=rec["turns"], clusterer="spectral", num_spks=2,
              subseg_cmn=subseg_cmn)
    want, want_sub = jpipe.diarize_wav(
        "rec", rec["wav"], SR, jax_embed,
        fbank_cfg=JFbankConfig(num_mel_bins=FEAT), **kw)
    got, got_sub = tpipe.diarize_wav(
        "rec", rec["wav"], SR, port_embed,
        fbank_cfg=FbankConfig(num_mel_bins=FEAT), device="cpu", **kw)
    assert list(got_sub) == list(want_sub) and len(got_sub) == 24
    np.testing.assert_allclose(np.concatenate(seen["port"]),
                               np.concatenate(seen["jax"]), rtol=0,
                               atol=1e-4)
    assert relabelled(got) == relabelled(want)
    hyp = {"rec": [(b, e, lab) for _, b, e, lab in got]}
    ref = {"rec": [(b, e, lab) for _, b, e, lab in want]}
    assert trttm.compute_der(ref, hyp) == 0.0
    truth = {"rec": [(b, e, f"s{i % 2}")
                     for i, (b, e) in enumerate(rec["turns"])]}
    assert trttm.compute_der(truth, hyp) < 0.15


@pytest.mark.parametrize("clusterer,stages", [
    ("spectral", ["affinity", "eigh", "k-means"]),
    ("umap", ["UMAP graph+init", "UMAP layout", "HDBSCAN", "PAHC"])])
def test_diarize_wav_marks_each_stage_once(rec, clusterer, stages):
    """`mark` sees each stage end once, in order, and changes nothing."""
    seen = []
    kw = dict(sad_segments=rec["turns"], clusterer=clusterer,
              fbank_cfg=FbankConfig(num_mel_bins=FEAT), device="cpu")
    embed = lambda banks: banks.std(dim=1, correction=0)  # noqa: E731
    got = tpipe.diarize_wav("rec", rec["wav"], SR, embed, mark=seen.append,
                            **kw)
    assert seen == ["fbank", "embedding"] + stages + ["merge"]
    assert got == tpipe.diarize_wav("rec", rec["wav"], SR, embed, **kw)


def test_diarize_wav_narrow_ecapa_matches_jax(rec):
    seen = {"jax": [], "port": []}
    fwd = jax.jit(lambda f: rec["jmodel"].apply(rec["variables"], f,
                                                train=False))
    embed = tpipe.model_embedder(rec["model"])

    def jax_embed(banks):
        seen["jax"].append(np.asarray(fwd(jnp.asarray(banks))))
        return seen["jax"][-1]

    def port_embed(banks):
        seen["port"].append(embed(banks))
        return seen["port"][-1]

    kw = dict(sad_segments=rec["turns"], batch_size=16)
    want, _ = jpipe.diarize_wav(
        "rec", rec["wav"], SR, jax_embed,
        fbank_cfg=JFbankConfig(num_mel_bins=FEAT), **kw)
    got, _ = tpipe.diarize_wav(
        "rec", rec["wav"], SR, port_embed,
        fbank_cfg=FbankConfig(num_mel_bins=FEAT), device="cpu", **kw)
    assert len(seen["port"]) == len(seen["jax"]) == 2
    want_emb = np.concatenate(seen["jax"])
    np.testing.assert_allclose(torch.cat(seen["port"]).numpy(), want_emb,
                               rtol=1e-4, atol=1e-4 * np.abs(want_emb).max())
    assert relabelled(got) == relabelled(want)
    assert len({lab for *_, lab in got}) == 2


def test_diarize_cli_matches_jax(rec, capsys):
    root = rec["root"]
    common = dict(sad_rttm=str(root / "ref.rttm"),
                  ref_rttm=str(root / "ref.rttm"))
    _, want_der = jdiar_cli.diarize(
        str(root / "config.yaml"), str(root / "avg_model.ckpt"),
        str(root / "wav.scp"), str(root / "jax.rttm"), **common)
    capsys.readouterr()
    _, der = tdiar_cli.main([
        "--config", str(root / "config.yaml"),
        "--checkpoint", str(root / "avg_model.ckpt"),
        "--wav_scp", str(root / "wav.scp"), "--out_rttm",
        str(root / "port.rttm"), "--sad_rttm", common["sad_rttm"],
        "--ref_rttm", common["ref_rttm"], "--device", "cpu"])
    assert capsys.readouterr().out == f"DER = {der * 100:.2f} %\n"
    assert rttm_rows(root / "port.rttm") == rttm_rows(root / "jax.rttm")
    assert der == want_der and der < 0.15


def test_sad_model_path(rec, tmp_path):
    class EnergyVad(torch.nn.Module):
        def reset_states(self):
            pass

        def forward(self, chunk, sr: int):
            rms = torch.sqrt(torch.mean(chunk * chunk) + 1e-12)
            return torch.sigmoid(20.0 * torch.log10(rms) + 20.0).reshape(1)

    path = str(tmp_path / "vad.jit")
    torch.jit.script(EnergyVad()).save(path)
    kw = dict(threshold=0.18, window_samples=512)
    sad = tvad.system_sad(rec["wav"], SR, model_path=path, **kw)
    assert sad == jvad.system_sad(rec["wav"], SR, model_path=path, **kw)
    assert len(sad) >= TURNS  # the AM dips split some turns
    root = rec["root"]
    tdiar_cli.main(["--config", str(root / "config.yaml"), "--checkpoint",
                    str(root / "avg_model.ckpt"), "--wav_scp",
                    str(root / "wav.scp"), "--out_rttm",
                    str(tmp_path / "sad.rttm"), "--sad_model", path,
                    "--device", "cpu"])
    want, _ = tpipe.diarize_wav(
        "rec", rec["wav"], SR, tpipe.model_embedder(rec["model"]),
        sad_segments=sad, fbank_cfg=FbankConfig(num_mel_bins=FEAT),
        device="cpu")
    assert rttm_rows(tmp_path / "sad.rttm") == relabelled(
        [("rec", f"{b:.3f}", f"{e - b:.3f}", lab) for _, b, e, lab in want])


def _post(url, body, ctype):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_server_diarize_matches_in_process(rec):
    root = rec["root"]
    ckpt = str(root / "avg_model.ckpt")
    server = EmbeddingServer(CONFIG, ckpt, port=0, device="cpu").start()
    try:
        reply = _post(f"http://127.0.0.1:{server.port}/diarize",
                      (root / "rec.wav").read_bytes(), "audio/wav")
    finally:
        server.close()
    embed = tpipe.model_embedder(load_model_for_eval(CONFIG, ckpt, "cpu"))
    want, _ = tpipe.diarize_wav("utt", rec["wav"], SR, embed,
                                fbank_cfg=fbank_config(CONFIG),
                                device="cpu")
    assert reply["segments"] == [
        {"begin": round(b, 3), "end": round(e, 3), "speaker": int(lab)}
        for _, b, e, lab in want]
    assert len({s["speaker"] for s in reply["segments"]}) == 2
    bare = EmbeddingServer(CONFIG, "", port=0, device="cpu",
                           embed_fn=lambda w, m: np.zeros((len(w), 4)))
    bare.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"http://127.0.0.1:{bare.port}/diarize",
                  (root / "u0.wav").read_bytes(), "audio/wav")
        assert err.value.code == 501
    finally:
        bare.close()


def test_speaker_matches_jax(rec):
    root = rec["root"]
    port = tspeaker.load_model(str(root), device="cpu")
    want = jspeaker.load_model(str(root))
    for name in ("u0", "u1"):
        e_want = want.extract_embedding(str(root / f"{name}.wav"))
        np.testing.assert_allclose(
            port.extract_embedding(str(root / f"{name}.wav")), e_want,
            rtol=1e-4, atol=1e-4 * np.abs(e_want).max())
    pair = (str(root / "u0.wav"), str(root / "u1.wav"))
    assert port.compute_similarity(*pair) == pytest.approx(
        want.compute_similarity(*pair), abs=1e-4)
    got = port.diarize(str(root / "rec.wav"), "rec")
    assert relabelled(got) == relabelled(want.diarize(str(root / "rec.wav"),
                                                      "rec"))
    assert len({lab for *_, lab in got}) == 2
    port.register("low", pair[0])
    assert port.recognize(pair[0])["name"] == "low"
    with pytest.raises(ValueError, match="already registered"):
        port.register("low", pair[1])
    with pytest.raises(NotImplementedError, match="hub"):
        tspeaker.load_model("english", device="cpu")
