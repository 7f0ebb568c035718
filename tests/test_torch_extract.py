"""Port parity for extraction over a corpus, against the JAX package on
the CPU.

- kaldi_io: vector and matrix arks written by the port are byte-identical
  to the JAX package's (and their scp lines equal); each package reads the
  other's files back exactly, by scp and by streaming the ark.
- Eval buckets: `eval_batches` and `eval_feat_batches` give JAX's batches
  bit for bit (keys in order, arrays, masks) on the linear grid and the
  pow2 ladder, with `max_samples` / `max_frames` capping the valid part,
  and with a `sort_window` smaller than the list.
- The feature input of `make_eval_embed_fn` (from_wav=False): a narrow
  ECAPA (C=64, feat 16, embed 8, global context) on masked (B, T, F)
  features against JAX's, within 1e-5 of the largest magnitude.
- The extraction CLI: `bin.extract.extract(..., device="cpu")` against
  JAX's `extract` on the same weights (the port's `.pt`; for JAX, carried
  over with torch_compat.torch_to_flax_variables and saved with its
  msgpack save_checkpoint), embeddings compared by key within 1e-4 of the
  largest magnitude (both write in bucket order), in wav and feat modes,
  linear and pow2 buckets, and each stripe of num_splits=2.
- A `featurize_fn` (a non-fbank frontend's hook) replaces the fbank and
  CMVN. Refusals: `data_parallel` over more than one card, an
  unknown `precision`; `precision="float32"` turns TF32 off inside the
  call only.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402
from flax.core import unfreeze  # noqa: E402

from wespeaker_tpu.bin import extract as j_extract  # noqa: E402
from wespeaker_tpu.data import dataset as jdata  # noqa: E402
from wespeaker_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA  # noqa: E402
from wespeaker_tpu.train import make_eval_embed_fn as j_embed_fn  # noqa: E402
from wespeaker_tpu.utils import checkpoint as jckpt  # noqa: E402
from wespeaker_tpu.utils import kaldi_io as jk  # noqa: E402
from wespeaker_tpu.utils.torch_compat import (rules_for,  # noqa: E402
                                              torch_to_flax_variables)
from wespeaker_tpu_torch.bin import extract as t_extract  # noqa: E402
from wespeaker_tpu_torch.data import dataset as tdata  # noqa: E402
from wespeaker_tpu_torch.data.wav_io import write_wav  # noqa: E402
from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN  # noqa: E402
from wespeaker_tpu_torch.train import make_eval_embed_fn  # noqa: E402
from wespeaker_tpu_torch.utils import eval_device  # noqa: E402
from wespeaker_tpu_torch.utils import kaldi_io as tk  # noqa: E402

torch.set_num_threads(2)
C, FEAT, EMB = 64, 16, 8


def _items(seed, n, dims=()):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 60, n)
    return [(f"utt{i}", rng.normal(size=(int(n_),) + dims).astype(np.float32))
            for i, n_ in enumerate(lens)]


def test_kaldi_arks_are_byte_identical_and_read_both_ways(tmp_path):
    vecs = _items(0, 5)
    mats = _items(1, 4, dims=(7,))
    for name, items, writer in (("vec", vecs, "write_vec_ark_scp"),
                                ("mat", mats, "write_mat_ark_scp")):
        tp, jp = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
        getattr(tk, writer)(tp, iter(items))
        getattr(jk, writer)(jp, iter(items))
        with open(tp + ".ark", "rb") as a, open(jp + ".ark", "rb") as b:
            assert a.read() == b.read()
        for scp, reader in ((tp + ".scp", jk), (jp + ".scp", tk)):
            got = reader.read_vec_scp_dict(scp)
            assert list(got) == [k for k, _ in items]
            for k, v in items:
                assert np.array_equal(got[k], v)
        streamed = list(tk.read_vec_ark(jp + ".ark"))
        assert [k for k, _ in streamed] == [k for k, _ in items]
        assert all(np.array_equal(a, v) for (_, a), (_, v) in
                   zip(streamed, items))
    # f64 payloads read as f64 ('DV'/'DM')
    with open(tmp_path / "d.ark", "wb") as f:
        f.write(b"k \x00BDV \x04" + np.int32(3).tobytes()
                + np.arange(3.0).tobytes())
    (tmp_path / "d.scp").write_text(f"k {tmp_path / 'd.ark'}:2\n")
    got = tk.read_vec_scp_dict(str(tmp_path / "d.scp"))["k"]
    assert got.dtype == np.float64 and np.array_equal(got, np.arange(3.0))


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["key"] == w["key"]
        for k in g:
            if k != "key":
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k],
                                                                   w[k]), k


@pytest.mark.parametrize("pow2,cap,window", [
    (False, None, 4096), (True, None, 4096), (False, 45, 4096),
    (True, 45, 4), (False, None, None), (True, 33, 3)])
def test_eval_buckets_are_bit_identical_to_jax(pow2, cap, window):
    wavs = _items(2, 11)
    kw = dict(batch_size=3, sort_window=window, pow2_buckets=pow2)
    _same_batches(tdata.eval_batches(iter(wavs), quantum_samples=16,
                                     max_samples=cap, **kw),
                  jdata.eval_batches(iter(wavs), quantum_samples=16,
                                     max_samples=cap, **kw))
    feats = _items(3, 10, dims=(5,))
    _same_batches(tdata.eval_feat_batches(iter(feats), quantum_frames=16,
                                          max_frames=cap, **kw),
                  jdata.eval_feat_batches(iter(feats), quantum_frames=16,
                                          max_frames=cap, **kw))


def _port_model(seed=0):
    """A narrow ECAPA with global context, its BN statistics and affines
    randomised from the seed."""
    torch.manual_seed(seed)
    model = ECAPA_TDNN(C, FEAT, EMB, global_context_att=True)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    return model.eval()


def _jax_variables(model, jmodel):
    init = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, FEAT)),
                       train=False)
    return unfreeze(jax.device_get(torch_to_flax_variables(
        model.state_dict(), init, rules_for("ECAPA_TDNN"))))


def _close(got, want, tol):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def test_feature_input_matches_jax():
    model = _port_model(1)
    jmodel = JECAPA(channels=C, feat_dim=FEAT, embed_dim=EMB,
                    global_context_att=True, fused_block=False,
                    fused_tail=False)
    variables = _jax_variables(model, jmodel)
    rng = np.random.default_rng(4)
    feat = rng.normal(size=(3, 37, FEAT)).astype(np.float32) + 2.0
    mask = np.ones((3, 37), np.float32)
    mask[1, 25:] = 0
    mask[2, 11:] = 0
    want = np.asarray(jax.jit(j_embed_fn(jmodel, from_wav=False))(
        variables, {"feat": jnp.asarray(feat), "mask": jnp.asarray(mask)}))
    got = make_eval_embed_fn(model, device="cpu", from_wav=False)(
        {"feat": feat, "mask": mask}).numpy()
    assert got.shape == (3, EMB)
    _close(got, want, 1e-5)
    # a frontend hook (train/composite.py::featurizers) takes the place of
    # the fbank and CMVN: handed the CMVN'd features, it gives the same
    from wespeaker_tpu_torch.frontend import apply_cmvn
    normed = apply_cmvn(torch.from_numpy(feat),
                        mask=torch.from_numpy(mask)).numpy()
    hooked = make_eval_embed_fn(model, device="cpu",
                                featurize_fn=lambda wav, m: (wav, m))(
        {"wav": normed, "mask": mask}).numpy()
    np.testing.assert_array_equal(hooked, got)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """5 wavs of 0.4-1.9 s, a jsonl list, their fbank-shaped feature
    matrices in a kaldi ark with an scp list, a port `.pt` and a JAX
    msgpack of the same weights, and both configs."""
    root = tmp_path_factory.mktemp("extract")
    rng = np.random.default_rng(5)
    lines, feats = [], []
    for i, sec in enumerate((1.3, 0.4, 1.9, 0.8, 1.1)):
        n = int(sec * 16000)
        tone = np.sin(2 * np.pi * (140 + 60 * i) / 16000 * np.arange(n))
        wav = (0.3 * tone + rng.uniform(-0.05, 0.05, n)).astype(np.float32)
        path = root / f"u{i}.wav"
        write_wav(path, wav, 16000)
        lines.append(json.dumps({"key": f"u{i}", "wav": str(path)}))
        feats.append((f"u{i}", rng.normal(
            size=(int(sec * 100), FEAT)).astype(np.float32)))
    (root / "wav.list").write_text("\n".join(lines) + "\n")
    tk.write_mat_ark_scp(str(root / "feats"), feats)
    model = _port_model(2)
    torch.save(model.state_dict(), root / "model.pt")
    jmodel = JECAPA(channels=C, feat_dim=FEAT, embed_dim=EMB,
                    global_context_att=True)
    jckpt.save_checkpoint(str(root / "model.ckpt"),
                          _jax_variables(model, jmodel))
    base = ("model: ECAPA_TDNN\nmodel_args:\n  channels: 64\n  feat_dim: 16\n"
            "  embed_dim: 8\n  global_context_att: true\n"
            "dataset_args:\n  fbank_args:\n    num_mel_bins: 16\n")
    (root / "wav.yaml").write_text(base)
    (root / "feat.yaml").write_text(base + "data_type: feat\n")
    return root


@pytest.mark.parametrize("mode,pow2,splits", [
    ("wav", False, 1), ("wav", True, 2), ("feat", False, 2),
    ("feat", True, 1)])
def test_extract_cli_matches_jax(corpus, mode, pow2, splits):
    data = corpus / ("wav.list" if mode == "wav" else "feats.scp")
    for idx in range(splits):
        out = {}
        for name, cli, ckpt in (("port", t_extract, "model.pt"),
                                ("jax", j_extract, "model.ckpt")):
            kw = {"device": "cpu"} if name == "port" else {}
            scp = cli.extract(str(corpus / f"{mode}.yaml"), str(corpus / ckpt),
                              str(data), str(corpus / f"{name}_{mode}_{idx}"),
                              batch_size=3, num_splits=splits,
                              split_index=idx, pow2_buckets=pow2,
                              read_threads=2, **kw)
            out[name] = list(tk.read_vec_scp(scp))
        assert [k for k, _ in out["port"]] == [k for k, _ in out["jax"]]
        want = dict(out["jax"])
        assert set(want) == {f"u{i}" for i in range(idx, 5, splits)}
        got = np.stack([v for _, v in out["port"]])
        _close(got, np.stack([want[k] for k, _ in out["port"]]), 1e-4)


def test_extract_refusals_and_precision(corpus, monkeypatch):
    seen = []
    real = t_extract._extract_inner

    def spy(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real(*args)

    monkeypatch.setattr(t_extract, "_extract_inner", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    t_extract.extract(str(corpus / "wav.yaml"), str(corpus / "model.pt"),
                      str(corpus / "wav.list"), str(corpus / "prec"),
                      precision="float32", device="cpu")
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError, match="precision"):
        t_extract.extract(str(corpus / "wav.yaml"), str(corpus / "model.pt"),
                          str(corpus / "wav.list"), str(corpus / "prec"),
                          precision="fast", device="cpu")

    model = torch.nn.Linear(2, 2)
    got, dtype = eval_device.prepare_eval_placement(
        model, bf16=True, device="cpu")
    assert got is model and dtype == torch.bfloat16
    assert model.weight.dtype == torch.float32  # cast per call, not here
    # data_parallel takes every visible card, one replica each, and rounds
    # the batch up to a multiple of them (JAX's eval_device.py); without
    # it, or on the CPU, one replica
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert eval_device.replica_devices(True, "cuda") == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    assert eval_device.replica_devices(False, "cuda") == [
        torch.device("cuda")]
    assert eval_device.replica_devices(True, "cpu") == [torch.device("cpu")]
    assert [eval_device.round_batch(b, 2) for b in (5, 6)] == [6, 6]
