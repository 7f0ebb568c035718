"""Port parity for the SSL data path and the SSL trainers on the CPU.

  - ssl/dataset.py's multi_crop and dino_batch give bit-identical arrays
    to the JAX package's for the same np.random.default_rng (with and
    without a per-view aug_fn; utterances shorter than a crop; the partial
    batch dropped);
  - SpeakerDataset with defer_chunk_aug yields the JAX package's stream of
    whole utterances, bit for bit, over two epochs; make_crop_aug is None
    without a store and refuses one;
  - make_ssl_featurize without spec-aug within 1e-4 of the JAX package's
    (of the features' largest magnitude), and with spec-aug the masking
    checks of tests/test_ssl.py::test_ssl_featurize_spec_aug;
  - bin/train_dino.py on a 2-speaker synthetic corpus with device="cpu":
    one epoch, then `resume: true` restores the saved trainer state
    exactly, then a second epoch continues the step count, and
    load_model_for_eval embeds an utterance from model_1.pt;
    bin/train_contrastive.py with moco (queue pointer) and simclr; both
    refuse what is not ported and take the card unless asked for the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both

from wespeaker_tpu.data.dataset import SpeakerDataset as JDataset  # noqa
from wespeaker_tpu.frontend import FbankConfig as JFbankConfig  # noqa: E402
from wespeaker_tpu.ssl import dataset as jssl  # noqa: E402
from wespeaker_tpu.ssl.featurize import \
    make_ssl_featurize as j_featurize  # noqa: E402
from wespeaker_tpu_torch.bin import train_contrastive as tc_cli  # noqa
from wespeaker_tpu_torch.bin import train_dino as dino_cli  # noqa: E402
from wespeaker_tpu_torch.bin.extract import load_model_for_eval  # noqa
from wespeaker_tpu_torch.data.dataset import SpeakerDataset  # noqa: E402
from wespeaker_tpu_torch.data.pipeline import make_crop_aug  # noqa: E402
from wespeaker_tpu_torch.data.wav_io import write_wav  # noqa: E402
from wespeaker_tpu_torch.frontend import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.ssl import dataset as tssl  # noqa: E402
from wespeaker_tpu_torch.ssl.featurize import make_ssl_featurize  # noqa
from wespeaker_tpu_torch.train import make_eval_embed_fn  # noqa: E402
from wespeaker_tpu_torch.utils.config import load_yaml  # noqa: E402

torch.set_num_threads(2)
FEAT, EMB = 24, 32


def _scale_aug(c, rng):
    return (c * rng.uniform(0.5, 1.5)).astype(np.float32)


@pytest.mark.parametrize("aug_fn", [None, _scale_aug])
def test_multi_crop_and_dino_batch_match_jax(aug_fn):
    src = np.random.default_rng(0)
    samples = [{"key": f"u{i}", "wav": src.standard_normal(n).astype(
        np.float32)} for i, n in enumerate((8000, 2500, 6000, 9000, 4000))]
    out = {}
    for name, mod in (("jax", jssl), ("port", tssl)):
        crops = mod.multi_crop(iter([dict(s) for s in samples]), 3200, 1600,
                               n_global=2, n_local=3, aug_fn=aug_fn,
                               rng=np.random.default_rng(7))
        out[name] = list(mod.dino_batch(crops, batch_size=2))
    assert len(out["port"]) == len(out["jax"]) == 2  # the fifth is dropped
    for g, w in zip(out["port"], out["jax"]):
        assert g["key"] == w["key"]
        assert g["global_wav"].shape == (4, 3200)
        assert g["local_wav"].shape == (6, 1600)
        for k in ("global_wav", "local_wav"):
            assert g[k].dtype == w[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k])


def _corpus(root, n_spk=2, n_utt=4, seconds=(1.2, 2.0), seed=0):
    """PCM16 wavs of noise, a jsonl raw list and utt2spk."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    lines, u2s = [], []
    for s in range(n_spk):
        for u in range(n_utt):
            key = f"spk{s}-utt{u}"
            n = int(rng.uniform(*seconds) * 16000)
            path = os.path.join(root, f"{key}.wav")
            write_wav(path, (rng.uniform(-0.3, 0.3, n) * (1 + s)).astype(
                np.float32), 16000)
            lines.append(json.dumps({"key": key, "wav": path,
                                     "spk": f"spk{s}"}))
            u2s.append(f"{key} spk{s}")
    raw = os.path.join(root, "raw.list")
    with open(raw, "w") as f:
        f.write("\n".join(lines) + "\n")
    utt2spk = os.path.join(root, "utt2spk")
    with open(utt2spk, "w") as f:
        f.write("\n".join(u2s) + "\n")
    return raw, utt2spk


def test_deferred_dataset_matches_jax(tmp_path):
    raw, _ = _corpus(str(tmp_path))
    spk2id = {"spk0": 0, "spk1": 1}
    conf = {"defer_chunk_aug": True, "speed_perturb": False,
            "filter_args": {"min_num_frames": 50, "max_num_frames": 150},
            "shuffle_args": {"shuffle_size": 3}}
    want = JDataset("raw", raw, conf, spk2id, seed=5)
    got = SpeakerDataset("raw", raw, conf, spk2id, seed=5)
    for epoch in range(2):
        ws, gs = list(want._epoch_iter(epoch)), list(got._epoch_iter(epoch))
        assert [s["key"] for s in gs] == [s["key"] for s in ws]
        assert len(gs) == 8
        lengths = {len(s["wav"]) for s in gs}
        assert len(lengths) > 1 and max(lengths) <= 150 * 160  # not chunked
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g["wav"], w["wav"])
            assert g["label"] == w["label"]
    assert make_crop_aug(None, None, 1.0) is None
    # a store makes a per-view augmentation (tests/test_torch_data_aug.py
    # holds it to the JAX package's); aug_prob 0 makes none
    assert callable(make_crop_aug("rirs", None, 0.6))
    assert make_crop_aug("rirs", None, 0.0) is None


def test_ssl_featurize_matches_jax():
    w = np.random.default_rng(0).uniform(-0.5, 0.5, (3, 16000)).astype(
        np.float32)
    want = np.asarray(j_featurize(JFbankConfig(num_mel_bins=40, dither=0.0),
                                  {"spec_aug": False}, 0)(w))
    got = make_ssl_featurize(FbankConfig(num_mel_bins=40, dither=0.0),
                             {"spec_aug": False}, 0, device="cpu")(w)
    assert got.shape == want.shape == (3, 98, 40)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-4, err


def test_ssl_featurize_spec_aug():
    w = np.random.default_rng(0).uniform(-0.5, 0.5, (2, 16000)).astype(
        np.float32)
    cfg = FbankConfig(num_mel_bins=40, dither=0.0)
    plain = make_ssl_featurize(cfg, {"spec_aug": False}, 0, device="cpu")
    auged = make_ssl_featurize(
        cfg, {"spec_aug": True,
              "spec_aug_args": {"prob": 1.0, "num_t_mask": 2,
                                "num_f_mask": 2, "max_t": 10, "max_f": 8}},
        0, device="cpu")
    base = plain(w).numpy()
    a1, a2 = auged(w).numpy(), auged(w).numpy()
    assert base.shape == a1.shape
    assert (a1 == 0).sum() > 0  # masks applied (prob=1)
    assert not np.array_equal(a1, a2)  # the generator advances per call
    kept = a1 != 0
    np.testing.assert_array_equal(a1[kept], base[kept])


def _write_config(tmp_path, raw, utt2spk, **extra):
    cfg = {
        "exp_dir": str(tmp_path / "exp"), "train_data": raw,
        "utt2spk": utt2spk, "data_type": "raw", "num_epochs": 2, "seed": 3,
        "log_batch_interval": 1, "model": "ECAPA_TDNN",
        "model_args": {"channels": 32, "feat_dim": FEAT, "embed_dim": EMB,
                       "global_context_att": True},
        "dataset_args": {"batch_size": 2, "aug_prob": 1.0,
                         "fbank_args": {"num_mel_bins": FEAT, "dither": 1.0},
                         "filter_args": {"min_num_frames": 50},
                         "shuffle_args": {"shuffle_size": 4},
                         "spec_aug": False},
        **extra}
    path = tmp_path / "conf.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


DINO_ARGS = {"head_out_dim": 64, "head_hidden_dim": 48, "bottleneck_dim": 16,
             "head_use_bn": True, "global_chunk_num": 2, "local_chunk_num": 2,
             "global_chunk_sec": 1.0, "local_chunk_sec": 0.5,
             "warmup_epochs": 0, "freeze_last_layer_epochs": 1}


def _same_state(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same_state(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_state(g, w, f"{where}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got.cpu(), want.cpu()), where
    else:
        assert got == want, where


def test_train_dino_resumes_where_it_stopped(tmp_path):
    raw, utt2spk = _corpus(str(tmp_path / "data"))
    conf = _write_config(tmp_path, raw, utt2spk, dino_args=DINO_ARGS)
    first = dino_cli.train_dino(conf, ["stop_epoch=1"], device="cpu")
    assert first.step == 4  # 8 utterances, batch 2
    models = tmp_path / "exp" / "models"
    assert (models / "model_0.pt").exists()
    assert (models / "trainer_state.pt").exists()
    assert not (models / "model_1.pt").exists()
    saved = first.state_dict()

    # resumed at epoch 1 with stop_epoch 1: the restored state, untrained
    restored = dino_cli.train_dino(conf, ["resume=true", "stop_epoch=1"],
                                   device="cpu")
    _same_state(restored.state_dict(), saved)

    second = dino_cli.train_dino(conf, ["resume=true"], device="cpu")
    assert second.step == 8
    assert not torch.equal(second.center, saved["center"])
    log = (tmp_path / "exp" / "train.log").read_text()
    assert "resumed trainer state at epoch 1 (step 4)" in log
    assert "epoch 1 it 7 loss" in log

    configs = load_yaml(str(tmp_path / "exp" / "config.yaml"))
    model = load_model_for_eval(configs, str(models / "model_1.pt"),
                                device="cpu")
    for key, value in model.state_dict().items():
        assert torch.equal(value, second.teacher.backbone.state_dict()[key])
    emb = make_eval_embed_fn(model, FbankConfig(num_mel_bins=FEAT),
                             device="cpu")({"wav": np.random.default_rng(
                                 1).uniform(-0.3, 0.3, (1, 16000)).astype(
                                 np.float32)})
    assert emb.shape == (1, EMB) and torch.isfinite(emb).all()


@pytest.mark.parametrize("method", ["moco", "simclr"])
def test_train_contrastive(tmp_path, method):
    raw, utt2spk = _corpus(str(tmp_path / "data"))
    conf = _write_config(tmp_path, raw, utt2spk, num_epochs=1,
                         ssl_method=method,
                         ssl_args={"queue_size": 6, "chunk_sec": 0.8})
    step = tc_cli.train_contrastive(conf, device="cpu")
    assert step.step == 4
    if method == "moco":
        assert step.queue.shape == (6, EMB) and step.queue_ptr == 8 % 6
        norms = step.queue.norm(dim=1)
        torch.testing.assert_close(norms, torch.ones(6))
    models = tmp_path / "exp" / "models"
    configs = load_yaml(str(tmp_path / "exp" / "config.yaml"))
    model = load_model_for_eval(configs, str(models / "model_0.pt"),
                                device="cpu")
    for key, value in model.state_dict().items():
        assert torch.equal(value, step.encoder.state_dict()[key]), key
    with pytest.raises(ValueError, match="multiple"):
        tc_cli.train_contrastive(conf, ["ssl_method=moco",
                                        "ssl_args={queue_size: 5}"],
                                 device="cpu")


def test_ssl_trainers_refuse_what_is_not_ported(tmp_path, monkeypatch):
    raw, utt2spk = _corpus(str(tmp_path / "data"), n_utt=1)
    conf = _write_config(tmp_path, raw, utt2spk, dino_args=DINO_ARGS)
    for fn in (dino_cli.train_dino, tc_cli.train_contrastive):
        with pytest.raises(NotImplementedError, match="not ported"):
            fn(conf, ["dataloader_args={num_workers: 2}"], device="cpu")
        # distributed_args is ported (tests/test_torch_parallel_ssl.py);
        # without the rendezvous address it raises before any rank waits
        with pytest.raises(ValueError, match="coordinator"):
            fn(conf, ["distributed_args={num_processes: 2, process_id: 0}"],
               device="cpu")
    with pytest.raises(ValueError, match="ssl_method"):
        tc_cli.train_contrastive(conf, ["ssl_method=byol"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (dino_cli.main, tc_cli.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--config", conf])
