"""The quality smoke (`bin/smoke_quality.py`) and the model it trains:
ECAPA_TDNN at 256 channels, on the CPU.

- The smoke's corpus at 3 speakers is byte-identical to
  scripts/smoke_quality_tpu.py::make_corpus's with its N_SPK set to 3 (the
  script is loaded by path and only read): every wav, both lists, utt2spk
  and the trials.
- One short run of the smoke on the CPU (a narrow ECAPA, C=64, 3
  speakers, one epoch of 2 steps) goes through the trainer, extraction,
  scoring and metrics CLIs and prints its JSON line, with the bucket
  drift of the model it trained.
- `train.composite.build_model` initialises Conv and Linear layers as the
  JAX package's flax modules (lecun_normal weights, zero biases), per
  layer against JAX's own init of the same ECAPA.
- The route of the SE blocks by group width, as in the JAX package: at 256
  channels (width 32) `eval_route` is "layers" and eval never calls the
  block kernel's wrapper nor the Res2 chain's, whatever `fused` and
  `fused_res2` say, while the tail takes its kernel once; at 512 and 1024
  (width 64, 128) it is "kernel". The 256-channel model in eval matches
  JAX's flax ECAPA (whose block kernel does not fit at that width) within
  1e-4 of the largest magnitude, masked.
"""

import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402
from flax.core import unfreeze  # noqa: E402

from wespeaker_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA  # noqa: E402
from wespeaker_tpu.utils.torch_compat import (rules_for,  # noqa: E402
                                              torch_to_flax_variables)
from wespeaker_tpu_torch.bin import smoke_quality  # noqa: E402
from wespeaker_tpu_torch.models import ecapa_tdnn  # noqa: E402

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _read_tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_corpus_is_byte_identical_to_the_jax_script(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "smoke_quality_tpu", REPO / "scripts" / "smoke_quality_tpu.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(script, "N_SPK", 3)
    root = tmp_path / "corpus"
    script.make_corpus(str(root))
    want = _read_tree(root)
    for p in root.rglob("*"):
        if p.is_file():
            p.unlink()
    smoke_quality.make_corpus(str(root), n_spk=3)
    got = _read_tree(root)
    assert sorted(got) == sorted(want)
    assert len(got) == 3 * 10 + 4
    for name in want:
        assert got[name] == want[name], name
    assert b"target" in got["trials"] and b"nontarget" in got["trials"]


def test_short_smoke_run_reaches_its_result_line(tmp_path, capsys):
    smoke_quality.main([str(tmp_path / "work"), "--n_spk", "3", "--epochs",
                        "1", "--device", "cpu", "--bucket_drift",
                        "model_args.channels=64",
                        "dataset_args.batch_size=8",
                        "dataset_args.num_frms=100", "samples_per_epoch=16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"method", "eer_percent", "minDCF", "n_speakers",
                        "train_wall_s", "extract_wall_s",
                        "bucket_drift_min_cos", "bucket_drift_mean_cos",
                        "plda_eer_percent", "asnorm_eer_percent",
                        "qmf_eer_percent", "back_end_wall_s"}
    for key in ("plda", "asnorm", "qmf"):
        assert 0.0 <= out[f"{key}_eer_percent"] <= 100.0
    assert 0.9 < out["bucket_drift_min_cos"] <= out[
        "bucket_drift_mean_cos"] <= 1.0 + 1e-9
    assert out["method"] == "supervised" and out["n_speakers"] == 3
    assert 0.0 <= out["eer_percent"] <= 100.0
    assert os.path.exists(tmp_path / "work" / "exp" / "scores"
                          / "trials.score")


@pytest.mark.parametrize("channels,route", [(256, "layers"),
                                            (512, "kernel"),
                                            (1024, "kernel")])
def test_se_blocks_route_by_group_width(channels, route):
    model = ecapa_tdnn.ECAPA_TDNN(channels, 16, 8)
    assert [b.eval_route for b in (model.layer2, model.layer3,
                                   model.layer4)] == [route] * 3


def test_build_model_initialises_as_jax():
    """The trainers' models start as the JAX package's: each Conv and
    Linear weight, in the port and in JAX's flax init of the same ECAPA,
    at lecun_normal's std 1/sqrt(fan_in), within 4 standard errors of a
    sample std (4 / sqrt(2n) for n elements; torch's default init sits at
    1/sqrt(3 fan_in), 42% below), and zero biases."""
    from wespeaker_tpu_torch.train.composite import build_model
    from wespeaker_tpu_torch.utils.weights import from_jax_variables

    configs = {"model": "ECAPA_TDNN", "model_args": dict(
        channels=64, feat_dim=16, embed_dim=8, global_context_att=True)}
    torch.manual_seed(0)
    model = build_model(configs)
    jmodel = JECAPA(channels=64, feat_dim=16, embed_dim=8,
                    global_context_att=True)
    want = from_jax_variables(jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 16)), train=False)))
    checked = 0
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Linear)):
            rtol = 4 / (2 * m.weight.numel()) ** 0.5
            for w in (m.weight.detach(), want[f"{name}.weight"]):
                np.testing.assert_allclose(w.std().item(),
                                           m.weight[0].numel() ** -0.5,
                                           rtol=rtol, err_msg=name)
            assert not m.bias.detach().any(), name
            checked += 1
    assert checked == 38  # layer1, 3 x 11 in the blocks, MFA, ASTP 2, linear


def _randomised(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model.eval()


def test_ecapa_256_takes_the_layers_and_the_tail_kernel(monkeypatch):
    calls = {"se": 0, "res2": 0, "tail": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name, attr in (("se", "fused_se_res2_block"),
                       ("res2", "fused_res2_chain"),
                       ("tail", "fused_mfa_astp")):
        monkeypatch.setattr(ecapa_tdnn, attr,
                            counting(name, getattr(ecapa_tdnn, attr)))
    torch.manual_seed(3)
    model = _randomised(ecapa_tdnn.ECAPA_TDNN(256, 16, 8,
                                              global_context_att=True), 3)
    jmodel = JECAPA(channels=256, feat_dim=16, embed_dim=8,
                    global_context_att=True, fused_block=True,
                    fused_tail=False)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 16)),
                       train=False)
    variables = unfreeze(torch_to_flax_variables(
        model.state_dict(), init, rules_for("ECAPA_TDNN")))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 24, 16)).astype(np.float32)
    mask = np.ones((2, 24), np.float32)
    mask[1, 17:] = 0
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                   mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        assert calls == {"se": 0, "res2": 0, "tail": 1}
        model.set_fused(False, fused_res2=True)(torch.from_numpy(x))
        assert calls == {"se": 0, "res2": 0, "tail": 1}
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
