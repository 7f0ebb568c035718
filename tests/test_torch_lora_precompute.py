"""The port's LoRA utilities (wespeaker_tpu_torch/utils/lora.py) and
precompute_feats CLI (bin/precompute_feats.py) against the JAX package's.

- LoRA over the tiny Whisper encoder's and w2v-bert's named parameters:
  the same weights chosen as the JAX package's target pattern chooses on
  the flax tree (its `/kernel` paths under the port's name rules, so
  w2v-bert's linear_out but not linear_q), b = 0 (apply is the identity),
  a ~ N(0, 1/r) from the generator, and `merge_lora` equal to the JAX
  package's merge of the same adapters, transposed to (out, in), within
  1e-6; `apply_lora` in torch.func.functional_call carries the gradient
  to the adapters; the train mask.
- precompute_feats: the torchjit backend on the CPU (`--device cpu`)
  writes the same matrices as the JAX package's for --layer last, avg,
  1 and all; --layer all feeds `frontend: feat_stack` through
  bin/train.py (data_type feat, two steps; the layer weights leave zero)
  and bin/extract.py; the StackedFeatFrontend against the JAX one; the hf
  backend raises naming transformers when it is absent, s3prl is gated,
  an unknown backend refused.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from wespeaker_tpu.utils import lora as jlora  # noqa: E402
from wespeaker_tpu_torch.utils import lora  # noqa: E402
from wespeaker_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(2)
SR = 16000


def _whisper():
    from wespeaker_tpu_torch.frontend.whisper_encoder import (
        WhisperEncoderFrontend)
    torch.manual_seed(0)
    return WhisperEncoderFrontend(n_mels=16, num_blocks=2, output_size=32,
                                  n_head=4, layer_st=0, layer_ed=1,
                                  n_ctx=64), "WhisperEncoder"


def _w2vbert():
    from wespeaker_tpu_torch.frontend.w2vbert import (W2VBertConfig,
                                                      W2VBertFrontend)
    torch.manual_seed(0)
    return W2VBertFrontend(W2VBertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64)), "Wav2Vec2Bert"


@pytest.mark.parametrize("make", [_whisper, _w2vbert],
                         ids=["whisper", "w2vbert"])
def test_lora_targets_and_merge_match_jax(make):
    model, family = make()
    sd = model.state_dict()
    adapters, scaling = lora.init_lora_params(
        model, rank=4, alpha=8.0, generator=torch.Generator().manual_seed(1))
    assert scaling == 2.0
    params = weights.to_jax_variables(sd, family)["params"]
    j_adapters, j_scaling = jlora.init_lora_params(params, rank=4, alpha=8.0)
    assert j_scaling == scaling
    rules = weights.rules_for(family)
    named = {weights._torch_key(tuple(p[:-1]), p[-1], rules)
             for p in j_adapters}
    assert sorted(named) == sorted(adapters)
    assert any(k.endswith(("linear_out.weight", "attn.out.weight"))
               for k in adapters)
    assert not any("linear_q" in k for k in adapters)
    # b = 0: applying is the identity
    for name, w in lora.apply_lora(model, adapters, scaling).items():
        assert torch.equal(w, dict(model.named_parameters())[name])
    gen = torch.Generator().manual_seed(2)
    for ab in adapters.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=gen)
    merged = lora.merge_lora(sd, adapters, scaling)
    j_ad = {}
    for path in j_adapters:
        key = weights._torch_key(tuple(path[:-1]), path[-1], rules)
        j_ad[path] = {k: v.numpy() for k, v in adapters[key].items()}
    j_merged = flatten_dict(jlora.merge_lora(params, j_ad, scaling))
    for path, kernel in j_merged.items():
        key = weights._torch_key(tuple(path[:-1]), path[-1], rules)
        want = np.asarray(kernel)
        if path[-1] == "kernel" and want.ndim == 2:
            want = want.T
        if key in adapters:
            np.testing.assert_allclose(merged[key].numpy(), want, rtol=0,
                                       atol=1e-6)
            assert not torch.allclose(merged[key], sd[key])
    mask = lora.lora_train_mask(model, adapters)
    assert set(mask["base"].values()) == {False}
    assert all(m == {"a": True, "b": True} for m in mask["lora"].values())


def test_lora_init_and_gradients():
    model, _ = _whisper()
    adapters, scaling = lora.init_lora_params(
        model, rank=8, generator=torch.Generator().manual_seed(3))
    a = torch.cat([ab["a"].flatten() for ab in adapters.values()])
    assert abs(a.std().item() - 8 ** -0.5) < 0.05 * 8 ** -0.5
    assert all(not ab["b"].any() for ab in adapters.values())
    for ab in adapters.values():
        ab["a"].requires_grad_()
        ab["b"].requires_grad_()
    x = torch.randn(2, 30, 16, generator=torch.Generator().manual_seed(4))
    out = torch.func.functional_call(
        model, lora.apply_lora(model, adapters, scaling), (x,))
    out.square().sum().backward()
    # b starts at 0, so only b's gradient is non-zero at the first step
    assert all(ab["b"].grad.abs().sum() > 0 for ab in adapters.values())


class MultiLayerFrontend(torch.nn.Module):
    """wav (1, N) -> a list of 3 hidden states (1, T, 4): frame energies
    at three per-layer scalings (tests/test_precompute_feats.py's)."""

    def forward(self, x):
        n = x.shape[1] // 160
        f = x[:, :n * 160].reshape(1, n, 160)
        base = torch.stack([f.mean(-1), f.abs().mean(-1),
                            (f * f).mean(-1), f.max(-1).values], dim=-1)
        return [base, base * 2.0, base - 1.0]


@pytest.fixture
def corpus(tmp_path):
    from wespeaker_tpu_torch.data.wav_io import write_wav

    rng = np.random.default_rng(0)
    with open(tmp_path / "raw.list", "w") as f:
        for i in range(4):
            path = str(tmp_path / f"u{i}.wav")
            write_wav(path, (0.3 * rng.standard_normal(SR + i * 800)).astype(
                np.float32), SR)
            f.write(json.dumps({"key": f"u{i}", "wav": path,
                                "spk": f"s{i % 2}"}) + "\n")
    with open(tmp_path / "utt2spk", "w") as f:
        f.write("".join(f"u{i} s{i % 2}\n" for i in range(4)))
    module = str(tmp_path / "frontend.pt")
    torch.jit.script(MultiLayerFrontend()).save(module)
    return str(tmp_path / "raw.list"), str(tmp_path / "utt2spk"), module


def test_precompute_matches_jax_and_feeds_feat_stack(corpus, tmp_path):
    from wespeaker_tpu.bin.precompute_feats import precompute as jprecompute
    from wespeaker_tpu_torch.bin import extract, precompute_feats
    from wespeaker_tpu_torch.bin import train as train_cli
    from wespeaker_tpu_torch.utils.kaldi_io import (read_vec_scp_dict,
                                                    read_vec_scp)

    raw, utt2spk, module = corpus
    for layer in ("last", "avg", "1", "all"):
        prefix = str(tmp_path / f"feats_{layer}")
        precompute_feats.main(["--data_list", raw, "--out_prefix", prefix,
                               "--backend", "torchjit", "--model_path",
                               module, "--layer", layer, "--device", "cpu"])
        jprecompute(raw, str(tmp_path / f"jax_{layer}"), "torchjit", module,
                    layer=layer)
        got = dict(read_vec_scp(prefix + ".scp"))
        want = dict(read_vec_scp(str(tmp_path / f"jax_{layer}.scp")))
        assert sorted(got) == sorted(want) == [f"u{i}" for i in range(4)]
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    assert got["u0"].shape == (100, 12)  # --layer all: (T, 3 x 4)

    config = {
        "exp_dir": str(tmp_path / "exp"), "data_type": "feat",
        "train_data": str(tmp_path / "feats_all.scp"), "utt2spk": utt2spk,
        "num_epochs": 1, "samples_per_epoch": 8, "log_batch_interval": 1,
        "model": "ECAPA_TDNN",
        "model_args": {"feat_dim": 4, "embed_dim": 16, "channels": 16},
        "projection_args": {"project_type": "arc_margin", "scale": 32.0},
        "dataset_args": {"batch_size": 4, "num_frms": 40, "shuffle": False,
                         "frontend": "feat_stack",
                         "feat_stack_args": {"num_layers": 3},
                         "filter_args": {"min_num_frames": 10,
                                         "max_num_frames": 1000}}}
    cfg = str(tmp_path / "train.yaml")
    with open(cfg, "w") as f:
        json.dump(config, f)
    step = train_cli.train(cfg, device="cpu")
    assert step.step == 2
    mix = step.model.frontend.featurizer.weights
    assert mix.shape == (3,) and mix.abs().max() > 0
    scp = extract.extract(str(tmp_path / "exp" / "config.yaml"),
                          str(tmp_path / "exp" / "models" / "model_0.pt"),
                          str(tmp_path / "feats_all.scp"),
                          str(tmp_path / "emb"), batch_size=4, device="cpu")
    embs = read_vec_scp_dict(scp)
    assert sorted(embs) == [f"u{i}" for i in range(4)]
    assert all(v.shape == (16,) and np.isfinite(v).all()
               for v in embs.values())


def test_stacked_feat_frontend_matches_jax():
    from wespeaker_tpu.frontend.ssl_frontends import (
        StackedFeatFrontend as JStacked)
    from wespeaker_tpu_torch.frontend.ssl_frontends import (
        StackedFeatFrontend)

    x = np.random.default_rng(5).standard_normal((2, 7, 12)).astype(
        np.float32)
    w = np.array([0.3, -0.2, 0.5], np.float32)
    want = JStacked(num_layers=3).apply(
        {"params": {"featurizer": {"weights": jnp.asarray(w)}}},
        jnp.asarray(x))
    port = StackedFeatFrontend(3)
    port.load_state_dict(weights.from_jax_variables(
        {"params": {"featurizer": {"weights": w}}}, "StackedFeat"))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="num_layers"):
        port(torch.zeros(1, 2, 13))


def test_backends_refused_or_gated(monkeypatch, tmp_path):
    from wespeaker_tpu_torch.bin import precompute_feats

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        precompute_feats.make_frontend_fn("hf", str(tmp_path), device="cpu")
    with pytest.raises(SystemExit, match="s3prl"):
        precompute_feats.make_frontend_fn("s3prl", "wavlm", device="cpu")
    with pytest.raises(SystemExit):
        precompute_feats.make_frontend_fn("nope", "x", device="cpu")

    class Out:
        hidden_states = [torch.ones(1, 5, 3) * i for i in range(4)]

    assert precompute_feats._to_tf(Out(), "avg").mean() == 1.5
    assert precompute_feats._to_tf(Out(), "all").shape == (5, 12)
    assert os.path.basename(precompute_feats.__file__) == \
        "precompute_feats.py"
