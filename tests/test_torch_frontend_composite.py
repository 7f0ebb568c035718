"""The neural frontends' composites (wespeaker_tpu_torch/train/composite.py,
models/with_frontend.py) built from the recipe YAMLs, against the JAX
package's build_model.

- Every `dataset_args.frontend` name the JAX package's build_model takes
  builds in the port; an unknown one raises KeyError in both, and the
  config errors they share (s3prl frame_shift other than 20, unknown
  `<frontend>_args` or `feat_stack_args` keys, a W2VBertConfig field that
  does not exist) raise the same exception type in both.
- The seven recipe YAMLs (voxceleb v2 ecapa_wavlm_joint_ft,
  ecapa_wavlm_joint_lmft, w2vbert_s1, w2vbert_s2_ft, w2vbert_s3_lmft;
  voxceleb v1 Whisper-PMFA stage 1 and 2) build unchanged at full width
  on the meta device, with the JAX package's composite name and frozen
  flags; one YAML of each family, its depth cut to 2 layers, has every
  parameter and BN statistic of the shape jax.eval_shape gives the JAX
  build, under the port's name rules.
- The tiny copies of the YAMLs (TINY) embed as the JAX package's in
  test_torch_frontend_recipes.py.
- The refusals: bin/diarize.py, Speaker and the server's /diarize (501)
  refuse a neural frontend; Wav2Vec2Frontend raises, naming the native
  wav2vec2 mode; feat data for a wav frontend and wavs for feat_stack.
- A training step after an extraction in the same process (cached
  position tensors made outside inference mode), and bin/extract.py
  splitting a bucket into row groups.
"""

import copy
import json
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_zoo_util import port_shapes, torch_shapes  # noqa: E402
from wespeaker_tpu.train.composite import build_model as j_build  # noqa
from wespeaker_tpu_torch.train import make_eval_embed_fn  # noqa: E402
from wespeaker_tpu_torch.train.composite import (build_model,  # noqa: E402
                                                 featurizers)
from wespeaker_tpu_torch.utils.config import (  # noqa: E402
    dump_yaml, parse_config_or_kwargs)
from wespeaker_tpu_torch.utils.weights import rules_name  # noqa: E402

torch.set_num_threads(2)
EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
V2 = EXAMPLES / "voxceleb" / "v2" / "conf"
V1 = EXAMPLES / "voxceleb" / "v1" / "Whisper-PMFA" / "conf"
YAMLS = [V2 / f"{n}.yaml" for n in (
    "ecapa_wavlm_joint_ft", "ecapa_wavlm_joint_lmft", "w2vbert_s1",
    "w2vbert_s2_ft", "w2vbert_s3_lmft")] + [
    V1 / f"whisper_pmfa_stage{i}.yaml" for i in (1, 2)]
NAMES = {"wavlm": "WavLM+ECAPA_TDNN",
         "whisper_encoder": "WhisperEncoder+whisper_PMFA",
         "w2vbert": "Wav2Vec2Bert+W2VBert_Adapter_MFA"}
TINY = {"wavlm": dict(hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64,
                      conv_dim=[16] * 7, num_conv_pos_embeddings=16,
                      num_conv_pos_embedding_groups=4, num_buckets=40,
                      max_bucket_distance=100),
        "whisper_encoder": dict(n_mels=16, num_blocks=2, output_size=32,
                                n_head=4, layer_st=0, layer_ed=1,
                                n_ctx=128),
        "w2vbert": dict(hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=64)}
N, N_SHORT = 16000, 11200


def _frontend(configs):
    return configs["dataset_args"]["frontend"]


def _tiny(configs):
    """The YAML's config with its frontend cut to TINY; an adapter-MFA
    head reads the 3 hidden states there are (n_mfa_layers 2 where the
    YAML takes 8)."""
    c = copy.deepcopy(configs)
    name = _frontend(c)
    c["dataset_args"][f"{name}_args"].update(TINY[name])
    if name == "w2vbert":
        args = c["model_args"]
        args["num_frontend_hidden_layers"] = 2
        if args.get("n_mfa_layers", -1) != -1:
            args["n_mfa_layers"] = 2
    return c


def _rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _wavs(seed):
    rng = np.random.default_rng(seed)
    wav = rng.uniform(-0.5, 0.5, (2, N)).astype(np.float32)
    wav[1, N_SHORT:] = 0.0
    mask = np.ones((2, N), np.float32)
    mask[1, N_SHORT:] = 0.0
    return wav, mask


@pytest.mark.parametrize("name", [
    "fbank", "tfmel", "whisper_encoder", "wavlm", "s3prl", "hubert",
    "wav2vec2", "feat_stack", "w2vbert", "bogus"])
def test_every_jax_frontend_name_builds(name):
    head = {"model": "ECAPA_TDNN",
            "model_args": {"channels": 16, "feat_dim": 24, "embed_dim": 8}}
    args = {"whisper_encoder": TINY["whisper_encoder"],
            "wavlm": TINY["wavlm"], "s3prl": TINY["wavlm"],
            "hubert": TINY["wavlm"], "wav2vec2": TINY["wavlm"],
            "feat_stack": {"num_layers": 3}, "w2vbert": TINY["w2vbert"],
            "tfmel": {"n_mels": 24}}
    configs = {**head, "dataset_args": {"frontend": name}}
    if name in args:
        configs["dataset_args"][f"{name}_args"] = dict(args[name])
    if name == "whisper_encoder":
        configs.update(model="whisper_PMFA_large_v2",
                       model_args={"embed_dim": 8})
    if name == "bogus":
        for build in (j_build, build_model, featurizers):
            with pytest.raises(KeyError, match="bogus"):
                build(configs)
        return
    jb = j_build(configs)
    model = build_model(configs)
    featurizers(configs)
    if name not in ("fbank", "tfmel"):
        assert type(jb.model).__name__ == type(model).__name__
        assert rules_name(model).split("+")[1] == type(
            model.speaker_model).__name__
    # hubert and wav2vec2 are the stack without the gated bias
    has_bias = any("rel_attn_embed" in k for k in model.state_dict())
    assert has_bias == (name in ("wavlm", "s3prl"))


@pytest.mark.parametrize("name,key,value,exc", [
    ("wavlm", "frame_shift", 10, ValueError),
    ("wavlm", "bogus_key", 1, ValueError),
    ("feat_stack", "bogus_key", 1, ValueError),
    ("w2vbert", "bogus_key", 1, TypeError)])
def test_config_errors_raise_as_in_jax(name, key, value, exc):
    args = {"feat_stack": {"num_layers": 2}}.get(name, {})
    configs = {"model": "ECAPA_TDNN",
               "model_args": {"channels": 16, "feat_dim": 24, "embed_dim": 8},
               "dataset_args": {"frontend": name,
                                f"{name}_args": {**args, key: value}}}
    for build in (j_build, build_model):
        with pytest.raises(exc):
            build(configs)


def _configs(path, **over):
    return parse_config_or_kwargs(str(path), [f"{k}={v}" for k, v in
                                              over.items()])


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: p.stem)
def test_recipe_yaml_builds_at_full_width(path):
    configs = _configs(path)
    name = _frontend(configs)
    model = build_model(configs, device="meta")
    assert rules_name(model) == NAMES[name]
    frozen = configs["dataset_args"][f"{name}_args"].get("frozen", False)
    assert model.frozen_frontend == frozen
    assert all(p.requires_grad != frozen
               for p in model.frontend.parameters())
    assert all(p.requires_grad for p in model.speaker_model.parameters())


@pytest.mark.parametrize("path,depth", [
    (YAMLS[0], {"dataset_args.wavlm_args.num_hidden_layers": 2}),
    (YAMLS[3], {"dataset_args.w2vbert_args.num_hidden_layers": 2,
                "model_args.num_frontend_hidden_layers": 2}),
    (YAMLS[5], {"dataset_args.whisper_encoder_args.num_blocks": 2,
                "dataset_args.whisper_encoder_args.layer_st": 0,
                "dataset_args.whisper_encoder_args.layer_ed": 1})],
    ids=["wavlm", "w2vbert", "whisper"])
def test_recipe_widths_have_the_jax_shapes(path, depth):
    configs = _configs(path, **depth)
    model = build_model(configs, device="meta")
    jb = j_build(configs)
    example = (jnp.zeros((1, 4000)) if _frontend(configs) == "wavlm"
               else jnp.zeros((1, 32, jb.init_feat_dim)))
    want = torch_shapes(jb.model, example, rules_name(model), train=False)
    assert port_shapes(model) == want


def test_diarization_and_wav2vec2_refusals(tmp_path):
    from wespeaker_tpu_torch.bin import diarize as diarize_cli
    from wespeaker_tpu_torch.cli.speaker import Speaker
    from wespeaker_tpu_torch.frontend.ssl_frontends import Wav2Vec2Frontend
    from wespeaker_tpu_torch.serving import build_embed_fn

    configs = _tiny(_configs(YAMLS[0]))
    with pytest.raises(ValueError, match="wavlm"):
        diarize_cli.diarize(str(YAMLS[0]), "unused.pt", "unused.scp",
                            str(tmp_path / "out.rttm"), device="cpu")
    dump_yaml(configs, str(tmp_path / "config.yaml"))
    with pytest.raises(ValueError, match="wavlm"):
        Speaker(str(tmp_path), device="cpu")
    ckpt = tmp_path / "model.pt"
    torch.save(build_model(configs).state_dict(), ckpt)
    embed, diarize = build_embed_fn(configs, str(ckpt), device="cpu")
    assert diarize is None  # the server's /diarize answers 501
    assert embed(*_wavs(4)).shape == (2, 192)
    with pytest.raises(NotImplementedError, match="wav2vec2"):
        Wav2Vec2Frontend("facebook/wav2vec2-large-lv60")


def test_server_answers_501_for_diarize(tmp_path):
    import urllib.error
    import urllib.request

    from wespeaker_tpu_torch.serving import EmbeddingServer

    configs = _tiny(_configs(YAMLS[5]))
    ckpt = tmp_path / "model.pt"
    torch.save(build_model(configs).state_dict(), ckpt)
    server = EmbeddingServer(configs, str(ckpt), port=0,
                             device="cpu").start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/diarize",
            data=json.dumps({"wav": [0.0] * 16000}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 501
    finally:
        server.close()


def test_extract_input_refusals_and_row_groups(tmp_path, monkeypatch):
    """bin/extract.py refuses feat data for a wav frontend and wavs for
    feat_stack; with a row cap of 1 each bucket runs row by row, and the
    embeddings equal the whole bucket's."""
    from wespeaker_tpu_torch.bin import extract
    from wespeaker_tpu_torch.data.wav_io import write_wav
    from wespeaker_tpu_torch.utils.kaldi_io import read_vec_scp_dict

    configs = _tiny(_configs(YAMLS[5]))
    ckpt = tmp_path / "model.pt"
    torch.save(build_model(configs).state_dict(), ckpt)
    with pytest.raises(ValueError, match="reads wavs"):
        extract._extract_inner({**configs, "data_type": "feat"}, str(ckpt),
                               "none.scp", "x", 4, 1, 0, False, 1, False,
                               False, torch.device("cpu"))
    stack = {"model": "ECAPA_TDNN", "model_args": {
        "channels": 16, "feat_dim": 8, "embed_dim": 8}, "dataset_args": {
            "frontend": "feat_stack", "feat_stack_args": {"num_layers": 2}}}
    with pytest.raises(ValueError, match="data_type feat"):
        extract._extract_inner(stack, str(ckpt), "none.list", "x", 4, 1, 0,
                               False, 1, False, False, torch.device("cpu"))
    wav, _ = _wavs(5)
    lst = tmp_path / "l.list"
    with open(lst, "w") as f:
        for i, n in enumerate((N, N_SHORT, 9000)):
            write_wav(str(tmp_path / f"u{i}.wav"), wav[0, :n], 16000)
            f.write(json.dumps({"key": f"u{i}",
                                "wav": str(tmp_path / f"u{i}.wav")}) + "\n")
    conf = str(tmp_path / "config.yaml")
    dump_yaml(configs, conf)
    out = {}
    for cap in (None, 1):
        if cap:
            monkeypatch.setattr(extract, "eval_rows_cap",
                                lambda *a, **k: cap)
        scp = extract.extract(conf, str(ckpt), str(lst),
                              str(tmp_path / f"e{cap}"), batch_size=3,
                              device="cpu")
        out[cap] = read_vec_scp_dict(scp)
    for k in out[None]:
        np.testing.assert_allclose(out[1][k], out[None][k], rtol=0,
                                   atol=1e-5)


def test_train_step_after_an_extraction_in_one_process():
    """The position tables cached by an extraction (made under
    inference_mode) serve a later training step's backward."""
    from wespeaker_tpu_torch.models.projections import ArcMarginProduct
    from wespeaker_tpu_torch.frontend import FbankConfig
    from wespeaker_tpu_torch.train import (AugConfig, build_train_state,
                                           make_train_step)

    for path in (YAMLS[1], YAMLS[3]):
        configs = _tiny(_configs(path))
        model, proj, opt, gen = build_train_state(
            lambda: (build_model(configs), ArcMarginProduct(
                configs["model_args"]["embed_dim"], 4)),
            {"optimizer": "SGD"}, device="cpu")
        train, evaluate = featurizers(configs)
        wav, mask = _wavs(6)
        make_eval_embed_fn(model, device="cpu", featurize_fn=evaluate)(
            {"wav": wav[:, :8000], "mask": mask[:, :8000]})
        step = make_train_step(model, proj, opt, lambda s: 0.01,
                               lambda s: 0.1, FbankConfig(),
                               AugConfig(spec_aug=False), device="cpu",
                               generator=gen, featurize_fn=train)
        out = step({"wav": wav[:, :8000], "label": np.array([0, 1])})
        assert np.isfinite(float(out["loss"]))


def test_warm_up_epoch_0_schedules_as_jax():
    """whisper_pmfa_stage1.yaml: warm_up_epoch 0 and B=70, so the LR's
    batch scaling (70 / 64) has no ramp; the JAX package's jnp.where
    discards its ramp's division by zero, the port returns the scale
    from the ramp's end on."""
    from wespeaker_tpu.utils import schedulers as jsched
    from wespeaker_tpu_torch.utils import schedulers as tsched

    sched = _configs(YAMLS[5])["scheduler_args"]
    kw = dict(num_epochs=4, epoch_iter=3, initial_lr=sched["initial_lr"],
              final_lr=sched["final_lr"], warm_up_epoch=0,
              scale_ratio=70 / 64)
    got = tsched.ExponentialDecrease(**kw)
    want = jsched.ExponentialDecrease(**kw)
    for step in range(12):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
