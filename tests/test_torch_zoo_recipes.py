"""The recipe YAMLs of the model zoo build in the port as in the JAX
package, and one serves on the CPU.

- Each of the ten YAMLs (voxceleb v2 eres2net, eres2net_lm, res2net,
  repvgg, xvec, xvec_lm, xi_vector, redimnet2, redimnet2_lm; cnceleb v2
  repvgg) builds through the port's `build_model` unchanged, at full
  width (on the meta device: shapes only, no forward), and every
  parameter and BN statistic has the shape that jax.eval_shape gives the
  JAX package's build of the same YAML, under the port's name rules.
- examples/voxceleb/v2/conf/eres2net.yaml and a torch state_dict give a
  server (device="cpu") whose concurrent replies equal the extractor's
  embedding of each utterance padded and masked to its bucket.
- The ReDimNet2 recipes' tfmel frontend (frontend/tfmel.py through
  train/composite.py::featurizers): the eval hook against the JAX
  package's featurize_eval (masked with the recipe's signal norm, and
  unmasked without it)
  at 1e-4, the train hook's time and frequency bands, and an extraction
  through it against the JAX package's on a narrow x-vector at 1e-4.
"""

import concurrent.futures
import functools
import json
import pathlib
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from tests.torch_zoo_util import port_shapes, torch_shapes  # noqa: E402
from wespeaker_tpu.train.composite import build_model as j_build  # noqa
from wespeaker_tpu_torch.bin.extract import load_model_for_eval  # noqa
from wespeaker_tpu_torch.frontend import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.serving import EmbeddingServer  # noqa: E402
from wespeaker_tpu_torch.train import make_eval_embed_fn  # noqa: E402
from wespeaker_tpu_torch.train.composite import (build_model,  # noqa: E402
                                                 featurizers)
from wespeaker_tpu_torch.utils.config import (  # noqa: E402
    parse_config_or_kwargs)

torch.set_num_threads(2)
EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
YAMLS = [f"voxceleb/v2/conf/{n}.yaml" for n in (
    "eres2net", "eres2net_lm", "res2net", "repvgg", "xvec", "xvec_lm",
    "xi_vector", "redimnet2", "redimnet2_lm")] + ["cnceleb/v2/conf/repvgg.yaml"]


@functools.lru_cache(maxsize=None)
def _jax_shapes(model_name, model_args, frontend, port_class):
    """The JAX build's shapes, once for each model the YAMLs share (the
    _lm fine-tunes and cnceleb's repvgg build voxceleb's models), named
    by the rules that the port's class name chooses, as its loader does."""
    configs = {"model": model_name, "model_args": dict(json.loads(
        model_args)), "dataset_args": json.loads(frontend)}
    return torch_shapes(j_build(configs).model, jnp.zeros((1, 32, configs[
        "model_args"]["feat_dim"])), port_class)


@pytest.mark.parametrize("rel", YAMLS)
def test_recipe_builds_with_the_jax_shapes(rel):
    configs = parse_config_or_kwargs(str(EXAMPLES / rel))
    with torch.device("meta"):
        model = build_model(configs)
    frontend = {k: v for k, v in configs["dataset_args"].items()
                if k in ("frontend", "tfmel_args")}
    want = _jax_shapes(configs["model"],
                       json.dumps(configs["model_args"], sort_keys=True),
                       json.dumps(frontend, sort_keys=True),
                       type(model).__name__)
    assert port_shapes(model) == want


def test_eres2net_yaml_serves_on_cpu(tmp_path):
    configs = parse_config_or_kwargs(
        str(EXAMPLES / "voxceleb" / "v2" / "conf" / "eres2net.yaml"))
    assert configs["model"] == "ERes2Net34_Base"
    torch.manual_seed(0)
    ckpt = tmp_path / "eres2net.pt"
    torch.save(build_model(configs).state_dict(), ckpt)
    rng = np.random.default_rng(11)
    wavs = [rng.uniform(-0.5, 0.5, n).astype(np.float32)
            for n in (9000, 16000)]
    server = EmbeddingServer(configs, str(ckpt), port=0, max_batch=4,
                             max_wait_ms=200, device="cpu").start()
    try:
        url = f"http://127.0.0.1:{server.port}/embed"

        def post(w):
            req = urllib.request.Request(
                url, data=json.dumps({"wav": w.tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return np.asarray(json.load(r)["embedding"], np.float32)

        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            replies = list(ex.map(post, wavs))
    finally:
        server.close()
    model = load_model_for_eval(configs, str(ckpt), device="cpu")
    fn = make_eval_embed_fn(model, FbankConfig(), device="cpu")
    for w, got in zip(wavs, replies):
        padded = np.zeros((1, 16000), np.float32)
        mask = np.zeros((1, 16000), np.float32)
        padded[0, :len(w)], mask[0, :len(w)] = w, 1.0
        want = fn({"wav": padded, "mask": mask})[0].numpy()
        assert got.shape == (512,)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


# ---- the ReDimNet2 recipes' tfmel frontend ----

REDIM2_YAML = EXAMPLES / "voxceleb" / "v2" / "conf" / "redimnet2.yaml"


def _tfmel_inputs(seed):
    rng = np.random.default_rng(seed)
    wav = rng.uniform(-0.5, 0.5, (3, 16000)).astype(np.float32)
    mask = np.ones((3, 16000), np.float32)
    mask[1, 11000:] = 0
    return wav, mask


@pytest.mark.parametrize("masked,norm_signal", [(True, True),
                                                 (False, False)])
def test_tfmel_matches_jax(masked, norm_signal):
    """The recipe's tfmel_args (72 mels, pre-emphasis), the signal norm on
    and off: the eval hook against JAX BuiltModel.featurize_eval, features
    and frame mask, at 1e-4 (log-mel in f32)."""
    configs = parse_config_or_kwargs(
        str(REDIM2_YAML), [f"dataset_args.tfmel_args.norm_signal="
                           f"{str(norm_signal).lower()}"])
    wav, mask = _tfmel_inputs(masked + 2 * norm_signal)
    batch = {"wav": wav, "mask": mask} if masked else {"wav": wav}
    want, want_mask = j_build(configs).featurize_eval(
        {k: jnp.asarray(v) for k, v in batch.items()})
    got, got_mask = featurizers(configs)[1](
        torch.from_numpy(wav), torch.from_numpy(mask) if masked else None)
    assert got.shape == want.shape == (3, 99, 72)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    if masked:
        np.testing.assert_array_equal(got_mask.numpy(),
                                      np.asarray(want_mask))
    else:
        assert got_mask is None and want_mask is None


def test_tfmel_train_hook_masks_a_band_of_time_and_of_frequency():
    """featurize_train: the eval features with one time band of 0-9 frames
    and one frequency band of 0-7 bins zeroed per utterance."""
    configs = parse_config_or_kwargs(str(REDIM2_YAML))
    wav = torch.from_numpy(_tfmel_inputs(5)[0])
    train, evaluate = featurizers(configs)
    clean = evaluate(wav)[0]
    got = train(wav, torch.Generator().manual_seed(0))
    for b in range(3):
        zero = (got[b] == 0) & (clean[b] != 0)
        rows = zero.all(dim=1).nonzero().flatten()
        cols = zero.all(dim=0).nonzero().flatten()
        assert len(rows) < 10 and len(cols) < 8
        assert torch.equal(zero, rows[:, None].eq(
            torch.arange(99)).any(0)[:, None]
            | cols[:, None].eq(torch.arange(72)).any(0)[None, :])
        keep = ~zero
        assert torch.equal(got[b][keep], clean[b][keep])


def test_tfmel_recipe_extracts_as_jax(tmp_path):
    """make_eval_embed_fn through the tfmel hook against the JAX package's
    make_eval_embed_fn with its featurize_eval, on a narrow x-vector that
    takes the recipe's 72 mels (the same weights); then a train step of
    the recipe's trainer hook runs."""
    from tests.torch_zoo_util import numpy_variables
    from wespeaker_tpu.models.tdnn import XVEC as JXVEC
    from wespeaker_tpu.train import make_eval_embed_fn as j_embed_fn
    from wespeaker_tpu_torch.models.projections import ArcMarginProduct
    from wespeaker_tpu_torch.models.tdnn import XVEC
    from wespeaker_tpu_torch.train import (AugConfig, build_train_state,
                                           make_train_step)
    from wespeaker_tpu_torch.utils import weights

    configs = parse_config_or_kwargs(str(REDIM2_YAML))
    jmodel = JXVEC(72, 16, 24, 16)
    variables = numpy_variables(jmodel, jnp.zeros((1, 40, 72)), 3)
    wav, mask = _tfmel_inputs(7)
    jfn = j_embed_fn(jmodel, featurize_fn=j_build(configs).featurize_eval)
    want = np.asarray(jax.jit(jfn)(variables, {"wav": jnp.asarray(wav),
                                               "mask": jnp.asarray(mask)}))
    model = XVEC(72, 16, 24, 16)
    model.load_state_dict(weights.from_jax_variables(variables, "XVEC"))
    train, evaluate = featurizers(configs)
    fn = make_eval_embed_fn(model, FbankConfig(), device="cpu",
                            featurize_fn=evaluate)
    got = fn({"wav": wav, "mask": mask}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    model, proj, opt, gen = build_train_state(
        lambda: (XVEC(72, 16, 24, 16), ArcMarginProduct(16, 4)),
        {"optimizer": "SGD", "optimizer_args": {"momentum": 0.9}},
        device="cpu")
    step = make_train_step(model, proj, opt, lambda s: 0.1, lambda s: 0.0,
                           FbankConfig(), AugConfig(), device="cpu",
                           generator=gen, featurize_fn=train)
    out = step({"wav": wav, "label": np.array([0, 1, 2])})
    assert np.isfinite(float(out["loss"])) and step.step == 1


def test_diarization_refuses_the_tfmel_frontend(tmp_path):
    """Diarization windows are fbank: bin/diarize.py and Speaker refuse a
    tfmel config rather than feed its model fbank (the JAX package's
    diarize CLI does not check; its server builds no /diarize for it)."""
    from wespeaker_tpu_torch.bin import diarize as diarize_cli
    from wespeaker_tpu_torch.cli.speaker import Speaker
    from wespeaker_tpu_torch.utils.config import dump_yaml

    with pytest.raises(ValueError, match="tfmel"):
        diarize_cli.diarize(str(REDIM2_YAML), "unused.pt", "unused.scp",
                            str(tmp_path / "out.rttm"), device="cpu")
    dump_yaml(parse_config_or_kwargs(str(REDIM2_YAML)),
              str(tmp_path / "config.yaml"))
    with pytest.raises(ValueError, match="tfmel"):
        Speaker(str(tmp_path), device="cpu")
