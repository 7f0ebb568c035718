"""Port parity for the ReDimNet family: the whole model, the weight
carry-over, the registry and YAML serving, against the JAX package on the
same numpy inputs, in f32 on the CPU.

- The model: three narrow ReDimNets (C = 4, feat 16-20, 2-3 stages,
  B = 2 x 40 frames) that between them run both 2-D block types
  (basic_resnet with fwSE and grouped convs, plain basic_resnet, and
  convnext_like), the 1-D types conv+att, att and fc, a conv_exp != 1
  stage, a stride-3 stage, the mfa conv + BN, two_emb_layer and
  return_frame_feat, masked and not, against JAX's flax ReDimNet in eval
  with BN statistics and the learned stage weights perturbed by noise:
  rtol/atol 1e-4 (f32 sums in another order through ~20 convs and an
  attention). C > 1 and F > 1 everywhere, so a wrong d = f * C + c order
  in to1d / to2d would show. JAX's references take an all-ones mask for
  "unmasked", which equals its mask=None path; one jitted apply per shape.
- Full width without compute: the port's state_dict shapes for B0-B6 equal
  the weight rules applied to JAX's `jax.eval_shape(model.init, ...)`.
- Weights: from_jax_variables gives exactly the port's keys (the frozen
  inputs_weights.0 included) and loads strictly; the JAX package's own
  converter maps the port's state_dict back to the same tree; a saved
  state_dict (upstream's names) loads strictly through load_checkpoint.
- A tiny-width redimnet.yaml-style YAML serves on the CPU; the 'gru' time
  block builds (tests/test_torch_redimnet_gru.py) and an unknown one
  raises.
"""

import concurrent.futures
import json
import pathlib
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict, unflatten_dict  # noqa: E402

from wespeaker_tpu.models import redimnet as jredimnet  # noqa: E402
from wespeaker_tpu.utils import torch_compat  # noqa: E402
from wespeaker_tpu_torch.bin.extract import load_model_for_eval  # noqa
from wespeaker_tpu_torch.frontend import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.models import get_speaker_model, redimnet  # noqa
from wespeaker_tpu_torch.models.pooling_layers import \
    set_pooling_fused  # noqa: E402
from wespeaker_tpu_torch.ops import pooling  # noqa: E402
from wespeaker_tpu_torch.serving import EmbeddingServer  # noqa: E402
from wespeaker_tpu_torch.train import make_eval_embed_fn  # noqa: E402
from wespeaker_tpu_torch.train.composite import build_model  # noqa: E402
from wespeaker_tpu_torch.utils import checkpoint, weights  # noqa: E402
from wespeaker_tpu_torch.utils.config import (  # noqa: E402
    parse_config_or_kwargs)

torch.set_num_threads(2)
NAME = "ReDimNetB2"  # any ReDimNet name chooses the same rules
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 2, 40
K = ((3, 3),)
CONFIGS = {
    # fwSE basic blocks with grouped 3x3 convs (groups = C // 2), conv+att
    # time blocks, a conv_exp = 2 stride-2 stage, two embedding layers
    "fwse_convatt": dict(feat_dim=16, C=4, block_1d_type="conv+att",
                         block_2d_type="basic_resnet_fwse",
                         stages_setup=((1, 1, 1, K, 4), (2, 1, 2, K, 4)),
                         group_divisor=2, embed_dim=8, two_emb_layer=True),
    # ConvNeXt-like 2-D blocks, a stride-3 conv_exp = 2 stage without a
    # time block, then an attention time block
    "convnext_att": dict(feat_dim=18, C=4, block_1d_type="att",
                         block_2d_type="convnext_like",
                         stages_setup=((3, 1, 2, K, None), (1, 1, 1, K, 3)),
                         group_divisor=2, embed_dim=8),
    # plain basic blocks (no group divisor), fc time blocks, the mfa conv
    "basic_fc_mfa": dict(feat_dim=20, C=4, block_1d_type="fc",
                         block_2d_type="basic_resnet",
                         stages_setup=((2, 1, 1, K, 4), (1, 1, 1, K, None),
                                       (2, 1, 1, K, 5)),
                         group_divisor=None, embed_dim=8, out_channels=24),
}


def _perturbed(variables, seed):
    """BN means and the learned stage weights plus 0.1 normal noise, BN
    variances scaled by U(0.5, 1.5); a numpy tree."""
    rng = np.random.default_rng(seed)
    flat = flatten_dict(jax.device_get(variables))
    for path, v in flat.items():
        v = np.asarray(v, np.float32)
        if path[-1] == "var":
            v = v * rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif path[0] == "batch_stats" or path[-1].startswith(
                "inputs_weights"):
            v = v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
        flat[path] = v
    return unflatten_dict(flat)


@pytest.fixture(scope="module")
def jax_redimnets():
    """{name: (module, variables, jitted apply with a mask)}."""
    out = {}
    for i, (name, kw) in enumerate(CONFIGS.items()):
        module = jredimnet.ReDimNet(**kw)
        variables = _perturbed(jax.jit(module.init)(
            jax.random.PRNGKey(i), jnp.zeros((1, T, kw["feat_dim"]))), i)
        apply = jax.jit(lambda v, x, m, mod=module: mod.apply(v, x, mask=m))
        out[name] = (module, variables, apply)
    return out


def _port(variables, name):
    model = redimnet.ReDimNet(**CONFIGS[name])
    model.load_state_dict(weights.from_jax_variables(variables, NAME),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_redimnet_matches_jax(jax_redimnets, name, masked):
    _, variables, apply = jax_redimnets[name]
    feat = CONFIGS[name]["feat_dim"]
    rng = np.random.default_rng(feat + masked)
    x = rng.normal(size=(B, T, feat)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    if masked:
        mask[1, 27:] = 0
    want = np.asarray(apply(variables, jnp.asarray(x), jnp.asarray(mask)))
    model = _port(variables, name)
    before = (pooling.fused_masked_stats.launches,
              pooling.fused_softmax_stats.launches)
    with torch.no_grad():
        got = model(torch.from_numpy(x),
                    torch.from_numpy(mask) if masked else None).numpy()
    assert got.shape == (B, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    assert (pooling.fused_masked_stats.launches,
            pooling.fused_softmax_stats.launches) == before
    # fused=False pooling: the plain path, the same numbers
    with torch.no_grad():
        plain = set_pooling_fused(model, False)(
            torch.from_numpy(x),
            torch.from_numpy(mask) if masked else None).numpy()
    np.testing.assert_allclose(plain, want, **MODEL_TOL)


def test_frame_features_match_jax(jax_redimnets):
    """return_frame_feat: the backbone's (B, T, D) after the mfa conv."""
    module, variables, _ = jax_redimnets["basic_fc_mfa"]
    x = np.random.default_rng(9).normal(size=(B, T, 20)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: module.apply(
        v, x, return_frame_feat=True))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(variables, "basic_fc_mfa")(
            torch.from_numpy(x), return_frame_feat=True).numpy()
    assert got.shape == want.shape == (B, T, 24)
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_to1d_order_is_f_major():
    """d = f * C + c, both ways, on a channels_last map."""
    x = torch.arange(2 * 3 * 5 * 7, dtype=torch.float32).reshape(2, 3, 5, 7)
    x = x.contiguous(memory_format=torch.channels_last)
    flat = redimnet.to1d(x)
    assert flat.shape == (2, 7, 5 * 3)
    assert flat[1, 4, 2 * 3 + 1] == x[1, 1, 2, 4]
    back = redimnet.to2d(flat, 3, 5)
    assert torch.equal(back, x)
    assert back.is_contiguous(memory_format=torch.channels_last)


CONSTRUCTORS = ["ReDimNetB0", "ReDimNetB1", "ReDimNetB2", "ReDimNetB3",
                "ReDimNetB4", "ReDimNetB5", "ReDimNetB6"]


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_full_width_parameter_shapes_match_jax(name):
    """Each constructor at its default width (B0: feat 60; the rest 72):
    the port's state_dict shapes equal the weight rules applied to JAX's
    eval_shape tree, with no compute on either side."""
    jmodel = getattr(jredimnet, name)()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, jmodel.feat_dim)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    want = {k: tuple(v.shape)
            for k, v in weights.from_jax_variables(zeros, name).items()}
    model = get_speaker_model(name)()
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert model.pool.global_context_att
    assert model.seg_1.in_features == 2 * jmodel.C * jmodel.feat_dim


def test_redimnet_variables_load_strictly_and_map_back(jax_redimnets,
                                                        tmp_path):
    for name in CONFIGS:
        _, variables, _ = jax_redimnets[name]
        sd = weights.from_jax_variables(variables, NAME)
        model = redimnet.ReDimNet(**CONFIGS[name])
        assert set(sd) == set(model.state_dict())
        assert torch.equal(sd["backbone.inputs_weights.0"],
                           torch.ones(1, 1, 1, 1))
        assert not model.backbone.inputs_weights[0].requires_grad
        model.load_state_dict(sd, strict=True)
        back = torch_compat.torch_to_flax_variables(
            model.state_dict(), variables, torch_compat.rules_for(NAME))
        want = flatten_dict(variables)
        got = flatten_dict(jax.device_get(back))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    # upstream's names: a saved state_dict loads strictly through the
    # checkpoint reader (as an upstream ReDimNet .pt does)
    _, variables, _ = jax_redimnets["fwse_convatt"]
    sd = weights.from_jax_variables(variables, NAME)
    for key in ("backbone.stage1.1.conv_block.se.squeeze.weight",
                "backbone.stage1.2.0.weight",
                "backbone.stage1.2.1.running_var",
                "backbone.stage1.4.tcm.0.dwconvs.0.weight",
                "backbone.stage0.3.tcm.4.feed_forward.output_dense.bias",
                "backbone.stage0.3.red_dim_conv.1.weight",
                "backbone.stem.1.bias", "pool.linear1.weight", "seg_2.bias"):
        assert key in sd, key
    path = tmp_path / "redimnet.pt"
    torch.save(sd, path)
    checkpoint.load_checkpoint(str(path),
                               redimnet.ReDimNet(**CONFIGS["fwse_convatt"]))
    assert list(weights.rules_for(NAME)) == [
        tuple(r) for r in torch_compat.rules_for(NAME)]


def test_redimnet_yaml_builds_b2_at_its_width():
    """examples/voxceleb/v2/conf/redimnet.yaml: ReDimNetB2, feat 72, embed
    192, ASTP with global context over C * F = 16 * 72 = 1152."""
    conf = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "voxceleb" / "v2" / "conf" / "redimnet.yaml")
    configs = parse_config_or_kwargs(str(conf))
    assert configs["model"] == NAME
    assert configs["dataset_args"]["fbank_args"]["num_mel_bins"] == 72
    model = build_model(configs)
    assert model.pool.linear2.out_channels == 1152
    assert (model.seg_1.in_features, model.seg_1.out_features) == (2304, 192)
    assert len([n for n in dir(model.backbone) if n.startswith("stage")]) == 6


def test_redimnet_yaml_serves_on_cpu(tmp_path):
    """A redimnet.yaml-style YAML at tiny width (model ReDimNet, fbank 16
    bins) and a torch state_dict give a server (device="cpu") whose
    concurrent replies equal the extractor's embedding of each utterance
    padded and masked to its bucket."""
    conf = tmp_path / "redimnet.yaml"
    conf.write_text(
        "model: ReDimNet\nmodel_args:\n  feat_dim: 16\n  C: 4\n"
        "  embed_dim: 8\n  group_divisor: 2\n"
        "  block_2d_type: convnext_like\n"
        "  stages_setup: [[1, 1, 1, [[3, 3]], 4], [2, 1, 1, [[3, 3]], 4]]\n"
        "dataset_args:\n  fbank_args:\n    num_mel_bins: 16\n")
    configs = parse_config_or_kwargs(str(conf))
    torch.manual_seed(0)
    ckpt = tmp_path / "redimnet.pt"
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
    fn = make_eval_embed_fn(model, FbankConfig(num_mel_bins=16),
                            device="cpu")
    for w, got in zip(wavs, replies):
        padded = np.zeros((1, 16000), np.float32)
        mask = np.zeros((1, 16000), np.float32)
        padded[0, :len(w)], mask[0, :len(w)] = w, 1.0
        want = fn({"wav": padded, "mask": mask})[0].numpy()
        assert got.shape == (8,)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_gru_time_block_is_not_ported():
    """The 'gru' block is ported (tests/test_torch_redimnet_gru.py holds it
    to JAX's); a time block the JAX package does not have still raises."""
    block = redimnet.TimeContextBlock1d(64, 16, block_type="gru")
    assert block(torch.zeros(2, 5, 64)).shape == (2, 5, 64)
    with pytest.raises(NotImplementedError, match="lstm"):
        redimnet.TimeContextBlock1d(64, 16, block_type="lstm")
    with pytest.raises(NotImplementedError):
        redimnet.ReDimNet(feat_dim=16, C=4, block_1d_type="lstm",
                          stages_setup=((1, 1, 1, K, 4),), group_divisor=2)
