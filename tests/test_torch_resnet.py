"""Port parity for the ResNet family: the whole model, the weight
carry-over, the registry and YAML serving, and two train steps with the
tap-packed filter gradient, against the JAX package on the same numpy
inputs, in f32 on the CPU.

- The model: narrow ResNets (BasicBlock and Bottleneck, one block per
  stage, m_channels 8, embed 16) at feat 16 and 20 (F' = 2 and 3; at 20 the
  JAX package's (feat // 8) formula and the true width differ, and both
  sides take the true one), masked and not, `two_emb_layer` and
  `return_frame_feat`, against JAX's flax ResNet in eval with BN statistics
  perturbed by 0.1 normal noise: rtol/atol 1e-4 (f32 sums in another order
  through ~10 convs).
- Two SGD steps (nesterov, weight decay 1e-4) of the BasicBlock model at
  feat 16 with ArcMargin over 10 classes, B=4 chunks of 40 frames, dither 0
  and spec-aug off, with `set_conv_dw_mode("packed")` on both sides (JAX's
  Pallas dW in interpret mode; the port's Conv2dPackedDW with the plain
  dw_pack on the CPU): loss and running variances within 1e-4 of each
  tensor's largest magnitude, running means within 1e-4 of their BN's
  running std (the stem's mean over CMVN'd features is near zero, ~1e-4 of
  that std, so a bound relative to itself would measure f32 noise),
  parameters within 2e-3 and updates and momentum within 3e-3 of their
  2-norms, as tests/test_torch_train.py::test_two_train_steps_match_jax
  holds ECAPA.
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

from wespeaker_tpu.frontend import FbankConfig as JFbankConfig  # noqa: E402
from wespeaker_tpu.models import resnet as jresnet  # noqa: E402
from wespeaker_tpu.models.projections import \
    ArcMarginProduct as JArcMargin  # noqa: E402
from wespeaker_tpu.ops import conv_dw_pack as jdw  # noqa: E402
from wespeaker_tpu.train import init_train_state  # noqa: E402
from wespeaker_tpu.train import make_train_step as j_make_train_step  # noqa
from wespeaker_tpu.train.optim import make_optimizer as j_opt  # noqa: E402
from wespeaker_tpu.train.train_step import AugConfig as JAug  # noqa: E402
from wespeaker_tpu.utils import schedulers as jsched  # noqa: E402
from wespeaker_tpu.utils import torch_compat  # noqa: E402
from wespeaker_tpu_torch.bin.extract import load_model_for_eval  # noqa
from wespeaker_tpu_torch.frontend import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.models import get_speaker_model, resnet  # noqa
from wespeaker_tpu_torch.models.projections import \
    ArcMarginProduct  # noqa: E402
from wespeaker_tpu_torch.ops import conv_dw_pack as tdw  # noqa: E402
from wespeaker_tpu_torch.serving import EmbeddingServer  # noqa: E402
from wespeaker_tpu_torch.train import (AugConfig, make_eval_embed_fn,  # noqa
                                       make_train_step)
from wespeaker_tpu_torch.train.optim import make_optimizer  # noqa: E402
from wespeaker_tpu_torch.utils import schedulers as tsched  # noqa: E402
from wespeaker_tpu_torch.utils import weights  # noqa: E402
from wespeaker_tpu_torch.utils.config import (  # noqa: E402
    parse_config_or_kwargs)

torch.set_num_threads(2)
NAME = "ResNet34"  # any ResNet name chooses the same rules
EMB = 16
BLOCKS = {"basic": (jresnet.BasicBlock, resnet.BasicBlock),
          "bottleneck": (jresnet.Bottleneck, resnet.Bottleneck)}
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_module(kind, feat, **extra):
    return jresnet.ResNet(BLOCKS[kind][0], (1, 1, 1, 1), m_channels=8,
                          feat_dim=feat, embed_dim=EMB, **extra)


def _port(variables, kind, feat, **extra):
    model = resnet.ResNet(BLOCKS[kind][1], (1, 1, 1, 1), m_channels=8,
                          feat_dim=feat, embed_dim=EMB, **extra)
    model.load_state_dict(weights.from_jax_variables(variables, NAME),
                          strict=True)
    return model.eval()


def _perturbed(variables, seed):
    """BN statistics plus 0.1 normal noise; a numpy tree."""
    rng = np.random.default_rng(seed)
    flat = flatten_dict(jax.device_get(variables))
    for path, v in flat.items():
        v = np.asarray(v, np.float32)
        if path[0] == "batch_stats":
            v = v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
        flat[path] = v
    return unflatten_dict(flat)


@pytest.fixture(scope="module")
def jax_resnets():
    """{(kind, feat, two_emb_layer): (module, variables, jitted apply)}.
    One init per block kind (at feat 16, BN statistics perturbed); the
    other trees differ from it only in the head, drawn here."""
    rng = np.random.default_rng(40)

    def head(width):
        return {"kernel": (rng.normal(size=(width, EMB)) * width ** -0.5
                           ).astype(np.float32),
                "bias": (0.1 * rng.normal(size=EMB)).astype(np.float32)}

    out = {}
    for kind, expansion in (("basic", 1), ("bottleneck", 4)):
        base = _perturbed(jax.jit(_jax_module(kind, 16).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 40, 16))), seed=16)
        trees = {(16, False): base,
                 (20, False): {"params": dict(base["params"], seg_1=head(
                     2 * 3 * 64 * expansion)),
                     "batch_stats": base["batch_stats"]}}
        if kind == "basic":
            trees[16, True] = {
                "params": dict(base["params"], seg_2=head(EMB)),
                "batch_stats": dict(base["batch_stats"], seg_bn_1={
                    "mean": (0.1 * rng.normal(size=EMB)).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, EMB).astype(np.float32)})}
        for (feat, two), variables in trees.items():
            module = _jax_module(kind, feat, two_emb_layer=two)
            apply = jax.jit(lambda v, x, m, mod=module: mod.apply(v, x,
                                                                  mask=m))
            out[kind, feat, two] = (module, variables, apply)
    return out


def _ragged_mask(b, t):
    m = np.ones((b, t), np.float32)
    m[1, (t * 2) // 3:] = 0
    return m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("feat", [16, 20])
@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
def test_resnet_matches_jax(jax_resnets, kind, feat, masked):
    _, variables, apply = jax_resnets[kind, feat, False]
    rng = np.random.default_rng(feat + masked)
    x = rng.normal(size=(3, 43, feat)).astype(np.float32)
    mask = _ragged_mask(3, 43) if masked else None
    want = np.asarray(apply(variables, jnp.asarray(x),
                            None if mask is None else jnp.asarray(mask)))
    model = _port(variables, kind, feat)
    assert model.seg_1.in_features == 2 * -(-feat // 8) * 64 * (
        4 if kind == "bottleneck" else 1)
    with torch.no_grad():
        got = model(torch.from_numpy(x), None if mask is None
                    else torch.from_numpy(mask)).numpy()
    assert got.shape == (3, EMB) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_two_emb_layer_and_frame_features_match_jax(jax_resnets):
    """seg_1, relu, the affine-free seg_bn_1 and seg_2; and the frame
    features (B, T', F' * C) with d = f * C + c, at feat 20 (F' = 3)."""
    module, variables, apply = jax_resnets["basic", 16, True]
    x = np.random.default_rng(6).normal(size=(2, 40, 16)).astype(np.float32)
    want = np.asarray(apply(variables, jnp.asarray(x), None))
    model = _port(variables, "basic", 16, two_emb_layer=True)
    assert model.seg_bn_1.weight is None
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **MODEL_TOL)

    module, variables, _ = jax_resnets["basic", 20, False]
    x = np.random.default_rng(7).normal(size=(2, 41, 20)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: module.apply(
        v, x, return_frame_feat=True))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(variables, "basic", 20)(torch.from_numpy(x),
                                            return_frame_feat=True).numpy()
    assert got.shape == want.shape == (2, 6, 3 * 64)
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_resnet_variables_load_strictly_and_map_back(jax_resnets):
    """from_jax_variables gives exactly the port's state_dict keys (the
    `layer<n>.<m>` blocks, `shortcut.0/.1`), seg_1 sized from the true F'
    (3 at feat 20, where (feat // 8) says 2), and the JAX package's own
    converter maps the port's state_dict back to the same variables."""
    for kind in ("basic", "bottleneck"):
        _, variables, _ = jax_resnets[kind, 20, False]
        sd = weights.from_jax_variables(variables, NAME)
        model = resnet.ResNet(BLOCKS[kind][1], (1, 1, 1, 1), m_channels=8,
                              feat_dim=20, embed_dim=EMB)
        assert set(sd) == set(model.state_dict())
        assert "layer2.0.shortcut.0.weight" in sd
        assert "layer2.0.shortcut.1.running_var" in sd
        model.load_state_dict(sd, strict=True)
        back = torch_compat.torch_to_flax_variables(
            model.state_dict(), variables, torch_compat.rules_for(NAME))
        want = flatten_dict(variables)
        got = flatten_dict(jax.device_get(back))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    assert list(weights.rules_for(NAME)) == [
        tuple(r) for r in torch_compat.rules_for(NAME)]


@pytest.mark.parametrize("name,block,depths", [
    ("ResNet18", resnet.BasicBlock, (2, 2, 2, 2)),
    ("ResNet34", resnet.BasicBlock, (3, 4, 6, 3)),
    ("ResNet50", resnet.Bottleneck, (3, 4, 6, 3)),
    ("ResNet101", resnet.Bottleneck, (3, 4, 23, 3)),
    ("ResNet152", resnet.Bottleneck, (3, 8, 36, 3)),
    ("ResNet221", resnet.Bottleneck, (6, 16, 48, 3)),
    ("ResNet293", resnet.Bottleneck, (10, 20, 64, 3))])
def test_registry_builds_every_constructor(name, block, depths):
    """resnet.yaml's model_args build each constructor with the JAX
    package's depths, TSTP pooled at 2 x 10 x 256 x expansion."""
    model = get_speaker_model(name)(feat_dim=80, embed_dim=256,
                                    pooling_func="TSTP", two_emb_layer=False)
    layers = [model.layer1, model.layer2, model.layer3, model.layer4]
    assert tuple(len(x) for x in layers) == depths
    assert all(isinstance(b, block) for x in layers for b in x)
    assert model.seg_1.in_features == 2 * 10 * 256 * block.expansion
    assert getattr(resnet, name) is get_speaker_model(name)


def test_resnet_yaml_serves_on_cpu(tmp_path):
    """examples/voxceleb/v2/conf/resnet.yaml and a torch state_dict give a
    server (device="cpu") whose concurrent replies equal the extractor's
    embedding of each utterance padded and masked to its bucket."""
    conf = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "voxceleb" / "v2" / "conf" / "resnet.yaml")
    configs = parse_config_or_kwargs(str(conf))
    assert configs["model"] == NAME
    torch.manual_seed(0)
    ckpt = tmp_path / "resnet.pt"
    torch.save(get_speaker_model(NAME)(**configs["model_args"]).state_dict(),
               ckpt)
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
        assert got.shape == (256,)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


# ---- two train steps, packed dW on both sides ----

FEAT, NCLS, B = 16, 10, 4
N_SAMPLES = 39 * 160 + 400  # 40 frames
OPT_CONF = {"optimizer": "SGD",
            "optimizer_args": {"momentum": 0.9, "nesterov": True,
                               "weight_decay": 1e-4}}


def _trace(opt_state):
    """The momentum tree inside optax's inject_hyperparams(chain(...))."""
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    if hasattr(opt_state, "inner_state"):
        return _trace(opt_state.inner_state)
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _trace(s)
            if found is not None:
                return found
    return None


def _rel_close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: max error {err:.3g} of its max > {tol}"


def _norm_close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-12)
    assert err <= tol, f"{what}: error {err:.3g} of its norm > {tol}"


def test_two_packed_train_steps_match_jax(monkeypatch):
    rng = np.random.default_rng(5)
    batches = [{"wav": rng.uniform(-0.5, 0.5, (B, N_SAMPLES)).astype(
                    np.float32),
                "label": rng.integers(0, NCLS, B).astype(np.int32)}
               for _ in range(2)]
    lr_kw = dict(num_epochs=10, epoch_iter=2, initial_lr=1e-4, final_lr=5e-5,
                 warm_up_epoch=1)
    m_kw = dict(epoch_iter=2, increase_start_epoch=1, fix_start_epoch=3,
                initial_margin=0.0, final_margin=0.2)
    packed_calls, plain = [], tdw.dw_pack

    def counting(x, dy, **kw):
        packed_calls.append(tuple(x.shape))
        return plain(x, dy, **kw)

    monkeypatch.setattr(tdw, "dw_pack", counting)
    jdw.set_conv_dw_mode("packed")
    tdw.set_conv_dw_mode("packed")
    try:
        jmodel = _jax_module("basic", FEAT)
        jproj = JArcMargin(EMB, NCLS)
        tx = j_opt(OPT_CONF)
        state = init_train_state(jmodel, jproj, tx, jax.random.PRNGKey(0),
                                 feat_dim=FEAT, embed_dim=EMB)
        jstep = jax.jit(j_make_train_step(
            jmodel, jproj, tx, jsched.ExponentialDecrease(**lr_kw),
            jsched.MarginScheduler(**m_kw),
            fbank_cfg=JFbankConfig(num_mel_bins=FEAT, dither=0.0),
            aug=JAug(spec_aug=False), compute_dtype=jnp.float32))

        model = resnet.ResNet(resnet.BasicBlock, (1, 1, 1, 1), m_channels=8,
                              feat_dim=FEAT, embed_dim=EMB)
        model.load_state_dict(weights.from_jax_variables(
            {"params": state.params["model"],
             "batch_stats": state.batch_stats}, NAME), strict=True)
        proj = ArcMarginProduct(EMB, NCLS)
        with torch.no_grad():
            proj.weight.copy_(torch.from_numpy(np.array(
                state.params["projection"]["weight"])))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt = make_optimizer(OPT_CONF, list(model.parameters())
                             + list(proj.parameters()))
        step = make_train_step(
            model, proj, opt, tsched.ExponentialDecrease(**lr_kw),
            tsched.MarginScheduler(**m_kw),
            FbankConfig(num_mel_bins=FEAT, dither=0.0),
            AugConfig(spec_aug=False), device="cpu")

        for i, batch in enumerate(batches):
            state, jm = jstep(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
            tm = step(batch)
            for key in ("loss", "acc", "lr", "margin"):
                _rel_close(float(tm[key]), float(jm[key]), 1e-4,
                           f"step {i} {key}")
    finally:
        jdw.set_conv_dw_mode("native")
        tdw.set_conv_dw_mode("native")
    # the stem (1 -> 8), layer1's two convs and layers 2-4's stride-1 conv2
    assert [s[-1] for s in packed_calls] == [64, 32, 16, 8, 8, 1] * 2
    assert float(jm["margin"]) > 0  # the second step ran with a margin

    want = weights.from_jax_variables({"params": state.params["model"],
                                       "batch_stats": state.batch_stats},
                                      NAME)
    got = model.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            assert int(got[key]) == 2, key
        elif key.endswith("running_var"):
            _rel_close(got[key], value, 1e-4, key)
        elif key.endswith("running_mean"):
            # held to 1e-4 of the std it is normalised by: the stem's mean
            # over CMVN'd features is ~1e-4 of that std, f32 noise ~4e-8
            std = float(np.sqrt(np.max(np.asarray(
                want[key[:-len("mean")] + "var"]))))
            err = float((got[key] - torch.as_tensor(value)).abs().max())
            assert err <= 1e-4 * std, f"{key}: max error {err:.3g}"
        else:
            _norm_close(got[key], value, 2e-3, key)
            _norm_close(got[key] - before[key], value - before[key], 3e-3,
                        f"update of {key}")
    _norm_close(proj.weight.detach(), state.params["projection"]["weight"],
                2e-3, "projection.weight")
    want_buf = weights.from_jax_variables(
        {"params": _trace(state.opt_state)["model"]}, NAME)
    for name, p in model.named_parameters():
        _norm_close(opt.state[p]["momentum_buffer"], want_buf[name], 3e-3,
                    f"momentum {name}")
