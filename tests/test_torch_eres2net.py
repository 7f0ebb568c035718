"""Port parity for ERes2Net and Res2Net: the whole model, the weight
carry-over, the registry, and two train steps with the tap-packed filter
gradient, against the JAX package on the same numpy inputs, in f32 on the
CPU.

- The models at m_channels 8 and embed 16: ERes2Net in its Base form
  (base width 32, scale 2, expansion 2; blocks (2, 1, 1, 1)) at feat 16 and
  in `_aug`'s form (base width 24, scale 3, expansion 4; blocks
  (1, 1, 1, 1)) at feat 20 (F' = 3, where the JAX package's feat // 8
  says 2; both sides take the true width), and Res2Net (blocks
  (1, 1, 1, 1)) at feat 16, masked and not, against JAX's flax models in
  eval, with seeded numpy weights and BN statistics
  (tests/torch_zoo_util.py): rtol/atol 1e-4
  (f32 sums in another order through ~20 convs). Then `two_emb_layer`
  and `return_frame_feat` (B, T', F' * C).
- The flax trees load strictly into the upstream-named modules
  (`layer<n>.<m>`, `convs.<i>`, `fuse_models.<i>.local_att.<j>`,
  `conv2_1`, `layer<n>_downsample`, `fuse_mode1234`) and map back exactly,
  by the port's own inverse and by the JAX package's converter; the rules
  are torch_compat's. The registry builds every constructor with the JAX
  package's depths.
- Two SGD steps (nesterov, weight decay 1e-4) of the Base-form ERes2Net at
  feat 16, blocks (1, 1, 1, 1), with ArcMargin over 10 classes, B=3 chunks
  of 40 frames, dither 0 and spec-aug off, under
  `set_conv_dw_mode("packed")` on both sides (JAX's Pallas dW in
  interpret mode): the packed dW takes the stem and the Res2 convs of
  widths 4, 8, 16 and 32; loss within 1e-4 of its magnitude, running
  variances within 1e-4 of their largest magnitude and running means
  within 1e-4 of their BN's running std, as tests/test_torch_resnet.py
  holds ResNet, and each parameter's update within 3e-3 of its norm (the
  stem BN's bias, zero at the start, is its update, so the 2e-3 that
  ResNet's parameters meet is not asked of it); AFF's conv biases, whose
  gradient the train-mode BN after them takes to zero, move by less than
  1e-6 on both sides.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from tests.test_torch_resnet import (_norm_close, _ragged_mask,  # noqa
                                     _rel_close)
from tests.torch_zoo_util import numpy_variables  # noqa: E402
from wespeaker_tpu.frontend import FbankConfig as JFbankConfig  # noqa: E402
from wespeaker_tpu.models import eres2net as jeres  # noqa: E402
from wespeaker_tpu.models import res2net as jres2  # noqa: E402
from wespeaker_tpu.models.projections import \
    ArcMarginProduct as JArcMargin  # noqa: E402
from wespeaker_tpu.ops import conv_dw_pack as jdw  # noqa: E402
from wespeaker_tpu.train import make_train_step as j_make_train_step  # noqa
from wespeaker_tpu.train.optim import make_optimizer as j_opt  # noqa: E402
from wespeaker_tpu.train.train_step import AugConfig as JAug  # noqa: E402
from wespeaker_tpu.train.train_step import TrainState  # noqa: E402
from wespeaker_tpu.utils import schedulers as jsched  # noqa: E402
from wespeaker_tpu.utils import torch_compat  # noqa: E402
from wespeaker_tpu_torch.frontend import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.models import eres2net, get_speaker_model  # noqa
from wespeaker_tpu_torch.models import res2net  # noqa: E402
from wespeaker_tpu_torch.models.projections import \
    ArcMarginProduct  # noqa: E402
from wespeaker_tpu_torch.ops import conv_dw_pack as tdw  # noqa: E402
from wespeaker_tpu_torch.train import AugConfig, make_train_step  # noqa
from wespeaker_tpu_torch.train.optim import make_optimizer  # noqa: E402
from wespeaker_tpu_torch.utils import schedulers as tsched  # noqa: E402
from wespeaker_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(2)
EMB = 16
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# kind -> (JAX module, port module, model name for the rules)
KINDS = {
    "base": (lambda feat, **kw: jeres.ERes2Net(
        8, (2, 1, 1, 1), feat_dim=feat, embed_dim=EMB, **kw),
        lambda feat, **kw: eres2net.ERes2Net(
            8, (2, 1, 1, 1), feat_dim=feat, embed_dim=EMB, **kw),
        "ERes2Net34_Base", 16),
    "aug": (lambda feat, **kw: jeres.ERes2Net(
        8, (1, 1, 1, 1), base_width=24, scale=3, expansion=4, feat_dim=feat,
        embed_dim=EMB, **kw),
        lambda feat, **kw: eres2net.ERes2Net(
            8, (1, 1, 1, 1), base_width=24, scale=3, expansion=4,
            feat_dim=feat, embed_dim=EMB, **kw),
        "ERes2Net34_aug", 20),
    "res2net": (lambda feat, **kw: jres2.Res2Net(
        8, (1, 1, 1, 1), feat_dim=feat, embed_dim=EMB, **kw),
        lambda feat, **kw: res2net.Res2Net(
            8, (1, 1, 1, 1), feat_dim=feat, embed_dim=EMB, **kw),
        "Res2Net34_Base", 16),
}


def _port(kind, variables, **kw):
    _, port, name, feat = KINDS[kind]
    model = port(feat, **kw)
    model.load_state_dict(weights.from_jax_variables(variables, name),
                          strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def jax_models():
    """{kind: (module, perturbed variables, jitted apply)}."""
    out = {}
    for i, (kind, (jmod, _, _, feat)) in enumerate(KINDS.items()):
        module = jmod(feat)
        variables = numpy_variables(module, jnp.zeros((1, 40, feat)), i)
        apply = jax.jit(lambda v, x, m, mod=module: mod.apply(v, x, mask=m))
        out[kind] = (module, variables, apply)
    return out


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
def test_model_matches_jax(jax_models, kind, masked):
    _, variables, apply = jax_models[kind]
    feat = KINDS[kind][3]
    rng = np.random.default_rng(feat + masked)
    x = rng.normal(size=(3, 45, feat)).astype(np.float32)
    mask = _ragged_mask(3, 45) if masked else None
    want = np.asarray(apply(variables, jnp.asarray(x),
                            None if mask is None else jnp.asarray(mask)))
    model = _port(kind, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x), None if mask is None
                    else torch.from_numpy(mask)).numpy()
    assert got.shape == (3, EMB) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_two_emb_layer_and_frame_features_match_jax(jax_models):
    """seg_1, relu, the affine-free seg_bn_1 and seg_2 (ERes2Net Base);
    the frame features (B, T', F' * C), d = f * C + c, of each kind."""
    rng = np.random.default_rng(3)
    module, variables, _ = jax_models["base"]
    variables = {"params": dict(variables["params"], seg_2={
        "kernel": (rng.normal(size=(EMB, EMB)) / 4).astype(np.float32),
        "bias": (0.1 * rng.normal(size=EMB)).astype(np.float32)}),
        "batch_stats": dict(variables["batch_stats"], seg_bn_1={
            "mean": (0.1 * rng.normal(size=EMB)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, EMB).astype(np.float32)})}
    jtwo = KINDS["base"][0](16, two_emb_layer=True)
    x = rng.normal(size=(2, 40, 16)).astype(np.float32)
    want = np.asarray(jax.jit(jtwo.apply)(variables, jnp.asarray(x)))
    model = _port("base", variables, two_emb_layer=True)
    assert model.seg_bn_1.weight is None
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **MODEL_TOL)

    for kind in ("aug", "res2net"):
        module, variables, _ = jax_models[kind]
        feat = KINDS[kind][3]
        x = rng.normal(size=(2, 41, feat)).astype(np.float32)
        want = np.asarray(jax.jit(lambda v, x, mod=module: mod.apply(
            v, x, return_frame_feat=True))(variables, jnp.asarray(x)))
        with torch.no_grad():
            got = _port(kind, variables)(torch.from_numpy(x),
                                         return_frame_feat=True).numpy()
        assert got.shape == want.shape and got.shape[1] == 6
        np.testing.assert_allclose(got, want, **MODEL_TOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_variables_load_strictly_and_map_back(jax_models, kind):
    _, variables, _ = jax_models[kind]
    name = KINDS[kind][2]
    sd = weights.from_jax_variables(variables, name)
    model = KINDS[kind][1](KINDS[kind][3])
    assert set(sd) == set(model.state_dict())
    if kind != "res2net":
        for key in ("layer3.0.conv2_1.weight", "layer3.0.bn2_1.running_var",
                    "layer4.0.fuse_models.0.local_att.4.running_mean",
                    "layer3.0.convs.0.weight", "layer1_downsample.weight",
                    "fuse_mode1234.local_att.0.bias",
                    "layer2.0.shortcut.1.weight"):
            assert key in sd, key
    model.load_state_dict(sd, strict=True)
    want = flatten_dict(variables)
    for back in (weights.to_jax_variables(model.state_dict(), name),
                 jax.device_get(torch_compat.torch_to_flax_variables(
                     model.state_dict(), variables,
                     torch_compat.rules_for(name)))):
        got = flatten_dict(back)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    assert list(weights.rules_for(name)) == [
        tuple(r) for r in torch_compat.rules_for(name)]


@pytest.mark.parametrize("name,depths,width", [
    ("ERes2Net34_Base", (3, 4, 6, 3), 32), ("ERes2Net34_Large",
                                            (3, 4, 6, 3), 64),
    ("ERes2Net34_aug", (3, 4, 6, 3), 64), ("Res2Net34_Base", (3, 4, 6, 3), 32),
    ("Res2Net34_Large", (3, 4, 6, 3), 64)])
def test_registry_builds_every_constructor(name, depths, width):
    model = get_speaker_model(name)(feat_dim=80, embed_dim=192)
    layers = [model.layer1, model.layer2, model.layer3, model.layer4]
    assert tuple(len(x) for x in layers) == depths
    assert model.conv1.out_channels == width
    e = 4 if name.endswith("aug") else 2
    assert model.seg_1.in_features == 2 * 10 * 8 * width * e
    module = eres2net if name.startswith("E") else res2net
    assert getattr(module, name) is get_speaker_model(name)


# ---- two train steps, packed dW on both sides ----

FEAT, NCLS, B = 16, 10, 3
N_SAMPLES = 39 * 160 + 400  # 40 frames
OPT_CONF = {"optimizer": "SGD",
            "optimizer_args": {"momentum": 0.9, "nesterov": True,
                               "weight_decay": 1e-4}}


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
        packed_calls.append((x.shape[-1], dy.shape[-1]))
        return plain(x, dy, **kw)

    monkeypatch.setattr(tdw, "dw_pack", counting)
    jdw.set_conv_dw_mode("packed")
    tdw.set_conv_dw_mode("packed")
    try:
        jmodel = jeres.ERes2Net(8, (1, 1, 1, 1), feat_dim=FEAT,
                                embed_dim=EMB)
        jproj = JArcMargin(EMB, NCLS)
        tx = j_opt(OPT_CONF)
        mvars = numpy_variables(jmodel, jnp.zeros((2, 40, FEAT)), 9,
                                stats=False)
        params = {"model": mvars["params"], "projection": jproj.init(
            jax.random.PRNGKey(1), jnp.zeros((2, EMB)),
            jnp.zeros((2,), jnp.int32))["params"]}
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=mvars["batch_stats"],
                           opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(2), proj_stats={})
        jstep = jax.jit(j_make_train_step(
            jmodel, jproj, tx, jsched.ExponentialDecrease(**lr_kw),
            jsched.MarginScheduler(**m_kw),
            fbank_cfg=JFbankConfig(num_mel_bins=FEAT, dither=0.0),
            aug=JAug(spec_aug=False), compute_dtype=jnp.float32))

        model = eres2net.ERes2Net(8, (1, 1, 1, 1), feat_dim=FEAT,
                                  embed_dim=EMB)
        model.load_state_dict(weights.from_jax_variables(
            {"params": state.params["model"],
             "batch_stats": state.batch_stats}, "ERes2Net"), strict=True)
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
    # a step: the stem (1 -> 8) and the Res2 convs of layers 1-3 (widths
    # 4, 8, 16: two a block in layers 1-2, conv2_1 and convs.0 in layer 3);
    # layer 4's width 32 is eligible too
    assert sorted(packed_calls[:len(packed_calls) // 2]) == sorted(
        [(1, 8), (4, 4), (4, 4), (8, 8), (8, 8), (16, 16), (16, 16),
         (32, 32), (32, 32)])
    assert float(jm["margin"]) > 0

    want = weights.from_jax_variables({"params": state.params["model"],
                                       "batch_stats": state.batch_stats},
                                      "ERes2Net")
    got = model.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            assert int(got[key]) == 2, key
        elif key.endswith("running_var"):
            _rel_close(got[key], value, 1e-4, key)
        elif key.endswith("running_mean"):
            std = float(np.sqrt(np.max(np.asarray(
                want[key[:-len("mean")] + "var"]))))
            err = float((got[key] - torch.as_tensor(value)).abs().max())
            assert err <= 1e-4 * std, f"{key}: max error {err:.3g}"
        elif float((value - before[key]).norm()) < 1e-6:
            # AFF's conv biases feed a train-mode BN, which takes their
            # gradient to zero: both sides' updates are f32 noise
            assert float((got[key] - before[key]).norm()) < 1e-6, key
        else:
            _norm_close(got[key] - before[key], value - before[key], 3e-3,
                        f"update of {key}")
