"""Port parity for the x-vector, the xi-vectors, SimAM-ResNet and
RepVGG/RepSPK (train and deploy form, the deploy conversion and its CLI),
and ECAPA's frame features, against the JAX package on the same seeded
numpy inputs and weights (tests/torch_zoo_util.py), in f32 on the CPU.

- The models, narrow (embed 16): XVEC (feat 16, hidden 16, stats 24) with
  TSTP and with XI pooling (T = 40, 14 frames lost to the unpadded convs,
  the mask cut as `mask[:, 14:]`), XI_VEC_ECAPA_TDNN at C = 32, SimAM-ResNet
  (in_planes 4, blocks (1, 1, 1, 1), feat 16; both packages take the same
  padded input, since SimAM's energy spans the padding), RepVGG (widths 8
  to 64, blocks (1, 2, 1, 1), a grouped block of 2 groups with identity
  branch) and RepSPK (blocks (1, 1, 1, 1), SE on), masked and not, in
  eval: rtol/atol 1e-4. Each deploy form, on the port's own conversion of
  the train form, against JAX's deploy model on `convert_repvgg_variables`
  (1e-4) and against the port's train form (1e-5); the conversion
  against `convert_repvgg_variables` leaf by leaf at 1e-6.
- bin/convert_repvgg.py on a trainer's `.pt` and on a JAX `.ckpt`: the
  `.ckpt` it writes equals `convert_repvgg_variables` at 1e-6, and both
  load strictly into the deploy model through load_checkpoint.
- The flax trees load strictly into the upstream-named modules and map
  back exactly; the rules are torch_compat's; the registry builds every
  constructor.
- ECAPA's `return_frame_feat` (the MFA conv's output) against JAX.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from tests.test_torch_resnet import _ragged_mask  # noqa: E402
from tests.torch_zoo_util import numpy_variables  # noqa: E402
from wespeaker_tpu.models import ecapa_tdnn as jecapa  # noqa: E402
from wespeaker_tpu.models import repvgg as jrep  # noqa: E402
from wespeaker_tpu.models import samresnet as jsam  # noqa: E402
from wespeaker_tpu.models import tdnn as jtdnn  # noqa: E402
from wespeaker_tpu.utils import torch_compat  # noqa: E402
from wespeaker_tpu_torch.bin import convert_repvgg  # noqa: E402
from wespeaker_tpu.models import get_speaker_model as j_get  # noqa: E402
from wespeaker_tpu_torch.models import (ecapa_tdnn, get_speaker_model,  # noqa
                                        repvgg, samresnet, tdnn)
from wespeaker_tpu_torch.utils import weights  # noqa: E402
from wespeaker_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, read_msgpack_checkpoint, save_msgpack_checkpoint)

torch.set_num_threads(2)
EMB, FEAT, T = 16, 16, 40
TOL = dict(rtol=1e-4, atol=1e-4)
_REP = dict(strides=(1, 1, 2, 2, 2), feat_dim=FEAT, embed_dim=EMB)
# kind -> (JAX module, port constructor, model name for the rules)
KINDS = {
    "xvec": (lambda: jtdnn.XVEC(FEAT, 16, 24, EMB),
             lambda: tdnn.XVEC(FEAT, 16, 24, EMB), "XVEC"),
    "xvec-xi": (lambda: jtdnn.XVEC(FEAT, 16, 24, EMB, pooling_func="XI"),
                lambda: tdnn.XVEC(FEAT, 16, 24, EMB, pooling_func="XI"),
                "XI_VEC"),
    "ecapa-xi": (lambda: jecapa.ECAPA_TDNN(32, FEAT, EMB, "XI"),
                 lambda: ecapa_tdnn.ECAPA_TDNN(32, FEAT, EMB, "XI"),
                 "XI_VEC_ECAPA_TDNN_c512"),
    "simam": (lambda: jsam.SimAM_ResNet_ASP(4, (1, 1, 1, 1), EMB, FEAT),
              lambda: samresnet.SimAM_ResNet_ASP(4, (1, 1, 1, 1), EMB, FEAT),
              "SimAM_ResNet34_ASP"),
    "repvgg": (lambda **kw: jrep.RepVGG(
        (1, 2, 1, 1), width_multiplier=(0.125,) * 4,
        override_groups_map={2: 2}, **_REP, **kw),
        lambda **kw: repvgg.RepVGG(
            (1, 2, 1, 1), width_multiplier=(0.125,) * 4,
            override_groups_map={2: 2}, **_REP, **kw), "REPVGG_A0"),
    "repspk": (lambda **kw: jrep.RepVGG(
        (1, 1, 1, 1), width_multiplier=(0.125,) * 4, block="RepSPK",
        use_se=True, **_REP, **kw),
        lambda **kw: repvgg.RepVGG(
            (1, 1, 1, 1), width_multiplier=(0.125,) * 4, block="RepSPK",
            use_se=True, **_REP, **kw), "REPVGG_RSBB_A0"),
}


def _port(kind, variables, **kw):
    """The port's model on the JAX variables, its rules chosen by its
    class name as the port's loader chooses them."""
    model = KINDS[kind][1](**kw)
    model.load_state_dict(weights.from_jax_variables(
        variables, type(model).__name__), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def jax_models():
    """{kind: (module, variables, jitted apply)}."""
    out = {}
    for i, (kind, (jmod, _, _)) in enumerate(KINDS.items()):
        module = jmod()
        variables = numpy_variables(module, jnp.zeros((1, T, FEAT)), i)
        apply = jax.jit(lambda v, x, m, mod=module: mod.apply(v, x, mask=m))
        out[kind] = (module, variables, apply)
    return out


def _inputs(seed, masked):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, T, FEAT)).astype(np.float32)
    mask = _ragged_mask(3, T) if masked else None
    return x, mask


def _run(model, x, mask, **kw):
    with torch.no_grad():
        return model(torch.from_numpy(x), None if mask is None
                     else torch.from_numpy(mask), **kw).numpy()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
def test_model_matches_jax(jax_models, kind, masked):
    _, variables, apply = jax_models[kind]
    x, mask = _inputs(len(kind) + masked, masked)
    want = np.asarray(apply(variables, jnp.asarray(x),
                            None if mask is None else jnp.asarray(mask)))
    got = _run(_port(kind, variables), x, mask)
    assert got.shape == (3, EMB) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_variables_load_strictly_and_map_back(jax_models, kind):
    _, variables, _ = jax_models[kind]
    name = KINDS[kind][2]
    model = KINDS[kind][1]()
    pname = type(model).__name__
    sd = weights.from_jax_variables(variables, pname)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    want = flatten_dict(variables)
    for back in (weights.to_jax_variables(model.state_dict(), pname),
                 jax.device_get(torch_compat.torch_to_flax_variables(
                     model.state_dict(), variables,
                     torch_compat.rules_for(name)))):
        got = flatten_dict(back)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    # the port's class name chooses torch_compat's rules for the model's
    # name: no family rule of its own, and none of torch_compat's missing
    # once each package's COMMON_RULES (applied to every family) are added
    jrules = {tuple(r) for r in torch_compat.rules_for(name)}
    assert jrules and set(weights.rules_for(pname)) <= jrules
    assert jrules | {tuple(r) for r in torch_compat.COMMON_RULES} <= (
        set(weights.rules_for(pname)) | set(weights.COMMON_RULES))


@pytest.mark.parametrize("kind", ["repvgg", "repspk"])
def test_repvgg_deploy_matches_jax_and_the_train_form(jax_models, kind):
    _, variables, apply = jax_models[kind]
    block = "RepVGG" if kind == "repvgg" else "RepSPK"
    want_tree = flatten_dict(jrep.convert_repvgg_variables(variables, block))
    train = _port(kind, variables)
    deploy_sd = repvgg.convert_repvgg_state_dict(train.state_dict(), block)
    got_tree = flatten_dict(weights.to_jax_variables(deploy_sd, "RepVGG"))
    assert set(got_tree) == {k for k in want_tree if k[0] == "params"}
    for k, v in got_tree.items():
        np.testing.assert_allclose(v, np.asarray(want_tree[k]), rtol=1e-6,
                                   atol=1e-6)
    deploy = KINDS[kind][1](deploy=True)
    deploy.load_state_dict(deploy_sd, strict=True)
    deploy.eval()
    jdeploy = KINDS[kind][0](deploy=True)
    for masked in (False, True):
        x, mask = _inputs(7 + masked, masked)
        want = np.asarray(jax.jit(lambda v, x, m: jdeploy.apply(
            v, x, mask=m))(jrep.convert_repvgg_variables(variables, block),
                           jnp.asarray(x),
                           None if mask is None else jnp.asarray(mask)))
        got = _run(deploy, x, mask)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, _run(train, x, mask), rtol=1e-5,
                                   atol=1e-5)


def test_convert_repvgg_cli_on_pt_and_ckpt(jax_models, tmp_path):
    _, variables, _ = jax_models["repvgg"]
    train = _port("repvgg", variables)
    pt = tmp_path / "train.pt"
    torch.save({"state_dict": train.state_dict(),
                "projection": {"weight": torch.zeros(3, EMB)}}, pt)
    ckpt = tmp_path / "train.ckpt"
    save_msgpack_checkpoint(str(ckpt), {
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "projection": {"weight": np.zeros((3, EMB), np.float32)}})
    want = flatten_dict(jrep.convert_repvgg_variables(variables, "RepVGG"))
    x, mask = _inputs(3, True)
    ref = _run(train, x, mask)
    for src in (pt, ckpt):
        dst = tmp_path / f"deploy{src.suffix}"
        convert_repvgg.main(["--checkpoint", str(src), "--save_path",
                             str(dst)])
        if src.suffix == ".ckpt":
            tree = flatten_dict(read_msgpack_checkpoint(str(dst)))
            assert set(tree) == {k for k in want if k[0] == "params"}
            for k, v in tree.items():
                np.testing.assert_allclose(np.asarray(v),
                                           np.asarray(want[k]), rtol=1e-6,
                                           atol=1e-6)
        deploy = load_checkpoint(str(dst), KINDS["repvgg"][1](deploy=True))
        np.testing.assert_allclose(_run(deploy.eval(), x, mask), ref,
                                   rtol=1e-5, atol=1e-5)


def test_ecapa_frame_features_match_jax(jax_models):
    """return_frame_feat: the MFA conv's output (B, T, 1536), masked (the
    SE squeeze sees the mask)."""
    module, variables, _ = jax_models["ecapa-xi"]
    x, mask = _inputs(11, True)
    want = np.asarray(jax.jit(lambda v, x, m: module.apply(
        v, x, mask=m, return_frame_feat=True))(
            variables, jnp.asarray(x), jnp.asarray(mask)))
    got = _run(_port("ecapa-xi", variables), x, mask, return_frame_feat=True)
    assert got.shape == want.shape == (3, T, 1536)
    np.testing.assert_allclose(got, want, **TOL)


def test_frame_features_of_the_2d_families(jax_models):
    """SimAM-ResNet's and RepVGG's (B, T', F' * C), d = f * C + c, and the
    x-vector's (B, T - 14, stats)."""
    x, _ = _inputs(12, False)
    for kind in ("simam", "repvgg", "xvec"):
        module, variables, _ = jax_models[kind]
        want = np.asarray(jax.jit(lambda v, x, mod=module: mod.apply(
            v, x, return_frame_feat=True))(variables, jnp.asarray(x)))
        got = _run(_port(kind, variables), x, None, return_frame_feat=True)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", [
    "XVEC", "XI_VEC_XVEC", "XI_VEC_ECAPA_TDNN_c512",
    "XI_VEC_ECAPA_TDNN_c1024", "SimAM_ResNet34_ASP", "SimAM_ResNet100_ASP"]
    + [n for n in dir(jrep) if n.startswith("REPVGG_")])
def test_registry_builds_every_constructor(name):
    """Every constructor at the YAMLs' widths (feat 80), built on the meta
    device (shapes only): the RepVGGs with the JAX constructor's depths,
    widths, groups, block and SE, the rest with the JAX package's
    parameter count (jax.eval_shape)."""
    kw = ({} if name.startswith("SimAM") else
          {"feat_dim": 80, "embed_dim": 256})
    with torch.device("meta"):
        model = get_speaker_model(name)(**kw)
    jmodule = j_get(name)(**kw)
    if name.startswith("REPVGG"):
        blocks = [b for i in range(1, 5) for b in getattr(model, f"stage{i}")]
        assert [len(getattr(model, f"stage{i}")) for i in range(1, 5)] == \
            list(jmodule.num_blocks)
        assert blocks[-1].rbr_dense.conv.out_channels == int(
            512 * jmodule.width_multiplier[3])
        groups = jmodule.override_groups_map or {}
        assert [b.rbr_dense.conv.groups for b in blocks] == [
            groups.get(i, 1) for i in range(1, len(blocks) + 1)]
        assert (blocks[0].se is not None) == jmodule.use_se
        assert type(blocks[0]).__name__ == jmodule.block + "Block"
        return
    shapes = jax.eval_shape(lambda: jmodule.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 200, 80))))
    want = sum(int(np.prod(s.shape)) for p, s in flatten_dict(
        shapes).items() if p[0] == "params")
    assert sum(p.numel() for p in model.parameters()) == want


def test_deploy_conversion_keeps_what_lies_outside_the_stages():
    """A RepVGG pooled by ASP: the conversion fuses the stages and keeps
    the pooling's BatchNorm statistics, so the deploy form loads strictly
    (the JAX package's convert_repvgg_variables drops every batch_stats
    leaf outside the stages, ROADMAP.md Queue 3)."""
    torch.manual_seed(0)
    kw = dict(width_multiplier=(0.125,) * 4, pooling_func="ASP", **_REP)
    train = repvgg.RepVGG((1, 1, 1, 1), **kw).eval()
    deploy_sd = repvgg.convert_repvgg_state_dict(train.state_dict())
    assert "pool.attention.2.running_var" in deploy_sd
    deploy = repvgg.RepVGG((1, 1, 1, 1), deploy=True, **kw).eval()
    deploy.load_state_dict(deploy_sd, strict=True)
    x, mask = _inputs(13, True)
    np.testing.assert_allclose(_run(deploy, x, mask), _run(train, x, mask),
                               rtol=1e-5, atol=1e-5)
    jtree = jrep.convert_repvgg_variables(
        weights.to_jax_variables(train.state_dict(), "RepVGG"))
    assert not jtree["batch_stats"]
