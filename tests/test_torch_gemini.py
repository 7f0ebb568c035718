"""Port parity for Gemini DF-ResNet: the plain stage function, the whole
model, the extraction forward and the weight carry-over, against the JAX
package on the same numpy inputs, in f32 on the CPU.

- The stage (`ops.inv_bottleneck`) against JAX
  `inv_bottleneck_stage_reference` and its Pallas kernel in interpret mode,
  at L=2, C = 8 and 16, (F, T) = (4, 16), (4, 29) and (3, 58): rtol/atol
  1e-5 (the same f32 arithmetic, sums in another order). Unlike the CAM
  block, the JAX stage kernel zeroes its T padding's h, so it is held to
  the port at unaligned T too.
- The whole model (depths (1, 1, 2, 1), dims (8, 8, 16, 16, 32), embed 24,
  feat 16 and 40, T = 64 and 58, masked and not) against JAX's flax path
  and its `fused_stages=True` path (Pallas interpret), weights through
  `from_jax_variables` with BN statistics perturbed by 0.1 normal noise, as
  tests/test_pallas_ops.py's
  `test_fused_inv_bottleneck_stage_module_matches_standard` perturbs them:
  rtol/atol 1e-4 (f32 sums in another order through 5
  blocks; the differences measure ~4e-7).
- Extraction (`make_eval_embed_fn`) within 1e-4 relative.
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
from wespeaker_tpu.models.gemini_dfresnet import (  # noqa: E402
    Gemini_DF_ResNet as JGemini)
from wespeaker_tpu.ops import inv_bottleneck_pallas as jinv  # noqa: E402
from wespeaker_tpu.train import make_eval_embed_fn as j_embed_fn  # noqa: E402
from wespeaker_tpu.utils import torch_compat  # noqa: E402
from wespeaker_tpu_torch.bin.extract import load_model_for_eval  # noqa
from wespeaker_tpu_torch.frontend import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.models import gemini_dfresnet  # noqa: E402
from wespeaker_tpu_torch.models import get_speaker_model  # noqa: E402
from wespeaker_tpu_torch.models.gemini_dfresnet import (  # noqa: E402
    Gemini_DF_ResNet)
from wespeaker_tpu_torch.ops import inv_bottleneck as tinv  # noqa: E402
from wespeaker_tpu_torch.serving import EmbeddingServer  # noqa: E402
from wespeaker_tpu_torch.train import make_eval_embed_fn  # noqa: E402
from wespeaker_tpu_torch.utils import weights  # noqa: E402
from wespeaker_tpu_torch.utils.config import (  # noqa: E402
    parse_config_or_kwargs)

torch.set_num_threads(2)
NAME = "Gemini_DF_ResNet114"  # any Gemini name chooses the same rules
KW = dict(depths=(1, 1, 2, 1), dims=(8, 8, 16, 16, 32), embed_dim=24)
STAGE_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


# ---- the stage ----

def _stage_args(rng, num_blocks, c):
    def r(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    L, d = num_blocks, 4 * c
    return dict(w1=r(L, c, d, s=c ** -0.5), s1=1 + r(L, d, s=.1),
                t1=r(L, d, s=.1), wdw=r(L, 3, 3, d, s=1 / 3),
                s2=1 + r(L, d, s=.1), t2=r(L, d, s=.1),
                w2=r(L, d, c, s=d ** -0.5), s3=1 + r(L, c, s=.1),
                t3=r(L, c, s=.1))


def _stage_case(c, f, t):
    rng = np.random.default_rng(100 * c + t)
    x = rng.normal(size=(2, f, t, c)).astype(np.float32)  # JAX's layout
    return x, _stage_args(rng, 2, c)


def _port_stage(x, args):
    """The port's stage on JAX's (B, F, T, C) array: the channels-last
    (B, C, F, T) view of the same storage in, the JAX layout out."""
    out = tinv.fused_inv_bottleneck_stage(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        **{k: torch.from_numpy(v) for k, v in args.items()})
    assert out.is_contiguous(memory_format=torch.channels_last)
    return out.permute(0, 2, 3, 1).numpy()


STAGE_SHAPES = [(4, 16), (4, 29), (3, 58)]


@pytest.mark.parametrize("f,t", STAGE_SHAPES)
@pytest.mark.parametrize("c", [8, 16])
def test_stage_plain_matches_jax_reference(c, f, t):
    x, args = _stage_case(c, f, t)
    want = np.asarray(jinv.inv_bottleneck_stage_reference(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in args.items()}))
    got = _port_stage(x, args)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, **STAGE_TOL)


@pytest.mark.parametrize("f,t", STAGE_SHAPES)
@pytest.mark.parametrize("c", [8, 16])
def test_stage_plain_matches_jax_kernel(c, f, t):
    """The Pallas kernel (interpret mode) pads T to a multiple of 16 and
    zeroes the pad frames' h, so its boundary taps read zeros as the port's
    do: equal at T = 29 and 58 too."""
    x, args = _stage_case(c, f, t)
    want = np.asarray(jinv.fused_inv_bottleneck_stage(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in args.items()},
        interpret=True))
    np.testing.assert_allclose(_port_stage(x, args), want, **STAGE_TOL)


def test_stage_launch_counter_stays_put_on_cpu(monkeypatch):
    """A CPU tensor takes the plain version, and so does a Gemini eval
    forward on the CPU, which calls the stage wrapper once per stage:
    nothing is launched."""
    x, args = _stage_case(8, 4, 16)
    before = tinv.fused_inv_bottleneck_stage.launches
    _port_stage(x, args)
    calls = []

    def counting(*a):
        calls.append(a[0].shape)
        return tinv.fused_inv_bottleneck_stage(*a)

    monkeypatch.setattr(gemini_dfresnet, "fused_inv_bottleneck_stage",
                        counting)
    torch.manual_seed(0)
    model = Gemini_DF_ResNet(**KW, feat_dim=16).eval()
    with torch.no_grad():
        model(torch.zeros(1, 20, 16))
        assert len(calls) == 4
        model.set_fused(False)(torch.zeros(1, 20, 16))
        model.set_fused(True).train()(torch.zeros(2, 20, 16))
    assert len(calls) == 4
    assert tinv.fused_inv_bottleneck_stage.launches == before


def test_stage_wrapper_refuses_what_it_does_not_take():
    """A map that is not channels-last, weights of another width or depth
    and a device without a kernel raise (before any launch); the CUDA
    checks refuse a type or a width the kernel does not take."""
    x, args = _stage_case(8, 4, 16)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    targs = {k: torch.from_numpy(v) for k, v in args.items()}
    with pytest.raises(ValueError, match="channels-last"):
        tinv.fused_inv_bottleneck_stage(xt.contiguous(), **targs)
    with pytest.raises(ValueError, match="channels-last"):
        tinv.fused_inv_bottleneck_stage(torch.from_numpy(x[0]), **targs)
    for name, shape in (("w1", (2, 8, 16)), ("wdw", (2, 3, 3, 16)),
                        ("w2", (2, 32, 4)), ("s3", (3, 8)),
                        ("t1", (2, 30))):
        with pytest.raises(ValueError, match=name):
            tinv.fused_inv_bottleneck_stage(
                xt, **dict(targs, **{name: torch.zeros(shape)}))
    meta = torch.empty(2, 4, 16, 8, device="meta").permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="no kernel"):
        tinv.fused_inv_bottleneck_stage(meta, **targs)
    with pytest.raises(TypeError, match="f32 or bf16"):
        tinv._check_cuda_args(xt.half())
    with pytest.raises(ValueError, match="multiple of 32"):
        tinv._check_cuda_args(xt)
    tinv._check_cuda_args(torch.zeros(1, 32, 3, 5).to(
        memory_format=torch.channels_last))


# ---- the whole model ----

def _perturbed(variables, seed):
    """BN statistics plus 0.1 normal noise (as tests/test_pallas_ops.py
    perturbs them for its Gemini test); a numpy tree."""
    rng = np.random.default_rng(seed)
    flat = flatten_dict(jax.device_get(variables))
    for path, v in flat.items():
        v = np.asarray(v, np.float32)
        if path[0] == "batch_stats":
            v = v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
        flat[path] = v
    return unflatten_dict(flat)


def _pooled_width(feat):
    f = feat
    for _ in range(4):
        f = (f - 1) // 2 + 1
    return 2 * f * KW["dims"][-1]  # TSTP: mean and std


class JaxGemini:
    """JAX Gemini at the test size: the module, jitted applies of its flax
    path and of its fused Pallas path (interpreted on the CPU), and its
    variables."""

    def __init__(self, feat, variables, **extra):
        self.module = JGemini(**KW, feat_dim=feat, **extra)
        fused = JGemini(**KW, feat_dim=feat, fused_stages=True, **extra)
        self.std = jax.jit(lambda v, x, m: self.module.apply(v, x, mask=m))
        self.fused = jax.jit(lambda v, x, m: fused.apply(v, x, mask=m))
        self.variables = variables


@pytest.fixture(scope="module")
def jax_gemini():
    """Feat 16 and 40 and, at feat 16, two_emb_layer. One init (at feat 16,
    BN statistics perturbed); the other trees differ from it only in the
    head, whose parameters are drawn here."""
    init = JGemini(**KW, feat_dim=16).init
    base = _perturbed(jax.jit(init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 16))), seed=16)
    rng = np.random.default_rng(40)
    emb = KW["embed_dim"]

    def head(width):
        return {"kernel": (rng.normal(size=(width, emb)) * width ** -0.5
                           ).astype(np.float32),
                "bias": (0.1 * rng.normal(size=emb)).astype(np.float32)}

    wide = {"params": dict(base["params"], seg_1=head(_pooled_width(40))),
            "batch_stats": base["batch_stats"]}
    two = {"params": dict(base["params"], seg_2=head(emb)),
           "batch_stats": dict(base["batch_stats"], seg_bn_1={
               "mean": (0.1 * rng.normal(size=emb)).astype(np.float32),
               "var": rng.uniform(0.5, 1.5, emb).astype(np.float32)})}
    return {16: JaxGemini(16, base), 40: JaxGemini(40, wide),
            "two": JaxGemini(16, two, two_emb_layer=True)}


def _port(variables, feat, **extra):
    model = Gemini_DF_ResNet(**KW, feat_dim=feat, **extra)
    model.load_state_dict(weights.from_jax_variables(variables, NAME),
                          strict=True)
    return model.eval()


def _ragged_mask(b, t):
    m = np.ones((b, t), np.float32)
    m[1, (t * 2) // 3:] = 0
    return m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t", [64, 58])
@pytest.mark.parametrize("feat", [16, 40])
def test_gemini_matches_jax(jax_gemini, feat, t, masked):
    """The port's stage calls (plain on the CPU) and its block-by-block path
    against JAX's flax path and its fused Pallas path."""
    jg = jax_gemini[feat]
    rng = np.random.default_rng(feat + t)
    x = rng.normal(size=(3, t, feat)).astype(np.float32)
    mask = _ragged_mask(3, t) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jg.std(jg.variables, jnp.asarray(x), jm))
    want_fused = np.asarray(jg.fused(jg.variables, jnp.asarray(x), jm))
    model = _port(jg.variables, feat)
    tm = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        got = model(torch.from_numpy(x), tm).numpy()
        got_blocks = model.set_fused(False)(torch.from_numpy(x), tm).numpy()
    assert got.shape == (3, KW["embed_dim"]) and got.dtype == np.float32
    for a in (got, got_blocks):
        np.testing.assert_allclose(a, want, **MODEL_TOL)
        np.testing.assert_allclose(a, want_fused, **MODEL_TOL)


def test_return_frame_feat_matches_jax(jax_gemini):
    """(B, T', F' * C) with d = f * C + c, at feat 40 (F' = 3)."""
    jg = jax_gemini[40]
    x = np.random.default_rng(5).normal(size=(2, 58, 40)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jg.module.apply(
        v, x, return_frame_feat=True))(jg.variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(jg.variables, 40)(torch.from_numpy(x),
                                   return_frame_feat=True).numpy()
    assert got.shape == want.shape == (2, 29, 3 * 32)
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_two_emb_layer_matches_jax(jax_gemini):
    """seg_1, relu, the affine-free seg_bn_1 and seg_2."""
    jg = jax_gemini["two"]
    x = np.random.default_rng(6).normal(size=(2, 58, 16)).astype(np.float32)
    want = np.asarray(jg.std(jg.variables, jnp.asarray(x), None))
    model = _port(jg.variables, 16, two_emb_layer=True)
    assert model.seg_bn_1.weight is None
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_make_eval_embed_fn_matches_jax(jax_gemini):
    jg = jax_gemini[40]
    rng = np.random.default_rng(8)
    wav = rng.uniform(-0.5, 0.5, (2, 12000)).astype(np.float32)
    mask = np.ones_like(wav)
    mask[1, 8000:] = 0
    batch = {"wav": wav, "mask": mask}
    fn = jax.jit(j_embed_fn(jg.module, JFbankConfig(num_mel_bins=40)))
    want = np.asarray(fn(jg.variables, {k: jnp.asarray(v)
                                        for k, v in batch.items()}))
    got = make_eval_embed_fn(_port(jg.variables, 40),
                             FbankConfig(num_mel_bins=40),
                             device="cpu")(batch).numpy()
    assert got.shape == (2, KW["embed_dim"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


# ---- weights ----

def test_gemini_variables_load_strictly_and_map_back(jax_gemini):
    """from_jax_variables gives exactly the port's state_dict keys (the
    stem's and downsamples' Sequential indices, the depthwise (4C, 1, 3, 3)
    weights), seg_1 is sized from the true F' (3 at feat 40, where
    (feat // 16) * 32 says 64 of 96), and the JAX package's own converter
    maps the port's state_dict back to the same variables."""
    variables = jax_gemini[40].variables
    sd = weights.from_jax_variables(variables, NAME)
    model = Gemini_DF_ResNet(**KW, feat_dim=40)
    assert set(sd) == set(model.state_dict())
    assert tuple(sd["stages.2.1.conv2.weight"].shape) == (64, 1, 3, 3)
    assert tuple(sd["downsample_layers.0.0.weight"].shape) == (8, 1, 3, 3)
    assert model.seg_1.in_features == 2 * 3 * 32
    model.load_state_dict(sd, strict=True)
    back = torch_compat.torch_to_flax_variables(
        model.state_dict(), variables, torch_compat.rules_for(NAME))
    want = flatten_dict(variables)
    got = flatten_dict(jax.device_get(back))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_rules_are_the_jax_packages():
    assert list(weights.rules_for(NAME)) == [
        tuple(r) for r in torch_compat.rules_for(NAME)]
    assert weights.rules_for("Gemini_DF_ResNet60") == weights.rules_for(NAME)


@pytest.mark.parametrize("name,depths", [
    ("Gemini_DF_ResNet60", (3, 3, 9, 3)),
    ("Gemini_DF_ResNet114", (3, 3, 27, 3)),
    ("Gemini_DF_ResNet183", (3, 8, 45, 3)),
    ("Gemini_DF_ResNet237", (3, 8, 63, 3))])
def test_registry_builds_every_constructor(name, depths):
    """gemini_dfresnet_adam.yaml's model_args build each constructor with
    the JAX package's depths and dims, TSTP pooled at 2 x 5 x 256."""
    model = get_speaker_model(name)(feat_dim=80, embed_dim=256,
                                    pooling_func="TSTP", two_emb_layer=False)
    assert isinstance(model, Gemini_DF_ResNet)
    assert tuple(len(s) for s in model.stages) == depths
    assert [s[0].conv1.in_channels for s in model.stages] == [32, 32, 64,
                                                              128, 256][1:]
    assert model.seg_1.in_features == 2 * 5 * 256
    assert model.fused_stages is None
    assert getattr(gemini_dfresnet, name) is get_speaker_model(name)


# ---- serving ----

def test_gemini_yaml_serves_on_cpu(tmp_path):
    """examples/voxceleb/v2/conf/gemini_dfresnet_adam.yaml and a torch
    state_dict give a server (device="cpu") whose concurrent replies equal
    the extractor's embedding of each utterance padded and masked to its
    bucket (the same function: within 1e-4 relative)."""
    conf = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "voxceleb" / "v2" / "conf" / "gemini_dfresnet_adam.yaml")
    configs = parse_config_or_kwargs(str(conf))
    assert configs["model"] == NAME
    torch.manual_seed(0)
    ckpt = tmp_path / "gemini.pt"
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
