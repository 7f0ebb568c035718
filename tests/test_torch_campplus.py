"""Port parity for CAM++: the plain dense-block function, the whole CAMPPlus
(eval and train mode), the extraction forward and the weight carry-over,
against the JAX package on the same numpy inputs, in f32 on the CPU.

- The block (`ops.cam_block`) against JAX `cam_dense_block_reference` and
  its Pallas kernel in interpret mode, at L=3, C0=64, B=2, T' = 37, 48,
  250 and 256 (250 and 256: three segments, the last one partial),
  dilation 1 and 2, with and without a ragged mask: rtol/atol 1e-5 (the
  same f32 arithmetic, sums in another order). The Pallas kernel pads T'
  to a multiple of 16 and its pad frames' nonzero h leak into the last d
  real frames' t+d tap, so it is held to the port only where it pads
  nothing (48, 256); `test_jax_kernel_pad_frames_leak_into_the_last_taps`
  records the difference.
- The whole model (feat 40, embed 32, the fixed 12/24/16 layers) against
  JAX `CAMPPlus(fused_blocks=False)`, weights through `from_jax_variables`
  with randomised BN statistics and biases: rtol/atol 5e-4 and cosine >=
  0.99999, the bound of the JAX package's own fused-vs-standard test
  (tests/test_pallas_ops.py::test_fused_cam_dense_block_module_matches_standard):
  sums in another order compound through 52 dense layers.
  `return_frame_feat` (the trunk's frame features) at the same bound.
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
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict, unflatten_dict  # noqa: E402

from wespeaker_tpu.frontend import FbankConfig as JFbankConfig  # noqa: E402
from wespeaker_tpu.models.campplus import CAMPPlus as JCAMPPlus  # noqa: E402
from wespeaker_tpu.ops import cam_block_pallas as jcam  # noqa: E402
from wespeaker_tpu.train import make_eval_embed_fn as j_embed_fn  # noqa: E402
from wespeaker_tpu.utils import torch_compat  # noqa: E402
from wespeaker_tpu_torch.bin.extract import load_model_for_eval  # noqa
from wespeaker_tpu_torch.frontend import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.models import get_speaker_model  # noqa: E402
from wespeaker_tpu_torch.models.campplus import CAMPPlus  # noqa: E402
from wespeaker_tpu_torch.ops import cam_block as tcam  # noqa: E402
from wespeaker_tpu_torch.serving import EmbeddingServer  # noqa: E402
from wespeaker_tpu_torch.train import make_eval_embed_fn  # noqa: E402
from wespeaker_tpu_torch.utils import weights  # noqa: E402
from wespeaker_tpu_torch.utils.config import (  # noqa: E402
    parse_config_or_kwargs)

torch.set_num_threads(2)
FEAT, EMB = 40, 32
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=5e-4, atol=5e-4)


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _model_close(got, want):
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    assert _cosines(got, want).min() >= 0.99999, _cosines(got, want)


# ---- the dense block ----

def _block_args(rng, num_layers, c0):
    """Stacked layer weights with the input rows zero-padded to C_end, as
    the models pass them."""
    cend = c0 + 32 * num_layers

    def r(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    s1 = np.zeros((num_layers, cend), np.float32)
    t1 = np.zeros((num_layers, cend), np.float32)
    w1 = np.zeros((num_layers, cend, 128), np.float32)
    for i in range(num_layers):
        ci = c0 + 32 * i
        s1[i, :ci] = 1 + r(ci, s=.1)
        t1[i, :ci] = r(ci, s=.1)
        w1[i, :ci] = r(ci, 128, s=ci ** -0.5)
    return dict(s1=s1, t1=t1, w1=w1, s2=1 + r(num_layers, 128, s=.1),
                t2=r(num_layers, 128, s=.1),
                w2=r(num_layers, 3, 128, 32, s=384 ** -0.5),
                wc1=r(num_layers, 128, 64, s=128 ** -0.5),
                bc1=r(num_layers, 64, s=.1),
                wc2=r(num_layers, 64, 32, s=64 ** -0.5),
                bc2=r(num_layers, 32, s=.1))


def _ragged_mask(b, t):
    m = np.ones((b, t), np.float32)
    m[1, (t * 7) // 10:] = 0  # T'=250: 175 valid, the third segment empty
    return m


def _block_case(seed, t, num_layers, masked):
    rng = np.random.default_rng(seed)
    args = _block_args(rng, num_layers, 64)
    x = rng.normal(size=(2, t, 64)).astype(np.float32)
    return x, args, _ragged_mask(2, t) if masked else None


def _port_block(x, args, dilation, mask):
    return tcam.fused_cam_dense_block(
        torch.from_numpy(x), **{k: torch.from_numpy(v)
                                for k, v in args.items()},
        dilation=dilation,
        mask=None if mask is None else torch.from_numpy(mask)).numpy()


def _jax_block(x, args, dilation, mask, kernel):
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    jmask = None if mask is None else jnp.asarray(mask)
    if kernel:
        return np.asarray(jcam.fused_cam_dense_block(
            jnp.asarray(x), **jargs, dilation=dilation, mask=jmask,
            interpret=True))
    return np.asarray(jcam.cam_dense_block_reference(
        jnp.asarray(x), **jargs, dilation=dilation, mask=jmask))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("t", [37, 48, 250, 256])
def test_cam_block_plain_matches_jax(t, dilation, masked):
    x, args, mask = _block_case(t + 10 * dilation, t, 3, masked)
    got = _port_block(x, args, dilation, mask)
    assert got.shape == (2, t, 64 + 32 * 3)
    np.testing.assert_array_equal(got[..., :64], x)
    np.testing.assert_allclose(got, _jax_block(x, args, dilation, mask,
                                               kernel=False), **BLOCK_TOL)
    if t % 16 == 0:  # the Pallas kernel pads no frame
        np.testing.assert_allclose(got, _jax_block(x, args, dilation, mask,
                                                   kernel=True), **BLOCK_TOL)


@pytest.mark.parametrize("t,dilation", [(37, 1), (250, 2)])
def test_jax_kernel_pad_frames_leak_into_the_last_taps(t, dilation):
    """JAX's Pallas block pads T' to a multiple of 16 and zeroes only the
    pad frames' y: their h, nonzero, is the t+d tap of the last d real
    frames. For one layer the kernel differs from its own reference in
    exactly those frames; the port, which pads nothing, agrees with the
    reference everywhere (within more layers the difference reaches every
    frame through the context means)."""
    x, args, _ = _block_case(0, t, 1, False)
    got = _port_block(x, args, dilation, None)
    want = _jax_block(x, args, dilation, None, kernel=False)
    pallas = _jax_block(x, args, dilation, None, kernel=True)
    np.testing.assert_allclose(got, want, **BLOCK_TOL)
    differ = np.abs(pallas - want).max(axis=(0, 2)) > 1e-3
    assert np.nonzero(differ)[0].tolist() == list(range(t - dilation, t))


def _small_block(rng, t=21):
    args = {k: torch.from_numpy(v) for k, v in _block_args(rng, 2, 64).items()}
    return torch.from_numpy(rng.normal(size=(1, t, 64)).astype(np.float32)), \
        args


def test_cam_block_launch_counter_stays_put_on_cpu():
    """A CPU tensor takes the plain version, and so does a CAMPPlus eval
    forward on the CPU: nothing is launched."""
    x, args = _small_block(np.random.default_rng(0))
    before = tcam.fused_cam_dense_block.launches
    tcam.fused_cam_dense_block(x, **args, dilation=2)
    torch.manual_seed(0)
    with torch.no_grad():
        CAMPPlus(FEAT, EMB).eval()(torch.zeros(1, 40, FEAT))
    assert tcam.fused_cam_dense_block.launches == before


def test_cam_block_refuses_what_the_kernel_does_not_take():
    """Devices without a kernel raise, as do shapes and types the CUDA
    kernel does not take (checked before any launch)."""
    x = torch.empty(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tcam.fused_cam_dense_block(x, *([x] * 10), dilation=1)
    x, args = _small_block(np.random.default_rng(1))

    def check(x=x, mask=None, seg_len=100, **over):
        a = dict(args, **over)
        tcam._check_cuda_args(x, a["s1"], a["w1"], a["w2"], a["wc1"],
                              a["wc2"], mask, seg_len)

    check()  # the kernel's own shapes pass
    with pytest.raises(TypeError, match="f32 or bf16"):
        check(x=x.half())
    with pytest.raises(ValueError, match="growth"):
        check(w2=torch.zeros(2, 3, 128, 16))
    with pytest.raises(ValueError, match="growth"):
        check(w2=torch.zeros(2, 3, 64, 32))
    with pytest.raises(ValueError, match="w1"):
        check(w1=torch.zeros(2, 128, 64))
    with pytest.raises(ValueError, match="gate"):
        check(wc1=torch.zeros(2, 128, 32))
    with pytest.raises(ValueError, match="mask"):
        check(mask=torch.ones(1, 20))
    with pytest.raises(ValueError, match="multiple of 32"):
        check(x=torch.zeros(1, 21, 48), s1=torch.zeros(2, 112),
              w1=torch.zeros(2, 112, 128))


# ---- the whole model ----

def _randomised(variables, seed):
    """BN statistics and affines and every bias randomised, so that BN
    folding and the biases are exercised; a numpy tree."""
    rng = np.random.default_rng(seed)
    flat = flatten_dict(jax.device_get(variables))
    for path, v in flat.items():
        v = np.asarray(v, np.float32)
        if path[-1] == "mean":
            v = 0.1 * rng.normal(size=v.shape)
        elif path[-1] == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif path[-1] == "scale":
            v = 1 + 0.1 * rng.normal(size=v.shape)
        elif path[-1] == "bias":
            v = 0.1 * rng.normal(size=v.shape)
        flat[path] = v.astype(np.float32)
    return unflatten_dict(flat)


@pytest.fixture(scope="module")
def jax_campplus():
    """JAX CAMPPlus(fused_blocks=False) at feat 40, embed 32, its
    randomised variables and a jitted eval apply."""
    jmodel = JCAMPPlus(feat_dim=FEAT, embed_dim=EMB, fused_blocks=False)
    variables = _randomised(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, FEAT))), seed=0)
    apply = jax.jit(lambda v, x, m: jmodel.apply(v, x, mask=m))
    return jmodel, variables, apply


def _port(variables):
    model = CAMPPlus(FEAT, EMB)
    model.load_state_dict(weights.from_jax_variables(variables, "CAMPPlus"),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("t,masked", [(224, False), (250, False),
                                      (250, True)])
def test_campplus_matches_jax(jax_campplus, t, masked):
    _, variables, apply = jax_campplus
    rng = np.random.default_rng(t)
    x = rng.normal(size=(2, t, FEAT)).astype(np.float32)
    mask = _ragged_mask(2, t) if masked else None
    want = np.asarray(apply(variables, jnp.asarray(x),
                            None if mask is None else jnp.asarray(mask)))
    model = _port(variables)
    tm = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        got = model(torch.from_numpy(x), tm).numpy()  # fused calls, plain
        got_layers = model.set_fused(False)(torch.from_numpy(x), tm).numpy()
    assert got.shape == (2, EMB) and got.dtype == np.float32
    _model_close(got, want)
    _model_close(got_layers, want)
    _model_close(got, got_layers)


def test_campplus_frame_features_match_jax(jax_campplus):
    """return_frame_feat: the trunk's frame features after out_nonlinear,
    (B, T', C) at T' = T / 2, masked, at the whole model's bound."""
    jmodel, variables, _ = jax_campplus
    x = np.random.default_rng(9).normal(size=(2, 64, FEAT)).astype(
        np.float32)
    mask = _ragged_mask(2, 64)
    want = np.asarray(jax.jit(lambda v, x, m: jmodel.apply(
        v, x, mask=m, return_frame_feat=True))(
            variables, jnp.asarray(x), jnp.asarray(mask)))
    with torch.no_grad():
        got = _port(variables)(torch.from_numpy(x), torch.from_numpy(mask),
                               return_frame_feat=True).numpy()
    assert got.shape == want.shape == (2, 32, 512)
    _model_close(got, want)


def test_campplus_train_mode_matches_flax(jax_campplus):
    """A train-mode forward: the output (batch statistics) and every
    running statistic after flax's momentum update, the FCM's 2-D
    BatchNorms included."""
    jmodel, variables, _ = jax_campplus
    x = np.random.default_rng(7).normal(size=(3, 96, FEAT)).astype(
        np.float32)
    want, upd = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    model = _port(variables).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **MODEL_TOL)
    want_sd = weights.from_jax_variables(
        {"batch_stats": jax.device_get(upd["batch_stats"])}, "CAMPPlus")
    sd = model.state_dict()
    stats = [k for k in want_sd if k.endswith(("running_mean",
                                               "running_var"))]
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.modules.batchnorm
                                            ._BatchNorm)
                                 for m in model.modules())
    assert any(k.startswith("head.layer1.0.shortcut.1") for k in stats)
    for k in stats:
        w = want_sd[k].numpy()
        np.testing.assert_allclose(sd[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1.0),
                                   err_msg=k)


def test_make_eval_embed_fn_matches_jax(jax_campplus):
    jmodel, variables, _ = jax_campplus
    rng = np.random.default_rng(8)
    wav = rng.uniform(-0.5, 0.5, (2, 40000)).astype(np.float32)
    mask = np.ones_like(wav)
    mask[1, 26000:] = 0
    batch = {"wav": wav, "mask": mask}
    fn = jax.jit(j_embed_fn(jmodel, JFbankConfig(num_mel_bins=FEAT)))
    want = np.asarray(fn(variables, {k: jnp.asarray(v)
                                     for k, v in batch.items()}))
    got = make_eval_embed_fn(_port(variables), FbankConfig(num_mel_bins=FEAT),
                             device="cpu")(batch).numpy()
    assert got.shape == (2, EMB) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


# ---- poolings ----

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["TAP", "TSDP", "TSTP"])
def test_statistics_poolings_match_jax(name, masked):
    """TAP, TSDP and TSTP (masked; ddof 1 for the std) against the JAX
    package's, within 1e-5, with their output widths."""
    from wespeaker_tpu.models import pooling_layers as jpool
    from wespeaker_tpu_torch.models import pooling_layers as tpool

    rng = np.random.default_rng(12)
    x = rng.normal(size=(3, 17, 8)).astype(np.float32)
    mask = _ragged_mask(3, 17) if masked else None
    jm = jpool.get_pooling(name, 8)
    want = np.asarray(jm.apply({}, jnp.asarray(x),
                               None if mask is None else jnp.asarray(mask)))
    got = tpool.get_pooling(name, 8)(
        torch.from_numpy(x),
        None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (3, tpool.pooling_out_dim(name, 8))
    assert tpool.pooling_out_dim(name, 8) == jpool.pooling_out_dim(name, 8)
    np.testing.assert_allclose(got, want, **BLOCK_TOL)


# ---- weights ----

def test_rank4_kernels_convert_to_torch_conv2d():
    """A flax 2-D conv kernel (kh, kw, I, O) becomes a torch (O, I, kh, kw)
    weight that computes the same convolution."""
    conv = fnn.Conv(6, (3, 3), strides=(2, 1), padding=((1, 1), (1, 1)),
                    use_bias=False)
    x = np.random.default_rng(9).normal(size=(2, 9, 7, 4)).astype(np.float32)
    params = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    sd = weights.from_jax_variables({"params": {"head": {"conv1": params}}},
                                    "CAMPPlus")
    w = sd["head.conv1.weight"]
    kernel = np.asarray(params["kernel"])
    assert tuple(w.shape) == (6, 4, 3, 3)
    np.testing.assert_array_equal(w.numpy(), kernel.transpose(3, 2, 0, 1))
    got = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                     w, stride=(2, 1), padding=1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_campplus_variables_load_strictly_and_map_back(jax_campplus):
    """from_jax_variables gives exactly the port's state_dict keys (2-D
    convs, shortcuts, affine-free BN included), and the JAX package's own
    converter maps the port's state_dict back to the same variables."""
    _, variables, _ = jax_campplus
    sd = weights.from_jax_variables(variables, "CAMPPlus")
    model = CAMPPlus(FEAT, EMB)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    back = torch_compat.torch_to_flax_variables(
        model.state_dict(), variables, torch_compat.rules_for("CAMPPlus"))
    want = flatten_dict(variables)
    got = flatten_dict(jax.device_get(back))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


@pytest.mark.parametrize("name", ["CAMPPlus", "ECAPA_TDNN",
                                  "ECAPA_TDNN_GLOB_c512"])
def test_rules_are_chosen_by_model_name(name):
    """The port's own copy of the name rules is the JAX package's, chosen
    by the model's name (the ECAPA list with the XI pooling's rules)."""
    got = weights.rules_for(name)
    want = [tuple(r) for r in torch_compat.rules_for(name)]
    assert got and list(got) == want
    # the neural-frontend heads have the JAX package's rules too, since
    # their frontends are ported; a name of no family gets none
    assert list(weights.rules_for("whisper_PMFA")) == [
        tuple(r) for r in torch_compat.rules_for("whisper_PMFA")]
    assert weights.rules_for("NoSuchModel") == ()


def test_ecapa_conversion_is_unchanged():
    """ECAPA callers that pass no model name get the ECAPA rules."""
    tree = {"params": {"layer2": {"block_1": {"convs_0": {
        "kernel": np.zeros((3, 8, 8), np.float32),
        "bias": np.zeros(8, np.float32)}}}},
        "batch_stats": {"layer2": {"block_1": {"bns_0": {
            "mean": np.zeros(8, np.float32),
            "var": np.ones(8, np.float32)}}}}}
    sd = weights.from_jax_variables(tree)
    named = weights.from_jax_variables(tree, "ECAPA_TDNN_GLOB_c512")
    assert list(sd) == list(named) and set(sd) == {
        "layer2.se_res2block.1.convs.0.weight",
        "layer2.se_res2block.1.convs.0.bias",
        "layer2.se_res2block.1.bns.0.running_mean",
        "layer2.se_res2block.1.bns.0.running_var",
        "layer2.se_res2block.1.bns.0.num_batches_tracked"}
    assert tuple(sd["layer2.se_res2block.1.convs.0.weight"].shape) == (8, 8, 3)


def test_campplus_config_builds_through_the_registry():
    """campplus.yaml's model and model_args build the port's CAMPPlus with
    TSTP pooling (pooled width 2 x 512 at full width)."""
    model = get_speaker_model("CAMPPlus")(feat_dim=80, embed_dim=512,
                                          pooling_func="TSTP")
    assert isinstance(model, CAMPPlus)
    assert model.xvector.dense.linear.in_channels == 1024
    assert model.head.out_channels == 320


def test_campplus_yaml_serves_on_cpu(tmp_path):
    """examples/voxceleb/v2/conf/campplus.yaml and a torch state_dict give
    a server (device="cpu") whose concurrent replies equal the extractor's
    embedding of each utterance padded and masked to its bucket (the same
    function: within 1e-4 relative)."""
    conf = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "voxceleb" / "v2" / "conf" / "campplus.yaml")
    configs = parse_config_or_kwargs(str(conf))
    assert configs["model"] == "CAMPPlus"
    torch.manual_seed(0)
    ckpt = tmp_path / "cam.pt"
    torch.save(CAMPPlus(**configs["model_args"]).state_dict(), ckpt)
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
