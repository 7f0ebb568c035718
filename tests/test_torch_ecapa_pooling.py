"""ECAPA-TDNN with each ported pooling but ASTP (TAP, TSDP, TSTP) against
the JAX package's flax ECAPA with the same pooling.

A narrow f32 ECAPA_TDNN (channels 64, feat 16, embed 8) is built in JAX
with randomised BN statistics and biases; its variables go to the port
through `utils.weights.from_jax_variables`. The fused tail is the MFA conv
+ ASTP, so with these poolings both packages run the MFA conv as a layer
and pool its output: in eval the port's `fused=True` (the fused SE blocks'
plain versions, and TSDP/TSTP through `ops.pooling`'s plain versions) and
`fused=False` (every module layer by layer), masked and not, agree with
JAX's layer-by-layer path within 1e-5 of the largest magnitude (f32, sums
in another order). One SGD train step with TSTP (ArcMargin over 10
classes, B=4 chunks of 40 frames, dither 0, spec-aug off, as
tests/test_torch_train.py) gives the same loss and BatchNorm running
statistics within 1e-4.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict, unflatten_dict  # noqa: E402

from wespeaker_tpu.frontend import FbankConfig as JFbankConfig  # noqa: E402
from wespeaker_tpu.models.ecapa_tdnn import ECAPA_TDNN as JECAPA  # noqa: E402
from wespeaker_tpu.models.projections import \
    ArcMarginProduct as JArcMargin  # noqa: E402
from wespeaker_tpu.train import init_train_state  # noqa: E402
from wespeaker_tpu.train import make_train_step as j_make_train_step  # noqa
from wespeaker_tpu.train.optim import make_optimizer as j_opt  # noqa: E402
from wespeaker_tpu.train.train_step import AugConfig as JAug  # noqa: E402
from wespeaker_tpu.utils import schedulers as jsched  # noqa: E402
from wespeaker_tpu_torch.frontend import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN  # noqa: E402
from wespeaker_tpu_torch.models.projections import \
    ArcMarginProduct  # noqa: E402
from wespeaker_tpu_torch.train import AugConfig, make_train_step  # noqa
from wespeaker_tpu_torch.train.optim import make_optimizer  # noqa: E402
from wespeaker_tpu_torch.utils import schedulers as tsched  # noqa: E402
from wespeaker_tpu_torch.utils.weights import from_jax_variables  # noqa

torch.set_num_threads(2)
C, FEAT, EMB, NCLS, B = 64, 16, 8, 10, 4
N_SAMPLES = 39 * 160 + 400  # 40 frames
OPT_CONF = {"optimizer": "SGD",
            "optimizer_args": {"momentum": 0.9, "nesterov": True,
                               "weight_decay": 1e-4}}


def _jax_variables(model, seed):
    """model.init, then BN statistics, scales and biases randomised so that
    BN folding and every bias are exercised; returns a numpy tree."""
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 32, FEAT)), train=False)
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


def _rel_close(got, want, tol, what):
    """max |got - want| within tol of max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: max error {err:.3g} of its max > {tol}"


@pytest.mark.parametrize("pooling", ["TAP", "TSDP", "TSTP"])
def test_ecapa_pooling_matches_jax_in_eval(pooling):
    jmodel = JECAPA(channels=C, feat_dim=FEAT, embed_dim=EMB,
                    pooling_func=pooling, fused_block=False,
                    fused_tail=False)
    variables = _jax_variables(jmodel, seed=4)
    model = ECAPA_TDNN(C, FEAT, EMB, pooling_func=pooling)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model.eval()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 27, FEAT)).astype(np.float32)
    mask = np.ones((3, 27), np.float32)
    mask[1, 17:] = 0
    mask[2, 9:] = 0
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        want = np.asarray(jmodel.apply(variables, jnp.asarray(x), mask=jm))
        for fused in (True, False):
            with torch.no_grad():
                got = model.set_fused(fused)(torch.from_numpy(x), tm).numpy()
            assert got.shape == (3, EMB)
            _rel_close(got, want, 1e-5,
                       f"{pooling} fused={fused} masked={m is not None}")


def test_ecapa_tstp_train_step_matches_jax():
    rng = np.random.default_rng(3)
    batch = {"wav": rng.uniform(-0.5, 0.5, (B, N_SAMPLES)).astype(np.float32),
             "label": rng.integers(0, NCLS, B).astype(np.int32)}
    lr_kw = dict(num_epochs=10, epoch_iter=2, initial_lr=1e-4, final_lr=5e-5,
                 warm_up_epoch=1)
    m_kw = dict(epoch_iter=2, increase_start_epoch=1, fix_start_epoch=3,
                initial_margin=0.0, final_margin=0.2)
    jmodel = JECAPA(channels=C, feat_dim=FEAT, embed_dim=EMB,
                    pooling_func="TSTP", fused_block=False, fused_tail=True)
    jproj = JArcMargin(EMB, NCLS)
    tx = j_opt(OPT_CONF)
    state = init_train_state(jmodel, jproj, tx, jax.random.PRNGKey(0),
                             feat_dim=FEAT, embed_dim=EMB)
    jstep = jax.jit(j_make_train_step(
        jmodel, jproj, tx, jsched.ExponentialDecrease(**lr_kw),
        jsched.MarginScheduler(**m_kw),
        fbank_cfg=JFbankConfig(num_mel_bins=FEAT, dither=0.0),
        aug=JAug(spec_aug=False), compute_dtype=jnp.float32))

    # fused=True: the tail takes the MFA conv + TSTP (the fused tail is
    # ASTP's only), the SE blocks layer by layer in training
    model = ECAPA_TDNN(C, FEAT, EMB, pooling_func="TSTP", fused=True)
    model.load_state_dict(from_jax_variables(
        {"params": state.params["model"],
         "batch_stats": state.batch_stats}), strict=True)
    proj = ArcMarginProduct(EMB, NCLS)
    with torch.no_grad():
        proj.weight.copy_(torch.from_numpy(np.array(
            state.params["projection"]["weight"])))
    opt = make_optimizer(OPT_CONF, list(model.parameters())
                         + list(proj.parameters()))
    step = make_train_step(
        model, proj, opt, tsched.ExponentialDecrease(**lr_kw),
        tsched.MarginScheduler(**m_kw),
        FbankConfig(num_mel_bins=FEAT, dither=0.0), AugConfig(spec_aug=False),
        device="cpu")

    state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = step(batch)
    for key in ("loss", "acc"):
        _rel_close(float(tm[key]), float(jm[key]), 1e-4, key)
    want = from_jax_variables({"params": state.params["model"],
                               "batch_stats": state.batch_stats})
    got = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats and "bn.running_mean" in stats
    for key in stats:
        _rel_close(got[key], want[key], 1e-4, key)
