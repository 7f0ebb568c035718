"""Two train steps of CAMPPlus and of Gemini DF-ResNet against the JAX
package's, on the CPU in f32, as tests/test_torch_train.py holds ECAPA and
tests/test_torch_resnet.py holds ResNet.

Each model at a narrow width (CAMPPlus: growth 8, bn_size 2, 16 initial
channels, feat 16, embed 16; Gemini: depths (1, 1, 2, 1), dims
(8, 8, 16, 16, 32), feat 16, embed 16) with ArcMargin over 10 classes,
B=4 chunks of 40 frames, dither 0 and spec-aug off, SGD as
`make_optimizer` builds it (nesterov, weight decay 1e-4), from the same
weights. JAX's default paths train without their Pallas kernels and the
port trains without its CUDA kernels, so both sides run the same layers.

Held: accuracy, LR and margin within 1e-4 relative; the BatchNorm running
variances within 1e-4 of each tensor's largest magnitude and the running
means within 1e-4 of their BN's running std (a mean near zero over CMVN'd
features would otherwise measure f32 noise); the loss of both steps within
1e-4 relative for Gemini, at LR 1e-4, and within 1e-3 for CAMPPlus, at LR
1e-7. `python -m tests.torch_train_parity_report` prints what the bars
leave: CAMPPlus's f32 train-mode embedding differs from JAX's by 9.0e-5 of
its largest magnitude after 52 dense layers, and the last BatchNorm (over
4 embeddings) and ArcMargin's scale 32 make that 2.2e-4 (step 0) and
6.4e-4 (step 1) in the loss; in f64 the two sides agree, so it is f32
rounding, not a difference of method. Its gradients reach 6e3 in norm at
this width, and at LR 1e-4 one step moves the weights so far that the
second step's losses differ by 28% (ROADMAP.md Queue 3 records this).
Gemini agrees within 1e-5 at either LR.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package needs both
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.frontend import FbankConfig as JFbankConfig  # noqa: E402
from wespeaker_tpu.models.campplus import CAMPPlus as JCAMPPlus  # noqa: E402
from wespeaker_tpu.models.gemini_dfresnet import \
    Gemini_DF_ResNet as JGemini  # noqa: E402
from wespeaker_tpu.models.projections import \
    ArcMarginProduct as JArcMargin  # noqa: E402
from wespeaker_tpu.train import init_train_state  # noqa: E402
from wespeaker_tpu.train import make_train_step as j_make_train_step  # noqa
from wespeaker_tpu.train.optim import make_optimizer as j_opt  # noqa: E402
from wespeaker_tpu.train.train_step import AugConfig as JAug  # noqa: E402
from wespeaker_tpu.utils import schedulers as jsched  # noqa: E402
from wespeaker_tpu_torch.frontend import FbankConfig  # noqa: E402
from wespeaker_tpu_torch.models.campplus import CAMPPlus  # noqa: E402
from wespeaker_tpu_torch.models.gemini_dfresnet import \
    Gemini_DF_ResNet  # noqa: E402
from wespeaker_tpu_torch.models.projections import \
    ArcMarginProduct  # noqa: E402
from wespeaker_tpu_torch.train import AugConfig, make_train_step  # noqa
from wespeaker_tpu_torch.train.optim import make_optimizer  # noqa: E402
from wespeaker_tpu_torch.utils import schedulers as tsched  # noqa: E402
from wespeaker_tpu_torch.utils import weights  # noqa: E402

torch.set_num_threads(2)
FEAT, EMB, NCLS, B = 16, 16, 10, 4
N_SAMPLES = 39 * 160 + 400  # 40 frames
OPT_CONF = {"optimizer": "SGD",
            "optimizer_args": {"momentum": 0.9, "nesterov": True,
                               "weight_decay": 1e-4}}
CAM_KW = dict(feat_dim=FEAT, embed_dim=EMB, growth_rate=8, bn_size=2,
              init_channels=16)
GEMINI_KW = dict(depths=(1, 1, 2, 1), dims=(8, 8, 16, 16, 32),
                 feat_dim=FEAT, embed_dim=EMB)
# (JAX model, port model, weight-rule name, loss bar, LR) of each family
FAMILIES = {
    "CAMPPlus": (lambda: JCAMPPlus(**CAM_KW), lambda: CAMPPlus(**CAM_KW),
                 "CAMPPlus", 1e-3, 1e-7),
    "Gemini": (lambda: JGemini(**GEMINI_KW),
               lambda: Gemini_DF_ResNet(**GEMINI_KW), "Gemini_DF_ResNet114",
               1e-4, 1e-4),
}


def _rel_err(got, want):
    """Largest error relative to the reference's largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-6)
    return float(np.max(np.abs(got - want))) / scale


def two_step_errors(family, lr):
    """Two train steps of `family` on both sides from the same weights at
    LR `lr`. Returns {"loss", "acc", "lr", "margin": [relative error at
    step 0, step 1], "running_var": largest error relative to each
    tensor's max, "running_mean": largest error relative to its BN's
    running std, "num_batches_tracked": the port's counts, "margin_1": the
    second step's margin}."""
    make_jax, make_port, rules, _, _ = FAMILIES[family]
    rng = np.random.default_rng(8)
    batches = [{"wav": rng.uniform(-0.5, 0.5, (B, N_SAMPLES)).astype(
                    np.float32),
                "label": rng.integers(0, NCLS, B).astype(np.int32)}
               for _ in range(2)]
    lr_kw = dict(num_epochs=10, epoch_iter=2, initial_lr=lr,
                 final_lr=lr / 2, warm_up_epoch=1)
    m_kw = dict(epoch_iter=2, increase_start_epoch=1, fix_start_epoch=3,
                initial_margin=0.0, final_margin=0.2)

    jmodel = make_jax()
    jproj = JArcMargin(EMB, NCLS)
    tx = j_opt(OPT_CONF)
    state = init_train_state(jmodel, jproj, tx, jax.random.PRNGKey(0),
                             feat_dim=FEAT, embed_dim=EMB)
    jstep = jax.jit(j_make_train_step(
        jmodel, jproj, tx, jsched.ExponentialDecrease(**lr_kw),
        jsched.MarginScheduler(**m_kw),
        fbank_cfg=JFbankConfig(num_mel_bins=FEAT, dither=0.0),
        aug=JAug(spec_aug=False), compute_dtype=jnp.float32))

    model = make_port()
    model.load_state_dict(weights.from_jax_variables(
        {"params": state.params["model"],
         "batch_stats": state.batch_stats}, rules), strict=True)
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

    out = {k: [] for k in ("loss", "acc", "lr", "margin")}
    for batch in batches:
        state, jm = jstep(state, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
        tm = step(batch)
        for key in out:
            out[key].append(_rel_err(float(tm[key]), float(jm[key])))
    out["margin_1"] = float(jm["margin"])

    want = weights.from_jax_variables({"params": state.params["model"],
                                       "batch_stats": state.batch_stats},
                                      rules)
    got = model.state_dict()
    out.update(running_var=0.0, running_mean=0.0, num_batches_tracked=set())
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            out["num_batches_tracked"].add(int(got[key]))
        elif key.endswith("running_var"):
            out["running_var"] = max(out["running_var"],
                                     _rel_err(got[key], value))
        elif key.endswith("running_mean"):
            std = float(np.sqrt(np.max(np.asarray(
                want[key[:-len("mean")] + "var"]))))
            err = float((got[key] - torch.as_tensor(value)).abs().max())
            out["running_mean"] = max(out["running_mean"], err / std)
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_two_train_steps_match_jax(family):
    _, _, _, loss_tol, lr = FAMILIES[family]
    errs = two_step_errors(family, lr)
    assert max(errs["loss"]) <= loss_tol, errs
    for key in ("acc", "lr", "margin", "running_var", "running_mean"):
        assert max(np.atleast_1d(errs[key])) <= 1e-4, (key, errs)
    assert errs["num_batches_tracked"] == {2}
    assert errs["margin_1"] > 0  # the second step ran with a margin
