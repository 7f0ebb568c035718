"""Two train steps of a neural-frontend composite in the port against the
JAX package's make_train_step: the tiny whisper_pmfa composite (16 mels,
one block of 32, tests/test_torch_whisper.py's widths), joint and frozen,
from the same weights (seeded numpy, carried by utils/weights.py), B=8,
f32, dither 0, spec-aug off, SGD with momentum and weight decay, an
ArcMargin head. The loss and accuracy of each step within 1e-4, the
head's BN running statistics within 1e-4 of their largest magnitude
after the steps; the frozen frontend's parameters bit-identical after
the steps (requires_grad off, so no update and no weight decay) and the
joint one's all moved, in both packages.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_zoo_util import numpy_variables  # noqa: E402

torch.set_num_threads(2)
FE = dict(n_mels=16, num_blocks=1, output_size=32, n_head=4, layer_st=0,
          layer_ed=0, n_ctx=128)


def _rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


EMB, NCLS, B = 16, 6, 8
OPT_CONF = {"optimizer": "SGD",
            "optimizer_args": {"momentum": 0.9, "nesterov": True,
                               "weight_decay": 1e-3}}


def _configs(frozen):
    fe = dict(FE, frozen=frozen)
    return {"model": "whisper_PMFA_large_v2",
            "model_args": {"embed_dim": EMB},
            "dataset_args": {"frontend": "whisper_encoder",
                             "whisper_encoder_args": fe}}


def _voices(rng, b, n):
    """b utterances that differ: a tone of its own pitch and level plus
    noise. Utterances of one noise would pool to statistics that agree to
    ~5e-4 across the batch, and the head's train-mode BatchNorm over B=3
    would scale the two packages' 1e-6 rounding differences up ~2,000x."""
    t = np.arange(n) / 16000
    f0 = rng.uniform(100, 400, (b, 1))
    level = rng.uniform(0.05, 0.5, (b, 1))
    return (level * np.sin(2 * np.pi * f0 * t)
            + rng.uniform(-0.05, 0.05, (b, n))).astype(np.float32)


@pytest.mark.parametrize("frozen", [False, True], ids=["joint", "frozen"])
def test_two_train_steps_match_jax(frozen):
    from wespeaker_tpu.bin.train import _frontend_frozen_mask
    from wespeaker_tpu.models.projections import get_projection as jget
    from wespeaker_tpu.train import make_train_step as j_make_train_step
    from wespeaker_tpu.train.composite import build_model as jbuild
    from wespeaker_tpu.train.optim import make_optimizer as j_opt
    from wespeaker_tpu.train.train_step import AugConfig as JAug
    from wespeaker_tpu.train.train_step import TrainState
    from wespeaker_tpu.utils import schedulers as jsched
    from wespeaker_tpu_torch.frontend import FbankConfig
    from wespeaker_tpu_torch.models.projections import get_projection
    from wespeaker_tpu_torch.train import AugConfig, make_train_step
    from wespeaker_tpu_torch.train.composite import (build_model,
                                                     featurizers)
    from wespeaker_tpu_torch.train.optim import make_optimizer
    from wespeaker_tpu_torch.utils import schedulers as tsched
    from wespeaker_tpu_torch.utils.weights import (from_jax_checkpoint,
                                                   rules_name)

    configs = _configs(frozen)
    lr_kw = dict(num_epochs=10, epoch_iter=2, initial_lr=1e-2,
                 final_lr=5e-3, warm_up_epoch=0)
    m_kw = dict(epoch_iter=2, increase_start_epoch=0, fix_start_epoch=1,
                initial_margin=0.1, final_margin=0.2)
    proj_conf = {"project_type": "arc_margin", "embed_dim": EMB,
                 "num_class": NCLS, "scale": 32.0}
    built = jbuild(configs)
    jproj = jget(proj_conf)
    tx = j_opt(OPT_CONF, _frontend_frozen_mask if frozen else None)
    mvars = numpy_variables(built.model, jnp.zeros((1, 40, 16)), seed=6,
                            stats=False, train=False)
    # jitted: one compile each instead of one per eager op
    pvars = jax.jit(jproj.init)(jax.random.PRNGKey(1), jnp.zeros((2, EMB)),
                                jnp.zeros((2,), jnp.int32))
    params = {"model": mvars["params"], "projection": pvars["params"]}
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=mvars["batch_stats"],
                       opt_state=jax.jit(tx.init)(params),
                       rng=jax.random.PRNGKey(2), proj_stats={})
    jstep = jax.jit(j_make_train_step(
        built.model, jproj, tx, jsched.ExponentialDecrease(**lr_kw),
        jsched.MarginScheduler(**m_kw), aug=JAug(spec_aug=False),
        compute_dtype=jnp.float32, featurize_fn=built.featurize_train))

    model = build_model(configs)
    proj = get_projection(proj_conf)
    model_sd, head_sd = from_jax_checkpoint(
        {"params": mvars["params"], "batch_stats": mvars["batch_stats"],
         "projection": pvars["params"]}, rules_name(model))
    model_sd["speaker_model.bn.norm.num_batches_tracked"] = torch.tensor(0)
    model.load_state_dict(model_sd, strict=True)
    proj.load_state_dict(head_sd, strict=True)
    before = {k: v.clone() for k, v in model.frontend.state_dict().items()}
    opt = make_optimizer(OPT_CONF, [p for p in list(model.parameters())
                                    + list(proj.parameters())
                                    if p.requires_grad])
    step = make_train_step(
        model, proj, opt, tsched.ExponentialDecrease(**lr_kw),
        tsched.MarginScheduler(**m_kw), FbankConfig(dither=0.0),
        AugConfig(spec_aug=False), device="cpu",
        featurize_fn=featurizers(configs)[0])

    rng = np.random.default_rng(7)
    for i in range(2):
        batch = {"wav": _voices(rng, B, 6400),
                 "label": rng.integers(0, NCLS, B).astype(np.int32)}
        state, jm = jstep(state, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
        tm = step(batch)
        for key in ("loss", "acc"):
            want = float(jm[key])
            assert abs(float(tm[key]) - want) <= 1e-4 * max(abs(want), 1.0)
    stats = state.batch_stats["speaker_model"]["bn_norm"]
    norm = model.speaker_model.bn["norm"]
    for got, want in ((norm.running_mean, stats["mean"]),
                      (norm.running_var, stats["var"])):
        assert _rel_err(got, want) <= 1e-4
    after = model.frontend.state_dict()
    same = [torch.equal(after[k], v) for k, v in before.items()]
    assert all(same) if frozen else not any(same)
    j_before = jax.tree_util.tree_leaves(mvars["params"]["frontend"])
    j_after = jax.tree_util.tree_leaves(state.params["model"]["frontend"])
    assert all(np.array_equal(a, np.asarray(b)) for a, b in
               zip(j_before, j_after)) == frozen
