"""Port parity for the pieces of the training path: the differentiable
MFA+ASTP tail (forward and backward), BatchNorm's running statistics, the
ArcMargin head and the LR and margin schedules, each against the JAX
package on the same numpy inputs, in f32 on the CPU.

The tail: on a CPU tensor the port's `mfa_astp_train` runs its plain
forward and its written-out backward inside the autograd Function; the
JAX side runs its Pallas forward in interpret mode and its custom
backward (the Pallas backward in interpret mode at T=32, its jnp backward
at T=30, where the Pallas one does not fit). Values at rtol/atol 2e-4 and
each gradient scaled by its largest magnitude at 5e-4, the bars of
tests/test_pallas_ops.py (same math, sums in another order).
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
flax = pytest.importorskip("flax")  # the JAX package needs both
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wespeaker_tpu.models.projections import \
    ArcMarginProduct as JArcMargin  # noqa: E402
from wespeaker_tpu.ops import mfa_astp_vjp as jvjp  # noqa: E402
from wespeaker_tpu.utils import schedulers as jsched  # noqa: E402
from wespeaker_tpu_torch.models.layers import batch_norm  # noqa: E402
from wespeaker_tpu_torch.models.projections import (  # noqa: E402
    ArcMarginProduct, get_projection)
from wespeaker_tpu_torch.ops import mfa_astp_vjp as tvjp  # noqa: E402
from wespeaker_tpu_torch.utils import schedulers as tsched  # noqa: E402

torch.set_num_threads(2)
NAMES = ["x2", "x3", "x4", "wm", "bm", "k1", "b1", "k2", "b2"]


def _tail_args(rng, b, t, c, a, glob):
    d = 3 * c

    def mk(*shape):
        return (rng.normal(size=shape) * 0.3).astype(np.float32)

    return [mk(b, t, c), mk(b, t, c), mk(b, t, c), mk(3 * c, d), mk(d),
            mk(3 * d if glob else d, a), mk(a), mk(a, d), mk(d)]


def _scaled_close(got, want, name, tol=5e-4):
    scale = max(float(np.max(np.abs(want))), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=tol,
                               err_msg=f"grad mismatch: {name}")


@pytest.mark.parametrize("glob", [True, False])
@pytest.mark.parametrize("t", [32, 30])
def test_mfa_astp_train_matches_jax(glob, t):
    rng = np.random.default_rng(7)
    b, c, a = 5, 128, 128
    args = _tail_args(rng, b, t, c, a, glob)
    g = rng.normal(size=(b, 6 * c)).astype(np.float32)

    jargs = [jnp.asarray(v) for v in args]
    jg = jnp.asarray(g)
    want = np.asarray(jvjp.mfa_astp_train(*jargs, glob, True))
    wants = jax.grad(
        lambda *a_: jnp.sum(jvjp.mfa_astp_train(*a_, glob, True) * jg),
        argnums=tuple(range(9)))(*jargs)

    targs = [torch.tensor(v, requires_grad=True) for v in args]
    out = tvjp.mfa_astp_train(*targs, glob=glob)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), targs)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=2e-4,
                               rtol=2e-4)
    assert grads[-1].abs().max().item() == 0.0  # db2, exactly
    for name, got, ref in zip(NAMES[:-1], grads, wants):
        assert got.shape == ref.shape, name
        _scaled_close(got.numpy(), np.asarray(ref), name)


@pytest.mark.parametrize("glob", [True, False])
def test_mfa_astp_train_bwd_reference_matches_autograd(glob):
    """The written-out backward against torch autograd through the plain
    forward (same residuals, so the same relu mask)."""
    rng = np.random.default_rng(8)
    args = [torch.from_numpy(v) for v in _tail_args(rng, 3, 30, 128, 128,
                                                     glob)]
    g = torch.from_numpy(rng.normal(size=(3, 768)).astype(np.float32))
    x2, x3, x4, wm, bm, k1, b1, k2, b2 = args
    pooled, h, att, cstats = tvjp.mfa_astp_train_fwd_reference(*args,
                                                               glob=glob)
    got = tvjp.mfa_astp_train_bwd_reference(x2, x3, x4, wm, k1, b2, k2,
                                            pooled, h, att, cstats, g,
                                            glob=glob)
    ins = [v.clone().requires_grad_(True) for v in args]
    out = tvjp.mfa_astp_train_reference(*ins, glob=glob)
    torch.testing.assert_close(out.detach(), pooled, rtol=1e-5, atol=1e-5)
    auto = torch.autograd.grad((out * g).sum(), ins)
    assert got[-1].abs().max().item() == 0.0
    for name, gv, av in zip(NAMES[:-1], got, auto):
        _scaled_close(gv.numpy(), av.numpy(), name, tol=1e-5)


@pytest.mark.parametrize("shape", [(4, 7, 6), (4, 6)])
def test_batch_norm_training_matches_flax(shape):
    """Training-mode BN: output and updated running statistics against
    flax nn.BatchNorm(momentum=0.9), whose running variance is the biased
    batch variance (PyTorch's own update would store n/(n-1) times it)."""
    rng = np.random.default_rng(3)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=c)).astype(np.float32)
    mean0 = (0.1 * rng.normal(size=c)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)

    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, mut = jbn.apply(variables, jnp.asarray(x),
                          mutable=["batch_stats"])

    bn = torch.nn.BatchNorm1d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    bn.train()
    got = batch_norm(torch.from_numpy(x), bn)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), **tol)
    assert int(bn.num_batches_tracked) == 1
    bn.eval()  # eval normalises with the running statistics, no update
    before = bn.running_var.clone()
    y = batch_norm(torch.from_numpy(x), bn)
    assert torch.equal(bn.running_var, before)
    ref = (torch.from_numpy(x) - bn.running_mean) / torch.sqrt(
        bn.running_var + 1e-5) * bn.weight + bn.bias
    torch.testing.assert_close(y, ref.detach(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("easy", [False, True])
@pytest.mark.parametrize("margin", [0.0, 0.2])
def test_arc_margin_matches_jax(margin, easy):
    rng = np.random.default_rng(4)
    embed = rng.normal(size=(6, 16)).astype(np.float32)
    label = rng.integers(0, 10, 6).astype(np.int32)
    head = JArcMargin(16, 10, scale=32.0, easy_margin=easy)
    params = head.init(jax.random.PRNGKey(0), jnp.asarray(embed),
                       jnp.asarray(label))
    want = np.asarray(head.apply(params, jnp.asarray(embed),
                                 jnp.asarray(label), margin))
    port = get_projection({"project_type": "arc_margin", "embed_dim": 16,
                           "num_class": 10, "scale": 32.0,
                           "easy_margin": easy})
    assert isinstance(port, ArcMarginProduct)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(
            params["params"]["weight"])))
    got = port(torch.from_numpy(embed), torch.from_numpy(label),
               margin).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    # every head is ported (tests/test_torch_heads.py)
    assert type(get_projection({"project_type": "add_margin",
                                "embed_dim": 16, "num_class": 10,
                                "scale": 32.0})).__name__ == \
        "AddMarginProduct"


EPOCH_ITER = 10
SCHEDULES = [
    ("ExponentialDecrease", dict(num_epochs=20, epoch_iter=EPOCH_ITER,
                                 initial_lr=0.1, final_lr=5e-5,
                                 warm_up_epoch=3, scale_ratio=4.0)),
    ("ExponentialDecrease", dict(num_epochs=20, epoch_iter=EPOCH_ITER,
                                 initial_lr=0.1, final_lr=5e-5,
                                 warm_up_epoch=3, scale_ratio=0.5,
                                 warm_from_zero=True)),
    ("TriAngular2", dict(num_epochs=20, epoch_iter=EPOCH_ITER,
                         initial_lr=0.1, final_lr=1e-3, warm_up_epoch=2,
                         scale_ratio=2.0)),
    ("WarmupLR_withStepDecay", dict(num_epochs=20, epoch_iter=EPOCH_ITER,
                                    initial_lr=0.1, warmup_epoch=2,
                                    decay_epoch=4, gamma=0.5)),
    ("WarmupCosineScheduler", dict(num_epochs=20, epoch_iter=EPOCH_ITER,
                                   min_lr=1e-4, max_lr=0.1, warmup_epoch=2,
                                   fix_epoch=15)),
]
STEPS = [0, 1, 5, 15, 29, 30, 31, 64, 120, 149, 150, 151, 199]


@pytest.mark.parametrize("name,kwargs", SCHEDULES)
def test_lr_schedules_match_jax(name, kwargs):
    """Steps in the warm-up, at its end, in the decay or ramp and past the
    fixed point."""
    want = jsched.get_lr_scheduler(name, **kwargs)
    got = tsched.get_lr_scheduler(name, **kwargs)
    for step in STEPS:
        assert math.isclose(got(step), float(want(step)), rel_tol=1e-5,
                            abs_tol=1e-9), (name, step)


@pytest.mark.parametrize("increase_type", ["exp", "linear"])
def test_margin_schedule_matches_jax(increase_type):
    kw = dict(epoch_iter=EPOCH_ITER, increase_start_epoch=3,
              fix_start_epoch=8, initial_margin=0.0, final_margin=0.2,
              increase_type=increase_type)
    want, got = jsched.MarginScheduler(**kw), tsched.MarginScheduler(**kw)
    # before the ramp (0-19), on it (20-69), fixed (70-)
    for step in (0, 10, 19, 20, 21, 45, 69, 70, 71, 150):
        assert math.isclose(got(step), float(want(step)), rel_tol=1e-5,
                            abs_tol=1e-7), step
    assert got(0) == 0.0 and got(70) == 0.2
